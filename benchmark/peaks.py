"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at
its 700 W power limit). The configurations compute in float32 with TF32
off; no route that keeps float32's accuracy runs faster than one TF32
pass, so TF32's dense rate is the ceiling for their products."""

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
