"""biscotti_tpu_torch — the PyTorch/CUDA port of biscotti_tpu.

A second package beside the JAX reference (`biscotti_tpu/`), grown slice by
slice. Module paths mirror the reference, so each file's counterpart is easy
to find. The port imports `torch` and numpy, never `jax` and nothing of
`biscotti_tpu`: what it needs of the reference's JAX-free modules it keeps as
its own copy.

Slice 1 is the in-process N-peer simulator round (`parallel/sim.py`): local
SGD, DP noise, the Krum accept mask (its scores from a hand-written Hopper
kernel, `ops/krum_cuda.py` + `csrc/krum_scores.cu`), aggregation and stake.
Slice 2 is the device crypto plane (`crypto/kernels/`: limb field, Edwards
group, MSM, fixed-base, grid validation, Shamir recovery), with the
on-curve validator as a hand-written Hopper kernel
(`crypto/kernels/cuda_validate.py` + `csrc/oncurve.cu`).
Slice 3 is the rest of the single-device simulator (the CNN families,
every defense, the mcmc13 mechanism, `run_scan`, the metrics hook), the
per-peer `Trainer` (`models/trainer.py`) and the device-round bench
(`bench.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`device.resolve_device`); with no GPU and no explicit CPU choice they raise.
"""

__version__ = "0.1.0"
