"""The port's crypto plane (counterpart of `biscotti_tpu/crypto/`).

  * `ed25519`     — the pure-Python Edwards25519 group, copied whole: the
                    python-int oracle of everything below
  * `commitments` — the slim part of the reference's commitments module
                    that the device plane needs: the Pedersen generator
                    H, the python MSM oracle and the affine cell loader
  * `kernels`     — the device crypto plane (limb field, Edwards group,
                    MSM, fixed-base, grid validation, Shamir recovery) in
                    torch, with the on-curve validator as a CUDA kernel
"""
