"""zkvm_tpu_torch -- the PyTorch/CUDA port of zkvm_tpu for NVIDIA Hopper.

The port keeps zkvm_tpu's module names and data (Montgomery limb tensors,
byte layouts) and replaces each Pallas TPU kernel with a hand-written CUDA
kernel (`csrc/`, bound in `ops/kernels.py`).  It imports torch and never
jax: of zkvm_tpu it uses only the jax-free host modules (fields, curves,
params, rng, native, serialize).  Every function that creates a tensor
takes an explicit `device`; a CPU tensor runs each kernel's plain PyTorch
version, a CUDA tensor the kernel.

Ported so far: field arithmetic, G1 batch operations, the Pippenger MSM
and the KZG10 commit key, commitments and SRS setup.
"""

__version__ = "0.1.0"
