"""zkvm_tpu_torch -- the PyTorch/CUDA port of zkvm_tpu for NVIDIA Hopper.

The port keeps zkvm_tpu's module names and data (Montgomery limb tensors,
byte layouts) and replaces each Pallas TPU kernel with a hand-written CUDA
kernel (`csrc/`, bound in `ops/kernels.py`).  It imports torch, never
jax, and nothing of zkvm_tpu: the host layer (params, fields, curves, rng,
serialize, native, plonk/polynomial) is the port's own copy.  Every
function that creates a tensor takes an explicit `device`; a CPU tensor
runs each kernel's plain PyTorch version, a CUDA tensor the kernel.

Ported so far: field arithmetic, G1 batch operations, the Pippenger MSM,
the KZG10 commit key, commitments, SRS setup and openings, the NTT (the
byte-plane matmul route and the staged butterfly route) and the
device-resident polynomial helpers.
"""

__version__ = "0.1.0"
