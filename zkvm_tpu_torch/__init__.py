"""zkvm_tpu_torch -- the PyTorch/CUDA port of zkvm_tpu for NVIDIA Hopper.

The port keeps zkvm_tpu's module names and data (Montgomery limb tensors,
byte layouts) and replaces each Pallas TPU kernel with a hand-written CUDA
kernel (`csrc/`, bound in `ops/kernels.py`).  It imports torch, never
jax, and nothing of zkvm_tpu: the host layer (params, fields, curves, rng,
serialize, native, hashes, merkle/tree, the plonk composer, transcript,
widgets, proof and verifier) is the port's own copy.  Every function that
creates a tensor takes an explicit `device`; a CPU tensor runs each
kernel's plain PyTorch version, a CUDA tensor the kernel.

Ported so far: the batch Merkle-membership service (its CLI, file formats
and circuit cache), the CDF debugger, the benches, the PLONK prover and
compiler (single device), field arithmetic, G1 batch operations, the
Pippenger MSM, the KZG10 commit key, commitments, SRS setup and openings,
the NTT (the byte-plane matmul route and the staged butterfly route), the
device-resident polynomial helpers, the batched Poseidon and the Merkle
tree.
"""

__version__ = "0.1.0"
