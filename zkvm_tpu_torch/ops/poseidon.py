"""Batched Poseidon/Hades on device: [5, 8, batch] int32 limb tensors
(limb-major, the batch on the last axis, Montgomery form).

Counterpart of the reference's `ops/poseidon.py`.  The 68 rounds run in the
`hades_permute` CUDA kernel (`csrc/hades.cu`) for a CUDA tensor and in its
plain PyTorch version for a CPU tensor (`kernels.hades_permute` decides by
the tensor's device); the host reference is `hashes/hades.py`.

Also provides the arity-4 Merkle digest (one permutation per node) and the
level-wise Merkle tree build used by `merkle.PoseidonTree.from_leaves`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import Fr
from ..hashes.poseidon import Domain
from ..hashes.poseidon_constants import MDS_MATRIX, ROUND_CONSTANTS
from ..hashes.safe import Call, aggregate_io_pattern, tag_input
from . import kernels
from . import limb_field as lf
from .limb_field import FR


@functools.lru_cache(maxsize=None)
def _consts_np() -> np.ndarray:
    """[365, 8] uint32 Montgomery table: the 68 x 5 round constants, then
    the 5 x 5 MDS matrix row-major."""
    flat = ([v for row in ROUND_CONSTANTS for v in row]
            + [v for row in MDS_MATRIX for v in row])
    assert len(flat) == kernels.HADES_CONST_ROWS
    return np.ascontiguousarray(FR.to_mont_array_np(flat).T)


@functools.lru_cache(maxsize=None)
def hades_consts(device: torch.device) -> torch.Tensor:
    """The constant table of `kernels.hades_permute` on `device`."""
    return lf.u32_to_tensor(_consts_np(), device)


def hades_permute_batch(state: torch.Tensor) -> torch.Tensor:
    """68 Hades rounds over a [5, 8, B] Montgomery-form state tensor."""
    return kernels.hades_permute(state.contiguous(),
                                 hades_consts(state.device))


@functools.lru_cache(maxsize=None)
def _domain_tag_mont(domain_value: int, n_inputs: int,
                     n_outputs: int) -> np.ndarray:
    """Host-computed SAFE domain tag, Montgomery limbs [8]."""
    io = aggregate_io_pattern([Call.absorb(n_inputs), Call.squeeze(n_outputs)])
    tag = Fr.hash_to_scalar(tag_input(io, domain_value))
    return FR.mont_limbs(tag.value)


def merkle4_digest_batch(children: torch.Tensor) -> torch.Tensor:
    """Hash.digest(Domain.Merkle4) for [4, 8, batch] children -> [8, batch].

    Rate 4 = one absorb pass + one squeeze permutation: exactly one Hades
    permutation per node.
    """
    batch = children.shape[-1]
    tag = _domain_tag_mont(Domain.Merkle4.value, 4, 1)
    tag_row = lf.const_tensor(FR, tag, (1, FR.n_limbs, batch),
                              children.device)
    return hades_permute_batch(torch.cat([tag_row, children]))[1]


def merkle_tree_levels(leaf_hashes: torch.Tensor) -> list[torch.Tensor]:
    """Build all levels of an arity-4 Poseidon Merkle tree, leaves upward.

    leaf_hashes: [8, n] with n a power of 4.  Returns [leaves, ..., root[8, 1]].
    """
    levels = [leaf_hashes]
    cur = leaf_hashes
    while cur.shape[-1] > 1:
        n = cur.shape[-1]
        children = cur.reshape(FR.n_limbs, n // 4, 4).permute(2, 0, 1)
        cur = merkle4_digest_batch(children)
        levels.append(cur)
    return levels
