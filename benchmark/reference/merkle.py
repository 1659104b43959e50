"""The frozen input generator: a sparse arity-4 Poseidon tree, its openings
and the batch service's input bytes.

The tree follows dusk-merkle / poseidon-merkle: an absent subtree is the
item 0, a node with at least one present child is the Merkle4 digest of
its four children.  An opening lists, from the root down, the four
children of each node on the leaf's path and the leaf's child index at
each level; its wire form is root, branch items (32-byte little-endian
scalars) and u32 little-endian positions.
"""

from __future__ import annotations

import random

from .field import R
from .formats import LeafInfo, MultipleLeavesData
from .poseidon import merkle4

ARITY = 4


class SparseTree:
    """Leaves at given positions of a height-`height` tree; every level's
    present nodes are hashed once, bottom up."""

    def __init__(self, height: int, leaves: dict[int, int]):
        self.height = height
        self.levels = [dict(leaves)]  # levels[k]: position -> item, k from the leaves
        for _ in range(height):
            below = self.levels[-1]
            parents = sorted({pos // ARITY for pos in below})
            self.levels.append({
                p: merkle4([below.get(ARITY * p + i, 0) for i in range(ARITY)])
                for p in parents})

    def root(self) -> int:
        return self.levels[self.height].get(0, 0)

    def opening(self, position: int) -> tuple[list[list[int]], list[int]]:
        """(branch, positions), the root's children first."""
        branch, positions = [], []
        for depth in range(self.height):
            level = self.height - depth - 1  # the children's level
            parent = position // ARITY ** (level + 1)
            below = self.levels[level]
            branch.append([below.get(ARITY * parent + i, 0)
                           for i in range(ARITY)])
            positions.append(position // ARITY ** level % ARITY)
        return branch, positions


def opening_bytes(root: int, branch, positions) -> bytes:
    out = bytearray(root.to_bytes(32, "little"))
    for level in branch:
        for item in level:
            out += item.to_bytes(32, "little")
    for p in positions:
        out += int(p).to_bytes(4, "little")
    return bytes(out)


def verify_opening(root: int, leaf: int, branch, positions) -> bool:
    """Recompute the root from the leaf up (Opening::verify)."""
    item = leaf
    for level, pos in zip(reversed(branch), reversed(positions)):
        if level[pos] != item:
            return False
        item = merkle4(level)
    return item == root


def make_pool(seed: int, height: int, leaves: int):
    """`leaves` distinct leaves at consecutive positions from a seeded
    offset (an append-only note tree filling up), with seeded values.
    Returns (root, positions, values, the MultipleLeavesData rkyv bytes)."""
    rnd = random.Random(seed)
    offset = rnd.randrange(ARITY ** height - leaves + 1)
    positions = list(range(offset, offset + leaves))
    values = [rnd.randrange(R) for _ in positions]
    tree = SparseTree(height, dict(zip(positions, values)))
    root = tree.root()
    infos = []
    for pos, value in zip(positions, values):
        branch, path = tree.opening(pos)
        infos.append(LeafInfo(pos, value.to_bytes(32, "little"),
                              opening_bytes(root, branch, path)))
    blob = MultipleLeavesData(root.to_bytes(32, "little"), infos)
    return root, positions, values, blob.to_rkyv_bytes()
