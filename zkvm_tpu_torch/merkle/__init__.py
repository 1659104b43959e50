"""Merkle tree layers (coset-merkle + poseidon-merkle equivalents)."""

from .tree import Aggregate, Opening, Tree, UnitAggregate
from .poseidon_tree import (ARITY, Item, PoseidonOpening, PoseidonTree,
                            opening_gadget, poseidon_opening_from_slice)

__all__ = ["Aggregate", "ARITY", "Item", "Opening", "PoseidonOpening",
           "PoseidonTree", "Tree", "UnitAggregate", "opening_gadget",
           "poseidon_opening_from_slice"]
