"""The circuits of the batch Merkle-membership proving service
(merkle-plonk/src/lib.rs parity).

The port's counterpart of `zkvm_tpu/service/batch.py` holds, so far, only
its two circuits: `OpeningCircuit` (one membership) and
`MultiOpeningCircuit` (K of them in one circuit, the 2^16-gate flagship
shape).  The batch service around them is not ported yet.
"""

from __future__ import annotations

from ..fields import Fr
from ..merkle import Item
from ..merkle.poseidon_tree import PoseidonTree, opening_gadget
from ..plonk.composer import Circuit, Composer
from ..plonk.constraint_system import Constraint


class OpeningCircuit(Circuit):
    """Merkle membership circuit (merkle-plonk/src/lib.rs:89-131)."""

    def __init__(self, opening, leaf: Item):
        self.opening = opening
        self.leaf = leaf

    @classmethod
    def default_for_height(cls, height: int) -> "OpeningCircuit":
        empty = Item(Fr.zero(), None)
        tree = PoseidonTree(height)
        tree.insert(0, empty)
        return cls(tree.opening(0), empty)

    def circuit(self, composer: Composer) -> None:
        leaf = composer.append_witness(self.leaf.hash)
        computed_root = opening_gadget(composer, self.opening, leaf)
        composer.append_gate(
            Constraint().left(-Fr.one()).a(computed_root)
            .public(self.opening.root.hash))


class MultiOpeningCircuit(Circuit):
    """K independent Merkle-membership checks in ONE circuit -- the
    BASELINE flagship shape (a 2^16-gate domain at K ~ 21, height 3).
    Each opening contributes its own public root input, so one proof
    attests K memberships (the batched-service analogue of proving
    merkle-plonk's OpeningCircuit K times)."""

    def __init__(self, openings_and_leaves):
        self.parts = list(openings_and_leaves)

    @classmethod
    def default_for(cls, height: int, count: int) -> "MultiOpeningCircuit":
        empty = Item(Fr.zero(), None)
        tree = PoseidonTree(height)
        tree.insert(0, empty)
        return cls([(tree.opening(0), empty)] * count)

    def circuit(self, composer: Composer) -> None:
        for opening, leaf in self.parts:
            leaf_w = composer.append_witness(leaf.hash)
            computed_root = opening_gadget(composer, opening, leaf_w)
            composer.append_gate(
                Constraint().left(-Fr.one()).a(computed_root)
                .public(opening.root.hash))
