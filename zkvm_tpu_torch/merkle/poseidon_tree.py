"""Poseidon-specialized arity-4 Merkle tree (poseidon-merkle crate parity).

Item/Tree/Opening semantics from poseidon-merkle/src/lib.rs:19-181; the
in-circuit opening verification from poseidon-merkle/src/zk.rs:16-102.

`PoseidonTree.from_leaves` builds a dense tree with the batched device
Poseidon (one Hades permutation per node, level-wise over the whole tree:
`ops/poseidon.py` `merkle_tree_levels`, kernel `csrc/hades.cu`).
"""

from __future__ import annotations

from ..fields import Fr
from ..hashes.gadget import HashGadget
from ..hashes.poseidon import Domain, Hash
from ..plonk.composer import Composer
from ..plonk.constraint_system import Constraint, Witness
from .tree import Aggregate, Opening, Tree, UnitAggregate

ARITY = 4


class Item:
    """Leaf/node payload: poseidon hash + auxiliary data
    (poseidon-merkle/src/lib.rs:19-63)."""

    __slots__ = ("hash", "data")

    SIZE = 32  # Serializable<32> for Item<()>

    def __init__(self, hash_: Fr, data=None):
        self.hash = hash_
        self.data = data

    def __eq__(self, other):
        return (isinstance(other, Item) and self.hash == other.hash
                and self.data == other.data)

    def __repr__(self):
        return f"Item({self.hash!r})"

    def to_bytes(self) -> bytes:
        return self.hash.to_bytes()

    @classmethod
    def from_bytes(cls, buf: bytes):
        h = Fr.from_bytes(buf)
        return None if h is None else cls(h, None)


class _ItemAggregate(Aggregate):
    """Aggregate<ARITY> for Item<T> (lib.rs:129-161)."""

    def __init__(self, data_aggregate=UnitAggregate):
        self.data_aggregate = data_aggregate
        self.EMPTY_SUBTREE = Item(Fr.zero(), data_aggregate.EMPTY_SUBTREE)

    def aggregate(self, items):
        hashes = [it.hash for it in items]
        datas = [it.data for it in items]
        return Item(Hash.digest(Domain.Merkle4, hashes)[0],
                    self.data_aggregate.aggregate(datas))


class PoseidonTree(Tree):
    """Tree<Item<T>, H, 4> (lib.rs:14)."""

    def __init__(self, height: int, data_aggregate=UnitAggregate):
        super().__init__(_ItemAggregate(data_aggregate), height, ARITY)

    @classmethod
    def from_archive_bytes(cls, buf: bytes) -> "PoseidonTree":
        """Rebuild a PoseidonTree from a whole-tree archive
        (Tree.to_archive_bytes; node.rs:158-214 capability parity)."""
        height = int.from_bytes(buf[8:12], "little")
        tree = cls(height)
        Tree.from_archive_bytes(buf, tree.item_type, Item.from_bytes,
                                tree=tree)
        return tree

    @classmethod
    def from_leaves(cls, height: int, leaves: list[Fr],
                    device) -> "PoseidonTree":
        """Bulk-build from dense leaf hashes using the batched device Poseidon
        on `device` ("cuda" launches the Hades kernel).

        Equivalent to inserting leaves 0..len-1 one by one, but hashing every
        tree level as one [4, 8, batch] device Poseidon call.
        """
        from ..ops import poseidon as dev
        from ..ops.limb_field import FR

        tree = cls(height)
        n = ARITY ** height
        assert len(leaves) <= n
        padded = [v.value for v in leaves] + [0] * (n - len(leaves))
        levels = dev.merkle_tree_levels(FR.to_mont_array(padded, device))
        host_levels = [[Fr(v) for v in FR.from_mont_array(lvl)]
                       for lvl in levels]
        # install leaves + cached aggregates so openings/roots need no rehash
        for i, leaf in enumerate(leaves):
            tree.insert(i, Item(leaf, None))
        tree._install_cached_hashes(host_levels)
        return tree

    def _install_cached_hashes(self, host_levels: list[list[Fr]]):
        """Prime node caches from the device-computed level hashes.

        Only nodes on fully-populated paths get cached values; sparse empty
        children keep the EMPTY_SUBTREE semantics.  Note: the device build
        hashes a DENSE tree (missing leaves = 0 = EMPTY hash), which matches
        the reference only when empty leaves hash like empty subtrees do NOT
        -- so we only install caches when the leaf count fills the level.
        """
        n_leaves = len(self.positions)
        if n_leaves != ARITY ** self.height:
            return  # sparse: fall back to lazy host hashing

        def fill(node, height, index):
            level = host_levels[self.height - height]
            if height == self.height:
                return
            node.item = Item(level[index], None)
            for c_i, child in enumerate(node.children):
                if child is not None:
                    fill(child, height + 1, index * ARITY + c_i)

        fill(self.root_node, 0, 0)


PoseidonOpening = Opening


def poseidon_opening_from_slice(buf: bytes, height: int) -> Opening:
    """Opening::from_slice for Item<()> payloads (wire format used by the
    batch service)."""
    return Opening.from_slice(buf, _ItemAggregate(), height, ARITY,
                              Item.SIZE, Item.from_bytes)


def opening_gadget(composer: Composer, opening: Opening,
                   leaf: Witness) -> Witness:
    """In-circuit opening verification (poseidon-merkle/src/zk.rs:16-102)."""
    height = opening.height
    level_witnesses = [[Composer.ZERO] * ARITY for _ in range(height)]
    position_bits = [[Composer.ZERO] * ARITY for _ in range(height)]
    for level_index in range(height - 1, -1, -1):
        level = opening.branch[level_index]
        for item_index, item in enumerate(level):
            bit = (Fr.one() if item_index == opening.positions[level_index]
                   else Fr.zero())
            position_bits[level_index][item_index] = (
                composer.append_witness(bit))
            level_witnesses[level_index][item_index] = (
                composer.append_witness(item.hash))
            composer.component_boolean(position_bits[level_index][item_index])
        bits = position_bits[level_index]
        s = composer.gate_add(Constraint().left(1).a(bits[0])
                              .right(1).b(bits[1]).fourth(1).d(bits[2]))
        s = composer.gate_add(Constraint().left(1).a(s).right(1).b(bits[3]))
        composer.assert_equal_constant(s, Fr.one(), None)

    current = leaf
    for level_index in range(height - 1, -1, -1):
        for item_index in range(ARITY):
            bit = position_bits[level_index][item_index]
            level_hash = composer.gate_mul(
                Constraint().mult(1).a(bit)
                .b(level_witnesses[level_index][item_index]))
            current_hash = composer.gate_mul(
                Constraint().mult(1).a(bit).b(current))
            composer.assert_equal(level_hash, current_hash)
        current = HashGadget.digest(composer, Domain.Merkle4,
                                    level_witnesses[level_index])[0]
    return current
