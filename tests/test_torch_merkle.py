"""zkvm_tpu_torch.merkle against zkvm_tpu.merkle: trees, roots, openings
and archive bytes.

The same numpy-seeded leaves enter both packages as ints; roots, openings
and whole trees are compared as bytes (exact equality), and cross between
the packages as bytes: `Tree.to_archive_bytes` ->
`PoseidonTree.from_archive_bytes`, `Opening.to_var_bytes` ->
`poseidon_opening_from_slice`.
"""

import numpy as np
import pytest
import torch

import zkvm_tpu.merkle.poseidon_tree as rtree
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.merkle import Item as RItem
from zkvm_tpu.merkle import PoseidonTree as RPoseidonTree
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.merkle import (ARITY, Item, PoseidonOpening, PoseidonTree,
                                   poseidon_opening_from_slice)

torch.set_num_threads(1)

Q = Fr.MODULUS


def _values(n, seed):
    blob = np.random.default_rng(seed).bytes(32 * n)
    return [int.from_bytes(blob[32 * i:32 * i + 32], "little") % Q
            for i in range(n)]


def _inserted(cls, item, fr, height, values):
    tree = cls(height)
    for i, v in enumerate(values):
        tree.insert(i, item(fr(v), None))
    return tree


@pytest.fixture(scope="module", params=[1, 2, 3])
def dense(request):
    height = request.param
    values = _values(ARITY ** height, height)
    return (height, values,
            PoseidonTree.from_leaves(height, [Fr(v) for v in values], "cpu"),
            RPoseidonTree.from_leaves(height, [RFr(v) for v in values]))


def test_from_leaves_root_matches_reference_and_inserts(dense):
    height, values, port, ref = dense
    assert len(port) == ARITY ** height == port.capacity()
    root = port.root().to_bytes()
    assert root == ref.root().to_bytes()
    assert root == _inserted(PoseidonTree, Item, Fr, height,
                             values).root().to_bytes()


def test_from_leaves_openings_match_reference(dense):
    height, values, port, ref = dense
    n = len(values)
    slow = _inserted(PoseidonTree, Item, Fr, height, values)
    for pos in sorted({0, 1, n // 2, n - 1}):
        opening = port.opening(pos)
        assert isinstance(opening, PoseidonOpening)
        wire = opening.to_var_bytes()
        assert wire == ref.opening(pos).to_var_bytes()
        assert wire == slow.opening(pos).to_var_bytes()
        assert opening.verify(Item(Fr(values[pos])))
        assert not opening.verify(Item(Fr(values[pos]) + Fr.one()))
        assert opening.positions == [pos // ARITY ** (height - 1 - k) % ARITY
                                     for k in range(height)]
    assert port.opening(n) is None


def test_openings_cross_as_bytes(dense):
    height, values, port, ref = dense
    pos = len(values) - 2
    from_ref = poseidon_opening_from_slice(ref.opening(pos).to_var_bytes(),
                                           height)
    assert from_ref.verify(Item(Fr(values[pos])))
    assert from_ref.root == port.root()
    to_ref = rtree.poseidon_opening_from_slice(
        port.opening(pos).to_var_bytes(), height)
    assert to_ref.verify(RItem(RFr(values[pos])))
    with pytest.raises(ValueError):
        poseidon_opening_from_slice(b"\x00" * 7, height)


def test_archive_bytes_cross_both_ways(dense):
    height, values, port, ref = dense
    blob = port.to_archive_bytes()
    assert blob == ref.to_archive_bytes()
    back = PoseidonTree.from_archive_bytes(ref.to_archive_bytes())
    assert back.to_archive_bytes() == blob
    assert back.root() == port.root() and len(back) == len(port)
    assert back.opening(1).to_var_bytes() == port.opening(1).to_var_bytes()
    over = RPoseidonTree.from_archive_bytes(blob)
    assert over.root().to_bytes() == port.root().to_bytes()
    with pytest.raises(ValueError):
        PoseidonTree.from_archive_bytes(b"NOTATREE" + blob[8:])


@pytest.mark.parametrize("height,count", [(2, 5), (3, 17), (2, 0)])
def test_from_leaves_sparse_matches_reference(height, count):
    """Fewer leaves than 4^h: the level hashes of the dense build are not
    installed, and empty subtrees keep their own meaning."""
    values = _values(count, 50 + count)
    port = PoseidonTree.from_leaves(height, [Fr(v) for v in values], "cpu")
    ref = RPoseidonTree.from_leaves(height, [RFr(v) for v in values])
    slow = _inserted(PoseidonTree, Item, Fr, height, values)
    assert len(port) == count
    assert port.root().to_bytes() == ref.root().to_bytes()
    assert port.root() == slow.root()
    assert port.to_archive_bytes() == ref.to_archive_bytes()
    assert port.opening(count) is None
    if count:
        wire = port.opening(count - 1).to_var_bytes()
        assert wire == ref.opening(count - 1).to_var_bytes()
        assert port.opening(count - 1).verify(Item(Fr(values[-1])))
        assert port.smallest_subtree()[1] == ref.smallest_subtree()[1]


def test_tree_insert_remove_walk_match_reference():
    values = _values(6, 60)
    port = _inserted(PoseidonTree, Item, Fr, 3, values)
    ref = _inserted(RPoseidonTree, RItem, RFr, 3, values)
    port.insert(40, Item(Fr(7), None))
    ref.insert(40, RItem(RFr(7), None))
    assert port.remove(2).hash.value == ref.remove(2).hash.value == values[2]
    assert port.remove(2) is None and not port.contains(2)
    assert port.root().to_bytes() == ref.root().to_bytes()
    assert ([it.hash.value for it in port.walk(lambda it: True)]
            == [it.hash.value for it in ref.walk(lambda it: True)])
    with pytest.raises(IndexError):
        port.insert(64, Item(Fr(1), None))
    with pytest.raises(AssertionError):
        PoseidonTree.from_leaves(1, [Fr(1)] * 5, "cpu")


def test_item_bytes():
    item = Item(Fr(123456789))
    assert item.to_bytes() == RItem(RFr(123456789)).to_bytes()
    assert Item.from_bytes(item.to_bytes()) == item
    assert Item.from_bytes(b"\xff" * 32) is None


def test_merkle_module_leaves_the_composer_out():
    """`opening_gadget` waits for the composer; the module must import
    without it."""
    import zkvm_tpu_torch.merkle.poseidon_tree as ptree

    assert not hasattr(ptree, "opening_gadget")
    assert hasattr(rtree, "opening_gadget")
