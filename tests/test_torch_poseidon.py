"""zkvm_tpu_torch.ops.poseidon and the hades_permute kernel's plain version
against zkvm_tpu.ops.poseidon, the Pallas kernel it replaces and the host
permutation.

Inputs are numpy-seeded field values with edge states among them; the same
integers enter both packages and limbs are compared bit for bit after the
layout conversion (exact arithmetic, tolerance zero).
"""

import numpy as np
import pytest
import torch

from zkvm_tpu.hashes import Domain as RDomain
from zkvm_tpu.hashes import Hash as RHash
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import pallas_field
from zkvm_tpu.ops import poseidon as rposeidon
from zkvm_tpu.ops.limb_field import FR as RFR
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.hashes import Domain, Hash, hades_permute
from zkvm_tpu_torch.ops import kernels, poseidon
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.limb_field import FR

torch.set_num_threads(1)

Q = FR.modulus


def _values(n, seed):
    blob = np.random.default_rng(seed).bytes(32 * n)
    return [int.from_bytes(blob[32 * i:32 * i + 32], "little") % Q
            for i in range(n)]


def _states(batch, seed):
    """[5][batch] ints: random lanes, then the all-zero state, every word
    r - 1, and two equal lanes."""
    words = [_values(batch, seed + w) for w in range(5)]
    for w in range(5):
        words[w][0] = 0
        words[w][1] = Q - 1
        words[w][3] = words[w][2]
    return words


def _port_state(words):
    return torch.stack([FR.to_mont_array(w, "cpu") for w in words])


def _ref_state(words):
    return np.stack([np.asarray(RFR.to_mont_array(w)) for w in words])


@pytest.fixture(scope="module")
def permuted():
    words = _states(7, 10)
    return words, poseidon.hades_permute_batch(_port_state(words))


def test_hades_permute_batch_matches_reference(permuted):
    words, got = permuted
    want = rposeidon.hades_permute_batch(_ref_state(words))  # its jnp path
    assert (lf.to_reference(got, FR) == np.asarray(want)).all()


def test_hades_permute_batch_matches_host(permuted):
    words, got = permuted
    outs = [FR.from_mont_array(got[w]) for w in range(5)]
    for lane in range(7):
        assert ([o[lane] for o in outs]
                == hades_permute([w[lane] for w in words]))
    assert torch.equal(got[:, :, 2], got[:, :, 3])


def test_hades_plain_matches_pallas_interpret():
    words = [w[:3] for w in _states(4, 20)]
    want = pallas_field.hades_permute_pallas(_ref_state(words), block=128,
                                             interpret=True)
    state = _port_state(words)
    got = kernels.hades_permute_plain(state, poseidon.hades_consts(
        state.device))
    assert (lf.to_reference(got, FR) == np.asarray(want)).all()


def test_hades_constants_cross_through_the_converter():
    """The port's constant table holds the reference's Montgomery limbs."""
    arc, mds, mask = pallas_field._hades_consts()  # [68, 5, 16], [5, 5, 16]
    ref = np.concatenate([arc.reshape(-1, 16), mds.reshape(-1, 16)])
    got = poseidon.hades_consts(torch.device("cpu"))
    assert got.shape == (kernels.HADES_CONST_ROWS, 8)
    assert (lf.to_reference(got.T.contiguous(), FR) == ref.T).all()
    full = [kernels.hades_full_round(r) for r in range(68)]
    assert full == [bool(mask[r, 0]) for r in range(68)]
    assert mask[:, 4].all()


def test_hades_wrapper_checks_its_operands():
    state = torch.zeros((5, 8, 3), dtype=torch.int32)
    consts = poseidon.hades_consts(state.device)
    with pytest.raises(ValueError):
        kernels.hades_permute(state[:4], consts)
    with pytest.raises(ValueError):
        kernels.hades_permute(state, consts[:-1])
    with pytest.raises(TypeError):
        kernels.hades_permute(state.to(torch.int64), consts)
    with pytest.raises(ValueError):
        kernels.hades_permute(state.to("meta"), consts)
    assert kernels.hades_permute(state[:, :, :0].contiguous(),
                                 consts).shape == (5, 8, 0)


def test_merkle4_digest_batch_matches_host_hash():
    kids = [_values(6, 30 + k) for k in range(4)]
    for k in range(4):
        kids[k][0] = 0
        kids[k][1] = Q - 1
    got = FR.from_mont_array(poseidon.merkle4_digest_batch(
        torch.stack([FR.to_mont_array(k, "cpu") for k in kids])))
    for lane in range(6):
        four = [k[lane] for k in kids]
        want = Hash.digest(Domain.Merkle4, [Fr(v) for v in four])[0].value
        assert got[lane] == want
        assert want == RHash.digest(RDomain.Merkle4,
                                    [RFr(v) for v in four])[0].value


def test_domain_tag_matches_reference():
    for domain, n_in in ((Domain.Merkle4, 4), (Domain.Merkle2, 2),
                         (Domain.Other, 3)):
        got = poseidon._domain_tag_mont(domain.value, n_in, 1)
        want = rposeidon._domain_tag_mont(domain.value, n_in, 1)  # 16 x 16 bit
        assert lf.limbs_to_int(got) == sum(
            int(v) << (16 * i) for i, v in enumerate(np.asarray(want)))


@pytest.mark.parametrize("n", [16, 64])
def test_merkle_tree_levels_match_reference(n):
    leaves = _values(n, 40 + n)
    leaves[0] = 0
    got = poseidon.merkle_tree_levels(FR.to_mont_array(leaves, "cpu"))
    want = rposeidon.merkle_tree_levels(RFR.to_mont_array(leaves))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (lf.to_reference(g, FR) == np.asarray(w)).all()
    assert got[-1].shape == (8, 1)
