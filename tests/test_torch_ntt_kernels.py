"""The plain versions of the butterfly stage (of which the ntt_stages kernel
runs many a launch), carry_fold and fold against the Pallas kernels they
replace (interpret mode) and host big ints, and the matmul NTT's tables and
byte-column tensor against the reference's.

Inputs are numpy-seeded; everything is exact integer arithmetic, so the
tolerance is zero: bit for bit after `to_reference`.  Each Pallas kernel is
called once, at the reference test's own small shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_tpu import params
from zkvm_tpu.ops import ntt_mxu as rmxu
from zkvm_tpu.ops import pallas_field
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import ntt_mxu
from zkvm_tpu_torch.ops.limb_field import FR

torch.set_num_threads(1)

Q = params.FR_MODULUS


def _fr_ref(n, seed, edge=()):
    """[16, n] uint32 Montgomery limbs (reference layout) of seeded values,
    the first lanes overwritten by `edge`."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    vals = [sum(int(w) << (63 * k) for k, w in enumerate(row)) % Q
            for row in words]
    vals[:len(edge)] = edge
    return lf.to_reference(FR.to_mont_array(vals, "cpu"), FR)


def _value(limbs32) -> int:
    return lf.limbs_to_int(limbs32)


def test_butterfly_plain_matches_pallas_interpret():
    n = 513  # crosses the 256-lane block boundary
    rinv = pow(1 << 256, -1, Q)
    # edge lanes: zeros, ones, r - 1, a sum >= r and a difference < 0
    even = _fr_ref(n, 1, [0, 1, Q - 1, Q - 1, 0, 5])
    odd = _fr_ref(n, 2, [0, 1, Q - 1, rinv, rinv, 0])
    tw = _fr_ref(n, 3, [7, 1, Q - 1, Q - 1, 9, 3])
    plus, minus = pallas_field.butterfly_pallas(
        jnp.asarray(even), jnp.asarray(odd), jnp.asarray(tw), block=256,
        interpret=True)
    got = kernels.butterfly_plain(*(lf.from_reference(a, FR, "cpu")
                                    for a in (even, odd, tw)))
    assert (lf.to_reference(got[0], FR) == np.asarray(plus)).all()
    assert (lf.to_reference(got[1], FR) == np.asarray(minus)).all()


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_butterfly_shared_twiddles_match_per_lane(lead):
    """One [8, B] twiddle table shared by every leading group gives what
    the per-lane multiply, add and subtract give."""
    n = 37
    rng = np.random.default_rng(4)
    shape = lead + (8, n)
    even, odd = (lf.u32_to_tensor(_rand_limbs(rng, shape), "cpu")
                 for _ in range(2))
    tw = lf.u32_to_tensor(_rand_limbs(rng, (8, n)), "cpu")
    plus, minus = kernels.butterfly_plain(even, odd, tw)
    t = lf.mont_mul(FR, odd, tw.expand(shape))
    assert torch.equal(plus, lf.add(FR, even, t))
    assert torch.equal(minus, lf.sub(FR, even, t))


def _rand_limbs(rng, shape):
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    a[..., -1, :] = rng.integers(0, int(FR.p_limbs[-1]),
                                 size=a[..., -1, :].shape)
    return a


def test_carry_fold_plain_matches_pallas_interpret_and_host():
    """Byte columns of matmul scale (below 2^24, and one lane at the sum of
    32 such, just below 2^29; the top columns small so the final carry
    dies), 513 lanes after flattening."""
    m, b = 3, 171
    rng = np.random.default_rng(5)
    d = np.zeros((68, m, b), dtype=np.int32)
    d[:63] = rng.integers(0, 1 << 24, size=(63, m, b))
    d[:63, 0, 0] = (1 << 24) - 1  # every column at one product's largest
    d[:, 0, 1] = 0
    # the matmul route's largest columns: 32 byte pairs of 256 * 255^2 each
    d[:63, 0, 7] = 32 * 256 * 255 * 255
    want = np.asarray(rmxu._carry_fold_pallas_interpret(jnp.asarray(d)))
    got = kernels.carry_fold(torch.from_numpy(d))
    assert got.shape == (8, m, b) and got.dtype == torch.int32
    assert (lf.to_reference(got.reshape(8, -1), FR)
            == want.reshape(16, -1)).all()
    host = lf.tensor_to_u32(got)
    for i in range(m):
        for j in range(0, b, 7):
            val = sum(int(d[t, i, j]) << (8 * t) for t in range(68))
            assert _value(host[:, i, j]) == val % Q, (i, j)


def test_fold_plain_matches_pallas_interpret_and_host():
    m, b = 8, 128
    rng = np.random.default_rng(6)
    limbs16 = rng.integers(0, 1 << 16, size=(34, m, b)).astype(np.uint32)
    limbs16[33] &= 0x3F  # values below 2^518, as the reference's test
    # lo in [r, 2r), in [2r, 2^256), and exactly r, 2r, 2^256 - 1
    for j, lo in enumerate([Q, Q + 5, 2 * Q - 1, 2 * Q, 2 * Q + 9,
                            (1 << 256) - 1]):
        for k in range(16):
            limbs16[k, 0, j] = (lo >> (16 * k)) & 0xFFFF
    want = np.asarray(rmxu._fold_pallas_interpret(jnp.asarray(limbs16)))
    packed = limbs16[0::2] | (limbs16[1::2] << np.uint32(16))  # [17, m, b]
    got = kernels.fold(lf.u32_to_tensor(packed, "cpu"))
    assert (lf.to_reference(got.reshape(8, -1), FR)
            == want.reshape(16, -1)).all()
    host = lf.tensor_to_u32(got)
    for j in range(0, b, 5):
        val = sum(int(limbs16[k, 0, j]) << (16 * k) for k in range(34))
        assert _value(host[:, 0, j]) == val % Q, j


def test_carry_bytes_then_fold_equals_carry_fold():
    rng = np.random.default_rng(7)
    d = np.zeros((68, 2, 50), dtype=np.int32)
    d[:63] = rng.integers(0, 1 << 24, size=(63, 2, 50))
    t = torch.from_numpy(d)
    words = kernels.carry_bytes(t)
    assert words.shape == (17, 2, 50) and words.dtype == torch.int32
    assert torch.equal(ntt_mxu.leaf_reduce_unfused(t), ntt_mxu.leaf_reduce(t))


def test_split_fold_constants_match_reference():
    assert (kernels.K1 == lf.int_to_limbs(
        rmxu.lf.limbs_to_int(np.asarray(rmxu._K1)), 8)).all()
    assert (kernels.K2 == lf.int_to_limbs(
        rmxu.lf.limbs_to_int(np.asarray(rmxu._K2)), 8)).all()
    assert ntt_mxu._NB == rmxu._NB == 68 and ntt_mxu._P == rmxu._P == 32


@pytest.mark.parametrize("m", [4, 32, 64])
def test_dft_matrix_bytes_match_reference(m):
    root = pow(params.FR_ROOT_OF_UNITY,
               1 << (params.FR_TWO_ADICITY - (m.bit_length() - 1)), Q)
    want = np.asarray(rmxu._dft_matrix_bytes(m, root)).astype(np.int64)
    got = ntt_mxu._dft_matrix_bytes(m, root)
    assert got.dtype == np.uint8 and got.shape == (32 * m, m)
    assert (got.astype(np.int64) == want).all()


@pytest.mark.parametrize("a,b", [(4, 8), (32, 16), (32, 32)])
def test_glue_table_matches_reference(a, b):
    n = a * b
    root = pow(params.FR_ROOT_OF_UNITY,
               1 << (params.FR_TWO_ADICITY - (n.bit_length() - 1)), Q)
    want = np.asarray(rmxu._glue_table(a, b, root))  # [16, a, b]
    got = ntt_mxu._glue_table(a, b, root)            # [8, a, b] uint32
    back = lf.to_reference(lf.u32_to_tensor(got.reshape(8, -1), "cpu"), FR)
    assert (back == want.reshape(16, -1)).all()


@pytest.mark.parametrize("n", [1 << 5, 1 << 9, 1 << 10, 1 << 16, 1 << 19])
def test_factor_matches_reference(n):
    assert ntt_mxu._factor(n) == rmxu._factor(n)


@pytest.mark.parametrize("whole", [True, False],
                         ids=["whole_product", "per_byte_plane"])
def test_byte_columns_match_reference(whole, monkeypatch):
    """The D tensor [68, m, bflat] of one leaf holds the same integers as
    the reference's (its whole-product branch), on both of the port's
    branches."""
    m, bflat = 16, 6
    root = pow(params.FR_ROOT_OF_UNITY,
               1 << (params.FR_TWO_ADICITY - 4), Q)
    x_ref = _fr_ref(bflat * m, 8).reshape(16, bflat, m)
    # the reference's lines, on its own table and byte slicing
    x = jnp.asarray(x_ref)
    table = jnp.asarray(rmxu._dft_matrix_bytes(m, root))
    b8 = jnp.stack([x & 0xFF, x >> 8], axis=1).reshape((32, bflat, m))
    rhs = jnp.moveaxis(b8, -1, 0).reshape(m, 32 * bflat).astype(jnp.bfloat16)
    c = jnp.dot(table, rhs, preferred_element_type=jnp.float32)
    c = np.asarray(c.reshape(32, m, 32, bflat).astype(jnp.int32))
    want = np.zeros((68, m, bflat), dtype=np.int64)
    for mm in range(32):
        want[mm:mm + 32] += c[:, :, mm, :]

    monkeypatch.setattr(ntt_mxu, "C_WHOLE_MAX_BYTES",
                        1 << 31 if whole else 0)
    xp = lf.from_reference_lead(x_ref, FR, "cpu")  # [bflat, 8, m]
    tp = torch.from_numpy(ntt_mxu._dft_matrix_bytes(m, root)).float()
    got = ntt_mxu._byte_columns(xp, tp)
    assert got.dtype == torch.int32
    assert (got.numpy().astype(np.int64) == want).all()


def test_matmul_is_exact_at_the_worst_case():
    """m = 256, every byte 255: each sum is 256 * 255^2 < 2^24 and float32
    holds it exactly (a bfloat16 result would not)."""
    m = 256
    table = torch.full((64, m), 255.0)
    rhs = torch.full((m, 8), 255.0)
    got = torch.matmul(table, rhs)
    assert got.dtype == torch.float32
    assert (got.to(torch.int64) == 256 * 255 * 255).all()
    rounded = torch.matmul(table.bfloat16(), rhs.bfloat16())
    assert rounded.dtype == torch.bfloat16
    assert (rounded.to(torch.int64) != 256 * 255 * 255).all()


def test_reference_converters_round_trip_with_leading_axes():
    ref = _fr_ref(2 * 3 * 5, 9).reshape(16, 2, 3, 5)
    t = lf.from_reference_lead(ref, FR, "cpu")
    assert t.shape == (2, 3, 8, 5) and t.dtype == torch.int32
    assert (lf.to_reference_lead(t, FR) == ref).all()
    flat = lf.from_reference_lead(ref[:, 0, 0], FR, "cpu")
    assert torch.equal(flat, t[0, 0])


def test_new_wrappers_refuse_wrong_operands():
    good = torch.zeros((68, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.carry_fold(torch.zeros((67, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.carry_fold(good.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.carry_fold(torch.zeros((68, 8), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError):
        kernels.carry_fold(good.to("meta"))
    with pytest.raises(ValueError):
        kernels.fold(torch.zeros((16, 4), dtype=torch.int32))
    limbs = torch.zeros((8, 4), dtype=torch.int32)
    table = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="twiddle table"):
        kernels.ntt_stages(limbs, torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.ntt_stages(limbs.to("meta"), table.to("meta"))
    with pytest.raises(ValueError, match="power of two"):
        kernels.ntt_stages(torch.zeros((8, 6), dtype=torch.int32), table)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ntt_stages(torch.zeros((8, 8), dtype=torch.int32)[:, ::2],
                           table)
    with pytest.raises(TypeError):
        kernels.ntt_stages(limbs.to(torch.int64), table)
    assert kernels.carry_fold(good[:, :0].contiguous()).shape == (8, 0)
