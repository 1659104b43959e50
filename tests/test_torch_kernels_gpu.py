"""The CUDA kernels on the card against their plain versions, bit for bit.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip elsewhere.  Run
them on the card with
`python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py`
(this file needs no jax: of zkvm_tpu it takes only the host MSM, which
imports none, as the oracle of the commitment).
"""

import numpy as np
import pytest
import torch

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.curves.msm import msm_variable_base as ref_msm_variable_base
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.plonk import kzg10
from zkvm_tpu_torch.rng import StdRng

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    kernels.build()
    return torch.device("cuda")


def _field(spec, shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    a[..., -1, :] = rng.integers(0, int(spec.p_limbs[-1]),
                                 size=a[..., -1, :].shape)
    return lf.u32_to_tensor(a, "cpu")


@pytest.mark.parametrize("spec", [lf.FR, lf.FQ], ids=["Fr", "Fq"])
def test_mont_mul_kernel_matches_plain(cuda, spec):
    a = _field(spec, (3, spec.n_limbs, 1027), 1)
    b = _field(spec, (3, spec.n_limbs, 1027), 2)
    got = kernels.mont_mul(spec, a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), kernels.mont_mul_plain(spec, a, b))


def test_padd_kernel_matches_plain(cuda):
    p = tuple(_field(lf.FQ, (2, 12, 515), s) for s in (3, 4, 5))
    q = tuple(_field(lf.FQ, (2, 12, 515), s) for s in (6, 7, 8))
    got = kernels.padd(tuple(t.to(cuda) for t in p),
                       tuple(t.to(cuda) for t in q))
    for g, w in zip(got, kernels.padd_plain(p, q)):
        assert torch.equal(g.cpu(), w)


_VIEWS = {
    "even_odd": lambda t: (t[..., 0::2], t[..., 1::2]),
    "halves": lambda t: (t[..., :257], t[..., 257:514]),
    "scan_fix": lambda t: (t[..., :256], t[..., 2:514:2]),
    "limbs_innermost": lambda t: (
        t.transpose(1, 2).contiguous().transpose(1, 2)[..., 0:514:2],
        t[..., 1::2]),
    "one_lane": lambda t: (t[..., 3:4], t[..., 100:101]),
    "no_group_axis": lambda t: (t[1, :, 0::2], t[0, :, 1::2]),
}


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_padd_kernel_reads_strided_operands(cuda, view):
    """Views of one ragged [3, 12, 515] batch, read in place on the card."""
    from zkvm_tpu_torch.ops import g1_ops

    wide = tuple(_field(lf.FQ, (3, 12, 515), s) for s in (19, 20, 21))
    on_card = tuple(t.to(cuda) for t in wide)
    p, q = zip(*(_VIEWS[view](t) for t in on_card))
    lanes = min(p[0].shape[-1], q[0].shape[-1])
    p = tuple(t[..., :lanes] for t in p)
    q = tuple(t[..., :lanes] for t in q)
    assert kernels.padd_layout(p) and kernels.padd_layout(q)
    before = kernels.LAUNCHES["padd"]
    got = g1_ops.padd(p, q)
    assert kernels.LAUNCHES["padd"] == before + 1
    want = kernels.padd_plain(tuple(t.cpu() for t in p),
                              tuple(t.cpu() for t in q))
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g.cpu(), w)


def test_padd_kernel_on_special_points(cuda):
    """O + Q, P + O, O + O, P + P, P + (-P) among ordinary sums, 130 lanes,
    against the plain version and the host's group law."""
    from zkvm_tpu_torch.curves.g1 import G1Affine, G1Projective
    from zkvm_tpu_torch.ops import g1_ops

    g = G1Projective.generator()
    pts = G1Projective.batch_normalize([g * (7 * i + 3) for i in range(260)])
    lhs, rhs = pts[:130], pts[130:]
    lhs[0] = G1Affine.identity()
    rhs[1] = G1Affine.identity()
    lhs[2] = rhs[2] = G1Affine.identity()
    rhs[3] = lhs[3]
    rhs[4] = -lhs[4]
    p = g1_ops.affine_to_device(lhs, "cpu")
    q = g1_ops.affine_to_device(rhs, "cpu")
    got = kernels.padd(tuple(t.to(cuda) for t in p),
                       tuple(t.to(cuda) for t in q))
    for g_, w in zip(got, kernels.padd_plain(p, q)):
        assert torch.equal(g_.cpu(), w)
    for i in (0, 1, 2, 3, 4, 5, 129):
        assert (g1_ops.device_to_projective(got, i)
                == lhs[i].to_projective() + rhs[i].to_projective())
    # a doubling by aliased operands
    pd = tuple(t.to(cuda) for t in p)
    for g_, w in zip(kernels.padd(pd, pd), kernels.padd_plain(p, p)):
        assert torch.equal(g_.cpu(), w)


def test_padd_wrapper_raises_on_card(cuda):
    x, y, z = (_field(lf.FQ, (2, 12, 64), s).to(cuda) for s in (22, 23, 24))
    other = y.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="share one layout"):
        kernels.padd((x, other, z), (x, y, z))
    with pytest.raises(ValueError):
        kernels.padd((x, y, z), (x.cpu(), y.cpu(), z.cpu()))


def test_padd_ilp_kernel_matches_plain_and_padd(cuda):
    """Ragged lanes (an odd count leaves half a thread pair past the end)
    and a doubling batch."""
    p = tuple(_field(lf.FQ, (2, 12, 515), s) for s in (3, 4, 5))
    q = tuple(_field(lf.FQ, (2, 12, 515), s) for s in (6, 7, 8))
    pd, qd = tuple(t.to(cuda) for t in p), tuple(t.to(cuda) for t in q)
    for a, b, want in ((pd, qd, kernels.padd_ilp_plain(p, q)),
                       (pd, pd, kernels.padd_ilp_plain(p, p))):
        got = kernels.padd_ilp(a, b)
        for g, s, w in zip(got, kernels.padd(a, b), want):
            assert torch.equal(g.cpu(), w)
            assert torch.equal(g, s)


@pytest.mark.parametrize("lanes", [1, 515])
def test_hades_permute_kernel_matches_plain(cuda, lanes):
    from zkvm_tpu_torch.ops import poseidon

    state = _field(lf.FR, (5, 8, lanes), 18)
    state[:, :, 0] = 0
    got = poseidon.hades_permute_batch(state.to(cuda))
    assert torch.equal(got.cpu(), poseidon.hades_permute_batch(state))


@pytest.mark.parametrize("size", ["1", "5", "6", "7", "31", "259", "cut-1",
                                  "cut", "cut+1", "2^14", "2^15"])
def test_hades_permute_both_kernels_match_plain_and_host(cuda, size):
    """Sizes on both sides of the dispatch constant, so that the
    five-thread and the one-thread kernel are both held against the plain
    version (on the card: the CPU's takes minutes at these sizes) and the
    host permutation; ragged warps of the five-thread kernel (6 permutations
    a warp) among them."""
    from zkvm_tpu_torch.hashes import hades_permute
    from zkvm_tpu_torch.ops import poseidon

    cut = kernels.hades_coop_max_lanes()
    lanes = {"cut-1": cut - 1, "cut": cut, "cut+1": cut + 1, "2^14": 1 << 14,
             "2^15": 1 << 15}.get(size) or int(size)
    state = _field(lf.FR, (5, 8, lanes), 29)
    state[:, :, 0] = 0
    state[:, :, -1] = torch.from_numpy(
        lf.int_to_limbs(lf.FR.modulus - 1, 8).view(np.int32))
    consts = poseidon.hades_consts(cuda)
    on_card = state.to(cuda)
    before = kernels.LAUNCHES["hades_permute"]
    got = kernels.hades_permute(on_card, consts)
    assert kernels.LAUNCHES["hades_permute"] == before + 1
    assert torch.equal(got, kernels.hades_permute_plain(on_card, consts))
    for j in {0, lanes // 2, lanes - 1}:
        ins = [lf.FR.from_mont_array(state[w, :, j:j + 1])[0]
               for w in range(5)]
        outs = [lf.FR.from_mont_array(got[w, :, j:j + 1].contiguous())[0]
                for w in range(5)]
        assert outs == hades_permute(ins)


_OPERANDS = {
    "constant_column": lambda b: b[0, :, :1],
    "shared_table": lambda b: b[1, :, :1027],
    "lane_broadcast": lambda b: b[:, :, 7:8],
    "every_second_lane": lambda b: b[:, :, 1::2],
    "limbs_innermost": lambda b: b[:, :, :1027].transpose(1, 2).contiguous()
    .transpose(1, 2),
    "expanded_view": lambda b: b[2, :, :1027].expand(3, -1, -1),
}


@pytest.mark.parametrize("spec", [lf.FR, lf.FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("kind", sorted(_OPERANDS))
def test_mont_mul_kernel_reads_broadcast_and_strided_operands(cuda, spec,
                                                              kind):
    a = _field(spec, (3, spec.n_limbs, 1027), 30)
    b = _field(spec, (3, spec.n_limbs, 2054), 31)
    view = _OPERANDS[kind](b.to(cuda))
    on_card = a.to(cuda)
    want = kernels.mont_mul_plain(spec, a, _OPERANDS[kind](b))
    for x, y in ((on_card, view), (view, on_card)):
        before = kernels.LAUNCHES["mont_mul"]
        got = lf.mont_mul(spec, x, y)
        assert kernels.LAUNCHES["mont_mul"] == before + 1
        assert got.is_contiguous() and torch.equal(got.cpu(), want)


def test_mont_mul_wrapper_raises_on_card(cuda):
    a = _field(lf.FR, (4, 3, 8, 64), 32).to(cuda)
    with pytest.raises(ValueError, match="cannot be read in place"):
        kernels.mont_mul(lf.FR, a, a[:, :1])
    with pytest.raises(ValueError):
        kernels.mont_mul(lf.FR, a, a.cpu())
    assert torch.equal(lf.mont_mul(lf.FR, a, a[:, :1]),
                       lf.mont_mul(lf.FR, a, a[:, :1].expand(a.shape)
                                   .contiguous()))


@pytest.mark.parametrize("spec", [lf.FR, lf.FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("e", ["0", "1", "2", "5", "0b1100101", "p-2"])
def test_mont_pow_kernel_matches_plain(cuda, spec, e):
    """One launch for the whole chain; zero lanes stay zero (one for e = 0),
    a ragged batch with a leading group axis."""
    e = spec.modulus - 2 if e == "p-2" else int(e, 0)
    a = _field(spec, (2, spec.n_limbs, 515), 33)
    a[:, :, 0] = 0
    a[0, :, 1] = torch.from_numpy(
        lf.int_to_limbs(spec.modulus - 1, spec.n_limbs).view(np.int32))
    before = dict(kernels.LAUNCHES)
    got = lf.mont_pow(spec, a.to(cuda), e)
    assert kernels.LAUNCHES["mont_pow"] == before["mont_pow"] + 1
    assert kernels.LAUNCHES["mont_mul"] == before["mont_mul"]
    assert torch.equal(got.cpu(), kernels.mont_pow_plain(spec, a, e))


def test_from_leaves_on_card_matches_cpu(cuda):
    from zkvm_tpu_torch.merkle import Item, PoseidonTree

    leaves = [Fr(11 * i + 5) for i in range(64)]
    tree = PoseidonTree.from_leaves(3, leaves, cuda)
    want = PoseidonTree.from_leaves(3, leaves, "cpu")
    assert tree.to_archive_bytes() == want.to_archive_bytes()
    assert tree.opening(37).verify(Item(leaves[37]))


def test_window_fold_kernel_matches_plain(cuda):
    sums = tuple(_field(lf.FQ, (12, 12), s).T.reshape(12, 12, 1)
                 .contiguous() for s in (9, 10, 11))
    got = kernels.window_fold(3, 4, 3, *(t.to(cuda) for t in sums))
    assert torch.equal(got.cpu(), kernels.window_fold_plain(3, 4, 3, *sums))


@pytest.mark.parametrize("n_sets", [1, 3, 4, 40])
@pytest.mark.parametrize("c,w_count", [(3, 4), (11, 24)])
def test_window_fold_kernel_sets_and_widths(cuda, n_sets, c, w_count):
    """One block a set: one set, a few, and more than any one block held;
    the 2^16 commitment's (c, W) and a small one; identity rows among
    them."""
    rows = n_sets * w_count
    sums = [_field(lf.FQ, (12, rows), s).T.reshape(rows, 12, 1).contiguous()
            for s in (25, 26, 27)]
    sums[0][0] = 0  # row 0 of set 0: (0 : y : 0), an identity
    sums[2][0] = 0
    got = kernels.window_fold(c, w_count, n_sets, *(t.to(cuda) for t in sums))
    want = kernels.window_fold_plain(c, w_count, n_sets, *sums)
    assert torch.equal(got.cpu(), want)


def test_product_chain_probe_matches_plain(cuda):
    a = _field(lf.FQ, (12, 32), 28)
    want = kernels.fq_mul_chain_plain(a, 40)
    for lazy in (False, True):
        assert torch.equal(kernels.fq_mul_chain(a.to(cuda), 40, lazy).cpu(),
                           want)


def test_setup_and_commit_on_card(cuda):
    pp = kzg10.PublicParameters.setup(40, StdRng(5), cuda)
    ref = kzg10.PublicParameters.setup(40, StdRng(5), "cpu")
    assert pp.to_raw_var_bytes() == ref.to_raw_var_bytes()
    coeffs = [Fr(3 * i + 1) for i in range(41)]
    got = pp.commit_key.commit(coeffs)
    want = ref_msm_variable_base(
        [RG1Affine(RFp(p.x.value), RFp(p.y.value))
         for p in pp.commit_key.powers_of_g[:41]],
        [RFr(c.value) for c in coeffs])
    assert got.point.to_bytes() == want.to_affine().to_bytes()


@pytest.mark.parametrize("log_n,lead", [(1, ()), (9, (3,)), (10, (2, 2)),
                                       (13, (3,)), (16, (1,))])
def test_butterfly_kernel_matches_plain(cuda, log_n, lead):
    """The staged transform (`ntt_stages`: one pass at 2^9 and 2^10, two at
    2^13, three at 2^16), both directions, against its plain version."""
    from zkvm_tpu_torch.ops import ntt

    x = _field(lf.FR, lead + (8, 1 << log_n), 12)
    for tw in ntt.Domain(1 << log_n)._butterfly_tables(torch.device("cpu")):
        got = kernels.ntt_stages(x.to(cuda), tw.to(cuda))
        assert torch.equal(got.cpu(), kernels.ntt_stages_plain(x, tw))


def _above_r(rng, n):
    p = lf.FR.modulus
    return [p + int.from_bytes(rng.bytes(40), "little") % ((1 << 256) - p)
            for _ in range(n)]


def _fr_tensor(values):
    return lf.u32_to_tensor(np.stack([lf.int_to_limbs(v, 8) for v in values],
                                     axis=-1), "cpu")


@pytest.mark.parametrize("log_n", [4, 9, 16, 19])
def test_butterfly_kernel_outside_its_contract(cuda, log_n):
    """On 256-bit words in [r, 2^256), which its contract now takes (the
    name is older), the kernel equals its plain version word for word,
    forward and inverse; and on (0, 0, r + 1, 0), (r, 0, 0, 0) and (0, r +
    1), as `tests/test_torch_ntt_design.py`'s schedule on the chains."""
    from zkvm_tpu_torch.ops import ntt

    p = lf.FR.modulus
    cpu = torch.device("cpu")
    x = _fr_tensor(_above_r(np.random.default_rng(20 + log_n), 1 << log_n))
    for tw in ntt.Domain(1 << log_n)._butterfly_tables(cpu):
        got = kernels.ntt_stages(x[None].to(cuda), tw.to(cuda))
        assert torch.equal(got.cpu(), kernels.ntt_stages_plain(x[None], tw))
    if log_n == 4:
        for row, want in (([0, 0, p + 1, 0], [1, p - 1, 1, p - 1]),
                          ([p, 0, 0, 0], [0, 0, 0, p]),
                          ([0, p + 1], [1, p - 1])):
            x = _fr_tensor(row)[None]
            tw = ntt.Domain(len(row))._butterfly_tables(cpu)[0]
            got = lf.tensor_to_u32(kernels.ntt_stages(x.to(cuda),
                                                      tw.to(cuda)))
            assert [lf.limbs_to_int(got[0, :, i])
                    for i in range(len(row))] == want
            assert torch.equal(kernels.ntt_stages(x.to(cuda),
                                                  tw.to(cuda)).cpu(),
                               kernels.ntt_stages_plain(x, tw))


def _quotient_operands(lanes, seed):
    """The 28 canonical operands at `lanes` (lanes 0, 1, 2 at 0, 1, r - 1)
    and a challenge table, on the CPU."""
    from zkvm_tpu_torch.ops import quotient_kernel as qk

    rng = np.random.default_rng(seed)
    ops = [_field(lf.FR, (8, lanes), int(rng.integers(1 << 30)))
           for _ in kernels.QUOTIENT_OPERANDS]
    edge = _fr_tensor([0, lf.FR.R, lf.FR.modulus - 1])  # 0, 1, r - 1
    for t in ops:
        t[:, :3] = edge[:, :lanes]
    chals = {n: int.from_bytes(rng.bytes(40), "little") % lf.FR.modulus
             for n in qk.CHALLENGES}
    return ops, qk.challenge_table(chals, "cpu")


@pytest.mark.parametrize("log_lanes", [8, 18, 19])
def test_quotient_kernel_matches_plain(cuda, log_lanes):
    """At the service's 8n (2^18) and the flagship's (2^19): the kernel
    against its plain version on the card, bit for bit."""
    ops, table = _quotient_operands(1 << log_lanes, 30 + log_lanes)
    ops = [t.to(cuda) for t in ops]
    before = kernels.LAUNCHES["quotient"]
    got = kernels.quotient(ops, table.to(cuda))
    assert kernels.LAUNCHES["quotient"] == before + 1
    assert torch.equal(got, kernels.quotient_plain(ops, table.to(cuda)))
    if log_lanes == 8:
        cpu = kernels.quotient_plain([t.cpu() for t in ops], table)
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("lanes", [1, 3, (1 << 10) + 37, (1 << 17) + 37])
def test_quotient_kernel_ragged_lanes(cuda, lanes):
    """Lane counts that leave the last block part empty, odd counts and a
    single lane: a thread pair past the last lane stores nothing, and every
    lane before it equals the plain version's."""
    ops, table = _quotient_operands(lanes, 60 + lanes % 97)
    ops = [t.to(cuda) for t in ops]
    got = kernels.quotient(ops, table.to(cuda))
    assert got.shape == (8, lanes) and got.is_contiguous()
    assert torch.equal(got, kernels.quotient_plain(ops, table.to(cuda)))
    if lanes < 1 << 17:
        cpu = kernels.quotient_plain([t.cpu() for t in ops], table)
        assert torch.equal(got.cpu(), cpu)


def test_quotient_kernel_reads_a_shards_slice(cuda):
    """A mesh shard's part of the flagship's [8, 2^19] operands (one of
    four: 2^17 lanes whose limb rows are 2^19 apart), read in place."""
    ops, table = _quotient_operands(1 << 19, 50)
    ops = [t.to(cuda) for t in ops]
    table = table.to(cuda)
    whole = kernels.quotient(ops, table)
    for shard in range(4):
        part = [t[:, shard << 17:(shard + 1) << 17] for t in ops]
        assert part[0].stride() == (1 << 19, 1)
        got = kernels.quotient(part, table)
        assert torch.equal(got, whole[:, shard << 17:(shard + 1) << 17])
        assert torch.equal(got, kernels.quotient_plain(part, table))


def _columns(seed, lanes):
    rng = np.random.default_rng(seed)
    d = np.zeros((68, lanes), dtype=np.int32)
    d[:63] = rng.integers(0, 1 << 24, size=(63, lanes))
    d[:63, 0] = (1 << 24) - 1
    # the matmul route's largest columns: 32 byte pairs of 256 * 255^2 each
    d[:63, 1] = 32 * 256 * 255 * 255
    return torch.from_numpy(d)


def test_carry_fold_kernel_matches_plain(cuda):
    d = _columns(15, 1027)
    got = kernels.carry_fold(d.to(cuda))
    assert torch.equal(got.cpu(), kernels.carry_fold_plain(d))


@pytest.mark.parametrize("lanes", [1027, 65536, 1 << 21])
def test_fold_kernel_matches_plain(cuda, lanes):
    rng = np.random.default_rng(16)
    w = rng.integers(0, 1 << 32, size=(17, lanes), dtype=np.uint64).astype(
        np.uint32)
    w[:, 0] = 0xFFFFFFFF
    w[:, 1] = 0
    w[:8, 2] = lf.int_to_limbs(lf.FR.modulus - 1, 8)  # lo = r - 1
    limbs = lf.u32_to_tensor(w, "cpu")
    got = kernels.fold(limbs.to(cuda))
    assert torch.equal(got.cpu(), kernels.fold_plain(limbs))


def test_transform_routes_agree_on_card(cuda):
    from zkvm_tpu_torch.ops import ntt, ntt_mxu

    n = 1 << 10
    dom = ntt.Domain(n)
    x = _field(lf.FR, (2, 8, n), 17)
    want = dom.fft_device(x)  # CPU: the plain versions
    got = dom.fft_device(x.to(cuda))  # the staged route: ntt_stages
    assert torch.equal(got.cpu(), want)
    t = ntt_mxu.MXUTransform(n, dom.group_gen)  # the matmul route
    assert torch.equal(t(x.to(cuda)).cpu(), want)
    assert torch.equal(ntt_mxu.transform_unfused(t, x.to(cuda)).cpu(), want)
    assert torch.equal(dom.ifft_device(got).cpu(), x)


_ADDSUB_VIEWS = {
    "contiguous": lambda b: b[:, :, :1027].contiguous(),
    "constant_column": lambda b: b[0, :, :1],
    "shared_table": lambda b: b[1, :, :1027],
    "lane_broadcast": lambda b: b[:, :, 7:8],
    "every_second_lane": lambda b: b[:, :, 1::2],
    "limbs_innermost": lambda b: b[:, :, :1027].transpose(1, 2).contiguous()
    .transpose(1, 2),
}


@pytest.mark.parametrize("spec", [lf.FR, lf.FQ], ids=["Fr", "Fq"])
@pytest.mark.parametrize("op", ["add", "sub", "neg"])
@pytest.mark.parametrize("kind", sorted(_ADDSUB_VIEWS))
@pytest.mark.parametrize("masked", [False, True])
def test_field_addsub_kernel_matches_plain(cuda, spec, op, kind, masked):
    """One launch, bit for bit against the plain version, for every layout
    the kernel reads in place, at the edge values 0, 1, p - 1, R mod p."""
    a = _field(spec, (3, spec.n_limbs, 1027), 40)
    b = _field(spec, (3, spec.n_limbs, 2054), 41)
    edges = [0, 1, spec.modulus - 1, spec.R]
    for j, v in enumerate(edges):
        col = torch.from_numpy(lf.int_to_limbs(v, spec.n_limbs)
                               .view(np.int32))
        a[0, :, j] = col
        b[0, :, len(edges) - 1 - j] = col
    mask = (torch.from_numpy(np.random.default_rng(42).integers(
        0, 2, (3, 1027)) == 1) if masked else None)
    view = _ADDSUB_VIEWS[kind]
    x = view(b) if op != "neg" else None
    want = kernels.field_addsub_plain(spec, op, a, x, mask)
    before = kernels.LAUNCHES["field_addsub"]
    got = kernels.field_addsub(
        spec, op, a.to(cuda), None if x is None else view(b.to(cuda)),
        None if mask is None else mask.to(cuda))
    assert kernels.LAUNCHES["field_addsub"] == before + 1
    assert got.is_contiguous() and torch.equal(got.cpu(), want)


def test_lf_add_sub_neg_launch_the_kernel_on_card(cuda):
    a = _field(lf.FR, (8, 515), 43).to(cuda)
    b = _field(lf.FR, (8, 515), 44).to(cuda)
    before = dict(kernels.LAUNCHES)
    lf.add(lf.FR, a, b), lf.sub(lf.FR, a, b), lf.neg(lf.FR, a)
    assert kernels.LAUNCHES["field_addsub"] == before["field_addsub"] + 3
    with pytest.raises(ValueError):
        kernels.field_addsub(lf.FR, "add", a, b.cpu())


def test_gate1_prove_on_card_equals_cpu(cuda):
    """The fixture prover proves the fixture circuit on the card to the CPU
    proof's bytes (which tests/test_torch_prover.py holds against zkvm_tpu)."""
    from pathlib import Path

    from zkvm_tpu_torch.plonk import Constraint, Prover
    from zkvm_tpu_torch.plonk.composer import Circuit

    class FixedCircuit(Circuit):
        def circuit(self, c):
            a = c.append_witness(Fr(3))
            b = c.append_witness(Fr(5))
            o = c.gate_add(Constraint().left(1).right(1).a(a).b(b))
            c.assert_equal_constant(o, Fr(8), None)
            x = c.gate_mul(Constraint().mult(1).a(a).b(b))
            c.assert_equal_constant(x, Fr(15), None)
            c.component_boolean(c.append_witness(Fr(1)))

    pb = (Path(__file__).parent / "fixtures" /
          "prover_bundle_v1.bin").read_bytes()
    on_card, _ = Prover.try_from_bytes(pb, cuda).prove(StdRng(5),
                                                       FixedCircuit())
    on_cpu, _ = Prover.try_from_bytes(pb, "cpu").prove(StdRng(5),
                                                       FixedCircuit())
    assert on_card.to_bytes() == on_cpu.to_bytes()


# the shapes of the two benchmark cells' commits: (c, N) of a proof's
# commits (n_pad 33,792) and of a 2^16 commit (66,560); a few digit rows
@pytest.mark.parametrize("c,n", [(10, 33792), (11, 66560)])
def test_msm_gather_kernel_matches_plain(cuda, c, n):
    """Merge mode, the rejects' gather at twice their lanes and the scan
    path's gather, against the composition they replace, bit for bit: rows
    of random buckets with dead lanes, one bucket, every pair split, all
    dead, a padded tail; points at z = 1, as every live row of the point
    matrix is, and at infinity."""
    from test_torch_msm_gather import field_rows, sorted_rows
    from zkvm_tpu_torch.ops import msm

    half = 1 << (c - 1)
    pm = field_rows(n, c)
    sid, neg, perm = (t.to(cuda) for t in sorted_rows(n, half, pm, c))
    pm = pm.to(cuda)
    before = kernels.LAUNCHES["msm_gather"]
    pts, rsid = kernels.msm_gather(pm, sid, neg, perm, half, pairs=True)
    assert kernels.LAUNCHES["msm_gather"] == before + 1
    want, want_rsid = kernels.msm_gather_plain(pm, sid, neg, perm, half,
                                               pairs=True)
    assert torch.equal(rsid, want_rsid)
    for g, w in zip(pts, want):
        assert g.is_contiguous() and torch.equal(g, w)
    rs, rp = msm._compact_rejects(rsid, half)
    for key, src in ((rs, rp * 2), (sid, None)):
        got = kernels.msm_gather(pm, key, neg, perm, half, src=src)
        want = kernels.msm_gather_plain(pm, key, neg, perm, half, src=src)
        for g, w in zip(got, want):
            assert g.is_contiguous() and torch.equal(g, w)


def _tree_points(n: int, seed: int):
    """n affine points A + i S, one at infinity (lane 7) and one repeated
    (lane 9 = lane 8), and n random scalars, lanes 8-10 a doubling in a
    bucket and a zero."""
    from zkvm_tpu_torch.curves.g1 import G1Affine, G1Projective

    rng = np.random.default_rng(seed)
    g = G1Projective.generator()
    a = g * int(rng.integers(1, 1 << 62))
    step = g * int(rng.integers(1, 1 << 62))
    pts = []
    for _ in range(n):
        pts.append(a)
        a = a + step
    points = G1Projective.batch_normalize(pts)
    points[7] = G1Affine.identity()
    points[9] = points[8]
    words = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64).tolist()
    scalars = [Fr(sum(int(w) << (63 * k) for k, w in enumerate(row)))
               for row in words]
    scalars[8], scalars[9], scalars[10] = scalars[9], scalars[9], Fr.zero()
    return points, scalars


def _assert_host_msm(points, sets, got):
    ref_points = [RG1Affine.identity() if p.infinity
                  else RG1Affine(RFp(p.x.value), RFp(p.y.value))
                  for p in points]
    for point, s in zip(got, sets):
        want = ref_msm_variable_base(ref_points[:len(s)],
                                     [RFr(x.value) for x in s])
        assert point.to_affine().to_bytes() == want.to_affine().to_bytes()


def test_halving_tree_commit_on_card_matches_host(cuda):
    """Two sets over 2^14 points (the halving tree, five levels; the second
    set's padding lanes dead), a point at infinity, a doubling in a bucket
    and zero scalars, against the host MSM."""
    from zkvm_tpu_torch.ops import msm

    n = msm.PTREE_MIN_POINTS
    points, scalars = _tree_points(n, 31)
    sets = [scalars, scalars[:5000]]
    before = kernels.LAUNCHES["msm_gather"]
    got = msm.MSMContext(points, cuda).msm_many(sets)
    assert kernels.LAUNCHES["msm_gather"] == before + 2
    _assert_host_msm(points, sets, got)


# a proof's commits at 2^15 and 2^17 and a 2^16 commit (four sets each), and
# a shape past the packed key (c = 13, N > 2^17: the stable-sort key)
@pytest.mark.parametrize("c,sets,n", [(10, 4, 33792), (11, 4, 66560),
                                      (11, 4, 132096), (13, 2, 140288)])
def test_msm_digits_kernel_matches_plain(cuda, c, sets, n):
    """Pack mode's keys and, where the key is packed, unpack mode's (sid,
    neg, perm) on the sorted keys, against the composition they replace,
    bit for bit: random scalars below r with the edge values, a zero
    padding tail, points at infinity."""
    from test_torch_msm_digits import infinity, limbs_of, scalars

    rng = np.random.default_rng(c * n)
    vals = scalars(c, 1, 64, c)[0]
    limbs = _field(lf.FR, (sets, 8, n), c + n)
    limbs[:, :, :64] = limbs_of([vals] * sets)
    limbs[-1, :, n - n // 7:] = 0
    limbs, pinf = limbs.to(cuda), infinity(n, int(rng.integers(1 << 30)))
    pinf = pinf.to(cuda)
    before = kernels.LAUNCHES["msm_digits"]
    keys = kernels.msm_digits(limbs, pinf, c)
    assert kernels.LAUNCHES["msm_digits"] == before + 1
    assert keys.is_contiguous()
    assert torch.equal(keys, kernels.msm_digits_plain(limbs, pinf, c))
    if not kernels.packed_key_fits(1 << (c - 1), n):
        return
    srt = torch.sort(keys, dim=-1).values
    got = kernels.msm_digits(srt, unpack=True)
    assert kernels.LAUNCHES["msm_digits"] == before + 2
    want = kernels.msm_digits_plain(srt, unpack=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_contiguous() and torch.equal(g, w)


def test_halving_tree_commit_with_msm_digits_matches_host(cuda):
    """The commit path (`msm_many_mont`, Montgomery coefficients on the
    card) over 2^14 points, the halving tree at c = 10: two launches of
    msm_digits, and each commitment equal to the host MSM, with zero
    scalars, r - 1 and scalars whose carry reaches the top window."""
    from test_torch_msm_digits import edge_values
    from zkvm_tpu_torch.ops import msm

    n = msm.PTREE_MIN_POINTS
    points, scalars = _tree_points(n, 37)
    scalars[:6] = [Fr(v) for v in edge_values(10)]
    sets = [scalars, scalars[:7000]]
    ctx = msm.MSMContext(points, cuda)
    mont = [lf.FR.to_mont_array([s.value for s in x], cuda) for x in sets]
    before = kernels.LAUNCHES["msm_digits"]
    got = ctx.msm_many_mont(mont)
    assert kernels.LAUNCHES["msm_digits"] == before + 2
    _assert_host_msm(points, sets, got)
