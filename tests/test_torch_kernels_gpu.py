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


@pytest.mark.parametrize("lead,shared", [((), False), ((3,), True),
                                         ((2, 2), False)])
def test_butterfly_kernel_matches_plain(cuda, lead, shared):
    shape = lead + (8, 1027)
    even, odd = _field(lf.FR, shape, 12), _field(lf.FR, shape, 13)
    tw = _field(lf.FR, (8, 1027) if shared else shape, 14)
    got = kernels.butterfly(even.to(cuda), odd.to(cuda), tw.to(cuda))
    for g, w in zip(got, kernels.butterfly_plain(even, odd, tw)):
        assert torch.equal(g.cpu(), w)


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


def test_fold_kernel_matches_plain(cuda):
    rng = np.random.default_rng(16)
    w = rng.integers(0, 1 << 32, size=(17, 1027), dtype=np.uint64).astype(
        np.uint32)
    w[:, 0] = 0xFFFFFFFF
    limbs = lf.u32_to_tensor(w, "cpu")
    got = kernels.fold(limbs.to(cuda))
    assert torch.equal(got.cpu(), kernels.fold_plain(limbs))


def test_transform_routes_agree_on_card(cuda):
    from zkvm_tpu_torch.ops import ntt, ntt_mxu

    n = 1 << 10
    dom = ntt.Domain(n)
    x = _field(lf.FR, (2, 8, n), 17)
    want = dom.fft_device(x)  # CPU: the plain versions
    got = dom.fft_device(x.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(ntt.butterfly_transform(dom, x.to(cuda)).cpu(), want)
    t = ntt_mxu.MXUTransform(n, dom.group_gen)
    assert torch.equal(ntt_mxu.transform_unfused(t, x.to(cuda)).cpu(), want)
    assert torch.equal(dom.ifft_device(got).cpu(), x)
