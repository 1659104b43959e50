"""The CUDA kernels on the card against their plain versions, bit for bit.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip elsewhere.  Run
them on the card with `python -m pytest -m gpu tests/test_torch_*.py`.
"""

import numpy as np
import pytest
import torch

from zkvm_tpu.curves.msm import msm_variable_base
from zkvm_tpu.fields import Fr
from zkvm_tpu.rng import StdRng
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.plonk import kzg10

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
    assert got.point == msm_variable_base(pp.commit_key.powers_of_g[:41],
                                          coeffs).to_affine()
