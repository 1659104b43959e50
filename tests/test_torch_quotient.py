"""The quotient round of the port against zkvm_tpu's, bit for bit.

`ops/quotient_kernel.py`'s `quotient_numerator` and `pointwise_divide` take
the same numpy-seeded Montgomery operands as the reference's (every
selector family live: all fifteen selector and sigma tables random) at
8n = 2^5 and 2^8; `plonk/quotient.py`'s `build_quotient_device` takes the
fixture's ProverKey and the same polynomials and challenges as the
reference's.  Challenges are [8, 1] columns, which every kernel reads in
place: the test watches that none is expanded to the full width.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import zkvm_tpu.ops.limb_field as rlf
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import quotient_kernel as rqk
from zkvm_tpu.plonk import quotient as rquotient
from zkvm_tpu.plonk.prover import Prover as RProver
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import quotient_kernel as qk
from zkvm_tpu_torch.ops.ntt import Domain
from zkvm_tpu_torch.plonk import Prover, quotient

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
P = lf.FR.modulus
SEL_NAMES = [name for _, name in quotient._SELECTOR_PAIRS]
CHAL_NAMES = ("alpha", "beta", "gamma", "range_sep", "logic_sep",
              "fixed_sep", "var_sep")


def _ints(n, rng):
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % P
            for row in words]


def _operands(size, seed):
    """(reference operands, port operands) of quotient_numerator."""
    rng = np.random.default_rng(seed)
    names = SEL_NAMES + ["a", "b", "c", "d", "a_w", "b_w", "d_w", "z", "z_w",
                         "pi", "l1", "linear"]
    vals = {nm: _ints(size, rng) for nm in names}
    vals["a"][:3] = [0, 1, P - 1]
    chals = dict(zip(CHAL_NAMES, _ints(7, rng)))
    ref = {nm: rlf.FR.to_mont_array(v) for nm, v in vals.items()}
    port = {nm: lf.FR.to_mont_array(v, "cpu") for nm, v in vals.items()}
    rchal = {nm: rlf.FR.const_mont(v) for nm, v in chals.items()}
    pchal = {nm: lf.u32_to_tensor(lf.FR.mont_limbs(v)[:, None], "cpu")
             for nm, v in chals.items()}
    wires = ("a", "b", "c", "d", "a_w", "b_w", "d_w")

    def args(d, c):
        return ({nm: d[nm] for nm in SEL_NAMES}, tuple(d[w] for w in wires),
                d["z"], d["z_w"], d["pi"], d["l1"], d["linear"], c)

    return args(ref, rchal), args(port, pchal), ref, port


@pytest.mark.parametrize("log_size", [5, 8])
def test_quotient_numerator_and_divide_match_reference(log_size,
                                                        monkeypatch):
    size = 1 << log_size
    rargs, pargs, ref, port = _operands(size, log_size)
    seen = []
    for name in ("mont_mul", "field_addsub"):
        real = getattr(kernels, name)

        def watch(*a, real=real, **k):
            seen.extend(t for t in a if isinstance(t, torch.Tensor))
            return real(*a, **k)
        monkeypatch.setattr(kernels, name, watch)
    want = np.asarray(rqk.quotient_numerator(*rargs))
    got = qk.quotient_numerator(*pargs)
    assert got.shape == (8, size) and got.is_contiguous()
    assert (lf.to_reference(got, lf.FR) == want).all()
    # every challenge column and constant reached a kernel as [8, 1]: none
    # was made full width for it
    assert all(t.shape[-1] in (1, size) for t in seen)
    assert all(t.untyped_storage().nbytes() == 4 * 8 for t in seen
               if t.shape[-1] == 1)
    assert sum(t.shape[-1] == 1 for t in seen) > 40
    v_h = ref["linear"], port["linear"]
    want = np.asarray(rqk.pointwise_divide(want, v_h[0]))
    got = qk.pointwise_divide(got, v_h[1])
    assert (lf.to_reference(got, lf.FR) == want).all()


@pytest.fixture(scope="module")
def fixture_provers():
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    return RProver.try_from_bytes(pb), Prover.try_from_bytes(pb, "cpu")


def test_build_quotient_device_matches_reference(fixture_provers):
    rprover, prover = fixture_provers
    n = prover.size
    rng = np.random.default_rng(11)
    lens = (n + 2, n + 2, n + 2, n + 2, n + 3, n)
    polys = [_ints(m, rng) for m in lens]
    chals = _ints(7, rng)
    rpolys = [rlf.FR.to_mont_array(v) for v in polys]
    ppolys = [lf.FR.to_mont_array(v, "cpu") for v in polys]
    import zkvm_tpu.ops.ntt as rntt

    want = rquotient.build_quotient_device(
        rntt.Domain(n), rprover.prover_key, rpolys[4], tuple(rpolys[:4]),
        rpolys[5], tuple(RFr(c) for c in chals))
    got = quotient.build_quotient_device(
        Domain(n), prover.prover_key, ppolys[4], tuple(ppolys[:4]),
        ppolys[5], tuple(Fr(c) for c in chals))
    assert got.shape == (8, 8 * n)
    assert (lf.to_reference(got, lf.FR) == np.asarray(want)).all()
    # the device cache is per device and built once
    cache = quotient._device_cache(prover.prover_key, "cpu")
    assert quotient._device_cache(prover.prover_key,
                                  torch.device("cpu")) is cache
    sel, v_h_inv, linear = cache
    rsel, rv_h_inv, rlinear = rquotient._device_cache(rprover.prover_key)
    for name in SEL_NAMES:
        assert (lf.to_reference(sel[name], lf.FR)
                == np.asarray(rsel[name])).all()
    assert (lf.to_reference(v_h_inv, lf.FR) == np.asarray(rv_h_inv)).all()
