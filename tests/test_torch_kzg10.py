"""The port's KZG10 slice against zkvm_tpu.plonk.kzg10.

One seed must give the reference's SRS byte for byte (the port computes
the powers of g on the device, the reference on the host at this size),
and commitments to the same Montgomery coefficient arrays must give the
same bytes.  Exact equality throughout.  Each package gets its own host
classes (field elements, points, RNG); the two meet only as ints and bytes.
"""

import numpy as np
import pytest
import torch

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.fields import Fr
from zkvm_tpu.ops import limb_field as rlf
from zkvm_tpu.plonk import kzg10 as rkzg
from zkvm_tpu.plonk.polynomial import Polynomial
from zkvm_tpu.rng import StdRng
from zkvm_tpu_torch.curves.g1 import G1Affine as PG1Affine
from zkvm_tpu_torch.fields import Fr as PFr
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.plonk import kzg10
from zkvm_tpu_torch.plonk.errors import (DegreeIsZero, PolynomialDegreeIsZero,
                                         PolynomialDegreeTooLarge,
                                         TruncatedDegreeIsZero,
                                         TruncatedDegreeTooLarge)
from zkvm_tpu_torch.rng import StdRng as PStdRng

torch.set_num_threads(1)

DEGREE = 24


@pytest.fixture(scope="module")
def params():
    port = kzg10.PublicParameters.setup(DEGREE, PStdRng(17), "cpu")
    ref = rkzg.PublicParameters.setup(DEGREE, StdRng(17))
    return port, ref


def _coeffs(n, seed, cls=PFr):
    """n seeded field elements as `cls` (the port's Fr or the reference's)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    return [cls(sum(int(w) << (63 * k) for k, w in enumerate(row)))
            for row in words]


def test_setup_matches_reference_bytes(params):
    port, ref = params
    assert port.to_raw_var_bytes() == ref.to_raw_var_bytes()
    assert port.commit_key.to_raw_var_bytes() == \
        ref.commit_key.to_raw_var_bytes()
    assert port.max_degree() == ref.max_degree()


def test_commit_many_mont_matches_reference(params):
    port, ref = params
    ck, _ = port.trim(DEGREE)
    rck, _ = ref.trim(DEGREE)
    lengths = (ck.max_degree() + 1, 20, 9)
    ref_t = [rlf.FR.to_mont_array([c.value for c in _coeffs(k, k)])
             for k in lengths]
    port_t = [lf.from_reference(np.asarray(t), lf.FR, "cpu") for t in ref_t]
    got = ck.commit_many_mont(port_t)
    want = rck.commit_many_mont(ref_t)
    assert [c.to_bytes() for c in got] == [c.to_bytes() for c in want]


def test_commit_matches_reference(params):
    port, ref = params
    ck, rck = port.commit_key, ref.commit_key
    polys = [_coeffs(ck.max_degree() + 1, 40), _coeffs(5, 41)]
    polys[1] += [PFr.zero()] * 3  # trailing zeros do not raise the degree
    got = ck.commit_many(polys)
    want = [rck.commit(Polynomial([Fr(c.value) for c in p])) for p in polys]
    assert [c.to_bytes() for c in got] == [c.to_bytes() for c in want]
    assert ck.commit(polys[1]) == got[1]


def test_degree_errors(params):
    port, _ = params
    ck = port.commit_key
    with pytest.raises(DegreeIsZero):
        kzg10.PublicParameters.setup(0, PStdRng(1), "cpu")
    with pytest.raises(PolynomialDegreeIsZero):
        ck.commit([PFr(5)])
    with pytest.raises(PolynomialDegreeIsZero):
        ck.commit([PFr(5), PFr.zero()])
    with pytest.raises(PolynomialDegreeTooLarge):
        ck.commit(_coeffs(ck.max_degree() + 2, 3))
    too_long = torch.zeros((8, ck.max_degree() + 2), dtype=torch.int32)
    with pytest.raises(PolynomialDegreeTooLarge):
        ck.commit_many_mont([too_long])
    with pytest.raises(TruncatedDegreeIsZero):
        ck.truncate(0)
    with pytest.raises(TruncatedDegreeTooLarge):
        ck.truncate(ck.max_degree() + 1)


def test_trim_and_key_round_trips(params):
    port, ref = params
    ck, ok = port.trim(8)
    rck, rok = ref.trim(8)
    assert ck.max_degree() == 8 + kzg10.PublicParameters.ADDED_BLINDING_DEGREE
    assert ck.to_raw_var_bytes() == rck.to_raw_var_bytes()
    assert ok.to_bytes() == rok.to_bytes()
    assert port.commit_key.truncate(1).max_degree() == 2
    raw = ref.commit_key.to_raw_var_bytes()
    from_bytes = kzg10.CommitKey.from_reference(raw, "cpu")
    from_key = kzg10.CommitKey.from_reference(ref.commit_key, "cpu")
    assert from_bytes == from_key == port.commit_key
    assert from_bytes.to_raw_var_bytes() == raw
    assert from_key.device == torch.device("cpu")


def test_commitment_encoding():
    c = kzg10.Commitment(PG1Affine.generator())
    assert kzg10.Commitment.from_bytes(c.to_bytes()) == c
    assert len(c.to_bytes()) == 48
    assert kzg10.Commitment.identity().point.is_identity()
    powers = kzg10.powers_of(PFr(10), 5)
    assert [p.value for p in powers] == [Fr(10).pow(i).value
                                         for i in range(6)]
    assert c.to_bytes() == rkzg.Commitment(RG1Affine.generator()).to_bytes()
