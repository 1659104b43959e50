"""The polynomial path of a prover round, whole, at n = 2^6 / 8n = 2^9 on
the CPU, in zkvm_tpu_torch and in zkvm_tpu:

  four evaluation vectors -> batched ifft -> blinders -> commit -> pad to
  8n -> coset fft and back -> evaluations at z -> linear combination with
  powers of v -> division by (X - z) -> commit of the witness ->
  AggregateProof.flatten -> OpeningKey.check.

Both packages get the same numpy-seeded inputs and the same RNG seed.
Every commitment and the witness must have the reference's bytes, every
tensor the reference's limbs (tolerance zero), and the opening must verify
in both -- and fail once an evaluation is altered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import ntt as rntt
from zkvm_tpu.plonk import dpoly as rdpoly
from zkvm_tpu.plonk import kzg10 as rkzg
from zkvm_tpu.plonk.polynomial import Polynomial as RPolynomial
from zkvm_tpu.rng import StdRng as RStdRng
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import ntt
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.plonk import dpoly, kzg10
from zkvm_tpu_torch.plonk.errors import PairingCheckFailure
from zkvm_tpu_torch.plonk.polynomial import Polynomial
from zkvm_tpu_torch.rng import StdRng

torch.set_num_threads(1)

Q = Fr.MODULUS
N = 1 << 6
SEED = 7
Z = 0x2F3A5C7E9B1D4F60718293A4B5C6D7E8F9
V = 0x1B2C3D4E5F60718293A4B5C6D7E8F90A1B


def _values(count, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(count, 5), dtype=np.uint64)
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % Q
            for row in words.tolist()]


@pytest.fixture(scope="module")
def port_path():
    """The path in the port, on CPU tensors."""
    rng = StdRng(SEED)
    pp = kzg10.PublicParameters.setup(N, rng, "cpu")
    ck, ok = pp.commit_key, pp.opening_key
    evals = torch.stack([dpoly.to_device(_values(N, 100 + k), N, "cpu")
                         for k in range(4)])                   # [4, 8, n]
    coeffs = ntt.Domain(N).ifft_device(evals)
    blinded = [dpoly.apply_blinders_device(rng, coeffs[k], 1)
               for k in range(4)]                              # [8, n + 2]
    commits = ck.commit_many_mont(blinded)
    padded = torch.stack([F.pad(t, (0, 8 * N - t.shape[-1]))
                          for t in blinded])                   # [4, 8, 8n]
    dom8 = ntt.Domain(8 * N)
    coset = dom8.coset_fft_device(padded)
    back = dom8.coset_ifft_device(coset)
    z, v = Fr(Z), Fr(V)
    stack = torch.stack(blinded)
    at_z = dpoly.eval_stack(stack, z)
    powers = kzg10.powers_of(v, 3)
    numerator = dpoly.lin_comb(list(zip(blinded, powers)), N + 2, "cpu")
    witness = dpoly.ruffini_device(numerator, z)
    w_commit = ck.commit_many_mont([witness])[0]
    agg = kzg10.AggregateProof(w_commit)
    for e, c in zip(at_z, commits):
        agg.add_part(e, c)
    return dict(pp=pp, ok=ok, coeffs=coeffs, blinded=blinded,
                commits=commits, padded=padded, coset=coset, back=back,
                at_z=at_z, numerator=numerator, witness=witness,
                w_commit=w_commit, agg=agg, z=z, v=v)


@pytest.fixture(scope="module")
def ref_path():
    """The same path in the JAX package (its CPU branches)."""
    rng = RStdRng(SEED)
    pp = rkzg.PublicParameters.setup(N, rng)
    ck, ok = pp.commit_key, pp.opening_key
    dom, dom8 = rntt.Domain(N), rntt.Domain(8 * N)
    evals = [rdpoly.to_device(_values(N, 100 + k), N) for k in range(4)]
    coeffs = [dom.ifft_device(e) for e in evals]
    blinded = [rdpoly.apply_blinders_device(rng, c, 1) for c in coeffs]
    commits = ck.commit_many_mont(blinded)
    padded = [jnp.pad(t, [(0, 0), (0, 8 * N - t.shape[-1])])
              for t in blinded]
    coset = [dom8.coset_fft_device(p) for p in padded]
    z, v = RFr(Z), RFr(V)
    at_z = rdpoly.eval_stack(jnp.stack(blinded), z)
    powers = rkzg.powers_of(v, 3)
    numerator = rdpoly.lin_comb(list(zip(blinded, powers)), N + 2)
    witness = rdpoly.ruffini_device(numerator, z)
    w_commit = ck.commit_many_mont([witness])[0]
    agg = rkzg.AggregateProof(w_commit)
    for e, c in zip(at_z, commits):
        agg.add_part(e, c)
    return dict(pp=pp, ok=ok, coeffs=coeffs, blinded=blinded,
                commits=commits, coset=coset, at_z=at_z,
                numerator=numerator, witness=witness, w_commit=w_commit,
                agg=agg, z=z, v=v)


def _same(port_tensor, ref_array) -> bool:
    return (lf.to_reference(port_tensor, FR) == np.asarray(ref_array)).all()


def test_setup_bytes_match(port_path, ref_path):
    assert port_path["pp"].to_raw_var_bytes() == \
        ref_path["pp"].to_raw_var_bytes()
    assert port_path["ok"].to_bytes() == ref_path["ok"].to_bytes()


@pytest.mark.parametrize("k", range(4))
def test_coefficients_and_blinding_match(port_path, ref_path, k):
    assert _same(port_path["coeffs"][k], ref_path["coeffs"][k])
    assert _same(port_path["blinded"][k], ref_path["blinded"][k])


@pytest.mark.parametrize("k", range(4))
def test_commitment_bytes_match(port_path, ref_path, k):
    assert port_path["commits"][k].to_bytes() == \
        ref_path["commits"][k].to_bytes()


@pytest.mark.parametrize("k", range(4))
def test_coset_evaluations_match_and_round_trip(port_path, ref_path, k):
    assert _same(port_path["coset"][k], ref_path["coset"][k])
    assert torch.equal(port_path["back"][k], port_path["padded"][k])


def test_evaluations_match_and_equal_host_horner(port_path, ref_path):
    got = [e.value for e in port_path["at_z"]]
    assert got == [e.value for e in ref_path["at_z"]]
    for k, e in enumerate(got):
        poly = Polynomial(dpoly.from_device(port_path["blinded"][k]))
        assert poly.evaluate(port_path["z"]).value == e


def test_witness_matches_reference_and_host(port_path, ref_path):
    assert _same(port_path["numerator"], ref_path["numerator"])
    assert _same(port_path["witness"], ref_path["witness"])
    assert port_path["w_commit"].to_bytes() == ref_path["w_commit"].to_bytes()
    polys = [Polynomial(dpoly.from_device(t)) for t in port_path["blinded"]]
    host = kzg10.CommitKey.compute_aggregate_witness(
        polys, port_path["z"], port_path["v"])
    rpolys = [RPolynomial(rdpoly.from_device(t))
              for t in ref_path["blinded"]]
    rhost = rkzg.CommitKey.compute_aggregate_witness(
        rpolys, ref_path["z"], ref_path["v"])
    assert [c.value for c in host.coeffs] == [c.value for c in rhost.coeffs]
    device = [c.value for c in dpoly.from_device(port_path["witness"])]
    assert device[:len(host.coeffs)] == [c.value for c in host.coeffs]
    assert not any(device[len(host.coeffs):])


def test_opening_verifies_in_both_packages(port_path, ref_path):
    proof = port_path["agg"].flatten(port_path["v"])
    rproof = ref_path["agg"].flatten(ref_path["v"])
    assert proof.evaluated_point.value == rproof.evaluated_point.value
    assert proof.commitment_to_polynomial.to_bytes() == \
        rproof.commitment_to_polynomial.to_bytes()
    assert proof.commitment_to_witness.to_bytes() == \
        rproof.commitment_to_witness.to_bytes()
    assert port_path["ok"].check(port_path["z"], proof) is True
    assert ref_path["ok"].check(ref_path["z"], rproof) is True


def test_altered_evaluation_does_not_verify(port_path):
    agg = kzg10.AggregateProof(port_path["w_commit"])
    for k, (e, c) in enumerate(zip(port_path["at_z"], port_path["commits"])):
        agg.add_part(e + Fr.one() if k == 2 else e, c)
    assert port_path["ok"].check(port_path["z"],
                                 agg.flatten(port_path["v"])) is False
    proof = port_path["agg"].flatten(port_path["v"])
    assert port_path["ok"].check(port_path["z"] + Fr.one(), proof) is False


class _FixedTranscript:
    """Stands in for the prover's transcript: one fixed challenge."""

    def __init__(self, cls):
        self.cls = cls

    def challenge_scalar(self, label):
        assert label == b"batch"
        return self.cls(0xC0FFEE1234567)


def test_batch_check_and_opening_key_bytes(port_path, ref_path):
    ok = kzg10.OpeningKey.from_bytes(ref_path["ok"].to_bytes())
    assert ok.to_bytes() == port_path["ok"].to_bytes()
    assert kzg10.OpeningKey.from_bytes(b"\x00" * 10) is None
    proof = port_path["agg"].flatten(port_path["v"])
    single = kzg10.KZGProof(port_path["w_commit"], proof.evaluated_point,
                            proof.commitment_to_polynomial)
    z = port_path["z"]
    assert ok.batch_check([z, z], [proof, single], _FixedTranscript(Fr))
    rproof = ref_path["agg"].flatten(ref_path["v"])
    assert ref_path["ok"].batch_check([ref_path["z"]] * 2, [rproof, rproof],
                                      _FixedTranscript(RFr))
    bad = kzg10.KZGProof(port_path["w_commit"],
                         proof.evaluated_point + Fr.one(),
                         proof.commitment_to_polynomial)
    with pytest.raises(PairingCheckFailure):
        ok.batch_check([z, z], [proof, bad], _FixedTranscript(Fr))
