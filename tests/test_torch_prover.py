"""Gate 1: the port's prover gives zkvm_tpu's proof bytes.

The port's `Prover.try_from_bytes` of the committed
`tests/fixtures/prover_bundle_v1.bin` (`FixedCircuit`, setup 2^6,
`StdRng(1234)`, label b"fixture") proves `FixedCircuit` under `StdRng(5)`
on the CPU to the same bytes as zkvm_tpu's prover from the same bundle;
zkvm_tpu's `Verifier` from `verifier_bundle_v1.bin` accepts them and
refuses them with a public input changed, and so does the port's.  Each
package's proof is computed once for the module.
"""

import sys
from pathlib import Path

import pytest
import torch

from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.plonk import Proof as RProof
from zkvm_tpu.plonk import PlonkError as RPlonkError
from zkvm_tpu.plonk import ProofVerificationError as RProofVerificationError
from zkvm_tpu.plonk.prover import Prover as RProver
from zkvm_tpu.plonk.verifier import Verifier as RVerifier
from zkvm_tpu.rng import StdRng as RStdRng
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.plonk import (PlonkError, Proof, ProofVerificationError,
                                  Prover, Verifier)
from zkvm_tpu_torch.rng import StdRng
from zkvm_tpu_torch.utils import metrics

sys.path.insert(0, str(Path(__file__).parent))
from test_fixtures import FixedCircuit as RFixedCircuit  # noqa: E402
from test_torch_plonk_host import FixedCircuit  # noqa: E402

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"


WRAPPERS = ("mont_mul", "field_addsub", "padd", "window_fold", "carry_fold")


@pytest.fixture(scope="module")
def proofs():
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    ref = RProver.try_from_bytes(pb).prove(RStdRng(5), RFixedCircuit())
    metrics.GLOBAL.reset()
    calls = dict.fromkeys(WRAPPERS, 0)
    real = {name: getattr(kernels, name) for name in WRAPPERS}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call
    try:
        for name in WRAPPERS:
            setattr(kernels, name, counting(name))
        port = Prover.try_from_bytes(pb, "cpu").prove(StdRng(5),
                                                      FixedCircuit())
    finally:
        for name in WRAPPERS:
            setattr(kernels, name, real[name])
    return ref, port, calls, metrics.report()


def test_gate1_proof_bytes_equal_the_reference(proofs):
    (rproof, rpis), (proof, pis), _, _ = proofs
    assert proof.to_bytes() == rproof.to_bytes()
    assert [p.to_bytes() for p in pis] == [p.to_bytes() for p in rpis]
    assert len(proof.to_bytes()) == Proof.SIZE


def test_gate1_reference_verifier_accepts_and_refuses(proofs):
    """FixedCircuit has no public input, so the changed public inputs are
    one more than it has."""
    _, (proof, pis), _, _ = proofs
    verifier = RVerifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes())
    theirs = RProof.from_bytes(proof.to_bytes())
    rpis = [RFr(p.value) for p in pis]
    assert rpis == []
    verifier.verify(theirs, rpis)
    with pytest.raises(RPlonkError):
        verifier.verify(theirs, rpis + [RFr(5)])
    bad = RProof.from_bytes(proof.to_bytes())
    bad.evaluations.a_eval = bad.evaluations.a_eval + RFr.one()
    with pytest.raises(RProofVerificationError):
        verifier.verify(bad, rpis)


def test_gate1_port_verifier_accepts_and_refuses(proofs):
    _, (proof, pis), _, _ = proofs
    verifier = Verifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes())
    verifier.verify(Proof.from_bytes(proof.to_bytes()), pis)
    with pytest.raises(PlonkError):
        verifier.verify(proof, pis + [Fr(5)])
    bad = Proof.from_bytes(proof.to_bytes())
    bad.evaluations.z_eval = bad.evaluations.z_eval + Fr.one()
    with pytest.raises(ProofVerificationError):
        verifier.verify(bad, pis)


def test_gate1_prove_runs_every_round_through_the_kernels(proofs):
    """The round spans of the reference are all opened, and the prove
    reached every kernel wrapper of the path (on the CPU their plain
    versions; on the card each launches its kernel): the Montgomery
    product, the field add/sub/neg, the point addition, the window fold and
    the matmul transform's leaf reduction."""
    _, _, calls, spans = proofs
    assert sorted(spans) == sorted(
        f"prove/{s}" for s in ("witness_synthesis", "wire_ingest",
                               "round1_wires", "round2_permutation",
                               "round3_quotient", "round4_evaluations",
                               "round5_openings"))
    assert all(v["count"] == 1 for v in spans.values())
    assert all(calls[name] > 0 for name in WRAPPERS), calls
