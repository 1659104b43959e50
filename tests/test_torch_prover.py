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
from zkvm_tpu_torch.hashes.gadget import GadgetPermutation
from zkvm_tpu_torch.ops import kernels, msm
from zkvm_tpu_torch.plonk import (PlonkError, Proof, ProofVerificationError,
                                  Prover, Verifier)
from zkvm_tpu_torch.rng import StdRng
from zkvm_tpu_torch.utils import metrics

sys.path.insert(0, str(Path(__file__).parent))
from test_fixtures import FixedCircuit as RFixedCircuit  # noqa: E402
from test_torch_plonk_host import FixedCircuit  # noqa: E402

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"


WRAPPERS = ("mont_mul", "field_addsub", "padd", "window_fold", "ntt_stages")


@pytest.fixture(scope="module")
def proofs():
    """(reference proof, port proof, calls, spans): `calls` counts each
    kernel wrapper of WRAPPERS, and holds under "commits" the span key open
    at each commit MSM call and under "permutes" the in-circuit Poseidon
    permutations; `spans` is the registry's report of the port's prove."""
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    ref = RProver.try_from_bytes(pb).prove(RStdRng(5), RFixedCircuit())
    metrics.GLOBAL.reset()
    calls = dict.fromkeys(WRAPPERS, 0)
    calls.update(commits=[], permutes=0)
    real = {name: getattr(kernels, name) for name in WRAPPERS}
    real_commit = msm.MSMContext.msm_many_mont
    real_permute = GadgetPermutation.permute

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    def commit(self, *a, **k):
        calls["commits"].append("/".join(metrics.GLOBAL._stack))
        return real_commit(self, *a, **k)

    def permute(self, state):
        calls["permutes"] += 1
        return real_permute(self, state)
    try:
        for name in WRAPPERS:
            setattr(kernels, name, counting(name))
        msm.MSMContext.msm_many_mont = commit
        GadgetPermutation.permute = permute
        port = Prover.try_from_bytes(pb, "cpu").prove(StdRng(5),
                                                      FixedCircuit())
    finally:
        for name in WRAPPERS:
            setattr(kernels, name, real[name])
        msm.MSMContext.msm_many_mont = real_commit
        GadgetPermutation.permute = real_permute
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


ROUNDS = ("witness_synthesis", "wire_ingest", "round1_wires",
          "round2_permutation", "round3_quotient", "round4_evaluations",
          "round5_openings")
MSM_STAGES = ("ingest", "signed digits", "sort", "gather", "scan tail",
              "reject folds", "weighted fold", "window_fold", "host decode")


def _is_added_span(key: str) -> bool:
    """A key of the spans this package adds beside the rounds: the
    preamble and the release of the witness; a Poseidon permutation in the witness synthesis; an MSM
    stage in a round that commits; each of these, or any round, with a
    garbage collection last, or a collection alone."""
    base = key.removesuffix("/prove/gc")
    if base in ("prove/gc", "prove/preamble", "prove/release") or (
            base != key and base.removeprefix("prove/") in ROUNDS):
        return True
    key = base
    top, _, inner = key.partition("/prove/")
    if top == "prove/witness_synthesis":
        return inner == "poseidon_gadget"
    stage = inner.removeprefix("msm/")
    return (top.startswith("prove/round") and inner != stage
            and (stage in MSM_STAGES or stage.startswith("tree level ")))


def test_gate1_prove_runs_every_round_through_the_kernels(proofs):
    """The round spans of the reference are all opened, once, and every
    other span is one this package adds where it belongs (`_is_added_span`);
    the prove reached every kernel wrapper of the path (on the CPU their
    plain versions; on the card each launches its kernel): the Montgomery
    product, the field add/sub/neg, the point addition, the window fold and
    the staged transform."""
    _, _, calls, spans = proofs
    rounds = [f"prove/{s}" for s in ROUNDS]
    assert all(spans[k]["count"] == 1 for k in rounds)
    assert [k for k in spans if k not in rounds
            and not _is_added_span(k)] == []
    assert all(calls[name] > 0 for name in WRAPPERS), calls


def test_gate1_prove_opens_the_preamble_and_the_stage_spans(proofs):
    """One `prove/preamble` and one `prove/release` a proof; one
    `prove/msm/ingest` a commit call, nested under the round that commits
    (rounds 1, 2, 3 and 5); one `prove/poseidon_gadget` a permutation of
    the circuit (FixedCircuit permutes none).  The proof bytes are the
    reference's (`test_gate1_proof_bytes_equal_the_reference`)."""
    _, _, calls, spans = proofs
    assert spans["prove/preamble"]["count"] == 1
    assert spans["prove/release"]["count"] == 1
    assert sorted(calls["commits"]) == [
        "prove/round1_wires", "prove/round2_permutation",
        "prove/round3_quotient", "prove/round5_openings"]
    ingest = {k.removesuffix("/prove/msm/ingest"): v["count"]
              for k, v in spans.items() if k.endswith("/prove/msm/ingest")}
    assert ingest == {k: 1 for k in calls["commits"]}
    gadget = sum(v["count"] for k, v in spans.items()
                 if k.endswith("prove/poseidon_gadget"))
    assert gadget == calls["permutes"] == 0
