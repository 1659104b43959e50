"""Gate 1 on a mesh: the port's prover over four logical shards gives
zkvm_tpu's single-device proof bytes.

`Prover.try_from_bytes` of the committed `tests/fixtures/prover_bundle_v1.bin`
(`FixedCircuit`, setup 2^6) proves `FixedCircuit` under `StdRng(5)` with
`mesh=Mesh(["cpu"] * 4)`: distributed transforms, cross-shard scans, the
sharded quotient and sharded commits.  The bytes must equal the reference's
single-device proof (the reference's mesh prove gives the same bytes by its
own construction, which `tests/test_sharded.py` checks on the dryrun
circuit), and both verifiers accept them.
"""

import sys
from pathlib import Path

import pytest
import torch

from zkvm_tpu.plonk import Proof as RProof
from zkvm_tpu.plonk import PlonkError as RPlonkError
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.plonk.prover import Prover as RProver
from zkvm_tpu.plonk.verifier import Verifier as RVerifier
from zkvm_tpu.rng import StdRng as RStdRng
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops.collective import Mesh
from zkvm_tpu_torch.plonk import PlonkError, Proof, Prover, Verifier
from zkvm_tpu_torch.rng import StdRng

sys.path.insert(0, str(Path(__file__).parent))
from test_fixtures import FixedCircuit as RFixedCircuit  # noqa: E402
from test_torch_plonk_host import FixedCircuit  # noqa: E402

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
WRAPPERS = ("mont_mul", "field_addsub", "padd", "window_fold", "ntt_stages")


@pytest.fixture(scope="module")
def proofs():
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    ref = RProver.try_from_bytes(pb).prove(RStdRng(5), RFixedCircuit())
    calls = dict.fromkeys(WRAPPERS, 0)
    real = {name: getattr(kernels, name) for name in WRAPPERS}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call
    prover = Prover.try_from_bytes(pb, "cpu")
    try:
        for name in WRAPPERS:
            setattr(kernels, name, counting(name))
        port = prover.prove(StdRng(5), FixedCircuit(),
                            mesh=Mesh(["cpu"] * 4, ("shards",)),
                            shard_axis="shards")
    finally:
        for name in WRAPPERS:
            setattr(kernels, name, real[name])
    return ref, port, calls, prover


def test_mesh_proof_bytes_equal_the_reference(proofs):
    (rproof, rpis), (proof, pis), _, _ = proofs
    assert proof.to_bytes() == rproof.to_bytes()
    assert [p.to_bytes() for p in pis] == [p.to_bytes() for p in rpis]


def test_mesh_proof_verifies_on_both_verifiers(proofs):
    _, (proof, pis), _, _ = proofs
    rverifier = RVerifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes())
    theirs = RProof.from_bytes(proof.to_bytes())
    rverifier.verify(theirs, [])
    with pytest.raises(RPlonkError):
        rverifier.verify(theirs, [RFr(5)])
    verifier = Verifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes())
    verifier.verify(Proof.from_bytes(proof.to_bytes()), pis)
    with pytest.raises(PlonkError):
        verifier.verify(proof, pis + [Fr(5)])


def test_mesh_prove_runs_through_the_kernels(proofs):
    """The mesh prove reached every kernel wrapper of the path (on the CPU
    their plain versions), and cached its sharded round programs."""
    _, _, calls, prover = proofs
    assert all(calls[name] > 0 for name in WRAPPERS), calls
    cache = prover.prover_key.__dict__["_mesh_programs_cache"]
    assert list(cache) == [(prover.size, Mesh(["cpu"] * 4, ("shards",)),
                            "shards")]


def test_mesh_prove_refuses_what_it_cannot_honour(proofs):
    _, _, _, prover = proofs
    with pytest.raises(ValueError, match="no mesh"):
        prover.prove(StdRng(5), FixedCircuit(), shard_axis="shards")
    with pytest.raises(ValueError, match="axis"):
        prover.prove(StdRng(5), FixedCircuit(),
                     mesh=Mesh(["cpu"] * 2, ("x",)), shard_axis="y")
    with pytest.raises(ValueError, match="home"):
        prover.prove(StdRng(5), FixedCircuit(), mesh=Mesh(["meta"] * 2))
