"""One circuit with the range, logic, boolean and select gadgets, proved by
both packages: the same bundles and the same proof bytes.

`tests/test_plonk_e2e.py`'s `RangeLogicCircuit` at that file's setup
(`1 << 7`, `StdRng(0x10)`) is compiled and proved under `StdRng(7)` by
zkvm_tpu and by the port on the CPU; its quotient round has the range and
logic widgets live, which the fixture circuit of gate 1 does not.  Each
package's proof is computed once for the module.
"""

import sys
from pathlib import Path

import pytest
import torch

from zkvm_tpu import plonk as rplonk
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.rng import StdRng as RStdRng
from zkvm_tpu_torch.plonk import Compiler, Proof, PublicParameters
from zkvm_tpu_torch.rng import StdRng

sys.path.insert(0, str(Path(__file__).parent))
from test_plonk_e2e import RangeLogicCircuit as RRangeLogic  # noqa: E402
from test_torch_plonk_host import RangeLogicCircuit  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    rpp = rplonk.PublicParameters.setup(1 << 7, RStdRng(0x10))
    rprover, rverifier = rplonk.Compiler.compile(rpp, b"range-logic",
                                                 RRangeLogic)
    ref = rprover.prove(RStdRng(7), RRangeLogic())
    pp = PublicParameters.setup(1 << 7, StdRng(0x10), "cpu")
    prover, verifier = Compiler.compile(pp, b"range-logic",
                                        RangeLogicCircuit)
    port = prover.prove(StdRng(7), RangeLogicCircuit())
    return (rprover, rverifier, ref), (prover, verifier, port)


def test_bundles_equal_the_reference(both):
    (rprover, rverifier, _), (prover, verifier, _) = both
    assert prover.to_bytes() == rprover.to_bytes()
    assert verifier.to_bytes() == rverifier.to_bytes()


def test_proof_bytes_equal_the_reference_and_verify(both):
    (_, rverifier, (rproof, rpis)), (_, verifier, (proof, pis)) = both
    assert proof.to_bytes() == rproof.to_bytes()
    verifier.verify(Proof.from_bytes(proof.to_bytes()), pis)
    rverifier.verify(rplonk.Proof.from_bytes(proof.to_bytes()),
                     [RFr(p.value) for p in pis])
