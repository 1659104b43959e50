"""Gate 2 on the CPU: the port's dryrun proof is the committed fixture.

The port's own copy of the dryrun contract (`zkvm_tpu_torch/utils/
dryrun.py`: the height-1 opening circuit, setup 2^11 under `StdRng(42)`,
label b"dryrun", prove under `StdRng(7)`) runs setup, compile and prove on
the CPU and must give `tests/fixtures/dryrun_proof_v1.bin` byte for byte,
public inputs included, and verify.  Marked `slow`: the setup at 2^11 and
the commitments on the plain CPU path take minutes.  `chip_smoke.py` holds
the same fixture on the card.
"""

import pytest
import torch

from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.plonk import PlonkError
from zkvm_tpu_torch.utils import dryrun

torch.set_num_threads(1)


@pytest.mark.slow
def test_dryrun_proof_equals_the_fixture_on_cpu():
    prover, verifier = dryrun.dryrun_prover("cpu")
    assert prover.device == torch.device("cpu")
    proof, pis = dryrun.prove_dryrun(prover)
    proof_bytes, fixture_pis = dryrun.load_fixture()
    assert proof.to_bytes() == proof_bytes
    assert [p.to_bytes() for p in pis] == [p.to_bytes() for p in fixture_pis]
    verifier.verify(proof, pis)
    with pytest.raises(PlonkError):
        verifier.verify(proof, [pis[0] + Fr.one()] + pis[1:])
