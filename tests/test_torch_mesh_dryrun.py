"""Gate 2 on a mesh, on the CPU: `dryrun_multichip` over logical shards.

The port's counterpart of `__graft_entry__.dryrun_multichip` runs the
Merkle forest, `msm_sharded`, the distributed transforms and the mesh
prove of the dryrun circuit (setup 2^11 under `StdRng(42)`, prove under
`StdRng(7)`) on a mesh of 2 and of 4 shards on `cpu`; the proof bytes must
equal `tests/fixtures/dryrun_proof_v1.bin` and verify.  Marked `slow`: the
setup, compile and the sharded commitments on the plain CPU path take
minutes.  `chip_smoke.py` runs it on the card at 2, 4 and 8 shards.
"""

import pytest
import torch

from zkvm_tpu_torch.ops.collective import Mesh
from zkvm_tpu_torch.utils import dryrun

torch.set_num_threads(1)


@pytest.mark.slow
@pytest.mark.parametrize("n_shards", [2, 4])
def test_dryrun_multichip_equals_the_fixture_on_cpu(n_shards):
    assert dryrun.load_fixture() is not None
    dryrun.dryrun_multichip(Mesh(["cpu"] * n_shards, ("leaves",)))
