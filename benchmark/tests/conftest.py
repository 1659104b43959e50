"""Fixtures of the benchmark's CPU tests.

On the CPU the port's commit MSM is its plain 16-bit-limb version, some
seconds a call at 2^10; these tests replace `CommitKey.commit_many_mont`
by the port's native host MSM over the same points (`host_commits`),
which gives the same points, so that a setup, a compile and proves at
height 1 take seconds.  Tests that need the card are marked `gpu` and
decide inside the test.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def host_commits(key, tensors, mesh=None, axis=None):
    """`commit_many_mont` through the native host MSM."""
    from zkvm_tpu_torch.curves.g1 import G1Affine
    from zkvm_tpu_torch.fields import Fp, Fr
    from zkvm_tpu_torch.native import native_msm
    from zkvm_tpu_torch.ops.limb_field import FR
    from zkvm_tpu_torch.plonk.kzg10 import Commitment

    out = []
    for t in tensors:
        vals = FR.from_mont_array(t)
        x, y, inf = native_msm(key.powers_of_g[:len(vals)],
                               [Fr(v) for v in vals])
        out.append(Commitment(G1Affine.identity() if inf
                              else G1Affine(Fp(x), Fp(y))))
    return out


@pytest.fixture(scope="session")
def fast_commits():
    from zkvm_tpu_torch.plonk import kzg10

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kzg10.CommitKey, "commit_many_mont", host_commits)
        yield


@pytest.fixture(scope="session")
def compiled(fast_commits):
    """(pp, prover, verifier): SRS 2^10 from StdRng(5) and the height-1
    opening circuit, compiled on the CPU."""
    from zkvm_tpu_torch.plonk import Compiler, PublicParameters
    from zkvm_tpu_torch.rng import StdRng
    from zkvm_tpu_torch.service.batch import OpeningCircuit

    pp = PublicParameters.setup(1 << 10, StdRng(5), "cpu")
    prover, verifier = Compiler.compile_with_circuit(
        pp, b"opening-circuit", OpeningCircuit.default_for_height(1))
    return pp, prover, verifier
