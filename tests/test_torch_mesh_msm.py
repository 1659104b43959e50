"""The port's sharded MSM (`msm_sharded`, `MSMContext.msm_many_mont(mesh=)`)
against zkvm_tpu's, as group elements.

The reference's `msm_sharded` runs on the virtual CPU devices of
`conftest.py`, the port's on logical shards on `cpu`; both take the same
numpy-seeded points and scalars (a zero scalar among them).  Each shard of
the port pads to `_granule(ceil(n / D))` and runs the scan pipeline, so
results are compared through canonical compressed bytes, tolerance zero.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RMesh

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.curves.msm import msm_variable_base as ref_msm_variable_base
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import msm as rmsm
from zkvm_tpu_torch.curves.g1 import G1Projective
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import msm
from zkvm_tpu_torch.ops.collective import Mesh
from zkvm_tpu_torch.ops.limb_field import FR

torch.set_num_threads(1)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    g = G1Projective.generator()
    a = g * int(rng.integers(1, 1 << 62))
    s = g * int(rng.integers(1, 1 << 62))
    out = []
    for _ in range(n):
        out.append(a)
        a = a + s
    return G1Projective.batch_normalize(out)


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    out = [Fr(sum(int(w) << (63 * k) for k, w in enumerate(row)))
           for row in words]
    out[0] = Fr.zero()
    return out


def _ref(points, scalars):
    return ([RG1Affine(RFp(p.x.value), RFp(p.y.value)) for p in points],
            [RFr(s.value) for s in scalars])


def _bytes(point) -> bytes:
    return point.to_affine().to_bytes()


@pytest.fixture(scope="module")
def inputs():
    points, scalars = _points(300, 1), _scalars(300, 2)
    want = _bytes(ref_msm_variable_base(*_ref(points, scalars)))
    return points, scalars, want


@pytest.mark.parametrize("n_shards", [4, 8])
def test_msm_sharded_matches_reference(inputs, n_shards):
    points, scalars, want = inputs
    devices = jax.devices()
    if len(devices) < n_shards:
        pytest.skip(f"the reference needs {n_shards} virtual devices")
    got = msm.msm_sharded(points, scalars, Mesh(["cpu"] * n_shards, ("pts",)),
                          axis="pts")
    assert _bytes(got) == want
    rgot = rmsm.msm_sharded(*_ref(points, scalars),
                            RMesh(devices[:n_shards], ("pts",)), axis="pts")
    assert _bytes(rgot) == want


def test_msm_many_mont_on_a_mesh_matches_reference(inputs):
    points, scalars, _ = inputs
    sets = [scalars, _scalars(200, 3)]
    ctx = msm.MSMContext(points, "cpu")
    tensors = [FR.to_mont_array([s.value for s in ss], "cpu") for ss in sets]
    got = ctx.msm_many_mont(tensors, mesh=Mesh(["cpu"] * 4))
    single = ctx.msm_many_mont(tensors)
    for g, s, ss in zip(got, single, sets):
        want = _bytes(ref_msm_variable_base(*_ref(points[:len(ss)], ss)))
        assert _bytes(g) == _bytes(s) == want
    # the mesh's home must hold the points
    with pytest.raises(ValueError):
        ctx.msm_many_mont(tensors, mesh=Mesh(["meta"] * 2))
