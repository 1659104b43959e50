"""The port's mesh (`ops.collective`, `ops.ntt_sharded`, the sharded
quotient and the Merkle forest) against zkvm_tpu's, bit for bit.

The reference runs on the eight virtual CPU devices that `conftest.py`
gives JAX; the port's mesh is logical shards on `cpu` (the same device
named once per shard).  The same numpy-seeded Montgomery values go through
both; tolerance zero everywhere: `to_reference` of the port's tensor equals
the reference's array.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RMesh

from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import collective as rcollective
from zkvm_tpu.ops import limb_field as rlf
from zkvm_tpu.ops import ntt_sharded as rntt_sharded
from zkvm_tpu.plonk import quotient as rquotient
import zkvm_tpu.ops.ntt as rntt
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import poseidon
from zkvm_tpu_torch.ops.collective import Mesh, sharded_scan_mul
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.ops.ntt import Domain
from zkvm_tpu_torch.ops.ntt_sharded import DistributedDomain
from zkvm_tpu_torch.plonk import dpoly, quotient
from zkvm_tpu_torch.utils.dryrun import forest_root

torch.set_num_threads(1)

P = FR.modulus


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.uint64).tolist()
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % P
            for row in words]


def _mesh(n_shards):
    return Mesh(["cpu"] * n_shards, ("x",))


def _ref_mesh(n_shards):
    devices = jax.devices()
    if len(devices) < n_shards:
        pytest.skip(f"the reference needs {n_shards} virtual devices")
    return RMesh(devices[:n_shards], ("x",))


def _same(port, ref) -> bool:
    return (lf.to_reference(port, FR) == np.asarray(ref)).all()


def test_mesh_collectives_move_the_parts_they_name():
    mesh = _mesh(4)
    assert mesh.size == 4 and mesh.home == torch.device("cpu")
    assert mesh.axis() == mesh.axis("x") == "x"
    with pytest.raises(ValueError):
        mesh.axis("y")
    x = torch.arange(2 * 16, dtype=torch.int32).reshape(2, 16)
    parts = mesh.split(x)
    assert [tuple(p.shape) for p in parts] == [(2, 4)] * 4
    assert torch.equal(mesh.gather(parts), x)
    stacks = mesh.all_gather([p[:, :1] for p in parts])
    assert len(stacks) == 4
    assert all(torch.equal(s, x[:, 0:16:4].T.reshape(4, 2, 1))
               for s in stacks)
    # shard j gets chunk j of every shard's last axis, in shard order
    out = mesh.all_to_all(parts, split_dim=-1, concat_dim=0)
    for j, o in enumerate(out):
        assert torch.equal(o, torch.cat([p[:, j:j + 1] for p in parts], 0))
    with pytest.raises(ValueError):
        mesh.split(x[:, :10])
    with pytest.raises(ValueError):
        Mesh(["cpu"], ("x", "y"))
    assert _mesh(2) == Mesh([torch.device("cpu")] * 2, ("x",))
    assert hash(_mesh(2)) == hash(Mesh(["cpu", "cpu"], ("x",)))


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_scan_mul_matches_reference(n_shards, reverse):
    vals = _ints(64, n_shards + 10 * reverse)
    vals[5] = 0
    x = FR.to_mont_array(vals, "cpu")
    got = sharded_scan_mul(x, _mesh(n_shards), reverse)
    assert torch.equal(got, dpoly.prefix_products(x, reverse))
    want = rcollective.sharded_scan_mul(rlf.FR.to_mont_array(vals),
                                        _ref_mesh(n_shards), "x", reverse)
    assert _same(got, want)


# the cases of tests/test_sharded.py: splits, a lifted N1, and the local
# fallback of a non-pow-2 mesh
DD_CASES = [(1 << 10, 2), (1 << 10, 8), (1 << 12, 4), (1 << 12, 8), (64, 8),
            (1 << 10, 3)]


@pytest.mark.parametrize("n,n_shards", DD_CASES,
                         ids=[f"{n}x{d}" for n, d in DD_CASES])
def test_distributed_domain_matches_reference(n, n_shards):
    vals = _ints(n, n * n_shards)
    x = FR.to_mont_array(vals, "cpu")
    dd = DistributedDomain(n, _mesh(n_shards))
    assert dd.local == (n_shards == 3)
    assert DistributedDomain(n, _mesh(n_shards), "x") is dd
    rdd = rntt_sharded.DistributedDomain(n, _ref_mesh(n_shards))
    rx = rlf.FR.to_mont_array(vals)
    dom = Domain(n)
    for name in ("fft_device", "ifft_device", "coset_fft_device",
                 "coset_ifft_device"):
        got = getattr(dd, name)(x)
        assert torch.equal(got, getattr(dom, name)(x)), name
        assert _same(got, getattr(rdd, name)(rx)), name


def test_distributed_domain_takes_leading_axes():
    n = 1 << 8
    x = FR.to_mont_array(_ints(3 * n, 3), "cpu").reshape(8, 3, n)
    x = x.transpose(0, 1).contiguous()  # [3, 8, n]
    dd = DistributedDomain(n, _mesh(4))
    assert torch.equal(dd.coset_fft_device(x), Domain(n).coset_fft_device(x))
    assert torch.equal(dd.ifft_device(x), Domain(n).ifft_device(x))


def _fake_key(fr, n, seed):
    """The parts of a ProverKey that the quotient reads (selector and sigma
    evaluations over the 8n coset, Z_H there, the linear evaluations), as
    random values in `fr`'s class: the quotient's arithmetic does not ask
    that they come from a circuit."""
    m = 8 * n
    vals = iter(_ints(17 * m, seed))
    key = SimpleNamespace()
    for fam, name in quotient._SELECTOR_PAIRS:
        evals = SimpleNamespace(evals=[fr(next(vals)) for _ in range(m)])
        if not hasattr(key, fam):
            setattr(key, fam, SimpleNamespace())
        setattr(getattr(key, fam), name, (None, evals))
    key.v_h_coset_8n = SimpleNamespace(evals=[fr(next(vals))
                                              for _ in range(m)])
    key.permutation.linear_evaluations = SimpleNamespace(
        evals=[fr(next(vals)) for _ in range(m)])
    return key


@pytest.mark.parametrize("n_shards", [4, 8])
def test_build_quotient_device_on_a_mesh_matches_reference(n_shards):
    n = 32  # 8n = 2^8
    rng_seed = 100 + n_shards
    lens = (n + 2, n + 2, n + 2, n + 2, n + 3, n)
    polys = [_ints(m, rng_seed + i) for i, m in enumerate(lens)]
    chals = _ints(7, rng_seed + 9)
    ppolys = [FR.to_mont_array(v, "cpu") for v in polys]
    pk = _fake_key(Fr, n, 5)
    mesh = _mesh(n_shards)
    args = (ppolys[4], tuple(ppolys[:4]), ppolys[5],
            tuple(Fr(c) for c in chals))
    got = quotient.build_quotient_device(Domain(n), pk, *args, mesh=mesh,
                                         axis="x")
    assert got.shape == (8, 8 * n)
    assert torch.equal(got, quotient.build_quotient_device(Domain(n), pk,
                                                           *args))
    rpolys = [rlf.FR.to_mont_array(v) for v in polys]
    want = rquotient.build_quotient_device(
        rntt.Domain(n), _fake_key(RFr, n, 5), rpolys[4], tuple(rpolys[:4]),
        rpolys[5], tuple(RFr(c) for c in chals))
    assert _same(got, want)
    # each shard's slice of the key's tables is cached once per mesh
    cache = quotient._mesh_cache(pk, mesh)
    assert quotient._mesh_cache(pk, _mesh(n_shards)) is cache
    assert len(cache) == n_shards


def test_forest_root_on_four_shards_is_the_tree_root():
    leaves = FR.to_mont_array(list(range(1, 65)), "cpu")
    root = forest_root(leaves, _mesh(4))
    assert torch.equal(root, poseidon.merkle_tree_levels(leaves)[-1])
