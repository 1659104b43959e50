"""The port's transforms take the staged route, and that route only ever
sees canonical operands.

`kernels.ntt_stages` assumes every element of its operand below r: its
first stage pair adds and subtracts the inputs with no product
(`csrc/ntt.cu`, `butterfly_one`), where the matmul route and the plain
version reduce any 256-bit limb vector.  `Domain`'s transforms and
`DistributedDomain`'s local FFTs reach the kernel through
`ntt.butterfly_transform`, which this file wraps to check every operand it
receives (each element < r, through `lf`'s borrow chain) on four paths:

  * the gate-1 prove of `tests/fixtures/prover_bundle_v1.bin`
    (`FixedCircuit`, `StdRng(5)`), checked by the port's verifier;
  * a compile (`setup(2^6)`, `StdRng(1234)`, label b"fixture"), whose
    bundles must be the committed fixtures;
  * the same prove over a 2-shard mesh (distributed transforms: the local
    FFTs of the all_to_all shards);
  * one leaf of the batch service at height 1 and capacity 10 (the
    smallest of `tests/test_torch_service.py`): setup, compile and prove.

The commitments and the SRS setup's products of these paths are computed
by the native host MSM in place of the device MSM and fixed-base products
(whose plain versions take seconds on the CPU and reach no transform): the
same points, so the same transcript and the same transform operands; the
compile's bytes show it.  `tests/test_torch_prover.py`, `test_torch_
compiler.py` and `test_torch_mesh_prove.py` run the device paths.

Then the route itself: each of `Domain`'s four transforms, and
`DistributedDomain`'s over two shards, against the matmul route
(`ntt_mxu.MXUTransform` under the same scalings) and the JAX package's
`Domain`, at 2^1 .. 2^10, bit for bit, each a case of its own.
"""

import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_tpu.ops import ntt as rntt
from zkvm_tpu_torch.curves.g1 import G1Projective
from zkvm_tpu_torch.fields import Fp, Fr
from zkvm_tpu_torch.merkle import Item, PoseidonTree
from zkvm_tpu_torch.native import native_msm
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops import g1_ops, ntt, ntt_mxu, ntt_sharded
from zkvm_tpu_torch.ops.collective import Mesh
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.plonk import Compiler, Prover, PublicParameters, Verifier
from zkvm_tpu_torch.plonk import kzg10
from zkvm_tpu_torch.rng import StdRng
from zkvm_tpu_torch.service import batch, formats

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_plonk_host import FixedCircuit  # noqa: E402

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
Q = FR.modulus
NAMES = ("fft_device", "ifft_device", "coset_fft_device", "coset_ifft_device")


def _canonical(t: torch.Tensor) -> bool:
    """Every element of a [..., 8, n] limb tensor is below r: the borrow
    out of x - r, through `lf`'s chain, is set in every lane."""
    x = lf.split16(t.reshape(-1, FR.n_limbs, t.shape[-1]))
    _, under = lf._borrow_sub(x, lf.const16(FR, FR.p_limbs, x))
    return bool(under.all())


def _native(points, scalars) -> G1Projective:
    x, y, inf = native_msm(points, scalars)
    return (G1Projective.identity() if inf
            else G1Projective(Fp(x), Fp(y), Fp.one()))


def _native_commit_many_mont(self, tensors, mesh=None, axis=None):
    """`CommitKey.commit_many_mont` by the native host MSM."""
    return [kzg10.Commitment(_native(
        self.powers_of_g[:t.shape[-1]],
        [Fr(v) for v in FR.from_mont_array(t)])) for t in tensors]


def _native_scalar_mul_base(base, scalars, device):
    """`g1_ops.batch_scalar_mul_base` (the SRS setup) by the native host
    MSM, one point a product."""
    return G1Projective.batch_normalize([_native([base], [s])
                                         for s in scalars])


@pytest.fixture
def operands(monkeypatch):
    """Every operand `ntt.butterfly_transform` receives: (shape, canonical)."""
    seen = []
    real = ntt.butterfly_transform

    def recording(domain, x, inverse=False):
        seen.append((tuple(x.shape), _canonical(x)))
        return real(domain, x, inverse)

    monkeypatch.setattr(ntt, "butterfly_transform", recording)
    monkeypatch.setattr(kzg10.CommitKey, "commit_many_mont",
                        _native_commit_many_mont)
    monkeypatch.setattr(g1_ops, "batch_scalar_mul_base",
                        _native_scalar_mul_base)
    return seen


def _all_canonical(seen, sizes):
    assert seen, "no transform ran"
    assert {shape[-1] for shape, _ in seen} >= set(sizes), seen
    assert all(ok for _, ok in seen), [s for s, ok in seen if not ok]


def test_prove_feeds_the_route_canonical_operands(operands):
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    prover = Prover.try_from_bytes(pb, "cpu")
    proof, pis = prover.prove(StdRng(5), FixedCircuit())
    _all_canonical(operands, {prover.size, 8 * prover.size})
    Verifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes()).verify(proof, pis)


def test_compile_feeds_the_route_canonical_operands(operands):
    pp = PublicParameters.setup(1 << 6, StdRng(1234), "cpu")
    prover, verifier = Compiler.compile_with_circuit(pp, b"fixture",
                                                     FixedCircuit())
    assert prover.to_bytes() == (FIXTURES /
                                 "prover_bundle_v1.bin").read_bytes()
    assert verifier.to_bytes() == (FIXTURES /
                                   "verifier_bundle_v1.bin").read_bytes()
    _all_canonical(operands, {prover.size, 8 * prover.size})


def test_mesh_prove_feeds_the_route_canonical_operands(operands):
    pb = (FIXTURES / "prover_bundle_v1.bin").read_bytes()
    prover = Prover.try_from_bytes(pb, "cpu")
    mesh = Mesh(["cpu"] * 2, ("shards",))
    proof, pis = prover.prove(StdRng(5), FixedCircuit(), mesh=mesh,
                              shard_axis="shards")
    # the local FFTs of the shards: N1 and N2 of n and of 8n
    dds = [ntt_sharded.DistributedDomain(m, mesh, "shards")
           for m in (prover.size, 8 * prover.size)]
    assert not any(dd.local for dd in dds)
    _all_canonical(operands, {k for dd in dds for k in (dd.n1, dd.n2)})
    Verifier.try_from_bytes(
        (FIXTURES / "verifier_bundle_v1.bin").read_bytes()).verify(proof, pis)


def test_service_leaf_feeds_the_route_canonical_operands(operands, tmp_path):
    """One good leaf of a height-1 tree through the service's batch entry:
    setup 2^10, compile, prove, verify, files written."""
    tree = PoseidonTree(1)
    for i in range(3):
        tree.insert(i, Item(Fr(1000 + i), None))
    (tmp_path / "merkle_some.bin").write_bytes(formats.MultipleLeavesData(
        tree.root().hash.to_bytes(),
        [formats.LeafInfo(1, Fr(1001).to_bytes(),
                          tree.opening(1).to_var_bytes())]).to_rkyv_bytes())
    config = batch.BatchProofConfig(
        merkle_input_file=str(tmp_path / "merkle_some.bin"),
        circuit_cache_file=str(tmp_path / "circuit_prove.bin"),
        verifier_file=str(tmp_path / "verifier.bin"),
        output_dir=str(tmp_path / "out"), capacity=10, tree_height=1,
        device="cpu")
    assert batch.process_batch_proofs_with_config(config) == 1
    assert len(list((tmp_path / "out").iterdir())) == 2
    _all_canonical(operands, {1 << 10, 1 << 13})


# -- the route against the matmul route and the reference ---------------------

def _values(count, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(count, 5), dtype=np.uint64)
    return [sum(int(w) << (63 * k) for k, w in enumerate(row)) % Q
            for row in words.tolist()]


def _matmul_run(self, x, inverse):
    """`Domain._run` by the matmul route."""
    if self.size == 1:
        return x
    root = self.group_gen_inv if inverse else self.group_gen
    return ntt_mxu.MXUTransform(self.size, root)(x)


@functools.lru_cache(maxsize=None)
def _cases(log_n: int, name: str):
    """Two seeded rows [2, 8, n], the matmul route's transform of them
    under `Domain`'s scalings, and the JAX package's Domain's (one row a
    call) in the reference's layout [16, 2, n].  The JAX package runs its
    staged route (`ZKVM_NTT_IMPL=butterfly`, the route of the Pallas kernel
    that `ntt_stages` replaces; `tests/test_torch_ntt.py` holds its matmul
    route against the port's): one compiled program a size, where its
    matmul route's carry scan costs most of a second a call on the CPU."""
    n = 1 << log_n
    x = FR.to_mont_array(_values(2 * n, 1000 * log_n + NAMES.index(name)),
                         "cpu").reshape(FR.n_limbs, 2, n).transpose(0, 1)
    x = x.contiguous()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ntt.Domain, "_run", _matmul_run)
        mp.setenv("ZKVM_NTT_IMPL", "butterfly")
        matmul = getattr(ntt.Domain(n), name)(x)
        rfn = getattr(rntt.Domain(n), name)
        ref = np.stack([np.asarray(rfn(jnp.asarray(lf.to_reference(
            x[g], FR)))) for g in range(2)], axis=1)
    return x, matmul, ref


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("log_n", range(1, 11))
@pytest.mark.parametrize("kind", ["Domain", "DistributedDomain"])
def test_transforms_equal_the_matmul_route_and_the_reference(
        kind, log_n, name, monkeypatch):
    x, matmul, ref = _cases(log_n, name)
    n = 1 << log_n
    calls = []
    real = ntt.butterfly_transform

    def counting(domain, t, inverse=False):
        calls.append(t.shape[-1])
        return real(domain, t, inverse)

    monkeypatch.setattr(ntt, "butterfly_transform", counting)
    dom = (ntt.Domain(n) if kind == "Domain" else
           ntt_sharded.DistributedDomain(n, Mesh(["cpu"] * 2, ("x",))))
    got = getattr(dom, name)(x)
    assert torch.equal(got, matmul)
    assert (lf.to_reference_lead(got, FR) == ref).all()
    assert calls  # the staged route ran
    if kind == "DistributedDomain" and not dom.local:
        assert set(calls) == {dom.n1, dom.n2}
