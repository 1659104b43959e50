"""The canonical dryrun circuit + fixture contract, on the port.

The port's own copy of `zkvm_tpu/utils/dryrun.py`: the same circuit (a
height-1 Poseidon-tree membership opening), the same seeds (setup 42,
prove 7), capacity and label, so the proof bytes must equal the committed
fixture `tests/fixtures/dryrun_proof_v1.bin` byte for byte.  Setup, compile
and prove run on the device the caller names.  `load_fixture` reads the
fixture and `write_fixture` writes it (`tools/gen_dryrun_fixture.py`).

`dryrun_multichip(mesh)` is the port's counterpart of the reference's
`__graft_entry__.dryrun_multichip`: it runs the sharded pipelines over a
`Mesh` and holds each against its single-device counterpart.
"""

from __future__ import annotations

import os
import random

import torch

SETUP_SEED = 42
PROVE_SEED = 7
CAPACITY = 1 << 11
LABEL = b"dryrun"

FIXTURE_RELPATH = os.path.join("tests", "fixtures", "dryrun_proof_v1.bin")


def dryrun_circuit():
    """Build the canonical opening circuit (fresh instance each call)."""
    from ..fields import Fr
    from ..merkle.poseidon_tree import Item, PoseidonTree
    from ..service.batch import OpeningCircuit

    tree = PoseidonTree(1)
    for i in range(3):
        tree.insert(i, Item(Fr(1000 + i)))
    leaf = Item(Fr(1002))
    opening = tree.opening(2)
    return OpeningCircuit(opening, leaf)


def dryrun_prover(device):
    """Setup + compile the dryrun circuit on `device`; returns (prover,
    verifier)."""
    from ..plonk import Compiler, PublicParameters
    from ..rng import StdRng

    pp = PublicParameters.setup(CAPACITY, StdRng(SETUP_SEED), device)
    return Compiler.compile_with_circuit(pp, LABEL, dryrun_circuit())


def prove_dryrun(prover):
    """Run the canonical deterministic prove; returns (proof, pis)."""
    from ..rng import StdRng

    return prover.prove(StdRng(PROVE_SEED), dryrun_circuit())


def fixture_path(repo_root: str | None = None) -> str:
    if repo_root is None:
        repo_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 os.pardir, os.pardir)
    return os.path.join(repo_root, FIXTURE_RELPATH)


def load_fixture(path: str | None = None) -> tuple[bytes, list] | None:
    """Read + validate the committed fixture; None when absent.

    Returns (proof_bytes, public_inputs) -- a truncated or corrupt file
    raises instead of yielding short bytes."""
    from ..fields import Fr
    from ..plonk.proof import Proof

    path = path or fixture_path()
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 4:
        raise ValueError(f"dryrun fixture truncated ({len(buf)} bytes)")
    plen = int.from_bytes(buf[:4], "little")
    if plen != Proof.SIZE or len(buf) < 4 + plen + 4:
        raise ValueError(
            f"dryrun fixture corrupt: proof len {plen} (expected "
            f"{Proof.SIZE}), file {len(buf)} bytes")
    proof_bytes = buf[4: 4 + plen]
    off = 4 + plen
    n_pis = int.from_bytes(buf[off: off + 4], "little")
    off += 4
    if len(buf) != off + 32 * n_pis:
        raise ValueError("dryrun fixture corrupt: bad public-input tail")
    pis = [Fr.from_bytes(buf[off + 32 * i: off + 32 * (i + 1)])
           for i in range(n_pis)]
    return proof_bytes, pis


def write_fixture(proof, pis, path: str | None = None) -> int:
    """Write `proof` (a `Proof` or its bytes) and its public inputs in the
    fixture's layout -- u32 LE proof length, the proof, u32 LE count, 32
    bytes an input -- to `path` (default: the committed fixture), the
    inverse of `load_fixture`; returns the bytes written."""
    pb = proof if isinstance(proof, bytes) else proof.to_bytes()
    w = bytearray()
    w += len(pb).to_bytes(4, "little") + pb
    w += len(pis).to_bytes(4, "little")
    for s in pis:
        w += s.to_bytes()
    with open(path or fixture_path(), "wb") as f:
        f.write(w)
    return len(w)


def forest_root(leaves: torch.Tensor, mesh) -> torch.Tensor:
    """The Merkle forest over `mesh`: each shard folds its part of the
    [8, n] leaves (on the home device; n / D a power of 4) to one root with
    `merkle4_digest_batch`, the local roots are gathered, zero-padded to a
    power of 4 and folded.  Returns the [8, 1] root on the home device; for
    a power-of-4 shard count it is `merkle_tree_levels`' root."""
    from ..ops import poseidon
    from ..ops.limb_field import FR

    def fold(cur):
        while cur.shape[-1] > 1:
            m = cur.shape[-1]
            cur = poseidon.merkle4_digest_batch(
                cur.reshape(FR.n_limbs, m // 4, 4).permute(2, 0, 1))
        return cur

    roots = mesh.gather([fold(part) for part in mesh.split(leaves)])
    width = 1
    while width < roots.shape[-1]:
        width *= 4
    return fold(torch.nn.functional.pad(roots, (0, width - roots.shape[-1])))


def dryrun_multichip(mesh) -> None:
    """The sharded pipelines over `mesh`, each against its single-device
    counterpart (raises AssertionError on a mismatch):

      * the Merkle forest of 16 leaves a shard (`forest_root`), against
        `merkle_tree_levels` where the shard count is 1, 4 or 16;
      * `msm_sharded` of 24 points against the host `msm_variable_base`;
      * `DistributedDomain` fft and coset ifft against `Domain`;
      * the mesh prove of the dryrun circuit, whose bytes must equal the
        committed fixture (or, without it, the single-device proof), and
        its verification."""
    from ..curves.g1 import G1Affine
    from ..curves.msm import msm_variable_base
    from ..fields import Fr
    from ..ops import poseidon
    from ..ops.limb_field import FR
    from ..ops.msm import msm_sharded
    from ..ops.ntt import Domain
    from ..ops.ntt_sharded import DistributedDomain
    from ..rng import StdRng

    n_dev = mesh.size
    leaves = FR.to_mont_array(list(range(1, 16 * n_dev + 1)), mesh.home)
    root = forest_root(leaves, mesh)
    if n_dev in (1, 4, 16) and not torch.equal(
            root, poseidon.merkle_tree_levels(leaves)[-1]):
        raise AssertionError("sharded merkle root mismatch")

    rng = random.Random(7)
    pts = [(G1Affine.generator() * Fr(rng.randrange(Fr.MODULUS))).to_affine()
           for _ in range(24)]
    scs = [Fr(rng.randrange(Fr.MODULUS)) for _ in range(24)]
    if msm_sharded(pts, scs, mesh) != msm_variable_base(pts, scs):
        raise AssertionError("sharded MSM mismatch")

    n_fft = max(64, 16 * n_dev * n_dev)
    x = FR.to_mont_array([rng.randrange(Fr.MODULUS) for _ in range(n_fft)],
                         mesh.home)
    dd, dom = DistributedDomain(n_fft, mesh), Domain(n_fft)
    if not torch.equal(dd.fft_device(x), dom.fft_device(x)):
        raise AssertionError("distributed NTT mismatch")
    if not torch.equal(dd.coset_ifft_device(x), dom.coset_ifft_device(x)):
        raise AssertionError("distributed coset iNTT mismatch")

    prover, verifier = dryrun_prover(mesh.home)
    loaded = load_fixture()
    if loaded is not None:
        ref_bytes = loaded[0]
    else:
        ref_bytes = prove_dryrun(prover)[0].to_bytes()
    proof, pis = prover.prove(StdRng(PROVE_SEED), dryrun_circuit(),
                              mesh=mesh)
    if proof.to_bytes() != ref_bytes:
        raise AssertionError("the mesh proof differs from the single-device "
                             "proof")
    verifier.verify(proof, pis)
