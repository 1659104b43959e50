"""The canonical dryrun circuit + fixture contract, on the port.

The port's own copy of `zkvm_tpu/utils/dryrun.py`: the same circuit (a
height-1 Poseidon-tree membership opening), the same seeds (setup 42,
prove 7), capacity and label, so the proof bytes must equal the committed
fixture `tests/fixtures/dryrun_proof_v1.bin` byte for byte.  Setup, compile
and prove run on the device the caller names.
"""

from __future__ import annotations

import os

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
