"""Batch Merkle-membership proving service (merkle-plonk/src/lib.rs parity).

The port's counterpart of `zkvm_tpu/service/batch.py`: the same circuits,
configuration, circuit cache and batch loop, with the same file names and
bytes.  The reference pulls TREE_HEIGHT/CAPACITY/file paths from a missing
external `common` crate (merkle-plonk/Cargo.toml:35); here they are
ordinary fields of BatchProofConfig, which also names the device that
proves (`"cuda"` unless the caller asks for another; nothing probes for a
card or falls back to the CPU).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

from ..fields import Fr
from ..merkle import Item
from ..merkle.poseidon_tree import (PoseidonTree, opening_gadget,
                                    poseidon_opening_from_slice)
from ..plonk import (Circuit, Compiler, Composer, Constraint, Prover,
                     PublicParameters, Verifier)
from ..rng import OsRng, StdRng
from ..utils import metrics
from .formats import (MultipleLeavesData, ZKProofData, prover_cache_from_bytes,
                      prover_cache_to_bytes)

log = logging.getLogger("zkvm_tpu_torch.service")

# the reference's defaults, kept for parity: capacity 13 holds the opening
# circuit up to height 8 only; height 17 needs capacity 15
DEFAULT_TREE_HEIGHT = 17  # the missing `common` crate's TREE_HEIGHT analogue
DEFAULT_CAPACITY = 13


@dataclass
class BatchProofConfig:
    """Runtime configuration (merkle-plonk/src/lib.rs:25-49), plus the
    device that compiles and proves."""

    merkle_input_file: str = "merkle_some.bin"
    circuit_cache_file: str = "circuit_prove.bin"
    verifier_file: str = "verifier.bin"
    output_dir: str = "."
    proof_file_prefix: str = "plonk_proof_"
    public_inputs_file_prefix: str = "plonk_publicinputs_"
    capacity: int = DEFAULT_CAPACITY
    tree_height: int = DEFAULT_TREE_HEIGHT
    device: str = "cuda"


class OpeningCircuit(Circuit):
    """Merkle membership circuit (merkle-plonk/src/lib.rs:89-131)."""

    def __init__(self, opening, leaf: Item):
        self.opening = opening
        self.leaf = leaf

    @classmethod
    def default_for_height(cls, height: int) -> "OpeningCircuit":
        empty = Item(Fr.zero(), None)
        tree = PoseidonTree(height)
        tree.insert(0, empty)
        return cls(tree.opening(0), empty)

    def circuit(self, composer: Composer) -> None:
        leaf = composer.append_witness(self.leaf.hash)
        computed_root = opening_gadget(composer, self.opening, leaf)
        composer.append_gate(
            Constraint().left(-Fr.one()).a(computed_root)
            .public(self.opening.root.hash))


class MultiOpeningCircuit(Circuit):
    """K independent Merkle-membership checks in ONE circuit -- the
    BASELINE flagship shape (a 2^16-gate domain at K ~ 21, height 3).
    Each opening contributes its own public root input, so one proof
    attests K memberships (the batched-service analogue of proving
    merkle-plonk's OpeningCircuit K times)."""

    def __init__(self, openings_and_leaves):
        self.parts = list(openings_and_leaves)

    @classmethod
    def default_for(cls, height: int, count: int) -> "MultiOpeningCircuit":
        empty = Item(Fr.zero(), None)
        tree = PoseidonTree(height)
        tree.insert(0, empty)
        return cls([(tree.opening(0), empty)] * count)

    def circuit(self, composer: Composer) -> None:
        for opening, leaf in self.parts:
            leaf_w = composer.append_witness(leaf.hash)
            computed_root = opening_gadget(composer, opening, leaf_w)
            composer.append_gate(
                Constraint().left(-Fr.one()).a(computed_root)
                .public(opening.root.hash))


def load_or_compile_opening_circuit(
        config: BatchProofConfig) -> tuple[Prover, Verifier]:
    """Disk circuit cache keyed by SRS capacity
    (merkle-plonk/src/lib.rs:152-227).  The prover proves on
    `config.device`."""
    try:
        with open(config.circuit_cache_file, "rb") as f:
            cached = f.read()
        capacity, prover_bytes = prover_cache_from_bytes(cached)
        if capacity == config.capacity:
            with open(config.verifier_file, "rb") as f:
                verifier_bytes = f.read()
            with metrics.phase("service/cache_load"):
                prover = Prover.try_from_bytes(prover_bytes, config.device)
                verifier = Verifier.try_from_bytes(verifier_bytes)
            log.info("loaded cached prover/verifier (capacity %d)", capacity)
            return prover, verifier
        log.info("capacity mismatch: cached=%d configured=%d",
                 capacity, config.capacity)
    except FileNotFoundError:
        pass

    for path in (config.circuit_cache_file, config.verifier_file):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    with metrics.phase("service/setup"):
        pp = PublicParameters.setup(1 << config.capacity, OsRng(),
                                    config.device)
    circuit = OpeningCircuit.default_for_height(config.tree_height)
    with metrics.phase("service/compile"):
        prover, verifier = Compiler.compile_with_circuit(
            pp, b"opening-circuit", circuit)
    with metrics.phase("service/cache_write"):
        with open(config.circuit_cache_file, "wb") as f:
            f.write(prover_cache_to_bytes(config.capacity,
                                          prover.to_bytes()))
        with open(config.verifier_file, "wb") as f:
            f.write(verifier.to_bytes())
    log.info("compiled and cached prover/verifier (capacity %d)",
             config.capacity)
    return prover, verifier


def process_batch_proofs_with_config(config: BatchProofConfig) -> int:
    """Load leaves, verify openings natively, prove each membership, verify,
    and write proof/public-input files (merkle-plonk/src/lib.rs:231-400).

    Returns the number of successfully proven leaves."""
    os.makedirs(config.output_dir, exist_ok=True)
    with open(config.merkle_input_file, "rb") as f:
        blob = f.read()
    all_leaves = MultipleLeavesData.from_rkyv_bytes(blob)
    root_hash = Fr.from_bytes(all_leaves.root_hash)
    if root_hash is None:
        raise ValueError("failed to parse root hash")

    t0 = time.monotonic()
    prover, verifier = load_or_compile_opening_circuit(config)
    log.info("circuit load took %.3fs", time.monotonic() - t0)
    log.info("processing %d leaves, root=%s",
             len(all_leaves.leaves_info), all_leaves.root_hash.hex())

    proven = 0
    for leaf_index, info in enumerate(all_leaves.leaves_info):
        leaf_hash = Fr.from_bytes(info.leaf_hash)
        if leaf_hash is None:
            log.warning("leaf %d: bad leaf hash, skipping", leaf_index)
            continue
        try:
            opening = poseidon_opening_from_slice(info.proof_bytes,
                                                  config.tree_height)
        except ValueError as err:
            log.warning("leaf %d: bad opening (%s), skipping",
                        leaf_index, err)
            continue
        if opening.root.hash != root_hash:
            log.warning("leaf %d: root mismatch, skipping", leaf_index)
            continue
        leaf = Item(leaf_hash, None)
        if not opening.verify(leaf):
            log.warning("leaf %d: not in tree, skipping", leaf_index)
            continue
        circuit = OpeningCircuit(opening, leaf)
        rng = StdRng(0xDEA1 + leaf_index)
        t_prove = time.monotonic()
        # the run's first prove pays for what the later ones reuse
        with metrics.phase("service/prove" if proven
                           else "service/first_prove"):
            proof, public_inputs = prover.prove(rng, circuit)
        if leaf_index == 0:
            log.info("first proof took %.3fs", time.monotonic() - t_prove)
        with metrics.phase("service/verify"):
            verifier.verify(proof, public_inputs)
        pi_bytes = b"".join(pi.to_bytes() for pi in public_inputs)
        proof_path = os.path.join(
            config.output_dir,
            f"{config.proof_file_prefix}{leaf_index + 1}.bin")
        pi_path = os.path.join(
            config.output_dir,
            f"{config.public_inputs_file_prefix}{leaf_index + 1}.bin")
        with open(proof_path, "wb") as f:
            f.write(ZKProofData(proof.to_bytes()).to_rkyv_bytes())
        with open(pi_path, "wb") as f:
            f.write(ZKProofData(pi_bytes).to_rkyv_bytes())
        proven += 1
        log.info("leaf %d proven and saved (%s)", leaf_index, proof_path)
    return proven


def process_batch_proofs() -> int:
    return process_batch_proofs_with_config(BatchProofConfig())
