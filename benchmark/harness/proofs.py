"""The closed loop of a proving service: one proof at a time.

Set-up draws the deployment's SRS from the seed, compiles the circuit as
the service does (`Compiler.compile_with_circuit(pp, label, circuit)`),
makes a pool of inputs, and proves `warmup` of them.  Each item of the
window then takes the next input, runs the service's steps before the
prover, proves, verifies the proof, and writes the proof's and the public
inputs' rkyv bytes to a file.  An input is never proven twice; a run that
runs out of inputs fails.  After the window, the reference rebuilds the
verifier key from the circuit's layout and the seed's trapdoor and checks
every proof file written.

What is the circuit's own sits in five methods, which a loop for another
circuit (`harness/<loop>.py`, `class Loop(proofs.Loop)`) overrides:
`default_circuit`, `make_inputs`, `circuit`, `layout` and
`public_inputs`.  This class's are the batch membership service's
(`service/batch.py`): a pool of distinct leaves made with the benchmark's
frozen generator and parsed with the service's own format; a proof takes
`openings` leaves of it (one: the service's `OpeningCircuit`), parses each
opening, checks its root and verifies it natively; its public inputs are
the tree's root.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path

from torch.profiler import record_function

from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.merkle import Item
from zkvm_tpu_torch.merkle.poseidon_tree import poseidon_opening_from_slice
from zkvm_tpu_torch.native import get_lib
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.plonk import Compiler, PublicParameters
from zkvm_tpu_torch.rng import StdRng
from zkvm_tpu_torch.service.batch import MultiOpeningCircuit, OpeningCircuit
from zkvm_tpu_torch.service.formats import MultipleLeavesData, ZKProofData

from ..reference import circuit as ref_circuit
from ..reference import merkle as ref_merkle
from ..reference import plonk as ref_plonk
from ..reference import srs as ref_srs
from ..reference.formats import ZKProofData as RefProofData

M64 = (1 << 64) - 1


def leaf_rng_seed(seed: int, item: int) -> int:
    """The prover's StdRng seed of the run's `item`-th proof."""
    return (seed * 1_000_003 + item) & M64


def opening_shape(config: dict) -> tuple[int, int]:
    """(tree height, openings a proof) of an opening configuration."""
    return config["tree"]["height"], config["openings"]


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.label = config["label"].encode()
        self.srs_log2 = config["srs_log2"]
        self.traffic = traffic
        self.seed = seed
        self.srs_seed = seed  # the control compiles under another setup
        self.device = device
        self.count = 0       # proofs started, warm-up included
        self.pool = 0        # proofs the inputs hold
        self.out_dir = None

    # -- the circuit: what a loop for another circuit overrides --------------
    def default_circuit(self):
        """The circuit that set-up compiles (its witness values unused)."""
        height, openings = opening_shape(self.config)
        if openings == 1:
            return OpeningCircuit.default_for_height(height)
        return MultiOpeningCircuit.default_for(height, openings)

    def make_inputs(self) -> int:
        """Make the pool of inputs; returns the number of proofs it holds."""
        height, openings = opening_shape(self.config)
        n_leaves = openings * (self.traffic["proofs"]
                               + self.traffic["warmup"])
        self.ref_root, _, _, blob = ref_merkle.make_pool(
            self.seed, height, n_leaves)
        data = MultipleLeavesData.from_rkyv_bytes(blob)
        self.root = Fr.from_bytes(data.root_hash)
        self.leaves = data.leaves_info
        return len(self.leaves) // openings

    def circuit(self, i: int):
        """Proof i's circuit, after the service's steps before the prover:
        each opening parsed, its root checked, verified natively."""
        height, openings = opening_shape(self.config)
        parts = []
        for info in self.leaves[i * openings:(i + 1) * openings]:
            leaf = Item(Fr.from_bytes(info.leaf_hash), None)
            opening = poseidon_opening_from_slice(info.proof_bytes, height)
            if opening.root.hash != self.root or not opening.verify(leaf):
                raise ValueError(f"leaf {info.position}: its opening is "
                                 f"refused")
            parts.append((opening, leaf))
        if openings == 1:
            return OpeningCircuit(*parts[0])
        return MultiOpeningCircuit(parts)

    def layout(self):
        """The reference's layout of the compiled circuit."""
        return ref_circuit.opening_circuit(*opening_shape(self.config))

    def public_inputs(self, i: int, layout) -> list[int]:
        """The public inputs the reference expects of proof i, one a public
        gate of `layout`, in order."""
        return [self.ref_root] * len(layout.public)

    # -- set-up -------------------------------------------------------------
    def setup(self, parts: dict) -> None:
        t = time.monotonic()
        if self.device != "cpu":
            kernels.build()
        parts["kernels"] = time.monotonic() - t
        t = time.monotonic()
        get_lib()
        parts["native"] = time.monotonic() - t
        t = time.monotonic()
        pp = PublicParameters.setup(1 << self.srs_log2,
                                    StdRng(self.srs_seed & M64), self.device)
        parts["srs"] = time.monotonic() - t
        t = time.monotonic()
        self.prover, self.verifier = Compiler.compile_with_circuit(
            pp, self.label, self.default_circuit())
        del pp
        parts["compile"] = time.monotonic() - t
        t = time.monotonic()
        self.pool = self.make_inputs()
        self.out_dir = Path(tempfile.mkdtemp(prefix="zkvm-bench-proofs-"))
        parts["inputs"] = time.monotonic() - t
        t = time.monotonic()
        for _ in range(self.traffic["warmup"]):
            rec = self.item()
            if rec["error"] is not None:
                raise RuntimeError(f"warm-up proof failed: {rec['error']}")
        parts["warmup"] = time.monotonic() - t

    # -- one item of the window ---------------------------------------------
    def item(self) -> dict:
        i = self.count
        if i >= self.pool:
            raise RuntimeError(f"the pool of {self.pool} proofs is used up "
                               f"after {i} proofs")
        self.count += 1
        path = self.out_dir / f"plonk_proof_{i}.bin"
        rec = {"index": i, "path": path, "error": None}
        t0 = t1 = t2 = time.perf_counter()
        with record_function("bench/leaf"):
            try:
                with record_function("bench/open"):
                    circuit = self.circuit(i)
                with record_function("bench/prove"):
                    t1 = time.perf_counter()
                    proof, public_inputs = self.prover.prove(
                        StdRng(leaf_rng_seed(self.seed, i)), circuit)
                    t2 = time.perf_counter()
                with record_function("bench/verify"):
                    self.verifier.verify(proof, public_inputs)
                with record_function("bench/write"):
                    with open(path, "wb") as f:
                        f.write(ZKProofData(proof.to_bytes()).to_rkyv_bytes())
                    pi_bytes = b"".join(pi.to_bytes() for pi in public_inputs)
                    with open(path.with_suffix(".pi"), "wb") as f:
                        f.write(ZKProofData(pi_bytes).to_rkyv_bytes())
            except Exception as err:  # the answer never came: counted failed
                rec["error"] = f"{type(err).__name__}: {err}"
        rec["wall"] = time.perf_counter() - t0
        rec["prove"] = t2 - t1
        return rec

    # -- after the window ---------------------------------------------------
    def end_to_end(self, records, window_s: float, window_dev=None) -> dict:
        """`proof_device_ms`: the card's busy time over the window, from
        the window's own trace (`window_dev`), per proof finished in it."""
        done = sum(r["error"] is None for r in records)
        return {"proof_device_ms": (1e3 * window_dev.busy_s / done
                                    if window_dev is not None and done
                                    else None)}

    def release(self) -> None:
        self.prover = self.verifier = None
        gc.collect()

    def check(self, records) -> dict:
        """Every proof of the run's window judged by the reference:
        rejected (unreadable, public inputs other than `public_inputs`, or
        a failing verification), missing (no file), repeated (the bytes of
        an earlier proof)."""
        tau, g = ref_srs.trapdoor(self.seed & M64)
        layout = self.layout()
        vk = ref_circuit.verifier_key(layout, tau, g)
        rejected = missing = repeated = 0
        seen = set()
        for rec in records:
            try:
                with open(rec["path"], "rb") as f:
                    proof = RefProofData.from_rkyv_bytes(f.read()).data
                with open(rec["path"].with_suffix(".pi"), "rb") as f:
                    pis = RefProofData.from_rkyv_bytes(f.read()).data
            except FileNotFoundError:
                missing += 1
                continue
            if proof in seen:
                repeated += 1
            seen.add(proof)
            values = self.public_inputs(rec["index"], layout)
            want = b"".join(v.to_bytes(32, "little") for v in values)
            try:
                if pis != want:
                    raise ref_plonk.Rejected("public inputs are not the "
                                             "expected ones")
                ref_plonk.verify(proof, dict(zip(layout.public, values)), vk,
                                 self.label, tau, g)
            except ref_plonk.Rejected as err:
                rejected += 1
                print(f"proof {rec['index']} rejected: {err}", flush=True)
        shutil.rmtree(self.out_dir, ignore_errors=True)
        return {"proofs_rejected": (rejected, 0),
                "proofs_missing": (missing, 0),
                "proofs_repeated": (repeated, 0)}
