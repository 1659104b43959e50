"""A proof cell of a circuit other than the openings needs new files only:
a loop that subclasses `proofs.Loop` (here defined in this module, where
a configuration would add `harness/<loop>.py`) and a traffic mix (here a
dict).  The circuit proves knowledge of a 64-bit JubJub scalar s whose
fixed-base product [s] G is a public point: the range and fixed-base
gate families.  Driven through `core.run` on the CPU as the opening cells
are (`test_benchmark_faults.py`), a sound run is correct and a run whose
every proof is altered has every proof rejected."""

from __future__ import annotations

import json
import random
import sys
import time

import pytest

from benchmark.harness import control, core, proofs
from benchmark.reference import circuit as rc
from benchmark.reference import jubjub
from zkvm_tpu_torch.curves.jubjub import JubjubAffine
from zkvm_tpu_torch.fields import Fr, JubjubFr
from zkvm_tpu_torch.plonk.composer import Circuit

from .test_benchmark_faults import ITEMS, run_window

LOOP = "keyproofs"
CELL = {"name": "keys.batch", "config": "keys", "traffic": "keys",
        "chips": 1}
CONFIG = {"name": "keys", "label": "key-circuit", "srs_log2": 9}
TRAFFIC = {"loop": LOOP, "proofs": 4, "warmup": 1, "trace_items": 2}


class KeyCircuit(Circuit):
    def __init__(self, s: int):
        self.s = s

    def circuit(self, c) -> None:
        s = c.append_witness(JubjubFr(self.s))
        c.component_range(s, 32)
        p = c.component_mul_generator(s, JubjubAffine.generator())
        x, y = jubjub.mul(jubjub.GENERATOR, self.s)
        c.assert_equal_public_point(p, JubjubAffine(Fr(x), Fr(y)))


class Loop(proofs.Loop):
    def default_circuit(self):
        return KeyCircuit(1)

    def make_inputs(self) -> int:
        rnd = random.Random(self.seed)
        n = self.traffic["proofs"] + self.traffic["warmup"]
        self.scalars = [rnd.randrange(1 << 64) for _ in range(n)]
        return n

    def circuit(self, i: int):
        return KeyCircuit(self.scalars[i])

    def layout(self):
        lay = rc.Layout()
        s = lay.witness()
        lay.range(s, 32)
        x, y = lay.mul_generator(s, jubjub.GENERATOR)
        lay.assert_public(x)
        lay.assert_public(y)
        return lay

    def public_inputs(self, i: int, layout) -> list[int]:
        return list(jubjub.mul(jubjub.GENERATOR, self.scalars[i]))


@pytest.fixture
def run_keys(monkeypatch, fast_commits, capsys):
    monkeypatch.setitem(sys.modules, f"benchmark.harness.{LOOP}",
                        sys.modules[__name__])
    monkeypatch.setattr(core, "find_cell",
                        lambda bench, name: (CELL, CONFIG, TRAFFIC))
    monkeypatch.setattr(core, "run_window", run_window)

    def go(seed=2_147_483_659):
        rc_ = core.run(["--workload", CELL["name"], "--seed", str(seed),
                        "--seconds", "1", "--trace", "0"], time.monotonic(),
                       device="cpu", check_card=False)
        out = capsys.readouterr()
        assert rc_ == 0, out.err
        return json.loads(out.out.strip().splitlines()[-1])
    return go


def test_the_layout_is_the_composers():
    from zkvm_tpu_torch.plonk.composer import Composer

    comp = Composer.initialized()
    KeyCircuit(12345).circuit(comp)
    lay = Loop(CONFIG, TRAFFIC, 1, "cpu").layout()
    assert len(lay.gates) == len(comp.constraints)
    assert lay.public == comp.public_input_indexes()
    assert [(g.a.index, g.b.index, g.c.index, g.d.index)
            for g in comp.constraints] == lay.wires


def test_a_sound_run_is_correct(run_keys):
    r = run_keys()
    assert r["correct"] and r["attempted"] == ITEMS and r["failed"] == 0
    assert r["checks"]["proofs_rejected"]["value"] == 0


def test_every_altered_proof_is_rejected(run_keys, monkeypatch):
    from zkvm_tpu_torch.plonk.proof import Proof

    real = Proof.to_bytes

    def to_bytes(self):
        raw = bytearray(real(self))
        raw[-32] ^= 1  # z_eval's lowest bit
        return bytes(raw)
    monkeypatch.setattr(Proof, "to_bytes", to_bytes)
    r = run_keys()
    assert not r["correct"]
    assert r["checks"]["proofs_rejected"]["value"] == ITEMS


def test_the_control_fails_every_proof(fast_commits, monkeypatch):
    monkeypatch.setitem(sys.modules, f"benchmark.harness.{LOOP}",
                        sys.modules[__name__])
    checks = control.proof_control(CONFIG, TRAFFIC, 7, "cpu", 2)
    assert checks["proofs_rejected"][0] == 2
