"""Whole runs of both cells on the CPU at a small size, the harness's look
for a card skipped: a sound run comes out correct, and each fault that a
cell can have, planted under the timed path, makes `correct` false.  The
controls at the same size fail the checks too.

Faults (one chip, so no exchange between chips to leave out):
* a step that returns its state unchanged: the prover hands back its
  previous proof / the commit its previous call's points;
* half of the batch left out: every second leaf's opening refused /
  half of a call's commitments not returned;
* an answer altered where it is produced: a proof's bytes / a point.

The window is cut to a fixed number of items (`run_window` below) so the
runs do not depend on the machine's speed, and the card-only trace of the
window is stood in for by a fixed busy time per item (`device_window`
below); the rest is `run.py`'s run.
"""

from __future__ import annotations

import json
import time

import pytest

from benchmark.harness import control, core, trace

CELLS = {
    "opening-h17.batch": ({"name": "opening-h17.batch", "chips": 1},
                          "configs/opening-h17.json",
                          {"srs_log2": 10, "tree": {"arity": 4, "height": 1}},
                          "traffic/batch.json",
                          {"proofs": 3, "warmup": 1}),
    "openings2-h17.commit": ({"name": "openings2-h17.commit", "chips": 1},
                             "configs/openings2-h17.json",
                             {"srs_log2": 8, "domain_log2": 8},
                             "traffic/commit.json", {"sets": 3}),
}
ITEMS = 3


def tiny(name):
    cell, cfg, cfg_over, trf, trf_over = CELLS[name]
    config = dict(core.load_json(core.BENCH_DIR / cfg), **cfg_over)
    traffic = dict(core.load_json(core.BENCH_DIR / trf), **trf_over)
    return cell, config, traffic


def run_window(loop, seconds):
    t0 = time.monotonic()
    records = [loop.item() for _ in range(ITEMS)]
    return (records, time.monotonic() - t0,
            sum(r["error"] is not None for r in records))


BUSY_PER_ITEM_S = 0.01


def device_window(run, device, kernels):
    out = run()
    return out, trace.DeviceWindow(
        busy_s=BUSY_PER_ITEM_S * (len(out[0]) if out else 0),
        missing_launches=0)


@pytest.fixture
def run_cell(monkeypatch, fast_commits, capsys):
    monkeypatch.setattr(core, "find_cell", lambda bench, name: tiny(name))
    monkeypatch.setattr(core, "run_window", run_window)
    monkeypatch.setattr(trace, "device_window", device_window)

    def go(name, seed=2_147_483_659):
        rc = core.run(["--workload", name, "--seed", str(seed), "--seconds",
                       "1", "--trace", "0"], time.monotonic(), device="cpu",
                      check_card=False)
        out = capsys.readouterr()
        assert rc == 0, out.err
        result = json.loads(out.out.strip().splitlines()[-1])
        assert list(result)[-1] == "checks"
        assert out.err.strip().splitlines()[-1].startswith("check ")
        return result
    return go


def _prover_faults(monkeypatch, kind):
    from zkvm_tpu_torch.merkle.tree import Opening
    from zkvm_tpu_torch.plonk import Prover
    from zkvm_tpu_torch.plonk.proof import Proof

    if kind == "unchanged":
        real, first = Prover.prove, []

        def prove(self, rng, circuit, *a, **k):
            out = real(self, rng, circuit, *a, **k)
            first.append(out)
            return first[0]
        monkeypatch.setattr(Prover, "prove", prove)
    elif kind == "left_out":
        real, calls = Opening.verify, []

        def verify(self, item):
            calls.append(1)
            return len(calls) % 2 == 1 and real(self, item)
        monkeypatch.setattr(Opening, "verify", verify)
    elif kind == "altered":
        real = Proof.to_bytes

        def to_bytes(self):
            raw = bytearray(real(self))
            raw[-32] ^= 1  # z_eval's lowest bit
            return bytes(raw)
        monkeypatch.setattr(Proof, "to_bytes", to_bytes)


def _commit_faults(monkeypatch, kind):
    from zkvm_tpu_torch.curves.g1 import G1Affine
    from zkvm_tpu_torch.plonk import kzg10

    real, last = kzg10.CommitKey.commit_many_mont, []

    def commit(self, tensors, *a, **k):
        out = real(self, tensors, *a, **k)
        if kind == "unchanged":
            last.append(out)
            return last[0]
        if kind == "left_out":
            return out[: len(out) // 2]
        return [kzg10.Commitment(G1Affine.generator())] + out[1:]
    monkeypatch.setattr(kzg10.CommitKey, "commit_many_mont", commit)


def test_sound_proof_run_is_correct(run_cell):
    r = run_cell("opening-h17.batch")
    assert r["correct"] and r["attempted"] == ITEMS and r["failed"] == 0
    assert set(r["metrics"]) == {"proof_device_ms", "setup_s"}
    assert r["metrics"]["proof_device_ms"]["value"] == pytest.approx(
        1e3 * BUSY_PER_ITEM_S)


@pytest.mark.parametrize("kind, number", [("unchanged", "proofs_repeated"),
                                          ("left_out", "proofs_missing"),
                                          ("altered", "proofs_rejected")])
def test_proof_faults_fail_the_run(run_cell, monkeypatch, kind, number):
    _prover_faults(monkeypatch, kind)
    r = run_cell("opening-h17.batch")
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]


def test_sound_commit_run_is_correct(run_cell):
    r = run_cell("openings2-h17.commit")
    assert r["correct"] and r["attempted"] == ITEMS and r["failed"] == 0
    assert set(r["metrics"]) == {"commit_device_ms", "setup_s"}
    assert r["metrics"]["commit_device_ms"]["value"] == pytest.approx(
        1e3 * BUSY_PER_ITEM_S)


@pytest.mark.parametrize("kind, number", [("unchanged", "commits_wrong"),
                                          ("left_out", "commits_missing"),
                                          ("altered", "commits_wrong")])
def test_commit_faults_fail_the_run(run_cell, monkeypatch, kind, number):
    _commit_faults(monkeypatch, kind)
    r = run_cell("openings2-h17.commit")
    assert not r["correct"]
    assert r["checks"][number]["value"] > 0


def test_commit_control_fails_every_commitment():
    _, config, traffic = tiny("openings2-h17.commit")
    for seed in (1, 2, 3):
        checks = control.commit_control(config, traffic, seed, "cpu")
        assert checks["commits_wrong"][0] == (traffic["sets"]
                                              * traffic["polys_per_call"])


def test_proof_control_fails_every_proof(fast_commits):
    _, config, traffic = tiny("opening-h17.batch")
    checks = control.proof_control(config, traffic, 7, "cpu", 2)
    assert checks["proofs_rejected"][0] == 2
