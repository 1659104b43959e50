"""The opening cells read the same as before the reference learnt the
other gate families and the proof loop took its circuit from hooks: the
opening layouts' columns and verifier keys, the proofs a CPU run of
`opening-h17.batch` writes at height 1 and the commitments of one of
`openings2-h17.commit`, under fixed seeds, against the values the harness
gave before that change (sha256 digests)."""

from __future__ import annotations

import hashlib

import pytest

from benchmark.harness import commits, proofs
from benchmark.reference import circuit as rc
from benchmark.reference import curve, srs

from .test_benchmark_faults import run_cell  # noqa: F401  (a fixture)

COLUMNS = {
    (1, 1): "33c68fe6be03010fb1cb3ba03ede6063b4b224bcb746b242a9c89ff1873af46e",
    (2, 1): "c6623c977644c775d85fb94a135f31330d3afb29df991a2fdf78b74b57fe0cea",
    (1, 2): "5d2151902af333fa0dfd16f544b9ae9bd1d9a83ec20cd46ecfc95b28f9faee44",
    (17, 1): "e3cd3ca90376f11e5e1b32756832cf341690e7d4fe1e4742134721133b3fba31",
}
KEYS = {  # verifier keys at the trapdoor of StdRng(5)
    (1, 1): "3f7614c3b0eaa3f5f44737476b96aa6b91ab950f064082aca67c3300299fa249",
    (2, 1): "e3e6d8d857dbd2ccb6b14b18b757e8d75dc728d36e9a8176c9b061ffbf875c0e",
    (1, 2): "2bb986154f83d7f09e419d1e0b07877471942e929d295245435a95a819e6c593",
}
PROOFS = [  # the window's proofs, rkyv bytes of the proof and of its inputs
    "f9d0c8d59ef52bb551e620b44d6d226b7efd95b1b053cfef42ba0efd2820fe6f",
    "0179712b8711201d770173757969d148b2a7c851f40879426ddaffb92ad780db",
    "a48751e72e108ae29cbd0be4af82a0f54fb6dc71e77a17e3820586f8b4fdc419",
]
COMMITS = [  # each call's four compressed commitments
    "8eb97c098c2b66097d396d5b3dc922c250220a512e21b77dd98e554f95bde079",
    "e830c111c630db8bb88993a57295380ab08c8255de195e3575bb14f9811cbcb8",
    "bba0b44287fbcf50d7fe42027202fc72dc954c5ec067249835ea507d344ad8bc",
]


@pytest.mark.parametrize("shape", sorted(COLUMNS))
def test_opening_columns_are_unchanged(shape):
    lay = rc.opening_circuit(*shape)
    assert all(f == rc.ARITH for f in lay.families)
    cols = rc.columns(lay, rc.domain_size(len(lay.gates)))
    d = hashlib.sha256()
    for name in sorted(cols):
        d.update(name.encode())
        for v in cols[name]:
            d.update(v.to_bytes(32, "little"))
    assert d.hexdigest() == COLUMNS[shape]


@pytest.mark.parametrize("shape", sorted(KEYS))
def test_opening_keys_are_unchanged(shape):
    tau, g = srs.trapdoor(5)
    vk = rc.verifier_key(rc.opening_circuit(*shape), tau, g)
    d = hashlib.sha256(str(vk["n"]).encode())
    for name in sorted(k for k in vk if k != "n"):
        d.update(name.encode() + curve.to_bytes(vk[name]))
    assert d.hexdigest() == KEYS[shape]


def test_opening_run_writes_the_same_proofs(run_cell, monkeypatch):
    real, seen = proofs.Loop.check, []

    def check(self, records):
        for r in records:
            seen.append(hashlib.sha256(
                r["path"].read_bytes()
                + r["path"].with_suffix(".pi").read_bytes()).hexdigest())
        return real(self, records)
    monkeypatch.setattr(proofs.Loop, "check", check)
    assert run_cell("opening-h17.batch")["correct"]
    assert seen == PROOFS


def test_commit_run_makes_the_same_commitments(run_cell, monkeypatch):
    real, seen = commits.Loop.check, []

    def check(self, records):
        seen.extend(hashlib.sha256(b"".join(
            c.to_bytes() for c in r["out"])).hexdigest() for r in records)
        return real(self, records)
    monkeypatch.setattr(commits.Loop, "check", check)
    assert run_cell("openings2-h17.commit")["correct"]
    assert seen == COMMITS
