"""The port's debugger and CDF format (plonk runtime.rs + debugger.rs): the
cases of tests/test_debugger.py on the port, the golden fixture read by the
port's `read_cdf`, and one trace written through both packages' debuggers,
byte for byte.

Both debuggers name the first stack frame outside their own package as a
record's source; the cross-package case builds its circuit in one helper
of this file for both, so both traces carry the same file and lines and
embed the same source file.
"""

import inspect
import json
import os

import pytest

import zkvm_tpu.fields as rfields
import zkvm_tpu.plonk as rplonk
import zkvm_tpu.plonk.debugger as rdebugger
import zkvm_tpu_torch.fields as pfields
import zkvm_tpu_torch.plonk as pplonk
import zkvm_tpu_torch.plonk.debugger as pdebugger
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.plonk import Composer, Constraint
from zkvm_tpu_torch.plonk.cdf import read_cdf
from zkvm_tpu_torch.plonk.constraint_system import Selector
from zkvm_tpu_torch.plonk.debugger import Debugger

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trace_v1.cdf")


def _build(composer):
    a = composer.append_witness(Fr(3))
    b = composer.append_witness(Fr(5))
    composer.gate_mul(Constraint().mult(1).a(a).b(b))
    return a, b


def test_debugger_records_events():
    composer = Composer.initialized()
    debugger = Debugger.attach(composer)
    _build(composer)
    assert len(debugger.witnesses) == 3  # a, b, product output
    assert len(debugger.constraints) == 1
    record = debugger.constraints[0]
    assert record["source"]["file"].endswith("test_torch_debugger.py")
    assert record["selectors"][Selector.MULTIPLICATION] == Fr(1)


def test_source_location_skips_the_port_package():
    """Frames inside zkvm_tpu_torch are skipped: the source is this file,
    at the line of the call that appended the witness."""
    composer = Composer.initialized()
    debugger = Debugger.attach(composer)
    line = inspect.currentframe().f_lineno + 1
    composer.append_witness(Fr(9))
    source = debugger.witnesses[0]["source"]
    assert source["file"] == os.path.abspath(__file__)
    assert (source["line"], source["function"]) == (
        line, "test_source_location_skips_the_port_package")
    package = os.path.dirname(os.path.dirname(pdebugger.__file__))
    assert os.path.basename(package) == "zkvm_tpu_torch"


def test_cdf_binary_roundtrip(tmp_path, monkeypatch):
    out = tmp_path / "trace.cdf"
    monkeypatch.setenv("CDF_OUTPUT", str(out))
    composer = Composer.initialized()
    Debugger.attach(composer)
    a, b = _build(composer)
    composer.runtime.event("proof_finished")

    data = read_cdf(str(out))
    assert len(data["constraints"]) == 1
    con = data["constraints"][0]
    assert con["selectors"]["qm"] == Fr(1).to_bytes()
    # gate_mul allocates the output o = a*b, so the gate is satisfied
    assert con["evaluation"] is True
    assert con["witnesses"][0] == a.index
    assert con["witnesses"][1] == b.index
    by_id = {w["id"]: w["value"] for w in data["witnesses"]}
    assert by_id[a.index] == Fr(3).to_bytes()
    assert by_id[b.index] == Fr(5).to_bytes()
    # context section embeds this test file (self-contained trace)
    assert any(name.endswith("test_torch_debugger.py")
               for name in data["files"])


def test_cdf_unsatisfied_evaluation_flag(tmp_path):
    composer = Composer.initialized()
    debugger = Debugger.attach(composer)
    a = composer.append_witness(Fr(3))
    # claim a * a == 10 (false): evaluation flag must be False in the CDF
    composer.append_gate(Constraint().mult(1).constant(-Fr(10)).a(a).b(a))
    out = tmp_path / "bad.cdf"
    debugger.flush(str(out))
    flags = [c["evaluation"] for c in read_cdf(str(out))["constraints"]]
    assert flags[-1] is False


def test_cdf_golden_fixture():
    """Layout pin: the committed fixture parses to known content."""
    data = read_cdf(FIXTURE)
    assert data["config"]["version"] == "1"
    assert [w["id"] for w in data["witnesses"]] == [0, 1]
    assert data["witnesses"][0]["value"] == Fr(7).to_bytes()
    assert len(data["constraints"]) == 1
    con = data["constraints"][0]
    assert con["witnesses"] == (0, 1, 0, 0)
    assert con["selectors"]["ql"] == Fr(2).to_bytes()
    assert con["evaluation"] is True
    assert con["source"] == {"line": 42, "col": 3, "file": "circuit.py"}


def test_cdf_rejects_another_file(tmp_path):
    from zkvm_tpu_torch.plonk.errors import InvalidCompressedCircuit

    bad = tmp_path / "x.cdf"
    bad.write_bytes(b"ZKCDF\x02" + bytes(8))
    with pytest.raises(InvalidCompressedCircuit):
        read_cdf(str(bad))


def test_cdf_output_env(tmp_path, monkeypatch):
    out = tmp_path / "trace.cdf.jsonl"
    monkeypatch.setenv("CDF_OUTPUT", str(out))
    composer = Composer.initialized()
    Debugger.attach(composer)
    _build(composer)
    composer.runtime.event("proof_finished")
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert {line["type"] for line in lines} == {"witness", "constraint"}


def test_unsatisfied_constraints():
    composer = Composer.initialized()
    debugger = Debugger.attach(composer)
    a = composer.append_witness(Fr(3))
    # claim a * a == 10 (false)
    composer.append_gate(Constraint().mult(1).constant(-Fr(10)).a(a).b(a))
    assert len(debugger.unsatisfied_constraints(composer)) == 1
    # fixing the constant satisfies it
    composer2 = Composer.initialized()
    a2 = composer2.append_witness(Fr(3))
    composer2.append_gate(Constraint().mult(1).constant(-Fr(9)).a(a2).b(a2))
    assert Debugger().unsatisfied_constraints(composer2) == []


PACKAGES = {"ref": (rfields, rplonk, rdebugger),
            "port": (pfields, pplonk, pdebugger)}


def _trace(package: str, path: str) -> None:
    """One circuit (a product, a sum, a boolean, a false claim) through one
    package's composer and debugger, flushed to `path`."""
    fields, plonk, debugger = PACKAGES[package]
    f = fields.Fr
    composer = plonk.Composer.initialized()
    dbg = debugger.Debugger.attach(composer)
    a = composer.append_witness(f(3))
    b = composer.append_witness(f(5))
    composer.gate_mul(plonk.Constraint().mult(1).a(a).b(b))
    composer.gate_add(plonk.Constraint().left(1).right(1).a(a).b(b))
    composer.component_boolean(composer.append_witness(f(1)))
    composer.append_gate(plonk.Constraint().mult(1).constant(-f(10)).a(a)
                         .b(a))
    dbg.flush(path)


@pytest.mark.parametrize("suffix", [".cdf", ".jsonl"])
def test_trace_bytes_equal_across_packages(tmp_path, suffix):
    paths = [str(tmp_path / f"{name}{suffix}") for name in PACKAGES]
    for name, path in zip(PACKAGES, paths):
        _trace(name, path)
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f0.read() == f1.read()
    if suffix == ".cdf":
        data = read_cdf(paths[1])
        assert [c["evaluation"] for c in data["constraints"]][-1] is False
        assert list(data["files"]) == [os.path.abspath(__file__)]
