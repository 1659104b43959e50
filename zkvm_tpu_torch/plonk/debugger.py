"""Circuit debugger: source-located constraint traces
(plonk/src/debugger.rs + runtime.rs equivalents).

Subscribes to a Composer's Runtime event bus, resolves the source location
of every witness/constraint via the Python stack (the reference uses the
`backtrace` crate), and on `proof_finished` writes a trace file to the path
in $CDF_OUTPUT (same env contract as the reference's dusk-cdf output,
debugger.rs:58-66).  The default output is the binary CDF container
(plonk/cdf.py) with per-gate selector columns, wired witnesses, the
evaluation flag (debugger.rs:126-135) and embedded source files; a path
ending in `.jsonl` keeps the line-oriented JSON debug format.

Usage:
    composer = Composer.initialized()
    debugger = Debugger.attach(composer)
    ... build circuit ...
    composer.runtime.event("proof_finished")     # or debugger.flush(path)
"""

from __future__ import annotations

import json
import os
import traceback

from ..fields import Fr
from .constraint_system import Constraint, Selector, Witness


def _source_location() -> dict:
    """First stack frame outside this package, zkvm_tpu_torch
    (debugger.rs:23-55 semantics)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for frame in reversed(traceback.extract_stack()):
        if not frame.filename.startswith(here + os.sep):
            return {"file": frame.filename, "line": frame.lineno,
                    "function": frame.name}
    return {"file": "<unknown>", "line": 0, "function": "<unknown>"}


class Debugger:
    """Event recorder producing a constraint-level trace."""

    def __init__(self):
        self.witnesses: list[dict] = []
        self.constraints: list[dict] = []

    @classmethod
    def attach(cls, composer) -> "Debugger":
        debugger = cls()
        composer.runtime.listeners.append(debugger.event)
        return debugger

    def event(self, kind: str, *payload) -> None:
        if kind == "witness_appended":
            witness, value = payload
            self.witnesses.append({
                "id": witness.index,
                "value": value,
                "source": _source_location(),
            })
        elif kind == "constraint_appended":
            constraint: Constraint = payload[0]
            self.constraints.append({
                "id": len(self.constraints),
                "wires": [w.index for w in constraint.witnesses],
                "selectors": {sel: constraint.coeff(sel)
                              for sel in Selector},
                "source": _source_location(),
            })
        elif kind == "proof_finished":
            path = os.environ.get("CDF_OUTPUT")
            if path:
                self.flush(path)

    # CDF selector column <- Selector slot (debugger.rs:80-148; note the
    # reference stores the Fourth selector q_f in the `qd` column)
    _CDF_SELECTORS = (
        ("qm", Selector.MULTIPLICATION), ("ql", Selector.LEFT),
        ("qr", Selector.RIGHT), ("qo", Selector.OUTPUT),
        ("qd", Selector.FOURTH), ("qc", Selector.CONSTANT),
        ("pi", Selector.PUBLIC_INPUT), ("qarith", Selector.ARITHMETIC),
        ("qlogic", Selector.LOGIC), ("qrange", Selector.RANGE),
        ("qgroup_variable", Selector.GROUP_ADD_VARIABLE_BASE),
        ("qfixed_add", Selector.GROUP_ADD_FIXED_BASE),
    )

    def flush(self, path: str) -> None:
        if path.endswith(".jsonl"):
            return self._flush_jsonl(path)
        from .cdf import write_cdf

        def wire_value(index: int) -> Fr:
            if index < len(self.witnesses):
                return self.witnesses[index]["value"]
            return Fr.zero()

        witnesses = [{"id": w["id"], "constraint": None,
                      "value": w["value"].to_bytes(), "source": w["source"]}
                     for w in self.witnesses]
        constraints = []
        for c in self.constraints:
            sel = c["selectors"]
            a, b, o, d = (w for w in c["wires"])
            evaluation = (sel[Selector.MULTIPLICATION] * wire_value(a)
                          * wire_value(b)
                          + sel[Selector.LEFT] * wire_value(a)
                          + sel[Selector.RIGHT] * wire_value(b)
                          + sel[Selector.OUTPUT] * wire_value(o)
                          + sel[Selector.FOURTH] * wire_value(d)
                          + sel[Selector.CONSTANT]
                          + sel[Selector.PUBLIC_INPUT]).is_zero()
            constraints.append({
                "id": c["id"],
                "selectors": {name: sel[slot].to_bytes()
                              for name, slot in self._CDF_SELECTORS},
                "witnesses": (a, b, o, d),
                "evaluation": evaluation,
                "source": c["source"],
            })
        # the encoder's tag is the format's (the reference package's name),
        # so that both packages write a trace byte for byte
        write_cdf(path, witnesses, constraints,
                  config={"version": "1", "source": "zkvm_tpu"})

    def _flush_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for record in self.witnesses:
                f.write(json.dumps({
                    "type": "witness", "id": record["id"],
                    "value": record["value"].to_hex_str(),
                    "source": record["source"]}) + "\n")
            for record in self.constraints:
                f.write(json.dumps({
                    "type": "constraint", "id": record["id"],
                    "wires": record["wires"],
                    "selectors": {sel.name.lower(): value.to_hex_str()
                                  for sel, value in
                                  record["selectors"].items()
                                  if not value.is_zero()},
                    "source": record["source"]}) + "\n")

    # -- interactive helpers -----------------------------------------------------
    def unsatisfied_constraints(self, composer) -> list[int]:
        """Indexes of arithmetic gates whose polynomial doesn't vanish --
        the debugging question the reference's CDF viewer answers."""
        bad = []
        for i, gate in enumerate(composer.constraints):
            a = composer[gate.a]
            b = composer[gate.b]
            c = composer[gate.c]
            d = composer[gate.d]
            pi = composer.public_inputs.get(i, Fr.zero())
            value = (gate.q_m * a * b + gate.q_l * a + gate.q_r * b
                     + gate.q_o * c + gate.q_f * d + gate.q_c + pi)
            if not (value * gate.q_arith).is_zero():
                bad.append(i)
        return bad
