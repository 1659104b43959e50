"""Binary Circuit Description Format (CDF) writer/reader.

The reference's debug feature streams runtime events into `dusk-cdf`'s
`Encoder` and writes a binary CDF file to `$CDF_OUTPUT`
(plonk/src/debugger.rs:58-166, Cargo.toml:33 `coset_cdf = dusk-cdf 0.5`).
The crate models:

  - `BaseConfig`/`Config`   -- encoder configuration (version, flags)
  - `EncodableWitness`      -- id, optional constraint id, 32-byte value,
                               source location
  - `EncodableConstraint`   -- id, `Polynomial` (13 selectors, wired
                               witnesses a/b/o/d, evaluation flag), source
  - `EncodableSource`       -- line, col, canonical path
  - `EncoderContextFileProvider` -- embeds the referenced source files so
                               the trace is self-contained

The dusk-cdf 0.5 implementation itself is not vendored in the reference
checkout (crates.io dependency; unavailable offline), so the byte layout
here is this repo's own versioned encoding of the SAME information model:
a `ZKCDF` magic + version header followed by a zlib stream of
length-prefixed little-endian records (witnesses, constraints, embedded
context files).  Everything debugger.rs feeds the encoder -- per-event
source locations, witness values, the 13 selector columns, the wired
witness indexes, the per-gate evaluation flag -- round-trips through
`read_cdf`, and a golden fixture pins the layout
(tests/fixtures/trace_v1.cdf).
"""

from __future__ import annotations

import io
import struct
import zlib

from .errors import InvalidCompressedCircuit

MAGIC = b"ZKCDF\x01"

# Selector column order in a constraint record (debugger.rs:80-148: the
# arithmetic selectors, the PI column, then the gate-family selectors).
SELECTOR_NAMES = ("qm", "ql", "qr", "qo", "qd", "qc", "pi", "qarith",
                  "qlogic", "qrange", "qgroup_variable", "qfixed_add")


def _w_str(out: io.BytesIO, s: str) -> None:
    raw = s.encode("utf-8")
    out.write(struct.pack("<I", len(raw)))
    out.write(raw)


def _r_str(buf: io.BytesIO) -> str:
    (n,) = struct.unpack("<I", buf.read(4))
    return buf.read(n).decode("utf-8")


def _w_source(out: io.BytesIO, source: dict) -> None:
    out.write(struct.pack("<QQ", int(source.get("line", 0)),
                          int(source.get("col", 0))))
    _w_str(out, str(source.get("file", "")))


def _r_source(buf: io.BytesIO) -> dict:
    line, col = struct.unpack("<QQ", buf.read(16))
    return {"line": line, "col": col, "file": _r_str(buf)}


def write_cdf(path: str, witnesses: list[dict], constraints: list[dict],
              config: dict | None = None,
              embed_sources: bool = True) -> None:
    """witnesses: [{id, value: 32 bytes, source}], constraints:
    [{id, selectors: {name: 32 bytes}, witnesses: (a, b, o, d),
      evaluation: bool, source}]."""
    body = io.BytesIO()
    cfg = dict(config or {})
    body.write(struct.pack("<I", len(cfg)))
    for key in sorted(cfg):
        _w_str(body, key)
        _w_str(body, str(cfg[key]))

    body.write(struct.pack("<Q", len(witnesses)))
    for w in witnesses:
        constraint = w.get("constraint")
        body.write(struct.pack("<Q?Q", int(w["id"]), constraint is not None,
                               0 if constraint is None else int(constraint)))
        value = bytes(w["value"])
        assert len(value) == 32
        body.write(value)
        _w_source(body, w.get("source", {}))

    body.write(struct.pack("<Q", len(constraints)))
    for c in constraints:
        body.write(struct.pack("<Q", int(c["id"])))
        sel = c.get("selectors", {})
        for name in SELECTOR_NAMES:
            value = bytes(sel.get(name, bytes(32)))
            assert len(value) == 32
            body.write(value)
        a, b, o, d = c["witnesses"]
        body.write(struct.pack("<QQQQ?", a, b, o, d,
                               bool(c.get("evaluation", False))))
        _w_source(body, c.get("source", {}))

    # context section: embed referenced source files (the crate's
    # EncoderContextFileProvider capability, debugger.rs:161)
    files: dict[str, bytes] = {}
    if embed_sources:
        seen = {w.get("source", {}).get("file") for w in witnesses}
        seen |= {c.get("source", {}).get("file") for c in constraints}
        for name in sorted(f for f in seen if f):
            try:
                with open(name, "rb") as handle:
                    files[name] = handle.read()
            except OSError:
                continue
    body.write(struct.pack("<I", len(files)))
    for name, data in files.items():
        _w_str(body, name)
        body.write(struct.pack("<Q", len(data)))
        body.write(data)

    payload = zlib.compress(body.getvalue(), level=6)
    with open(path, "wb") as out:
        out.write(MAGIC)
        out.write(struct.pack("<Q", len(payload)))
        out.write(payload)


def read_cdf(path: str) -> dict:
    """Parse a CDF file back into {config, witnesses, constraints, files}."""
    with open(path, "rb") as handle:
        raw = handle.read()
    if raw[:len(MAGIC)] != MAGIC:
        raise InvalidCompressedCircuit("not a CDF file")
    (size,) = struct.unpack_from("<Q", raw, len(MAGIC))
    buf = io.BytesIO(zlib.decompress(raw[len(MAGIC) + 8:len(MAGIC) + 8 + size]))

    (n_cfg,) = struct.unpack("<I", buf.read(4))
    config = {}
    for _ in range(n_cfg):
        key = _r_str(buf)
        config[key] = _r_str(buf)

    (n_wit,) = struct.unpack("<Q", buf.read(8))
    witnesses = []
    for _ in range(n_wit):
        wid, has_c, cid = struct.unpack("<Q?Q", buf.read(17))
        value = buf.read(32)
        witnesses.append({"id": wid,
                          "constraint": cid if has_c else None,
                          "value": value, "source": _r_source(buf)})

    (n_con,) = struct.unpack("<Q", buf.read(8))
    constraints = []
    for _ in range(n_con):
        (cid,) = struct.unpack("<Q", buf.read(8))
        selectors = {name: buf.read(32) for name in SELECTOR_NAMES}
        a, b, o, d, evaluation = struct.unpack("<QQQQ?", buf.read(33))
        constraints.append({"id": cid, "selectors": selectors,
                            "witnesses": (a, b, o, d),
                            "evaluation": evaluation,
                            "source": _r_source(buf)})

    (n_files,) = struct.unpack("<I", buf.read(4))
    files = {}
    for _ in range(n_files):
        name = _r_str(buf)
        (size,) = struct.unpack("<Q", buf.read(8))
        files[name] = buf.read(size)
    return {"config": config, "witnesses": witnesses,
            "constraints": constraints, "files": files}
