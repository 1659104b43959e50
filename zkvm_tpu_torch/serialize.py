"""Byte-serialization substrate (coset-bytes equivalent).

The reference's layer-0 crate (coset-bytes) provides fixed-size Serializable,
stream readers/writers, and hex parsing.  Here those are plain Python helpers:
objects expose `to_bytes()` / classmethod `from_bytes(buf)`, and this module
supplies the stream-style reader/writer plus hex utilities.

Reference parity: coset-bytes/bytes/src/{serialize.rs, parse.rs, errors.rs}.
"""

from __future__ import annotations


class BadLength(ValueError):
    pass


class InvalidData(ValueError):
    pass


class InvalidChar(ValueError):
    pass


class Reader:
    """Stream-style reader over a byte buffer (coset-bytes Read trait)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise BadLength(f"need {n} bytes, have {len(self.buf) - self.pos}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_u32_le(self) -> int:
        return int.from_bytes(self.read(4), "little")

    def read_u64_le(self) -> int:
        return int.from_bytes(self.read(8), "little")

    def read_obj(self, cls):
        """from_reader: deserialize cls (with SIZE or NUM_BYTES) from the stream."""
        size = getattr(cls, "SIZE", None) or getattr(cls, "NUM_BYTES")
        obj = cls.from_bytes(self.read(size))
        if obj is None:
            raise InvalidData(f"invalid {cls.__name__} encoding")
        return obj

    def remaining(self) -> int:
        return len(self.buf) - self.pos


class Writer:
    """Stream-style writer (coset-bytes Write trait)."""

    def __init__(self):
        self.chunks: list[bytes] = []

    def write(self, data: bytes):
        self.chunks.append(bytes(data))
        return self

    def write_u32_le(self, v: int):
        return self.write(int(v).to_bytes(4, "little"))

    def write_u64_le(self, v: int):
        return self.write(int(v).to_bytes(8, "little"))

    def write_obj(self, obj):
        return self.write(obj.to_bytes())

    def getvalue(self) -> bytes:
        return b"".join(self.chunks)


def from_hex_str(cls, s: str):
    """ParseHexStr: parse hex of the canonical byte encoding (parse.rs:6)."""
    if s.startswith(("0x", "0X")):
        s = s[2:]
    try:
        raw = bytes.fromhex(s)
    except ValueError as e:
        raise InvalidChar(str(e)) from None
    obj = cls.from_bytes(raw)
    if obj is None:
        raise InvalidData(f"invalid {cls.__name__} encoding")
    return obj


def hex_str(obj) -> str:
    return obj.to_bytes().hex()
