"""On-disk formats of the batch proving service.

The reference exchanges files as rkyv 0.7 archives (merkle-plonk/src/lib.rs:
MultipleLeavesData, LeafInfo, ZKProofData) and a bincode-wrapped
ProverWithCapacity circuit cache.  This module reimplements those exact byte
layouts so files interoperate with the Rust pipeline:

  * rkyv 0.7: archived values are written dependencies-first; the root
    struct sits at the END of the buffer (`rkyv::archived_root`).  Vec<T>
    archives as { ptr: i32 relative offset, len: u32 }; fixed arrays inline.
  * bincode (default config): little-endian, u64 lengths for Vec<u8>.
"""

from __future__ import annotations

from dataclasses import dataclass


def _align(buf: bytearray, alignment: int) -> None:
    while len(buf) % alignment:
        buf.append(0)


def _rel_ptr(target_pos: int, field_pos: int) -> bytes:
    return (target_pos - field_pos).to_bytes(4, "little", signed=True)


@dataclass
class LeafInfo:
    """LeafInfo { position: u64, leaf_hash: [u8; 32], proof_bytes: Vec<u8> }."""

    position: int
    leaf_hash: bytes
    proof_bytes: bytes

    ARCHIVED_SIZE = 48  # u64 + [u8;32] + ArchivedVec(8)


@dataclass
class MultipleLeavesData:
    """MultipleLeavesData { root_hash: [u8; 32], leaves_info: Vec<LeafInfo> }."""

    root_hash: bytes
    leaves_info: list[LeafInfo]

    ARCHIVED_SIZE = 40  # [u8;32] + ArchivedVec(8)

    def to_rkyv_bytes(self) -> bytes:
        buf = bytearray()
        # 1. dependencies of each LeafInfo (their proof byte vectors)
        proof_positions = []
        for info in self.leaves_info:
            proof_positions.append(len(buf))
            buf += info.proof_bytes
        # 2. the archived LeafInfo array (align 8 for the u64 field)
        _align(buf, 8)
        array_pos = len(buf)
        for info, proof_pos in zip(self.leaves_info, proof_positions):
            entry_pos = len(buf)
            buf += int(info.position).to_bytes(8, "little")
            assert len(info.leaf_hash) == 32
            buf += info.leaf_hash
            buf += _rel_ptr(proof_pos, entry_pos + 40)
            buf += len(info.proof_bytes).to_bytes(4, "little")
        # 3. the root struct at the end
        _align(buf, 8)
        root_pos = len(buf)
        assert len(self.root_hash) == 32
        buf += self.root_hash
        buf += _rel_ptr(array_pos, root_pos + 32)
        buf += len(self.leaves_info).to_bytes(4, "little")
        return bytes(buf)

    @classmethod
    def from_rkyv_bytes(cls, buf: bytes) -> "MultipleLeavesData":
        root_pos = len(buf) - cls.ARCHIVED_SIZE
        root_hash = buf[root_pos: root_pos + 32]
        vec_field = root_pos + 32
        rel = int.from_bytes(buf[vec_field: vec_field + 4], "little",
                             signed=True)
        n = int.from_bytes(buf[vec_field + 4: vec_field + 8], "little")
        array_pos = vec_field + rel
        leaves = []
        for i in range(n):
            entry = array_pos + i * LeafInfo.ARCHIVED_SIZE
            position = int.from_bytes(buf[entry: entry + 8], "little")
            leaf_hash = buf[entry + 8: entry + 40]
            prel = int.from_bytes(buf[entry + 40: entry + 44], "little",
                                  signed=True)
            plen = int.from_bytes(buf[entry + 44: entry + 48], "little")
            ppos = entry + 40 + prel
            leaves.append(LeafInfo(position, leaf_hash,
                                   buf[ppos: ppos + plen]))
        return cls(root_hash, leaves)


@dataclass
class ZKProofData:
    """ZKProofData { data: Vec<u8> } (rkyv archive)."""

    data: bytes

    ARCHIVED_SIZE = 8

    def to_rkyv_bytes(self) -> bytes:
        buf = bytearray(self.data)
        _align(buf, 4)
        root_pos = len(buf)
        buf += _rel_ptr(0, root_pos)
        buf += len(self.data).to_bytes(4, "little")
        return bytes(buf)

    @classmethod
    def from_rkyv_bytes(cls, buf: bytes) -> "ZKProofData":
        root_pos = len(buf) - cls.ARCHIVED_SIZE
        rel = int.from_bytes(buf[root_pos: root_pos + 4], "little",
                             signed=True)
        n = int.from_bytes(buf[root_pos + 4: root_pos + 8], "little")
        start = root_pos + rel
        return cls(buf[start: start + n])


def prover_cache_to_bytes(capacity: int, prover_bytes: bytes) -> bytes:
    """bincode-serialize ProverWithCapacity { capacity: usize, prover: Vec<u8> }
    (merkle-plonk/src/lib.rs:62-66): u64 LE capacity + u64 LE len + bytes."""
    return (int(capacity).to_bytes(8, "little")
            + len(prover_bytes).to_bytes(8, "little") + prover_bytes)


def prover_cache_from_bytes(buf: bytes) -> tuple[int, bytes]:
    capacity = int.from_bytes(buf[0:8], "little")
    n = int.from_bytes(buf[8:16], "little")
    return capacity, buf[16: 16 + n]
