"""Native host runtime: C implementations of the latency-bound host work.

The TPU kernels own the throughput path (MSM/NTT/quotient); the verifier's
small MSMs and single pairing check are latency-bound host work that the
reference runs in native Rust (proof.rs:335-401).  `bls.c` provides those
as a tiny C library, built on first use with the system compiler and
cached in the package's git-ignored `build/` directory.  Everything degrades gracefully: if no compiler
is available the callers fall back to the exact-int Python paths
(curves/fast_tower.py), which produce identical bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "bls.c")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build(so_path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"  # concurrent builds
    cmd = ["cc", "-O2", "-shared", "-fPIC", "-fvisibility=hidden",
           "-fopenmp", _SRC, "-o", tmp]
    for cc in ("cc", "gcc", "g++"):
        cmd[0] = cc
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, so_path)
            return True
    return False


def get_lib():
    """The loaded native library, or None if unavailable.

    Rebuilds when the source is newer than the cached .so (source edits
    during development would otherwise be silently ignored).
    """
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ZKVM_NO_NATIVE"):
            return None
        so_path = os.path.join(_BUILD_DIR, "_bls.so")
        try:
            stale = (not os.path.exists(so_path)
                     or os.path.getmtime(so_path) < os.path.getmtime(_SRC))
            if stale and not _build(so_path):
                return None
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.bls_msm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_size_t, ctypes.c_char_p]
        lib.bls_msm.restype = None
        lib.bls_miller_loop.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_size_t, ctypes.c_char_p]
        lib.bls_miller_loop.restype = None
        lib.bls_final_exp.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.bls_final_exp.restype = None
        lib.bls_pairing_check.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_size_t]
        lib.bls_pairing_check.restype = ctypes.c_int
        lib.keccak_f1600.argtypes = [ctypes.c_void_p]
        lib.keccak_f1600.restype = None
        _LIB = lib
        return _LIB


def native_keccak_f1600(state: bytearray) -> bool:
    """In-place Keccak-f[1600] on a 200-byte state; False if no library."""
    lib = get_lib()
    if lib is None:
        return False
    buf = (ctypes.c_uint8 * 200).from_buffer(state)
    lib.keccak_f1600(buf)
    return True


def native_msm(points, scalars):
    """MSM over affine G1 points and Fr scalars via the C library.

    `points`: list of G1Affine; `scalars`: list of Fr.  Returns an
    (x, y, infinity) canonical-int triple, or None when the native library
    is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(points)
    pbuf = bytearray(96 * n)
    sbuf = bytearray(32 * n)
    for i, (p, s) in enumerate(zip(points, scalars)):
        if not p.is_identity():
            pbuf[96 * i: 96 * i + 48] = p.x.value.to_bytes(48, "little")
            pbuf[96 * i + 48: 96 * i + 96] = p.y.value.to_bytes(48, "little")
        sbuf[32 * i: 32 * i + 32] = s.value.to_bytes(32, "little")
    out = ctypes.create_string_buffer(97)
    lib.bls_msm(bytes(pbuf), bytes(sbuf), n, out)
    raw = out.raw
    if raw[96]:
        return (0, 0, True)
    return (int.from_bytes(raw[:48], "little"),
            int.from_bytes(raw[48:96], "little"), False)


def _g2_bytes(q) -> bytes:
    return (q.x.c0.value.to_bytes(48, "little")
            + q.x.c1.value.to_bytes(48, "little")
            + q.y.c0.value.to_bytes(48, "little")
            + q.y.c1.value.to_bytes(48, "little"))


def native_pairing_check(terms) -> bool | None:
    """final_exp(prod miller_loop(p, q)) == 1 for [(G1Affine, G2Affine)].

    Identity terms must be pre-filtered.  Returns None when the native
    library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(terms)
    g1 = b"".join(p.x.value.to_bytes(48, "little")
                  + p.y.value.to_bytes(48, "little") for p, _ in terms)
    g2 = b"".join(_g2_bytes(q) for _, q in terms)
    return bool(lib.bls_pairing_check(g1, g2, n))


def native_miller_loop(terms):
    """Raw fp12 tuple (fast_tower layout) for [(G1Affine, G2Affine)], or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(terms)
    g1 = b"".join(p.x.value.to_bytes(48, "little")
                  + p.y.value.to_bytes(48, "little") for p, _ in terms)
    g2 = b"".join(_g2_bytes(q) for _, q in terms)
    out = ctypes.create_string_buffer(576)
    lib.bls_miller_loop(g1, g2, n, out)
    return _fp12_from_bytes(out.raw)


def native_final_exp(f12):
    """Final exponentiation of a raw fp12 tuple, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = _fp12_to_bytes(f12)
    out = ctypes.create_string_buffer(576)
    lib.bls_final_exp(buf, out)
    return _fp12_from_bytes(out.raw)


_P = 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab


def _fp12_to_bytes(f) -> bytes:
    return b"".join(
        (c % _P).to_bytes(48, "little")
        for six in f for two in six for c in two)


def _fp12_from_bytes(raw: bytes):
    vals = [int.from_bytes(raw[48 * i: 48 * (i + 1)], "little")
            for i in range(12)]
    it = iter(vals)
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))
