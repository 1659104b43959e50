"""The port's CUDA kernels: build, bind, launch, count, and plain versions.

Three kernels from `zkvm_tpu_torch/csrc/` (CUDA C++ for sm_90a):

  * `mont_mul`     replaces `pallas_field.mont_mul_pallas`
  * `padd`         replaces `pallas_field.padd_pallas_2l`
  * `window_fold`  replaces `pallas_field.window_fold_pallas`

They are compiled with `nvcc` into one shared library with a plain C
interface on first use (never at import), cached under
`zkvm_tpu_torch/build/` by a hash of the sources, and bound with ctypes.

Each wrapper checks dtype, shape, device and contiguity, allocates its
outputs, launches on the current stream and adds one to `LAUNCHES[name]`.
A CPU tensor takes the kernel's plain PyTorch version (`*_plain`, defined
here beside the kernel); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import limb_field as lf
from .limb_field import FQ

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_SOURCES = ("mont_mul.cu", "padd.cu", "window_fold.cu")
_HEADERS = ("common.cuh", "field.cuh")
_FIELD_ID = {"Fr": 0, "Fq": 1}

# launches of each kernel since the last `reset_launches()`
LAUNCHES = {"mont_mul": 0, "padd": 0, "window_fold": 0}

_lib = None
BUILD_LOG = ""  # nvcc/ptxas output of the last build (register counts)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> float:
    """Build (if needed) and load the kernel library; returns the seconds
    spent.  A library whose name carries the current sources' hash is
    reused; anything else is rebuilt."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    digest = hashlib.sha256()
    for name in _HEADERS + _SOURCES:
        digest.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libzkvm_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")  # concurrent builds
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp),
               *(str(CSRC / s) for s in _SOURCES)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{BUILD_LOG}")
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    lib.zk_mont_mul.argtypes = [_I, _P, _P, _P, _LL, _LL, _P]
    lib.zk_padd.argtypes = [_P] * 9 + [_LL, _LL, _P]
    lib.zk_window_fold.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    for fn in (lib.zk_mont_mul, lib.zk_padd, lib.zk_window_fold):
        fn.restype = _I
    lib.zk_error_string.argtypes = [_I]
    lib.zk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - t0


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _lib.zk_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _check(name: str, tensors, shape, n_limbs: int) -> torch.device:
    """Validate kernel operands; returns their common device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if len(shape) < 2 or shape[-2] != n_limbs:
        raise ValueError(f"{name}: limb axis of {tuple(shape)} is not "
                         f"{n_limbs}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


# -----------------------------------------------------------------------------
# mont_mul
# -----------------------------------------------------------------------------

def mont_mul_plain(spec: lf.FieldSpec, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain version of the mont_mul kernel."""
    return lf.join16(lf.mont_mul16(spec, lf.split16(a), lf.split16(b)))


def mont_mul(spec: lf.FieldSpec, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of [..., L, B] int32 tensors."""
    dev = _check("mont_mul", (a, b), a.shape, spec.n_limbs)
    if dev.type == "cpu":
        return mont_mul_plain(spec, a, b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    build()
    lanes = a.shape[-1]
    groups = a.numel() // (spec.n_limbs * lanes)
    with torch.cuda.device(dev):
        _launch("mont_mul", _lib.zk_mont_mul, _FIELD_ID[spec.name],
                a.data_ptr(), b.data_ptr(), out.data_ptr(), groups, lanes,
                _stream(dev))
    return out


# -----------------------------------------------------------------------------
# padd
# -----------------------------------------------------------------------------

B3_MONT = FQ.mont_limbs(12)  # 3 * b for b = 4


def padd16(p, q):
    """Complete RCB15 addition (algorithm 7, a = 0) on 16-bit wide Fq
    triples, with the 12 variable products stacked into three multiplies
    (the reference's `_padd_jnp` batching; same values, fewer ops)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    add = lambda a, b: lf.add16(FQ, a, b)
    sub = lambda a, b: lf.sub16(FQ, a, b)
    mul = lambda a, b: lf.mont_mul16(FQ, a, b)
    st = torch.stack
    sa = add(st([x1, y1, x1]), st([y1, z1, z1]))
    sb = add(st([x2, y2, x2]), st([y2, z2, z2]))
    r = mul(torch.cat([st([x1, y1, z1]), sa]),
            torch.cat([st([x2, y2, z2]), sb]))
    t0, t1, t2 = r[0], r[1], r[2]
    u = sub(sub(r[3:6], st([t0, t1, t0])), st([t1, t2, t2]))
    t3, t4, t5 = u[0], u[1], u[2]
    b3 = lf.const16(FQ, B3_MONT, t2).expand((2,) + t2.shape)
    w = mul(st([t2, t5]), b3)
    t6, y3 = w[0], w[1]
    z3 = add(t1, t6)
    t1 = sub(t1, t6)
    t0_3 = add(add(t0, t0), t0)
    v = mul(st([t3, t4, t1, y3, z3, t0_3]), st([t1, y3, z3, t0_3, t4, t3]))
    return (sub(v[0], v[1]), add(v[2], v[3]), add(v[4], v[5]))


def padd_plain(p, q):
    """Plain version of the padd kernel."""
    out = padd16(tuple(lf.split16(t) for t in p),
                 tuple(lf.split16(t) for t in q))
    return tuple(lf.join16(t) for t in out)


def padd(p, q):
    """Complete G1 addition of [..., 12, B] int32 projective triples."""
    dev = _check("padd", (*p, *q), p[0].shape, FQ.n_limbs)
    if dev.type == "cpu":
        return padd_plain(p, q)
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    if p[0].numel() == 0:
        return out
    build()
    lanes = p[0].shape[-1]
    groups = p[0].numel() // (FQ.n_limbs * lanes)
    with torch.cuda.device(dev):
        _launch("padd", _lib.zk_padd, *(t.data_ptr() for t in (*p, *q)),
                *(t.data_ptr() for t in out), groups, lanes, _stream(dev))
    return out


# -----------------------------------------------------------------------------
# window_fold
# -----------------------------------------------------------------------------

def window_fold_plain(c: int, w_count: int, n_sets: int, x, y, z):
    """Plain version of the window_fold kernel: Horner over the windows,
    highest first, with `padd16` doing every doubling and addition."""
    rows = [lf.split16(t.reshape(n_sets, w_count, FQ.n_limbs)
                       .permute(1, 2, 0)) for t in (x, y, z)]  # [W, 24, S]
    one = lf.const16(FQ, FQ.one_mont, rows[0])
    zero = torch.zeros((2 * FQ.n_limbs, n_sets), dtype=torch.int64,
                       device=x.device)
    acc = (zero, one.expand(-1, n_sets).clone(), zero)
    for w in range(w_count - 1, -1, -1):
        for _ in range(c):
            acc = padd16(acc, acc)
        acc = padd16(acc, tuple(r[w] for r in rows))
    return torch.stack([lf.join16(t) for t in acc])


def window_fold(c: int, w_count: int, n_sets: int, x, y, z) -> torch.Tensor:
    """Fold [S*W, 12, 1] window sums into [3, 12, S] per-set totals."""
    dev = _check("window_fold", (x, y, z), (n_sets * w_count, FQ.n_limbs, 1),
                 FQ.n_limbs)
    if dev.type == "cpu":
        return window_fold_plain(c, w_count, n_sets, x, y, z)
    out = torch.empty((3, FQ.n_limbs, n_sets), dtype=torch.int32, device=dev)
    if n_sets == 0:
        return out
    build()
    with torch.cuda.device(dev):
        _launch("window_fold", _lib.zk_window_fold, x.data_ptr(),
                y.data_ptr(), z.data_ptr(), out.data_ptr(), c, w_count,
                n_sets, _stream(dev))
    return out
