"""The port's CUDA kernels: build, bind, launch, count, and plain versions.

Thirteen kernels from `zkvm_tpu_torch/csrc/` (CUDA C++ for sm_90a):

  * `mont_mul`     replaces `pallas_field.mont_mul_pallas` (reads broadcast
                   and strided operands in place)
  * `mont_pow`     replaces a chain of `mont_mul_pallas` calls that `jit`
                   fuses into one program (`limb_field.mont_pow`): a^e for
                   one host exponent in one launch
  * `padd`         replaces `pallas_field.padd_pallas_2l` (reads strided
                   operands in place)
  * `window_fold`  replaces `pallas_field.window_fold_pallas`
  * `ntt_stages`   replaces `pallas_field.butterfly_pallas`, which the
                   reference runs once a stage between gathers: the whole
                   staged transform, bit reversal included, in a few
                   launches of many stages each (`ntt_plan`)
  * `carry_fold`   replaces `ntt_mxu._carry_fold_pallas`
  * `fold`         replaces `ntt_mxu._fold_pallas`
  * `hades_permute` replaces `pallas_field.hades_permute_pallas` (two
                   kernels behind one entry: one thread a lane, or five
                   threads a lane for a launch too small to fill the card;
                   `csrc/hades.cu` picks by the lane count)
  * `padd_ilp`     replaces `pallas_field.padd_pallas_ilp` / `_ilp2l`
  * `field_addsub` replaces the field additions, subtractions and negations
                   that `jit` fuses into every program holding them
                   (`limb_field.add` / `sub` / `neg`), with an optional
                   lane mask (reads broadcast and strided operands in place)
  * `quotient`     replaces the two programs `jit` fuses in the quotient
                   round (`quotient_kernel.quotient_numerator` and
                   `pointwise_divide`): the numerator of the gate and
                   permutation identities times Z_H^-1, lane by lane, in
                   one launch
  * `msm_gather`   a kernel of the port alone, with no TPU counterpart: the
                   MSM's bucket-sorted points (a row gather of the
                   point-major matrix, y negated by the digit's sign, dead
                   lanes parked) with the first level of the halving tree
                   added on the way (`ops/msm.py`)
  * `msm_digits`   a kernel of the port alone, with no TPU counterpart: the
                   integer work on both sides of the MSM's bucket sort,
                   scalar limbs to signed radix-2^c digits and their sort
                   keys, and the sorted keys back to the (bucket, sign,
                   point index) that `msm_gather` reads

They are compiled with `nvcc` (one process per source, all started
together) and linked into one shared library with a plain C interface on
first use (never at import), cached under `zkvm_tpu_torch/build/` by a hash
of the sources, and bound with ctypes.

`padd`, `padd_ilp`, `window_fold`, `msm_gather` and the Fq chain of
`mont_pow` share the lazily reduced carry-flag arithmetic of
`csrc/fq_lazy.cuh`; `hades_permute`, `ntt_stages`, `carry_fold`, `fold`,
`quotient` and the Fr chain of `mont_pow` that of `csrc/fr_lazy.cuh` (Fr
leaves less room: its ranges are stated there); `msm_digits` does no field
arithmetic; the other kernels use `csrc/field.cuh`.
`fq_mul_chain` (one warp, a chain of dependent Fq products) and
`empty_launch` are measuring probes, not kernels of any path: they have no
count.

Each wrapper checks dtype, shape, device and layout, allocates its
outputs, launches on the current stream and adds one to `LAUNCHES[name]`.
A CPU tensor takes the kernel's plain PyTorch version (`*_plain`, defined
here beside the kernel); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import params
from . import limb_field as lf
from .limb_field import FQ, FR

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_SOURCES = ("mont_mul.cu", "padd.cu", "window_fold.cu", "ntt.cu",
            "ntt_fold.cu", "hades.cu", "padd_ilp.cu", "field_addsub.cu",
            "quotient.cu", "msm_gather.cu", "msm_digits.cu")
_HEADERS = ("common.cuh", "field.cuh", "fq_lazy.cuh", "fr_lazy.cuh")
_FIELD_ID = {"Fr": 0, "Fq": 1}

# launches of each kernel since the last `reset_launches()`
LAUNCHES = {"mont_mul": 0, "mont_pow": 0, "padd": 0, "window_fold": 0,
            "ntt_stages": 0, "carry_fold": 0, "fold": 0, "hades_permute": 0,
            "padd_ilp": 0, "field_addsub": 0, "quotient": 0,
            "msm_gather": 0, "msm_digits": 0}

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
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"  # concurrent builds
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in _SOURCES]
        procs = [subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
             str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(_SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        BUILD_LOG = "".join(logs)
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
        tmp = BUILD_DIR / f"link.{tag}.tmp"
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *(str(o) for o in objs)],
                           capture_output=True, text=True)
        BUILD_LOG += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{BUILD_LOG}")
        tmp.replace(so)
        for o in objs:
            o.unlink()
    lib = ctypes.CDLL(str(so))
    lib.zk_mont_mul.argtypes = [_I, _P, _P, _P, _LL, _LL, _P, _P]
    lib.zk_mont_pow.argtypes = [_I, _P, _P, _P, _I, _LL, _LL, _P]
    lib.zk_empty_launch.argtypes = [_LL, _I, _P]
    lib.zk_padd.argtypes = [_P] * 9 + [_LL, _LL, _P, _P]
    lib.zk_fq_chain.argtypes = [_P, _P, _I, _I, _P]
    lib.zk_window_fold.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.zk_ntt_pass.argtypes = [_P, _P, _P, _LL, _I, _I, _I, _I, _P]
    lib.zk_carry_fold.argtypes = [_P, _P, _LL, _P]
    lib.zk_fold.argtypes = [_P, _P, _LL, _P]
    lib.zk_hades_permute.argtypes = [_P, _P, _P, _LL, _P]
    lib.zk_padd_ilp.argtypes = [_P] * 9 + [_LL, _LL, _P, _P]
    lib.zk_field_addsub.argtypes = [_I, _I, _P, _P, _P, _P, _LL, _LL, _P, _P]
    lib.zk_quotient.argtypes = [_P, _P, _P, _P, _LL, _P]
    lib.zk_msm_gather.argtypes = [_P] * 9 + [_LL, _LL, _LL, _I, _P]
    lib.zk_msm_digits.argtypes = [_P, _P, _P, _LL, _LL, _I, _I, _I, _P]
    lib.zk_msm_digits_unpack.argtypes = [_P] * 4 + [_LL, _I, _P]
    for fn in (lib.zk_mont_mul, lib.zk_mont_pow, lib.zk_empty_launch,
               lib.zk_padd, lib.zk_window_fold, lib.zk_ntt_pass,
               lib.zk_carry_fold, lib.zk_fold, lib.zk_hades_permute,
               lib.zk_padd_ilp, lib.zk_fq_chain, lib.zk_field_addsub,
               lib.zk_quotient, lib.zk_msm_gather, lib.zk_msm_digits,
               lib.zk_msm_digits_unpack):
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

def _strided_layout(sizes, strides):
    """(group, limb, lane) strides in elements of a [..., L, B] view with
    these sizes and strides whose leading axes collapse into one group axis
    (stride[k] = stride[k + 1] * size[k + 1]; a broadcast axis has stride
    0), else None.  The limb and lane strides are free."""
    lead = [(n, s) for n, s in zip(sizes[:-2], strides[:-2]) if n != 1]
    for (_, s0), (n1, s1) in zip(lead, lead[1:]):
        if s0 != s1 * n1:
            return None
    return (lead[-1][1] if lead else 0, strides[-2], strides[-1])


def mont_mul_shape(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The [..., L, B] shape two mont_mul operands broadcast to (the limb
    axis taken as it is: `mont_mul` checks it)."""
    sa, sb = tuple(a.shape), tuple(b.shape)
    if sa == sb:
        return sa
    if len(sa) < len(sb):
        sa, sb = sb, sa
    sb = (1,) * (len(sa) - len(sb)) + sb
    for n, m in zip(sa, sb):
        if n != m and n != 1 and m != 1:
            raise ValueError(f"mont_mul: shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)} do not broadcast")
    return tuple(max(n, m) if n and m else 0 for n, m in zip(sa, sb))


def mont_mul_layout(t: torch.Tensor, shape):
    """(group, limb, lane) strides in elements if the mont_mul kernel can
    read `t`, broadcast to the [..., L, B] `shape`, in place, else None.  It
    can when `t` has the limb axis at -2 in full and its leading axes, as
    broadcast, collapse into one group axis: a constant column [L, 1], one
    table shared by every leading group, every second lane, a slice of the
    lanes."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        if t.is_contiguous():
            return (shape[-2] * shape[-1], shape[-1], 1)
        return _strided_layout(shape, t.stride())
    pad = len(shape) - t.dim()
    if t.dim() < 2 or pad < 0 or t.shape[-2] != shape[-2]:
        return None
    strides = [0] * pad
    for n, m, stride in zip(t.shape, shape[pad:], t.stride()):
        if n != m and n != 1:
            return None
        strides.append(stride if n == m else 0)  # a broadcast axis
    return _strided_layout(shape, strides)


def _mont_operands(name: str, spec: lf.FieldSpec, tensors) -> torch.device:
    """What every Montgomery kernel asks of its operands; their device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dim() < 2 or t.shape[-2] != spec.n_limbs:
            raise ValueError(f"{name}: limb axis of {tuple(t.shape)} is not "
                             f"{spec.n_limbs}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def mont_mul_plain(spec: lf.FieldSpec, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain version of the mont_mul kernel, on the same (broadcast or
    strided) operands."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    wide = shape[:-2] + (2 * shape[-2],) + shape[-1:]
    return lf.join16(lf.mont_mul16(spec, lf.split16(a).expand(wide),
                                   lf.split16(b)))


def mont_mul(spec: lf.FieldSpec, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of int32 limb tensors that broadcast
    to one [..., L, B] shape.  Each operand is read in place through its
    strides (see `mont_mul_layout`); what cannot be raises.  The result is
    contiguous."""
    dev = _mont_operands("mont_mul", spec, (a, b))
    shape = mont_mul_shape(a, b)
    layouts = (mont_mul_layout(a, shape), mont_mul_layout(b, shape))
    for t, layout in zip((a, b), layouts):
        if layout is None:
            raise ValueError(
                f"mont_mul: an operand of shape {tuple(t.shape)} and strides "
                f"{t.stride()} cannot be read in place as {shape}: its "
                f"leading axes must collapse into one")
    if dev.type == "cpu":
        return mont_mul_plain(spec, a, b)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    build()
    lanes = shape[-1]
    groups = out.numel() // (spec.n_limbs * lanes)
    strides = (ctypes.c_longlong * 6)(*layouts[0], *layouts[1])
    with torch.cuda.device(dev):
        _launch("mont_mul", _lib.zk_mont_mul, _FIELD_ID[spec.name],
                a.data_ptr(), b.data_ptr(), out.data_ptr(), groups, lanes,
                strides, _stream(dev))
    return out


# -----------------------------------------------------------------------------
# field_addsub
# -----------------------------------------------------------------------------

FIELD_OPS = {"add": 0, "sub": 1, "neg": 2}


def field_addsub_shape(op: str, a: torch.Tensor, b, mask) -> tuple:
    """The [..., L, B] shape of a field_addsub result: a and b (and the mask
    as [..., 1, B]) broadcast to it."""
    shape = tuple(a.shape) if op == "neg" else mont_mul_shape(a, b)
    if mask is not None:
        shape = tuple(torch.broadcast_shapes(shape, mask.unsqueeze(-2).shape))
    return shape


def mask_layout(mask: torch.Tensor, shape):
    """(group, lane) strides in bytes if the kernel can read the [..., B]
    bool `mask`, broadcast over the limbs of the [..., L, B] `shape`, in
    place, else None."""
    if mask.dtype != torch.bool or mask.dim() < 1:
        return None
    try:
        view = mask.unsqueeze(-2).expand(shape)
    except RuntimeError:
        return None
    layout = _strided_layout(shape, view.stride())
    return None if layout is None else (layout[0], layout[2])


def field_addsub_plain(spec: lf.FieldSpec, op: str, a: torch.Tensor,
                       b=None, mask=None) -> torch.Tensor:
    """Plain version of the field_addsub kernel: the 16-bit wide add16 /
    sub16 of `limb_field`, then the mask's select."""
    wa = lf.split16(a)
    if op == "add":
        r = lf.add16(spec, wa, lf.split16(b))
    elif op == "sub":
        r = lf.sub16(spec, wa, lf.split16(b))
    else:
        r = lf.sub16(spec, torch.zeros_like(wa), wa)
    if mask is not None:
        r = torch.where(mask.unsqueeze(-2), r, wa)
    shape = field_addsub_shape(op, a, b, mask)
    return lf.join16(r.expand(shape[:-2] + (2 * shape[-2],) + shape[-1:]))


def field_addsub(spec: lf.FieldSpec, op: str, a: torch.Tensor, b=None,
                 mask=None) -> torch.Tensor:
    """(a + b) mod p, (a - b) mod p or (-a) mod p (`op` "add", "sub", "neg";
    b is None for "neg") elementwise over int32 limb tensors that broadcast
    to one [..., L, B] shape; with a [..., B] bool `mask`, that value where
    the mask is set and `a` where it is clear.  Each operand and the mask
    are read in place through their strides (see `mont_mul_layout`); what
    cannot be raises.  The result is contiguous."""
    if op not in FIELD_OPS or (b is None) != (op == "neg"):
        raise ValueError(f"field_addsub: op {op!r} with "
                         f"{'no' if b is None else 'a'} second operand")
    dev = _mont_operands("field_addsub", spec, (a,) if b is None else (a, b))
    shape = field_addsub_shape(op, a, b, mask)
    layouts = [mont_mul_layout(t, shape) for t in ((a,) if b is None
                                                   else (a, b))]
    for t, layout in zip((a, b), layouts):
        if layout is None:
            raise ValueError(
                f"field_addsub: an operand of shape {tuple(t.shape)} and "
                f"strides {t.stride()} cannot be read in place as {shape}: "
                f"its leading axes must collapse into one")
    mask_strides = (0, 0)
    if mask is not None:
        if mask.device != dev:
            raise ValueError(f"field_addsub: mask on {mask.device}, "
                             f"operands on {dev}")
        mask_strides = mask_layout(mask, shape)
        if mask_strides is None:
            raise ValueError(f"field_addsub: a mask of shape "
                             f"{tuple(mask.shape)}, strides {mask.stride()} "
                             f"and dtype {mask.dtype} cannot be read in "
                             f"place over {shape}")
    if dev.type == "cpu":
        return field_addsub_plain(spec, op, a, b, mask)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    build()
    lanes = shape[-1]
    groups = out.numel() // (spec.n_limbs * lanes)
    if b is None:
        b, layouts = a, layouts * 2
    strides = (ctypes.c_longlong * 8)(*layouts[0], *layouts[1],
                                      *mask_strides)
    with torch.cuda.device(dev):
        _launch("field_addsub", _lib.zk_field_addsub, _FIELD_ID[spec.name],
                FIELD_OPS[op], a.data_ptr(), b.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                groups, lanes, strides, _stream(dev))
    return out


# -----------------------------------------------------------------------------
# mont_pow
# -----------------------------------------------------------------------------

MAX_EXPONENT_BITS = 384


def mont_pow_plain(spec: lf.FieldSpec, a: torch.Tensor,
                   e: int) -> torch.Tensor:
    """Plain version of the mont_pow kernel: MSB-first square-and-multiply
    from 1, one plain product a squaring and one a set bit (the loop of the
    reference's `mont_pow`)."""
    w = lf.split16(a)
    acc = lf.const16(spec, spec.one_mont, w).expand(w.shape)
    for i in range(e.bit_length() - 1, -1, -1):
        acc = lf.mont_mul16(spec, acc, acc)
        if (e >> i) & 1:
            acc = lf.mont_mul16(spec, acc, w)
    return lf.join16(acc.contiguous())


def mont_pow(spec: lf.FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery in and out) over a contiguous [..., L, B] int32
    tensor, for one non-negative host exponent of at most 384 bits: the
    whole chain in one launch.  Zero stays zero for e > 0; e = 0 gives 1."""
    dev = _mont_operands("mont_pow", spec, (a,))
    if not a.is_contiguous():
        raise ValueError("mont_pow: the operand must be contiguous")
    if e < 0 or e.bit_length() > MAX_EXPONENT_BITS:
        raise ValueError(f"mont_pow: exponent of {e.bit_length()} bits "
                         f"(sign {'-' if e < 0 else '+'}) is not in "
                         f"[0, 2^{MAX_EXPONENT_BITS})")
    if dev.type == "cpu":
        return mont_pow_plain(spec, a, e)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    build()
    lanes = a.shape[-1]
    groups = a.numel() // (spec.n_limbs * lanes)
    bits = e.bit_length()
    words = (ctypes.c_uint32 * (MAX_EXPONENT_BITS // 32))(
        *((e >> (32 * i)) & lf.M32 for i in range((bits + 31) // 32)))
    with torch.cuda.device(dev):
        _launch("mont_pow", _lib.zk_mont_pow, _FIELD_ID[spec.name],
                a.data_ptr(), out.data_ptr(), words, bits, groups, lanes,
                _stream(dev))
    return out


def empty_launch(blocks: int, threads: int, dev: torch.device) -> None:
    """A measuring probe, not a kernel of any path: launch an empty kernel
    of `blocks` blocks of `threads`, so that a run can say how much of a
    short launch is the launch itself."""
    build()
    with torch.cuda.device(dev):
        rc = _lib.zk_empty_launch(blocks, threads, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"empty launch failed: "
                           f"{_lib.zk_error_string(rc).decode()} ({rc})")


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


def padd_layout(point):
    """(group, limb, lane) strides in elements if the padd kernel can read
    the [..., 12, B] triple `point` in place, else None.  It can when the
    three coordinates share one shape and one set of strides and the leading
    axes collapse into one group axis (stride[k] = stride[k + 1] * size[k +
    1]); the limb and lane strides are free."""
    x = point[0]
    if x.dim() < 2 or any(t.shape != x.shape or t.stride() != x.stride()
                          for t in point[1:]):
        return None
    return _strided_layout(x.shape, x.stride())


def _add_points(name: str, p, q, layouts):
    """The body the two addition wrappers share: validate the six
    coordinates and their layouts (`padd_layout` of p and of q, None where
    the kernel cannot read a point in place), then the plain version (CPU)
    or one launch of `zk_<name>` into contiguous outputs."""
    for point, layout in zip((p, q), layouts):
        if layout is None:
            raise ValueError(
                f"{name}: the three coordinates of a point must share one "
                f"layout whose leading axes collapse into one (strides "
                f"{[t.stride() for t in point]})")
    if len(p) != 3 or len(q) != 3:
        raise ValueError(f"{name}: a point is an (x, y, z) triple")
    shape, dev = p[0].shape, p[0].device
    for t in (*p, *q):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    if len(shape) < 2 or shape[-2] != FQ.n_limbs:
        raise ValueError(f"{name}: limb axis of {tuple(shape)} is not "
                         f"{FQ.n_limbs}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cpu":
        return padd_plain(p, q)
    out = tuple(torch.empty(shape, dtype=torch.int32, device=dev)
                for _ in range(3))
    if p[0].numel() == 0:
        return out
    build()
    lanes = shape[-1]
    groups = p[0].numel() // (FQ.n_limbs * lanes)
    strides = (ctypes.c_longlong * 6)(*layouts[0], *layouts[1])
    with torch.cuda.device(dev):
        _launch(name, getattr(_lib, "zk_" + name),
                *(t.data_ptr() for t in (*p, *q)),
                *(t.data_ptr() for t in out), groups, lanes, strides,
                _stream(dev))
    return out


def padd(p, q, layouts=None):
    """Complete G1 addition of [..., 12, B] int32 projective triples.  Each
    point may be any strided view (every second lane, one half, a
    transpose) as long as its three coordinates share one layout; the
    result is contiguous.  A caller that has the two points' `padd_layout`
    already hands them over as `layouts`, so that they are computed once."""
    if layouts is None:
        layouts = (padd_layout(p), padd_layout(q))
    return _add_points("padd", p, q, layouts)


def padd_ilp_plain(p, q):
    """Plain version of the padd_ilp kernel: the function is `padd`'s, so
    `padd16` serves both addition kernels."""
    return padd_plain(p, q)


def padd_ilp(p, q, layouts=None):
    """The same addition as `padd`, bit for bit, by the grouped kernel: two
    threads a point, each taking 3 + 3 of the 6 + 6 products.  Strided
    points and `layouts` are taken as `padd` takes them."""
    if layouts is None:
        layouts = (padd_layout(p), padd_layout(q))
    return _add_points("padd_ilp", p, q, layouts)


# -----------------------------------------------------------------------------
# msm_gather
# -----------------------------------------------------------------------------

def msm_gather_plain(pm, sid, neg, perm, half: int, src=None,
                     pairs: bool = False):
    """Plain version of the msm_gather kernel: the PyTorch composition it
    replaces.  A row gather of `pm` by the permutation (read at `src`), the
    masked negation of y, the identity parked where the bucket id is above
    `half`; in merge mode `padd` of the even and odd lanes, kept where the
    two share a bucket, and the left lanes' ids where they do not."""
    from . import g1_ops  # g1_ops imports this module

    if src is not None:
        at = src.to(torch.int64).clamp(0, perm.shape[-1] - 1)
        neg, perm = neg.gather(1, at), perm.gather(1, at)
    b, k = perm.shape
    l = FQ.n_limbs
    g = pm.index_select(0, perm.reshape(-1))             # [B*K, 36]
    g = g.reshape(b, k, 3 * l).transpose(1, 2)           # [B, 36, K]
    x, y, z = g[:, :l], g[:, l:2 * l], g[:, 2 * l:]
    pts = g1_ops.park_identity(sid > half, (x, lf.neg(FQ, y, mask=neg), z))
    if not pairs:
        return pts
    left = tuple(t[..., 0::2] for t in pts)
    right = tuple(t[..., 1::2] for t in pts)
    sl, sr = sid[:, 0::2], sid[:, 1::2]
    same = sl == sr
    return (g1_ops.pselect(same, g1_ops.padd(left, right), right),
            torch.where(same, half + 1, sl))


def msm_gather(pm, sid, neg, perm, half: int, src=None, pairs: bool = False):
    """The MSM's bucket-sorted points from one sort per digit row: sid [B, N]
    int32 ascending bucket ids (dead lanes above `half`), neg [B, N] bool
    signs and perm [B, N] int64 rows of the point-major pm [rows, 36].  The
    point of sorted lane i is pm[perm[:, i]], y negated where neg is set,
    the identity where sid > half.  Every row a live lane reads is affine
    (z = 1), as `msm.MSMContext` holds its points: the kernel adds pairs by
    the affine formula.

    Merge mode (`pairs`): lanes 2j and 2j + 1 added where they share a
    bucket, else lane 2j + 1; returns (x, y, z) [B, 12, N/2] and the left
    lanes' ids [B, N/2] int32 (half + 1 where merged).  Gather mode: the
    points of the sorted lanes src [B, K] int32 (all N when `src` is None),
    sid then being the output lanes' [B, K] ids; returns (x, y, z) [B, 12,
    K].  Outputs are contiguous and canonical."""
    if perm.dim() != 2:
        raise ValueError(f"msm_gather: perm of shape {tuple(perm.shape)} is "
                         f"not [B, N]")
    b, n = perm.shape
    if pairs and (src is not None or n % 2):
        raise ValueError("msm_gather: merge mode takes an even N and no src")
    k = n // 2 if pairs else (n if src is None else src.shape[-1])
    specs = [(pm, torch.int32, (pm.shape[0], 3 * FQ.n_limbs)),
             (sid, torch.int32, (b, n if pairs else k)),
             (neg, torch.bool, (b, n)), (perm, torch.int64, (b, n))]
    if src is not None:
        specs.append((src, torch.int32, (b, k)))
    dev = pm.device
    for t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"msm_gather: {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
        if t.device != dev:
            raise ValueError(f"msm_gather: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("msm_gather: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"msm_gather: unsupported device {dev}")
    if dev.type == "cpu":
        return msm_gather_plain(pm, sid, neg, perm, half, src, pairs)
    if pm.data_ptr() % 16:
        raise ValueError("msm_gather: pm must be 16-byte aligned")
    out = tuple(torch.empty((b, FQ.n_limbs, k), dtype=torch.int32,
                            device=dev) for _ in range(3))
    rsid = torch.empty((b, k), dtype=torch.int32, device=dev) if pairs else None
    if b * k:
        build()
        with torch.cuda.device(dev):
            _launch("msm_gather", _lib.zk_msm_gather, pm.data_ptr(),
                    sid.data_ptr(), neg.data_ptr(), perm.data_ptr(),
                    None if src is None else src.data_ptr(),
                    *(t.data_ptr() for t in out),
                    None if rsid is None else rsid.data_ptr(), b, k, n, half,
                    _stream(dev))
    return (out, rsid) if pairs else out


# -----------------------------------------------------------------------------
# msm_digits
# -----------------------------------------------------------------------------

def digit_windows(c: int) -> int:
    """Signed radix-2^c digits of a scalar: 256 bits and headroom for the
    carry sweep."""
    return -(-260 // c)


def key_index_bits(n: int) -> int:
    """Bits of a lane index in the packed sort key of n lanes."""
    return max(n - 1, 1).bit_length()


def packed_key_fits(half: int, n: int) -> bool:
    """Whether (bucket, sign, index) of n lanes and `half` buckets pack into
    one i32 key; past it (from n > 2^17 at c = 13) the key overflows and the
    stable sort of (bucket, sign) takes over."""
    return ((half + 1) << (key_index_bits(n) + 1)) < (1 << 31)


def msm_digits_plain(x, pinf=None, c: int = 0, unpack: bool = False):
    """Plain version of the msm_digits kernel: the PyTorch composition it
    replaces.  Pack mode: `msm._signed_digit_tensors`, then each digit's
    key (`msm._digit_keys`); unpack mode: the packed keys' three fields."""
    if unpack:
        ib = key_index_bits(x.shape[-1])
        return (x >> (ib + 1), ((x >> ib) & 1) == 1,
                (x & ((1 << ib) - 1)).to(torch.int64))
    from . import msm  # msm imports this module

    return msm._digit_keys(msm._signed_digit_tensors(x, c), pinf,
                           1 << (c - 1))


def msm_digits(x, pinf=None, c: int = 0, unpack: bool = False):
    """The integer work on both sides of the MSM's bucket sort.

    Pack mode: canonical scalar limbs x [S, 8, N] int32 and the points'
    infinity flags pinf [N] bool -> one sort key a signed radix-2^c digit,
    [S*W, N] int32 (W = `digit_windows(c)`; row s*W + w is digit w of set
    s): the bucket |d| (half + 1 where d = 0 or the point is at infinity)
    and the sign, with the lane index where `packed_key_fits(half, N)`, so
    that an unstable sort orders a row by (bucket, sign, index); else
    (bucket << 1) | sign, the key of a stable sort.  Unpack mode: packed
    keys x [B, N] int32, each row sorted -> (sid [B, N] int32 bucket ids,
    neg [B, N] bool signs, perm [B, N] int64 lanes), the operands of
    `msm_gather`.  Outputs are contiguous."""
    name = "msm_digits"
    if x.dtype != torch.int32 or x.dim() != (2 if unpack else 3):
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)}, expected int32 "
                         f"{'[B, N]' if unpack else '[S, 8, N]'}")
    dev = x.device
    if not unpack:
        s, n_limbs, n = x.shape
        if n_limbs != FR.n_limbs:
            raise ValueError(f"{name}: limb axis of {tuple(x.shape)} is not "
                             f"{FR.n_limbs}")
        if pinf is None or pinf.dtype != torch.bool or \
                tuple(pinf.shape) != (n,):
            raise ValueError(f"{name}: pinf must be bool [{n}]")
        if not 1 <= c <= 24:
            raise ValueError(f"{name}: window width {c} outside [1, 24]")
        if pinf.device != dev:
            raise ValueError(f"{name}: operands on {pinf.device} and {dev}")
    if not x.is_contiguous() or not (unpack or pinf.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cpu":
        return msm_digits_plain(x, pinf, c, unpack)
    if unpack:
        b, n = x.shape
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: keys must be 16-byte aligned")
        sid = torch.empty((b, n), dtype=torch.int32, device=dev)
        neg = torch.empty((b, n), dtype=torch.bool, device=dev)
        perm = torch.empty((b, n), dtype=torch.int64, device=dev)
        if b * n:
            build()
            with torch.cuda.device(dev):
                _launch(name, _lib.zk_msm_digits_unpack, x.data_ptr(),
                        sid.data_ptr(), neg.data_ptr(), perm.data_ptr(),
                        b * n, key_index_bits(n), _stream(dev))
        return sid, neg, perm
    w_count = digit_windows(c)
    keys = torch.empty((s * w_count, n), dtype=torch.int32, device=dev)
    if s * n:
        ib = key_index_bits(n) if packed_key_fits(1 << (c - 1), n) else 0
        build()
        with torch.cuda.device(dev):
            _launch(name, _lib.zk_msm_digits, x.data_ptr(), pinf.data_ptr(),
                    keys.data_ptr(), s, n, c, w_count, ib, _stream(dev))
    return keys


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


def fq_mul_chain_plain(a: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of the probe: x <- x a / R, `iters` times, from x = a."""
    w = lf.split16(a)
    acc = w
    for _ in range(iters):
        acc = lf.mont_mul16(FQ, acc, w)
    return lf.join16(acc)


def fq_mul_chain(a: torch.Tensor, iters: int, lazy: bool) -> torch.Tensor:
    """A measuring probe, not a kernel of any path: one warp, each of its 32
    lanes walks `iters` dependent Fq products x <- x a / R from x = a, by
    `field.cuh`'s fully reduced product or (`lazy`) by the carry-flag product
    of the two G1 kernels.  `a` is [12, 32] int32 below q; returns the
    canonical x.  Its time over `iters` is the latency of one product in one
    thread."""
    dev = _check("fq_mul_chain", (a,), (FQ.n_limbs, 32), FQ.n_limbs)
    if dev.type == "cpu":
        return fq_mul_chain_plain(a, iters)
    out = torch.empty_like(a)
    build()
    with torch.cuda.device(dev):
        rc = _lib.zk_fq_chain(a.data_ptr(), out.data_ptr(), iters, int(lazy),
                              _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fq_mul_chain launch failed: "
                           f"{_lib.zk_error_string(rc).decode()} ({rc})")
    return out


# -----------------------------------------------------------------------------
# ntt_stages
# -----------------------------------------------------------------------------

# the tiles a block of `csrc/ntt.cu` holds: 2^9 or 2^10 Fr elements, 16 or
# 32 KB of shared memory, four blocks of 128 threads an SM
NTT_LOG_TILES = (9, 10)


def bit_reverse_indices(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt_plan(log_n: int, log_tile: int) -> list[tuple[int, int, int]]:
    """The passes of the staged transform of 2^log_n elements over tiles of
    at most 2^log_tile: (s0, k, c) = the pass runs the stages s0 .. s0 +
    k - 1 on tiles of 2^k rows by 2^c columns.  A transform that fits one
    tile is one pass of one column.  Else the first pass keeps at least 4
    columns (its loads are runs of that many words), the later ones at
    least 8, and the stages are spread evenly over the fewest passes; a
    later pass takes its columns from the position's low bits, so c <= s0
    (which binds only for tiles below 2^8).  Tiles of at least 2^4."""
    if log_n <= log_tile:
        return [(0, log_n, 0)]
    first, later = log_tile - 2, log_tile - 3
    passes = 2 + max(0, -(-(log_n - first - later) // later))
    base, extra = divmod(log_n, passes)
    plan, s0 = [], 0
    for i in range(passes):
        k = base + (i < extra)
        plan.append((s0, k, min(log_tile - k, log_n - k if i == 0 else s0)))
        s0 += k
    return plan


def ntt_log_tile(log_n: int) -> int:
    """The tile a transform of 2^log_n takes: of NTT_LOG_TILES the one with
    the fewest passes, the smaller where they tie (more blocks in flight,
    the faster on the card: `tools/ntt_tiles.py`).  2^16 and 2^19 take
    2^9 in three passes, 2^20 takes 2^10 in three."""
    return min(NTT_LOG_TILES, key=lambda e: (len(ntt_plan(log_n, e)), e))


def butterfly_plain(even: torch.Tensor, odd: torch.Tensor, tw: torch.Tensor):
    """One radix-2 stage on paired lanes: (even + tw * odd, even - tw * odd)
    over Fr, `tw` shaped like the operands or broadcast to them."""
    e = lf.split16(even)
    t = lf.mont_mul16(FR, lf.split16(odd), lf.split16(tw))
    return lf.join16(lf.add16(FR, e, t)), lf.join16(lf.sub16(FR, e, t))


def ntt_stages_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain version of the ntt_stages kernel: the bit-reversal gather,
    then one `butterfly_plain` a stage.  Stage s pairs the positions b 2h +
    t and b 2h + h + t (h = 2^s) with the twiddle tw[(n >> (s + 1)) t]."""
    n = x.shape[-1]
    lead = x.shape[:-2]
    brev = torch.from_numpy(bit_reverse_indices(n).astype(np.int64))
    x = x.index_select(-1, brev.to(x.device))
    for s in range(n.bit_length() - 1):
        h = 1 << s
        m = n // (2 * h)
        v = x.reshape(*lead, FR.n_limbs, m, 2, h)
        w = tw[:, :n // 2:n >> (s + 1)].unsqueeze(-2).expand(FR.n_limbs, m, h)
        plus, minus = butterfly_plain(
            v[..., 0, :].reshape(*lead, FR.n_limbs, m * h),
            v[..., 1, :].reshape(*lead, FR.n_limbs, m * h),
            w.reshape(FR.n_limbs, m * h))
        x = torch.stack([plus.reshape(*lead, FR.n_limbs, m, h),
                         minus.reshape(*lead, FR.n_limbs, m, h)],
                        dim=-2).reshape(x.shape)
    return x


def ntt_stages(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The radix-2 NTT of a contiguous [..., 8, n] int32 Montgomery tensor
    (n = 2^L >= 2), natural order in and out, with the [8, n/2] table of
    the powers of the root (the inverse root for the inverse transform,
    whose 1/n scaling is the caller's).  On the card: one launch a pass of
    `ntt_plan` (three at 2^16, 2^19 and 2^20), each counted.

    Contract: every element of `tw` is canonical (below r); the elements
    of `x` may be any 256-bit words.  The result equals the plain version's
    (that is the reference's staged transform) word for word on every
    input: its butterflies by tw[0] = 1, which take no product, first bring
    the odd operand below r as the plain version's product by R mod r does,
    and its additions keep the carry out of 2^256 and subtract r once, as
    the plain version's do (`csrc/ntt.cu`; `tests/test_torch_ntt_design.py`
    models it on (0, 0, r + 1, 0), (r, 0, 0, 0) and rows in [r, 2^256)).
    For canonical `x`, the only input on a path
    (`tests/test_torch_ntt_route.py`), every element of the result is
    canonical."""
    dev = _mont_operands("ntt_stages", FR, (x, tw))
    n = x.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"ntt_stages: length {n} is not a power of two "
                         f">= 2")
    if tuple(tw.shape) != (FR.n_limbs, n // 2):
        raise ValueError(f"ntt_stages: twiddle table {tuple(tw.shape)} is "
                         f"not [8, {n // 2}]")
    if not (x.is_contiguous() and tw.is_contiguous()):
        raise ValueError("ntt_stages: operands must be contiguous")
    if dev.type == "cpu":
        return ntt_stages_plain(x, tw)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    build()
    log_n = n.bit_length() - 1
    rows = x.numel() // (FR.n_limbs * n)
    with torch.cuda.device(dev):
        for s0, k, c in ntt_plan(log_n, ntt_log_tile(log_n)):
            _launch("ntt_stages", _lib.zk_ntt_pass, x.data_ptr(),
                    out.data_ptr(), tw.data_ptr(), rows, log_n, s0, k, c,
                    _stream(dev))
    return out


# -----------------------------------------------------------------------------
# carry_fold and fold (the leaf reductions of the matmul NTT)
# -----------------------------------------------------------------------------

N_COLUMNS = 68               # byte columns of one reassembled product
N_WORDS = N_COLUMNS // 4     # 17 carried 32-bit words

# split-fold constants: value = lo + 2^256 mid + 2^512 hi, and the Montgomery
# product with K1 = 2^256 R mod r (K2 = 2^512 R mod r) multiplies by 2^256
# (2^512)
K1 = lf.int_to_limbs((1 << 256) * FR.R % FR.modulus, FR.n_limbs)
K2 = lf.int_to_limbs((1 << 512) * FR.R % FR.modulus, FR.n_limbs)


def _check_rows(name: str, t: torch.Tensor, rows: int) -> torch.device:
    """Validate a row-major [rows, ...] kernel operand."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() < 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                         f"[{rows}, ...]")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def fold16(w: torch.Tensor) -> torch.Tensor:
    """Split-fold of canonical 16-bit limbs [34, ...] int64 -> [16, ...]
    mod r: lo mod r + mid * 2^256 + hi * 2^512.  lo < 2^256 < 3r takes two
    conditional subtractions; mid is any 256-bit value, and its product
    with K1 < r still lands below 2r, which `mont_mul16` reduces."""
    n = 2 * FR.n_limbs
    lo, mid = w[:n], w[n:2 * n]
    hi = F.pad(w[2 * n:], (0, 0) * (w.dim() - 1) + (0, 3 * n - w.shape[0]))
    for _ in range(2):
        lo = lf._reduce_once(FR, lf._with_top(lo.unsqueeze(0))).squeeze(0)
    y = lf.add16(FR, lo, lf.mont_mul16(FR, mid, lf.const16(FR, K1, w)))
    return lf.add16(FR, y, lf.mont_mul16(FR, hi, lf.const16(FR, K2, w)))


def carry_bytes(d: torch.Tensor) -> torch.Tensor:
    """The byte carry over [68, B] int32 columns -> [17, B] int32 carried
    words (the reference's carry scan, arithmetic shifts included)."""
    cols = d.to(torch.int64)
    carry = torch.zeros_like(cols[0])
    words = []
    for w in range(N_WORDS):
        word = torch.zeros_like(carry)
        for k in range(4):
            c = cols[4 * w + k] + carry
            word = word | ((c & 0xFF) << (8 * k))
            carry = c >> 8
        words.append(word)
    v = torch.stack(words)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def fold_plain(limbs: torch.Tensor) -> torch.Tensor:
    """Plain version of the fold kernel."""
    flat = limbs.reshape(N_WORDS, -1)
    out = lf.join16(fold16(lf.split16(flat)))
    return out.reshape((FR.n_limbs,) + limbs.shape[1:])


def carry_fold_plain(d: torch.Tensor) -> torch.Tensor:
    """Plain version of the carry_fold kernel."""
    return fold_plain(carry_bytes(d))


def _launch_rows(name: str, t: torch.Tensor, dev) -> torch.Tensor:
    """Launch `zk_<name>` over the lanes of a [rows, ...] operand."""
    out = torch.empty((FR.n_limbs,) + t.shape[1:], dtype=torch.int32,
                      device=dev)
    if t.numel() == 0:
        return out
    build()
    with torch.cuda.device(dev):
        _launch(name, getattr(_lib, "zk_" + name), t.data_ptr(),
                out.data_ptr(), t.numel() // t.shape[0], _stream(dev))
    return out


def carry_fold(d: torch.Tensor) -> torch.Tensor:
    """[68, ...] int32 byte columns (non-negative, below 2^29) -> [8, ...]
    int32 limbs of the value sum_t d[t] 2^(8t) mod r."""
    dev = _check_rows("carry_fold", d, N_COLUMNS)
    if dev.type == "cpu":
        return carry_fold_plain(d)
    return _launch_rows("carry_fold", d, dev)


def fold_multiply_adds() -> int:
    """32-bit multiply-adds of one lane of the split-fold of
    `csrc/ntt_fold.cu` (`fold` and `carry_fold`): one Montgomery product
    (mid by K1, 272) and the eight limb products of hi's one word by K2,
    which row 0 alone takes, a low and a high half each."""
    return dot_multiply_adds(1) + 2 * FR.n_limbs


def fold(limbs: torch.Tensor) -> torch.Tensor:
    """[17, ...] int32 carried words -> [8, ...] int32 limbs mod r."""
    dev = _check_rows("fold", limbs, N_WORDS)
    if dev.type == "cpu":
        return fold_plain(limbs)
    return _launch_rows("fold", limbs, dev)


# -----------------------------------------------------------------------------
# hades_permute
# -----------------------------------------------------------------------------

HADES_WIDTH = params.HADES_WIDTH
HADES_ROUNDS = params.HADES_ROUNDS
_HADES_HALF = params.HADES_FULL_ROUNDS // 2
# rows of the constant table: 68 x 5 round constants, then the 5 x 5 MDS
# matrix row-major, each a Montgomery Fr element of 8 limbs
HADES_CONST_ROWS = HADES_ROUNDS * HADES_WIDTH + HADES_WIDTH * HADES_WIDTH


def hades_coop_max_lanes() -> int:
    """The lane count up to which `csrc/hades.cu` takes its five-thread
    kernel, read out of the source (for the checks that want a size on
    either side of it; the wrapper itself does not choose)."""
    found = re.search(r"kCoopMaxLanes = (\d+);",
                      (CSRC / "hades.cu").read_text())
    return int(found.group(1))


def hades_full_round(r: int) -> bool:
    """Rounds 0-3 and 64-67 put every word through the S-box, rounds 4-63
    only the last."""
    return (r < _HADES_HALF
            or r >= _HADES_HALF + params.HADES_PARTIAL_ROUNDS)


def hades_permute_plain(state: torch.Tensor,
                        consts: torch.Tensor) -> torch.Tensor:
    """Plain version of the hades_permute kernel: the five words stacked in
    one tensor, the 25 MDS products in one multiply."""
    w = HADES_WIDTH
    c = lf.split16(consts.reshape(HADES_CONST_ROWS, FR.n_limbs, 1))
    arc = c[:HADES_ROUNDS * w].reshape(HADES_ROUNDS, w, -1, 1)
    mds = c[HADES_ROUNDS * w:].reshape(w, w, -1, 1)
    mul = lambda a, b: lf.mont_mul16(FR, a, b)
    s = lf.split16(state)                                    # [5, 16, B]
    for r in range(HADES_ROUNDS):
        s = lf.add16(FR, s, arc[r])
        box = s if hades_full_round(r) else s[w - 1:]
        x2 = mul(box, box)
        x5 = mul(mul(x2, x2), box)
        s = x5 if hades_full_round(r) else torch.cat([s[:w - 1], x5])
        # out[row] = sum_col MDS[row, col] * s[col]
        prod = mul(s.unsqueeze(0).expand((w,) + s.shape), mds)
        out = prod[:, 0]
        for col in range(1, w):
            out = lf.add16(FR, out, prod[:, col])
        s = out
    return lf.join16(s)


def hades_permute(state: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """68 Hades rounds over a [5, 8, B] int32 Montgomery state.  `consts`
    is the [365, 8] int32 Montgomery table of round constants and MDS
    matrix (`ops/poseidon.py` builds it once per device).  One launch; the
    source picks five threads a permutation or one thread a lane by B."""
    dev = _check("hades_permute", (state,),
                 (HADES_WIDTH, FR.n_limbs, state.shape[-1]), FR.n_limbs)
    if (_check_rows("hades_permute", consts, HADES_CONST_ROWS) != dev
            or tuple(consts.shape) != (HADES_CONST_ROWS, FR.n_limbs)):
        raise ValueError(f"hades_permute: constants {tuple(consts.shape)} "
                         f"on {consts.device}, state on {dev}")
    if dev.type == "cpu":
        return hades_permute_plain(state, consts)
    out = torch.empty_like(state)
    if state.numel() == 0:
        return out
    build()
    with torch.cuda.device(dev):
        _launch("hades_permute", _lib.zk_hades_permute, state.data_ptr(),
                consts.data_ptr(), out.data_ptr(), state.shape[-1],
                _stream(dev))
    return out


# -----------------------------------------------------------------------------
# quotient
# -----------------------------------------------------------------------------

# the kernel's operands, in the order of `enum Operand` in csrc/quotient.cu:
# the fifteen selector and sigma tables, the seven wires (three of them
# shifted), the grand product and its shift, the public inputs, L1 alpha^2,
# X over the coset and Z_H^-1
QUOTIENT_OPERANDS = (
    "q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_arith", "q_range", "q_logic",
    "q_fixed_group_add", "q_variable_group_add", "s_sigma_1", "s_sigma_2",
    "s_sigma_3", "s_sigma_4", "a", "b", "c", "d", "a_w", "b_w", "d_w", "z",
    "z_w", "pi", "l1_alpha_sq", "linear", "v_h_inv")
# the entries of its challenge table, in the order of `enum Entry`: the seven
# challenges, each separator s times kappa^i (kappa = s^2), -alpha and the
# constants (`quotient_kernel.challenge_values`)
QUOTIENT_TABLE = (
    "alpha", "beta", "gamma", "range_sep", "logic_sep", "fixed_sep",
    "var_sep", "range_0", "range_1", "range_2", "range_3", "logic_0",
    "logic_1", "logic_2", "logic_3", "logic_4", "fixed_0", "fixed_1",
    "fixed_2", "fixed_3", "var_0", "var_1", "var_2", "neg_alpha", "one",
    "two", "eighteen", "eighty_one", "neg_eighty_one", "eighty_three",
    "jubjub_d")
# the statements the programs of a lane are written in
QUOTIENT_STATEMENTS = ("ld", "tb", "st", "meet", "fmul", "fadd", "fsub",
                       "fneg", "fdot2", "fdot3", "fdot4", "fdot5")
# the parts of a lane's program: the two threads' halves (each sums its
# widgets into its own `total`) and the second thread's combine, whose
# `meet` reads the first thread's `total`
QUOTIENT_PARTS = {"first": "the first half of a lane",
                  "second": "the second half of a lane",
                  "combine": "the combine"}


def _statements(body: str) -> list[tuple[str, list[str]]]:
    """(name, arguments) of every call in `body`; declarations skipped."""
    out = []
    for stmt in re.sub(r"//[^\n]*", "", body).split(";"):
        stmt = " ".join(stmt.split())
        if not stmt or stmt.startswith(("uint32_t", "const Park ")):
            continue
        found = re.fullmatch(r"(\w+)\((.*)\)", stmt)
        if found is None:
            raise ValueError(f"quotient.cu: {stmt!r} is not a statement")
        out.append((found.group(1),
                    [a.strip() for a in found.group(2).split(",")]))
    return out


def quotient_program():
    """The program of a lane of `csrc/quotient.cu`, read out of the source:
    ({part: its statements} for QUOTIENT_PARTS, {name: (parameters,
    statements)} of the functions they call besides QUOTIENT_STATEMENTS).
    For the kernel's bound and the CPU model of the kernel; the wrapper does
    not need it."""
    text = (CSRC / "quotient.cu").read_text()
    parts = {}
    for part, marker in QUOTIENT_PARTS.items():
        found = re.search(r"// ---- %s ----\n(.*?)// ---- end of %s ----"
                          % (marker, marker), text, re.S)
        parts[part] = _statements(found.group(1))
    functions = {}
    for name in dict.fromkeys(op for stmts in parts.values()
                              for op, _ in stmts):
        if name in QUOTIENT_STATEMENTS:
            continue
        found = re.search(r"void %s\(([^)]*)\) \{\n(.*?)\n\}" % name, text,
                          re.S)
        params = [p.split()[-1].lstrip("*")
                  for p in found.group(1).split(",")]
        functions[name] = (params, _statements(found.group(2)))
    return parts, functions


def dot_multiply_adds(k: int) -> int:
    """32-bit multiply-adds of one Montgomery dot product of k pairs over Fr
    (`fr_lazy.cuh`'s `dot<k>`): k x 64 limb products and 72 of the
    reduction, a low and a high half each (k = 1: one product, 272)."""
    n = FR.n_limbs
    return 2 * ((k + 1) * n * n + n)


def quotient_multiply_adds(part: str | None = None) -> int:
    """32-bit multiply-adds of one lane of the quotient kernel (of one part
    of QUOTIENT_PARTS, or of all): its products (`fmul`) and dot products
    (`fdot<k>`), as the source has them (additions and subtractions are not
    counted)."""
    parts, functions = quotient_program()

    def count(stmts) -> int:
        total = 0
        for op, _ in stmts:
            if op == "fmul":
                total += dot_multiply_adds(1)
            elif op.startswith("fdot"):
                total += dot_multiply_adds(int(op[4:]))
            elif op in functions:
                total += count(functions[op][1])
        return total

    return sum(count(stmts) for name, stmts in parts.items()
               if part in (None, name))


def quotient_plain(operands, table: torch.Tensor) -> torch.Tensor:
    """Plain version of the quotient kernel: the chain of
    `quotient_kernel.quotient_numerator` and `pointwise_divide` on the plain
    product, addition and subtraction (`mont_mul_plain`,
    `field_addsub_plain`) on the operands' device."""
    from . import quotient_kernel as qk  # it imports this module

    return qk.quotient_chain(operands, table, qk.PLAIN)


def quotient(operands, table: torch.Tensor) -> torch.Tensor:
    """The quotient over (a slice of) the 8n coset: the numerator of the
    gate and permutation identities times Z_H^-1, lane by lane, into a
    contiguous [8, L] int32 Montgomery tensor.  `operands` are the 28 [8, L]
    int32 tensors named by QUOTIENT_OPERANDS, each with contiguous lanes
    (any limb stride: a shard's slice of a global tensor is read in place);
    `table` is the [31, 8] challenge table (`quotient_kernel.
    challenge_table`).  One launch, after a copy of the table to the
    kernel's constant memory on the same stream.

    Contract: every element of every operand and of the table is canonical
    (below r), as on every path (the coset FFT's outputs, their rolls, the
    key's tables): the kernel computes the canonical value of the same
    field expression as the chain, whose words are then the same."""
    if len(operands) != len(QUOTIENT_OPERANDS):
        raise ValueError(f"quotient: {len(operands)} operands, not "
                         f"{len(QUOTIENT_OPERANDS)}")
    dev = operands[0].device
    lanes = operands[0].shape[-1]
    for name, t in zip(QUOTIENT_OPERANDS, operands):
        if t.dtype != torch.int32:
            raise TypeError(f"quotient: {name} is {t.dtype}, not int32")
        if tuple(t.shape) != (FR.n_limbs, lanes):
            raise ValueError(f"quotient: {name} is {tuple(t.shape)}, not "
                             f"[{FR.n_limbs}, {lanes}]")
        if t.device != dev:
            raise ValueError(f"quotient: {name} on {t.device}, not {dev}")
        if lanes > 1 and t.stride(-1) != 1:
            raise ValueError(f"quotient: the lanes of {name} are not "
                             f"contiguous (strides {t.stride()})")
    if (table.dtype != torch.int32 or table.device != dev
            or tuple(table.shape) != (len(QUOTIENT_TABLE), FR.n_limbs)
            or not table.is_contiguous()):
        raise ValueError(f"quotient: the table is {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}, not a "
                         f"contiguous int32 [{len(QUOTIENT_TABLE)}, "
                         f"{FR.n_limbs}] on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"quotient: unsupported device {dev}")
    if dev.type == "cpu":
        return quotient_plain(operands, table)
    out = torch.empty((FR.n_limbs, lanes), dtype=torch.int32, device=dev)
    if lanes == 0:
        return out
    build()
    count = len(QUOTIENT_OPERANDS)
    ptrs = (ctypes.c_void_p * count)(*(t.data_ptr() for t in operands))
    strides = (ctypes.c_longlong * count)(*(t.stride(-2) for t in operands))
    with torch.cuda.device(dev):
        _launch("quotient", _lib.zk_quotient, ptrs, strides,
                table.data_ptr(), out.data_ptr(), lanes, _stream(dev))
    return out
