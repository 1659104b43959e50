"""The port's CUDA kernels: build, bind, launch, count, and plain versions.

Ten kernels from `zkvm_tpu_torch/csrc/` (CUDA C++ for sm_90a):

  * `mont_mul`     replaces `pallas_field.mont_mul_pallas` (reads broadcast
                   and strided operands in place)
  * `mont_pow`     replaces a chain of `mont_mul_pallas` calls that `jit`
                   fuses into one program (`limb_field.mont_pow`): a^e for
                   one host exponent in one launch
  * `padd`         replaces `pallas_field.padd_pallas_2l` (reads strided
                   operands in place)
  * `window_fold`  replaces `pallas_field.window_fold_pallas`
  * `butterfly`    replaces `pallas_field.butterfly_pallas`
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

They are compiled with `nvcc` (one process per source, all started
together) and linked into one shared library with a plain C interface on
first use (never at import), cached under `zkvm_tpu_torch/build/` by a hash
of the sources, and bound with ctypes.

`padd`, `window_fold` and the Fq chain of `mont_pow` share the lazily
reduced carry-flag arithmetic of `csrc/fq_lazy.cuh`; `hades_permute` and the
Fr chain of `mont_pow` that of `csrc/fr_lazy.cuh` (Fr leaves less room: its
ranges are stated there); the other kernels use `csrc/field.cuh`.
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

import torch
import torch.nn.functional as F

from .. import params
from . import limb_field as lf
from .limb_field import FQ, FR

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_SOURCES = ("mont_mul.cu", "padd.cu", "window_fold.cu", "butterfly.cu",
            "ntt_fold.cu", "hades.cu", "padd_ilp.cu", "field_addsub.cu")
_HEADERS = ("common.cuh", "field.cuh", "fq_lazy.cuh", "fr_lazy.cuh")
_FIELD_ID = {"Fr": 0, "Fq": 1}

# launches of each kernel since the last `reset_launches()`
LAUNCHES = {"mont_mul": 0, "mont_pow": 0, "padd": 0, "window_fold": 0,
            "butterfly": 0, "carry_fold": 0, "fold": 0, "hades_permute": 0,
            "padd_ilp": 0, "field_addsub": 0}

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
    lib.zk_butterfly.argtypes = [_P] * 5 + [_LL, _LL, _LL, _P]
    lib.zk_carry_fold.argtypes = [_P, _P, _LL, _P]
    lib.zk_fold.argtypes = [_P, _P, _LL, _P]
    lib.zk_hades_permute.argtypes = [_P, _P, _P, _LL, _P]
    lib.zk_padd_ilp.argtypes = [_P] * 9 + [_LL, _LL, _P]
    lib.zk_field_addsub.argtypes = [_I, _I, _P, _P, _P, _P, _LL, _LL, _P, _P]
    for fn in (lib.zk_mont_mul, lib.zk_mont_pow, lib.zk_empty_launch,
               lib.zk_padd, lib.zk_window_fold, lib.zk_butterfly,
               lib.zk_carry_fold, lib.zk_fold, lib.zk_hades_permute,
               lib.zk_padd_ilp, lib.zk_fq_chain, lib.zk_field_addsub):
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
    coordinates, then the plain version (CPU) or one launch of `zk_<name>`
    into contiguous outputs.  `layouts` holds the `padd_layout` of p and of
    q for the kernel that reads strided points in place, and is None for the
    one that takes contiguous operands only."""
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
        if layouts is None and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
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
    strides = () if layouts is None else (
        (ctypes.c_longlong * 6)(*layouts[0], *layouts[1]),)
    with torch.cuda.device(dev):
        _launch(name, getattr(_lib, "zk_" + name),
                *(t.data_ptr() for t in (*p, *q)),
                *(t.data_ptr() for t in out), groups, lanes, *strides,
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
    for point, layout in zip((p, q), layouts):
        if layout is None:
            raise ValueError(
                f"padd: the three coordinates of a point must share one "
                f"layout whose leading axes collapse into one (strides "
                f"{[t.stride() for t in point]})")
    return _add_points("padd", p, q, layouts)


def padd_ilp_plain(p, q):
    """Plain version of the padd_ilp kernel: `padd16` already runs the 14
    products as the kernel's three groups of 6 + 2 + 6 independent ones,
    so it serves both addition kernels."""
    return padd_plain(p, q)


def padd_ilp(p, q):
    """The same addition as `padd`, bit for bit, by the grouped kernel: two
    threads a point, each taking 3 + 1 + 3 of the 6 + 2 + 6 products.
    Contiguous operands only."""
    return _add_points("padd_ilp", p, q, None)


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
# butterfly
# -----------------------------------------------------------------------------

def butterfly_plain(even: torch.Tensor, odd: torch.Tensor, tw: torch.Tensor):
    """Plain version of the butterfly kernel."""
    e = lf.split16(even)
    t = lf.mont_mul16(FR, lf.split16(odd), lf.split16(tw))
    return lf.join16(lf.add16(FR, e, t)), lf.join16(lf.sub16(FR, e, t))


def butterfly(even: torch.Tensor, odd: torch.Tensor, tw: torch.Tensor):
    """(even + tw * odd, even - tw * odd) over Fr on [..., 8, B] int32
    tensors.  `tw` is shaped like the operands, or one [8, B] table shared
    by every leading group."""
    dev = _check("butterfly", (even, odd), even.shape, FR.n_limbs)
    shared = tw.dim() == 2 and even.dim() > 2
    if _check("butterfly", (tw,), even.shape[-2:] if shared else even.shape,
              FR.n_limbs) != dev:
        raise ValueError(f"butterfly: twiddles on {tw.device}, operands on "
                         f"{dev}")
    if dev.type == "cpu":
        return butterfly_plain(even, odd, tw)
    plus, minus = torch.empty_like(even), torch.empty_like(even)
    if even.numel() == 0:
        return plus, minus
    build()
    lanes = even.shape[-1]
    groups = even.numel() // (FR.n_limbs * lanes)
    with torch.cuda.device(dev):
        _launch("butterfly", _lib.zk_butterfly, even.data_ptr(),
                odd.data_ptr(), tw.data_ptr(), plus.data_ptr(),
                minus.data_ptr(), groups, lanes,
                0 if shared else FR.n_limbs * lanes, _stream(dev))
    return plus, minus


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
