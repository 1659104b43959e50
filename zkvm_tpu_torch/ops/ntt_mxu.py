"""Matmul NTT: field DFTs as byte-sliced integer matrix products.

Counterpart of `zkvm_tpu/ops/ntt_mxu.py`, with the same tables and the same
integers at every step:

  * A size-m <= 256 DFT over Fr is a matrix product Y = W @ X with
    W[k, j] = root^(k*j).  Field elements are sliced into bytes; the
    byte-slice products are exact in float32 (products <= 255^2, at most 256
    summands, so every partial sum stays below 2^24 whatever the order of
    accumulation).  The operands are float32 and so is the result:
    `torch.matmul` of two bfloat16 tensors would round the sums to 8 bits.
  * Larger sizes use the recursive Cooley-Tukey (4-step) decomposition
    n = a*b: b-point DFTs, twiddle glue w^(j1*k2) (one `mont_mul` launch),
    a-point DFTs -- each level again a batched matmul.
  * The big-integer products (< 2^521) are reassembled from the byte-plane
    matmul outputs and reduced mod r by the `carry_fold` kernel (byte carry
    + 2^256 / 2^512 split-fold) in one pass over the byte columns.

Tensors are `[*lead, 8, n]` int32 Montgomery limbs -- limbs second to last
as everywhere in the port, any number of leading batch axes -- where the
reference's transform takes limb-leading `[16, *lead, n]`
(`limb_field.from_reference_lead` converts).  Montgomery form passes
through untouched: inputs are x*R, the DFT matrix is plain root powers.
Tables are built on the host once per (n, root) and lifted once per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import params
from . import kernels
from . import limb_field as lf
from .limb_field import FR

_Q = params.FR_MODULUS

_MAX_RADIX = 256  # contraction length cap for exact f32 accumulation

# byte planes per Fr element, and byte positions of the reassembled product
# (2^521 needs 66 bytes; two spare columns let the final carry die)
_P = 4 * FR.n_limbs
_NB = kernels.N_COLUMNS

# The whole product C [32, m, 32, bflat] float32 is 1024x the data.  Up to
# this many bytes of C (2 GiB: one 2^19 polynomial, four of 2^16) it is one
# matmul; above, the product runs per byte plane of the right-hand side and
# only one [32 m, bflat] plane is alive at a time.
C_WHOLE_MAX_BYTES = 1 << 31


def _factor(n: int) -> list[int]:
    """Split n = 2^L into the fewest radices <= 256, sizes balanced."""
    log_n = n.bit_length() - 1
    if n <= _MAX_RADIX:
        return [n]
    k = -(-log_n // 8)  # passes needed
    base, rem = divmod(log_n, k)
    return [1 << (base + 1)] * rem + [1 << base] * (k - rem)


@functools.lru_cache(maxsize=None)
def _dft_matrix_bytes(m: int, root: int) -> np.ndarray:
    """[P*m, m] uint8 byte planes of W[k, j] = root^(k*j) mod q.

    Row index is (byte_plane, k) with the plane slowest, so a single matmul
    yields every (plane, out) pair."""
    buf = bytearray()
    rk = 1
    for _ in range(m):
        cur = 1
        for _ in range(m):
            buf += cur.to_bytes(_P, "little")
            cur = cur * rk % _Q
        rk = rk * root % _Q
    w = np.frombuffer(bytes(buf), dtype=np.uint8).reshape(m, m, _P)
    return np.ascontiguousarray(w.transpose(2, 0, 1)).reshape(_P * m, m)


@functools.lru_cache(maxsize=None)
def _glue_table(a: int, b: int, root: int) -> np.ndarray:
    """Montgomery [L, a, b] uint32 table of root^(j1*k2) (the 4-step
    twiddles)."""
    vals = []
    ra = 1
    for _ in range(a):
        cur = 1
        for _ in range(b):
            vals.append(cur)
            cur = cur * ra % _Q
        ra = ra * root % _Q
    return FR.to_mont_array_np(vals).reshape(FR.n_limbs, a, b)


def _mont_mul_lead(x: torch.Tensor, glue: torch.Tensor) -> torch.Tensor:
    """x [B, a, 8, b] times the glue table [a, 8, b], every batch row."""
    return lf.mont_mul(FR, x, glue.expand(x.shape))


def _byte_planes(x: torch.Tensor) -> torch.Tensor:
    """[bflat, 8, m] int32 limbs -> [bflat, 32, m] int32 bytes; plane p is
    byte p of the value (shift, then mask: the shift is arithmetic)."""
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32,
                          device=x.device).view(4, 1)
    b8 = (x.unsqueeze(-2) >> shifts) & 0xFF  # [bflat, 8, 4, m]
    return b8.reshape(x.shape[0], _P, x.shape[-1])


def _byte_columns(x: torch.Tensor, table: torch.Tensor,
                  whole: bool | None = None) -> torch.Tensor:
    """The DFT's byte-product columns D [68, m, bflat] int32 for
    x [bflat, 8, m]: D[t] = sum over k + p = t of
    (table plane k) @ (byte plane p of x).  `whole` picks the branch (one
    matmul, or one per byte plane); left at None, the size of C decides."""
    bflat, _, m = x.shape
    b8 = _byte_planes(x)
    d = torch.zeros((_NB, m, bflat), dtype=torch.int32, device=x.device)
    if whole is None:
        whole = 4 * _P * m * _P * bflat <= C_WHOLE_MAX_BYTES
    if not whole:
        rhs3 = b8.permute(1, 2, 0).to(torch.float32)  # [P, m, bflat]
        for p in range(_P):
            c_p = torch.matmul(table, rhs3[p])  # [P*m, bflat]
            d[p:p + _P] += c_p.view(_P, m, bflat).to(torch.int32)
    else:
        rhs = b8.permute(2, 1, 0).reshape(m, _P * bflat).to(torch.float32)
        c = torch.matmul(table, rhs).view(_P, m, _P, bflat)
        # anti-diagonal byte accumulation
        for p in range(_P):
            d[p:p + _P] += c[:, :, p, :].to(torch.int32)
    return d


def leaf_reduce(d: torch.Tensor) -> torch.Tensor:
    """Byte columns [68, m, bflat] -> [8, m, bflat] mod r: ONE pass of the
    fused carry_fold kernel."""
    return kernels.carry_fold(d)


def leaf_reduce_unfused(d: torch.Tensor) -> torch.Tensor:
    """The same reduction in two steps: the byte carry as a tensor scan,
    then the fold kernel.  Kept beside the fused one as a cross-check; no
    transform of the port's entry points takes it."""
    return kernels.fold(kernels.carry_bytes(d))


def _dft_leaf(x: torch.Tensor, table: torch.Tensor,
              reduce=leaf_reduce) -> torch.Tensor:
    """Matmul DFT along the last axis of x [bflat, 8, m]."""
    y = reduce(_byte_columns(x, table))  # [8, m, bflat]
    return y.permute(2, 0, 1).contiguous()


class _Plan:
    """One Cooley-Tukey level: n = a * b with precomputed tables."""

    __slots__ = ("n", "leaf_table", "a", "b", "glue", "sub_b", "sub_a",
                 "_dev")

    def __init__(self, n: int, root: int, radices: list[int]):
        self.n = n
        self._dev = {}
        if len(radices) == 1:
            self.leaf_table = _dft_matrix_bytes(n, root)
            self.a = self.b = self.glue = self.sub_b = self.sub_a = None
        else:
            self.leaf_table = None
            a = radices[0]
            b = n // a
            self.a, self.b = a, b
            self.glue = _glue_table(a, b, root)
            self.sub_b = _Plan(b, pow(root, a, _Q), radices[1:])
            self.sub_a = _Plan(a, pow(root, b, _Q), [a])

    def _lift(self, name: str, device: torch.device) -> torch.Tensor:
        """The table as a device tensor, cached per (table, device): the
        leaf table as float32 [32 m, m], the glue as int32 [a, 8, b]."""
        key = (name, device)
        dev = self._dev.get(key)
        if dev is None:
            if name == "leaf_table":
                dev = torch.from_numpy(self.leaf_table).to(device).to(
                    torch.float32)
            else:
                dev = lf.u32_to_tensor(self.glue, device).permute(
                    1, 0, 2).contiguous()
            self._dev[key] = dev
        return dev

    def apply(self, x: torch.Tensor, reduce=leaf_reduce) -> torch.Tensor:
        """DFT along the last axis of [B, 8, n]."""
        if self.n == 1:
            return x
        if self.leaf_table is not None:
            return _dft_leaf(x, self._lift("leaf_table", x.device), reduce)
        a, b = self.a, self.b
        rows = x.shape[0]
        l = FR.n_limbs
        # x[j], j = j1 + a*j2  ->  A[.., j1, j2]
        xa = x.reshape(rows, l, b, a).permute(0, 3, 1, 2).reshape(
            rows * a, l, b)
        xb = self.sub_b.apply(xa, reduce).view(rows, a, l, b)  # [.., j1, k2]
        xb = _mont_mul_lead(xb, self._lift("glue", x.device))
        xc = self.sub_a.apply(
            xb.permute(0, 3, 2, 1).reshape(rows * b, l, a), reduce)
        # [.., k2, k1] -> X[k2 + b*k1]: row-major [k1, k2]
        return xc.view(rows, b, l, a).permute(0, 2, 3, 1).reshape(
            rows, l, self.n)


class MXUTransform:
    """Cached forward-or-inverse NTT of a fixed size along the last axis.
    The device is the operand's; tables are cached per device."""

    _cache: dict[tuple[int, int], "MXUTransform"] = {}

    def __new__(cls, n: int, root: int):
        key = (n, root)
        if key not in cls._cache:
            inst = super().__new__(cls)
            inst.plan = _Plan(n, root, _factor(n)) if n > 1 else None
            inst.n = n
            cls._cache[key] = inst
        return cls._cache[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: [*lead, 8, n] int32 Montgomery -> transformed along the last
        axis."""
        return self._apply(x, leaf_reduce)

    def _apply(self, x: torch.Tensor, reduce) -> torch.Tensor:
        if x.shape[-1] != self.n or x.shape[-2] != FR.n_limbs:
            raise ValueError(f"expected [..., {FR.n_limbs}, {self.n}], got "
                             f"{tuple(x.shape)}")
        if self.plan is None:
            return x
        flat = x.reshape((-1,) + x.shape[-2:])
        return self.plan.apply(flat, reduce).reshape(x.shape)

    def apply_axis(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Transform along `axis`, a leading batch axis of length n or the
        last axis (the limb axis -2 is not allowed): swap it with the last
        axis, transform, and swap back."""
        axis %= x.dim()
        if axis == x.dim() - 1:
            return self(x)
        if axis == x.dim() - 2:
            raise ValueError("cannot transform along the limb axis")
        y = self(x.transpose(axis, -1).contiguous())
        return y.transpose(axis, -1).contiguous()


def transform_unfused(t: MXUTransform, x: torch.Tensor) -> torch.Tensor:
    """`t(x)` with every leaf reduced by `leaf_reduce_unfused` (the carry
    scan and the fold kernel) -- the cross-check of the fused kernel over a
    whole transform."""
    return t._apply(x, leaf_reduce_unfused)
