"""Batched prime-field arithmetic on 32-bit-limb int32 tensors.

Counterpart of `zkvm_tpu/ops/limb_field.py`.  Element batches are stored
LIMB-MAJOR, `[..., L, B]` with the limb axis second-to-last and the batch
axis last, in Montgomery form with R = 2^256 (Fr, L = 8) or R = 2^384
(Fq, L = 12).  Those radices equal the reference's 2^(16*16) and 2^(16*24),
so a port tensor holds the same values as the reference's 16-bit-limb
`[16|24, B]` uint32 tensors in half the bytes; `from_reference` and
`to_reference` are the one place the two layouts meet.

The int32 limbs hold uint32 bit patterns (the CUDA kernels reinterpret
them as `uint32_t`).  torch's CPU `uint32` lacks `+`, `>>` and `>`, so the
plain arithmetic below widens to int64 with 16-bit limbs ("16-bit wide"
form, `[..., 2L, B]`): limb products stay below 2^32 and lazy column sums
far below 2^63.  These plain functions run on any device; the Montgomery
multiply and the power dispatch to the CUDA kernels for a CUDA tensor
(`kernels.mont_mul`, `kernels.mont_pow`) and to `mont_mul16` only for a CPU
tensor.  The multiply reads broadcast and strided operands in place: a
caller hands over an `[L, 1]` column or an expanded view and nothing of the
full shape is made for it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import params

LIMB_BITS = 32
M16 = 0xFFFF
M32 = 0xFFFFFFFF


def int_to_limbs(value: int, n_limbs: int) -> np.ndarray:
    """Little-endian 32-bit limbs of a non-negative int (uint32 numpy)."""
    return np.array([(value >> (LIMB_BITS * i)) & M32 for i in range(n_limbs)],
                    dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    out = 0
    for i, v in enumerate(np.asarray(limbs).astype(np.uint32).tolist()):
        out |= int(v) << (LIMB_BITS * i)
    return out


@dataclass(frozen=True)
class FieldSpec:
    """Static parameters binding the limb functions to one prime field."""

    name: str
    modulus: int
    n_limbs: int  # 32-bit limbs

    @functools.cached_property
    def R(self) -> int:
        return (1 << (LIMB_BITS * self.n_limbs)) % self.modulus

    @functools.cached_property
    def R2(self) -> int:
        return self.R * self.R % self.modulus

    @functools.cached_property
    def nprime(self) -> int:
        """-p^{-1} mod 2^32 (the CIOS word constant)."""
        return (-pow(self.modulus, -1, 1 << 32)) % (1 << 32)

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.n_limbs)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R2, self.n_limbs)

    @functools.cached_property
    def one_mont(self) -> np.ndarray:
        """1 in Montgomery form (= R mod p)."""
        return int_to_limbs(self.R, self.n_limbs)

    def mont_limbs(self, value: int) -> np.ndarray:
        """Montgomery limbs of a host constant."""
        return int_to_limbs(value % self.modulus * self.R % self.modulus,
                            self.n_limbs)

    def to_mont_array_np(self, values) -> np.ndarray:
        """Canonical ints -> Montgomery limbs [L, N] as uint32 numpy, on
        the host alone (for tables that are built once and lifted)."""
        nbytes = 4 * self.n_limbs
        r, p = self.R, self.modulus
        buf = b"".join((int(v) % p * r % p).to_bytes(nbytes, "little")
                       for v in values)
        flat = np.frombuffer(buf, dtype="<u4").reshape(len(values),
                                                       self.n_limbs)
        return np.ascontiguousarray(flat.T)

    # ---- host <-> device conversion (canonical ints <-> limb tensors) ----
    def to_raw_array(self, values, device) -> torch.Tensor:
        """Canonical ints -> raw (non-Montgomery) limb tensor [L, N]."""
        nbytes = 4 * self.n_limbs
        buf = b"".join((int(v) % self.modulus).to_bytes(nbytes, "little")
                       for v in values)
        raw = np.frombuffer(buf, dtype="<u4").reshape(len(values),
                                                      self.n_limbs)
        return u32_to_tensor(raw.T, device)

    def to_mont_array(self, values, device) -> torch.Tensor:
        """Canonical ints -> Montgomery limb tensor [L, N] (one multiply)."""
        return to_mont(self, self.to_raw_array(values, device))

    def from_mont_array(self, t: torch.Tensor) -> list[int]:
        """Montgomery tensor [..., L, N] -> canonical ints, batch-major."""
        return raw_to_ints(self, from_mont(self, t))


FR = FieldSpec("Fr", params.FR_MODULUS, 8)
FQ = FieldSpec("Fq", params.FP_MODULUS, 12)


# =============================================================================
# Layout conversion
# =============================================================================

def u32_to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bit patterns."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def tensor_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bit patterns."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def raw_to_ints(spec: FieldSpec, t: torch.Tensor) -> list[int]:
    """Raw limb tensor [..., L, N] -> ints, flattened batch-major."""
    host = tensor_to_u32(t)
    flat = np.ascontiguousarray(np.moveaxis(host, -2, -1)).reshape(
        -1, spec.n_limbs)
    blob = flat.astype("<u4").tobytes()
    nbytes = 4 * spec.n_limbs
    return [int.from_bytes(blob[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(flat.shape[0])]


def from_reference(arr, spec: FieldSpec, device) -> torch.Tensor:
    """Reference layout ([..., 2L, B] uint32 holding 16-bit limbs) -> port
    layout ([..., L, B] int32 holding 32-bit limbs).  Values unchanged."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[-2] == 2 * spec.n_limbs, a.shape
    packed = a[..., 0::2, :] | (a[..., 1::2, :] << np.uint32(16))
    return u32_to_tensor(packed, device)


def to_reference(t: torch.Tensor, spec: FieldSpec) -> np.ndarray:
    """Port layout -> reference layout (inverse of `from_reference`)."""
    v = tensor_to_u32(t)
    assert v.shape[-2] == spec.n_limbs, v.shape
    out = np.empty(v.shape[:-2] + (2 * spec.n_limbs,) + v.shape[-1:],
                   dtype=np.uint32)
    out[..., 0::2, :] = v & np.uint32(M16)
    out[..., 1::2, :] = v >> np.uint32(16)
    return out


def from_reference_lead(arr, spec: FieldSpec, device) -> torch.Tensor:
    """Reference limb-LEADING batches ([2L, *lead, n] uint32, the layout of
    its matmul NTT) -> the port's [*lead, L, n] int32 (limbs always at -2),
    for any number of leading batch axes."""
    a = np.asarray(arr, dtype=np.uint32)
    return from_reference(np.moveaxis(a, 0, -2), spec, device)


def to_reference_lead(t: torch.Tensor, spec: FieldSpec) -> np.ndarray:
    """Inverse of `from_reference_lead`: [*lead, L, n] -> [2L, *lead, n]."""
    return np.ascontiguousarray(np.moveaxis(to_reference(t, spec), -2, 0))


def split16(t: torch.Tensor) -> torch.Tensor:
    """int32 [..., L, B] -> 16-bit wide int64 [..., 2L, B]."""
    x = t.to(torch.int64) & M32
    w = torch.stack([x & M16, x >> 16], dim=-2)  # [..., L, 2, B]
    return w.reshape(t.shape[:-2] + (2 * t.shape[-2],) + t.shape[-1:])


def join16(w: torch.Tensor) -> torch.Tensor:
    """16-bit wide int64 [..., 2L, B] (canonical) -> int32 [..., L, B]."""
    v = w[..., 0::2, :] | (w[..., 1::2, :] << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


# =============================================================================
# Plain arithmetic on the 16-bit wide form
# =============================================================================

def const16(spec: FieldSpec, limbs32, like: torch.Tensor) -> torch.Tensor:
    """[2L, 1] int64 column of a 32-bit limb constant, on `like`'s device."""
    v = np.asarray(limbs32, dtype=np.int64)
    col = np.stack([v & M16, v >> 16], axis=-1).reshape(-1, 1)
    return torch.as_tensor(col, dtype=torch.int64, device=like.device)


def _shift(t: torch.Tensor, d: int, fill: int = 0) -> torch.Tensor:
    """Move limb rows up by d (row k -> k + d); `fill` enters at row 0."""
    return F.pad(t[..., :t.shape[-2] - d, :], (0, 0, d, 0), value=fill)


# Carry and borrow chains: below this many elements per limb row, per-op
# overhead dominates and the chain resolves in a few whole-tensor passes (a
# running max finds each row's deciding row); above it, a row-by-row ripple
# moves fewer bytes.  Both give the same limbs.
_RIPPLE_MIN_LANES = 2048


def _ripple(t: torch.Tensor) -> bool:
    return t[..., 0, :].numel() >= _RIPPLE_MIN_LANES


def _lookahead(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Carry out of each limb row, given 0/1 generate and propagate rows:
    the generate bit of the nearest row at or below that does not
    propagate."""
    rows = torch.arange(g.shape[-2], device=g.device).view(-1, 1)
    last = torch.cummax(torch.where(p == 0, rows, -1), dim=-2).values
    return torch.gather(g, -2, last.clamp(min=0)) & (last >= 0)


def _normalize(cols: torch.Tensor, rounds: int) -> torch.Tensor:
    """Non-negative lazy columns -> canonical 16-bit limbs, same row count
    (the value must fit).  Lookahead form: `rounds` local carry rounds
    bring every row to at most 2^16 (one round for rows < 2^17, three for
    rows < 2^40), then the remaining 0/1 carries resolve at once."""
    if _ripple(cols):
        out, carry = [], 0
        for k in range(cols.shape[-2]):
            v = cols[..., k:k + 1, :] + carry
            out.append(v & M16)
            carry = v >> 16
        return torch.cat(out, dim=-2)
    s = cols
    for _ in range(rounds):
        s = (s & M16) + _shift(s >> 16, 1)
    d = s & M16
    c_in = _shift(_lookahead(s >> 16, (d == M16).to(torch.int64)), 1)
    return (d + c_in) & M16


def _borrow_sub(a: torch.Tensor, b: torch.Tensor):
    """a - b over canonical 16-bit limbs; returns (diff, borrowed?) with
    the borrow out as a [..., 1, B] 0/1 row."""
    v = a - b
    if _ripple(v):
        out, borrow = [], 0
        for k in range(v.shape[-2]):
            d = v[..., k:k + 1, :] - borrow
            borrow = (d < 0).to(torch.int64)
            out.append(d + (borrow << 16))
        return torch.cat(out, dim=-2), borrow
    d = v & M16
    binc = _lookahead((v < 0).to(torch.int64), (d == 0).to(torch.int64))
    return (d - _shift(binc, 1)) & M16, binc[..., -1:, :]


def _with_top(t: torch.Tensor) -> torch.Tensor:
    """Append one zero limb row (headroom for a carry out)."""
    return F.pad(t, (0, 0, 0, 1))


def _reduce_once(spec: FieldSpec, s: torch.Tensor):
    """Canonical limbs s with one extra top row, value < 2p -> value mod p
    on the n lower rows."""
    body, top = s[..., :-1, :], s[..., -1:, :]
    diff, under = _borrow_sub(body, const16(spec, spec.p_limbs, body))
    return torch.where((top > 0) | (under == 0), diff, body)


def add16(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on 16-bit wide operands in [0, p)."""
    return _reduce_once(spec, _normalize(_with_top(a + b), 1))


def sub16(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p on 16-bit wide operands in [0, p)."""
    diff, under = _borrow_sub(a, b)
    fixed = diff + under * const16(spec, spec.p_limbs, diff)
    return _normalize(_with_top(fixed), 1)[..., :-1, :]


def mont_mul16(spec: FieldSpec, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p on 16-bit wide operands: CIOS
    with lazy columns (each collects < 2n products below 2^32, so rows stay
    below 2^38), then one normalisation and one conditional subtraction."""
    n = a.shape[-2]
    np0 = spec.nprime & M16
    p_col = const16(spec, spec.p_limbs, a)
    acc = torch.zeros(a.shape[:-2] + (2 * n + 1,) + a.shape[-1:],
                      dtype=torch.int64, device=a.device)
    for j in range(n):
        col = acc[..., j:j + n, :]
        col.addcmul_(a, b[..., j:j + 1, :])
        m = ((col[..., 0:1, :] & M16) * np0) & M16
        col.addcmul_(m, p_col)
        acc[..., j + 1:j + 2, :] += col[..., 0:1, :] >> 16
    return _reduce_once(spec, _normalize(acc[..., n:, :], 3))


# =============================================================================
# Public functions on int32 [..., L, B] tensors
# =============================================================================

def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, both in the same (Montgomery or raw) domain."""
    return join16(add16(spec, split16(a), split16(b)))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    return join16(sub16(spec, split16(a), split16(b)))


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p, with -0 = 0."""
    w = split16(a)
    return join16(sub16(spec, torch.zeros_like(w), w))


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-2)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """mask ? a : b with mask shaped [..., B] over limb tensors [..., L, B]."""
    return torch.where(mask.unsqueeze(-2), a, b)


def const_tensor(spec: FieldSpec, limbs32, shape, device) -> torch.Tensor:
    """A host limb constant broadcast to a contiguous [..., L, B] tensor."""
    col = u32_to_tensor(np.asarray(limbs32, dtype=np.uint32)[:, None], device)
    return col.expand(shape).contiguous()


def mont_mul(spec: FieldSpec, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p through the mont_mul kernel (its
    plain version for a CPU tensor).  The operands broadcast to one
    [..., L, B] shape; each is handed over as it is where the kernel can
    read it in place (`kernels.mont_mul_layout`), and copied only where it
    cannot."""
    from . import kernels  # kernels imports this module

    shape = kernels.mont_mul_shape(a, b)
    a, b = (t if kernels.mont_mul_layout(t, shape) is not None
            else t.expand(shape).contiguous() for t in (a, b))
    return kernels.mont_mul(spec, a, b)


def mont_square(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def mont_mul_const(spec: FieldSpec, a: torch.Tensor, c_limbs) -> torch.Tensor:
    """Montgomery product with a host-constant operand (32-bit limbs), which
    the kernel reads as one [L, 1] column."""
    col = u32_to_tensor(np.asarray(c_limbs, dtype=np.uint32)[:, None],
                        a.device)
    return mont_mul(spec, a, col)


def to_mont(spec: FieldSpec, a_raw: torch.Tensor) -> torch.Tensor:
    """Raw limbs -> Montgomery form (multiply by R^2)."""
    return mont_mul_const(spec, a_raw, spec.r2_limbs)


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical raw limbs (multiply by 1)."""
    return mont_mul_const(spec, a, int_to_limbs(1, spec.n_limbs))


def mont_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery in/out) for a host exponent: MSB-first
    square-and-multiply from 1, the whole chain in ONE launch of the
    mont_pow kernel for a CUDA tensor (the bits are the same for every
    lane), a loop of plain products for a CPU tensor."""
    from . import kernels  # kernels imports this module

    return kernels.mont_pow(spec, a.contiguous(), e)


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched Fermat inversion a^(p-2); zero maps to zero."""
    return mont_pow(spec, a, spec.modulus - 2)
