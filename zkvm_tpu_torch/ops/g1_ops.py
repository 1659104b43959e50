"""Batched G1 point arithmetic on limb tensors over Fq.

Counterpart of `zkvm_tpu/ops/g1_ops.py`.  A point batch is a tuple
(x, y, z) of [..., 12, B] int32 Montgomery-limb tensors (homogeneous
projective, limb-major).  The group law is the complete RCB15 algebra of
the host implementation (`zkvm_tpu/curves/weierstrass.py`): branch-free and
identity-safe, so every pipeline built on it is data-oblivious.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.g1 import G1Affine, G1Projective
from ..fields import Fp

from . import kernels
from . import limb_field as lf
from .limb_field import FQ


def _in_place(point):
    """The point as the padd kernel can read it, with its layout: itself
    where its three coordinates share one layout (every second lane, one
    half, a transposed gather: no copy), else a contiguous copy."""
    layout = kernels.padd_layout(point)
    if layout is None:
        point = tuple(t.contiguous() for t in point)
        layout = kernels.padd_layout(point)
    return point, layout


def padd(p, q):
    """Complete projective addition (RCB15 algorithm 7, a = 0) through the
    padd kernel (its plain version for CPU tensors).  Strided operands are
    read in place; the result is contiguous."""
    (p, lp), (q, lq) = _in_place(tuple(p)), _in_place(tuple(q))
    return kernels.padd(p, q, (lp, lq))


def padd_ilp(p, q):
    """The same addition by the grouped kernel (`kernels.padd_ilp`: two
    threads a point), strided operands read in place as `padd` reads them;
    bit-identical to `padd`, which stays the default."""
    (p, lp), (q, lq) = _in_place(tuple(p)), _in_place(tuple(q))
    return kernels.padd_ilp(p, q, (lp, lq))


def sum_lanes(t, add=padd):
    """Fold an [..., 12, M] point triple (M a power of two) to [..., 12, 1]
    by a binary halving tree of `add` (`padd` or `padd_ilp`)."""
    m = t[0].shape[-1]
    if m & (m - 1):
        raise ValueError(f"lane count {m} is not a power of two")
    while m > 1:
        m //= 2
        t = add(tuple(c[..., :m] for c in t), tuple(c[..., m:] for c in t))
    return t


def pdouble(p):
    """Projective doubling.  On CUDA the complete addition formula doubles
    correctly, so P + P goes to the padd kernel (as the reference's TPU
    branch does); on the CPU the dedicated RCB15 doubling (algorithm 9)
    runs, bit-identical to the reference's `_pdouble_jnp`."""
    if p[0].device.type == "cuda":
        return padd(p, p)
    out = _pdouble16(tuple(lf.split16(t) for t in p))
    return tuple(lf.join16(t) for t in out)


def _pdouble16(p):
    """RCB15 doubling on 16-bit wide triples, multiplies stacked as in the
    reference's `_pdouble_jnp`."""
    x, y, z = p
    add = lambda a, b: lf.add16(FQ, a, b)
    sub = lambda a, b: lf.sub16(FQ, a, b)
    mul = lambda a, b: lf.mont_mul16(FQ, a, b)
    st = torch.stack
    r = mul(st([y, y, z, x]), st([y, z, z, y]))
    t0, t1, zz, xy = r[0], r[1], r[2], r[3]
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)
    t2 = mul(zz, lf.const16(FQ, kernels.B3_MONT, zz).expand(zz.shape))
    y3 = add(t0, t2)
    t2_3 = add(add(t2, t2), t2)
    t0 = sub(t0, t2_3)
    v = mul(st([t2, t1, t0, xy]), st([z3, z3, y3, t0]))
    x3, z3o, y3o, xyt = v[0], v[1], v[2], v[3]
    return add(xyt, xyt), add(y3o, x3), z3o


def pneg(p):
    x, y, z = p
    return x, lf.neg(FQ, y), z


def pselect(mask, p, q):
    """mask ? p : q elementwise over the batch."""
    return tuple(lf.select(mask, a, b) for a, b in zip(p, q))


def park_identity(mask, pts):
    """Lanes where the [..., B] mask is set become the identity (0 : 1 : 0)."""
    x, y, z = pts
    one = lf.u32_to_tensor(FQ.one_mont[:, None], x.device)
    m = mask.unsqueeze(-2)
    return (torch.where(m, 0, x), torch.where(m, one, y),
            torch.where(m, 0, z))


def identity_batch(shape, device):
    """Identity points (0 : 1 : 0), batch dims (*shape[:-1], 12, shape[-1])."""
    full = tuple(shape[:-1]) + (FQ.n_limbs,) + tuple(shape[-1:])
    zeros = torch.zeros(full, dtype=torch.int32, device=device)
    ones = lf.const_tensor(FQ, FQ.one_mont, full, device)
    return zeros, ones, zeros.clone()


# ---- host <-> device conversion ---------------------------------------------

def affine_to_device(points: list[G1Affine], device):
    """Encode affine points as projective Montgomery limb tensors [12, n]:
    bytes -> raw limbs on the host, ONE kernel multiply for the Montgomery
    factor."""
    n = len(points)
    if n == 0:
        z = torch.zeros((FQ.n_limbs, 0), dtype=torch.int32, device=device)
        return z, z.clone(), z.clone()
    nbytes = 4 * FQ.n_limbs
    buf = bytearray(2 * nbytes * n)
    inf = np.zeros(n, dtype=bool)
    for i, p in enumerate(points):
        if p.infinity:
            inf[i] = True
        else:
            o = 2 * nbytes * i
            buf[o:o + nbytes] = p.x.value.to_bytes(nbytes, "little")
            buf[o + nbytes:o + 2 * nbytes] = p.y.value.to_bytes(nbytes,
                                                                "little")
    raw = np.frombuffer(bytes(buf), dtype="<u4").reshape(n, 2, FQ.n_limbs)
    xy = lf.to_mont(FQ, lf.u32_to_tensor(raw.transpose(1, 2, 0), device))
    one = lf.const_tensor(FQ, FQ.one_mont, (FQ.n_limbs, n), device)
    inf_t = torch.as_tensor(inf, device=device)
    zero = torch.zeros_like(one)
    ys = lf.select(inf_t, one, xy[1])  # infinity lanes: (0 : 1 : 0)
    return xy[0], ys, lf.select(inf_t, zero, one)


def device_to_projective(p, index=None) -> G1Projective:
    """Decode one device point (or batch element `index`) to the host type."""
    x, y, z = p
    if index is not None:
        x, y, z = x[..., index], y[..., index], z[..., index]
    xv, yv, zv = (FQ.from_mont_array(t.reshape(FQ.n_limbs, -1)[:, :1])[0]
                  for t in (x, y, z))
    return G1Projective(Fp(xv), Fp(yv), Fp(zv))


def batch_scalar_mul_base(base: G1Affine, scalars, device) -> list[G1Affine]:
    """[s_i * base] for many scalars: windowed fixed-base on the device.

    A host table of d * (16^w * base) (64 nibble windows x 16 digits)
    turns each lane into 64 unconditional table-lookup additions (digit 0
    looks up the identity, which the complete addition absorbs); one
    Fermat inversion of z per lane normalises on the device, and only the
    byte decode runs on the host.  Used by the SRS setup."""
    n = len(scalars)
    if n == 0:
        return []
    byts = np.frombuffer(b"".join(s.to_bytes() for s in scalars),
                         dtype=np.uint8).reshape(n, 32)
    digits = np.empty((n, 64), dtype=np.int64)
    digits[:, 0::2] = byts & 0xF
    digits[:, 1::2] = byts >> 4
    digits_t = torch.as_tensor(np.ascontiguousarray(digits.T), device=device)

    # host table: [64, 12, 16] Montgomery coords of d * (16^w * base)
    table = np.zeros((3, 64, FQ.n_limbs, 16), dtype=np.uint32)
    wbase = base.to_projective()
    for w in range(64):
        cur = G1Projective.identity()
        for d in range(16):
            for k, coord in enumerate((cur.x, cur.y, cur.z)):
                table[k, w, :, d] = FQ.mont_limbs(coord.value)
            if d < 15:
                cur = cur + wbase
        for _ in range(4):
            wbase = wbase.double()
    tx, ty, tz = (lf.u32_to_tensor(t, device) for t in table)

    acc = identity_batch((n,), device)
    for w in range(64):
        idx = digits_t[w]
        acc = padd(acc, tuple(t[w].index_select(1, idx) for t in (tx, ty, tz)))
    x, y, z = acc
    zinv = lf.mont_inv(FQ, z)  # zero (identity) stays zero
    xs = FQ.from_mont_array(lf.mont_mul(FQ, x, zinv))
    ys = FQ.from_mont_array(lf.mont_mul(FQ, y, zinv))
    inf = lf.is_zero(FQ, z).cpu().numpy()
    return [G1Affine.identity() if inf[i] else G1Affine(Fp(xs[i]), Fp(ys[i]))
            for i in range(n)]
