"""Device Pippenger MSM: bucket accumulation by sort + segmented sums.

Counterpart of `zkvm_tpu/ops/msm.py` (single device).  The pipeline is the
reference's, step for step:

  1. signed radix-2^c digits [S*W, N] from canonical scalar limbs;
  2. one sort per digit row of a packed i32 key (bucket, sign, index);
  3. a row gather of the point-major [N, 36] matrix by that permutation,
     negating y where the digit is negative; dead lanes (digit 0 or the
     point at infinity) are parked at the identity;
  4. bucket accumulation: an inclusive prefix scan (`_msm_pipeline`), or
     for N >= PTREE_MIN_POINTS the halving tree (`_msm_ptree_pipeline`),
     which merges adjacent same-bucket lanes with one addition per level
     and compacts the rejects;
  5. bucket sums as differences of prefix values at bucket boundaries;
  6. the weighted fold sum_b b * S_b as suffix sums plus a lane reduction;
  7. the window fold sum_w 2^(c w) * T_w, one `window_fold` kernel launch.

Every point addition goes through the padd kernel and the final fold
through the window_fold kernel (their plain versions for CPU tensors).
The scan is a log-depth tensor recursion of additions on strided slices,
the same code on every device.  Projective coordinates therefore differ
from the reference's (another addition order); results agree as group
elements.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..curves.g1 import G1Affine, G1Projective
from ..fields import Fp, Fr

from . import g1_ops, kernels
from . import limb_field as lf
from .limb_field import FQ, FR

_GRANULE = 1024  # scalar-count padding granule

# the halving tree pays off from this size on (measured on the reference's
# first device; kept so that both packages take the same path at each size)
PTREE_MIN_POINTS = 1 << 14


def _window_bits(n: int) -> int:
    """Scan-path window width: total scan work (~W*N additions, W ~ 256/c)
    against per-window bucket work (~2.5 * 2^(c-1) additions)."""
    if n <= (1 << 11):
        return 8
    if n <= (1 << 14):
        return 12
    return 13


def _ptree_window_bits(n: int) -> int:
    """Tree window width: 2^(c-1) buckets must stay << N for the halving
    levels to bite."""
    if n >= (1 << 16):
        return 11
    return 10


def _align128(v: int) -> int:
    return -(-v // 128) * 128


def _granule(n: int) -> int:
    """Padded size class: 128-lane multiples up to 1024, _GRANULE above."""
    if n <= _GRANULE:
        return _align128(max(n, 1))
    return -(-n // _GRANULE) * _GRANULE


# -----------------------------------------------------------------------------
# Pipeline pieces
# -----------------------------------------------------------------------------

def _signed_digit_tensors(limbs: torch.Tensor, c: int) -> torch.Tensor:
    """[S, 8, N] canonical int32 limbs -> signed digits [S, W, N] int32."""
    s, n_limbs, n = limbs.shape
    w_count = -(-260 // c)  # 256 bits + headroom for the carry sweep
    half = 1 << (c - 1)
    mask = (1 << c) - 1
    u = limbs.to(torch.int64) & lf.M32
    zero = torch.zeros((s, n), dtype=torch.int64, device=limbs.device)
    uds = []
    for w in range(w_count):
        bit = w * c
        li, sh = bit // 32, bit % 32
        if li >= n_limbs:
            uds.append(zero)
            continue
        v = u[:, li, :] >> sh
        if sh + c > 32 and li + 1 < n_limbs:
            v = v | (u[:, li + 1, :] << (32 - sh))
        uds.append(v & mask)
    carry = zero
    ds = []
    for w in range(w_count):
        d = uds[w] + carry
        wrap = d > half
        ds.append(torch.where(wrap, d - (1 << c), d))
        carry = wrap.to(torch.int64)
    return torch.stack(ds, dim=1).to(torch.int32)


def _scan_padd(t, reverse: bool = False):
    """Inclusive prefix (suffix when `reverse`) sums over the last axis of
    an [..., 12, M] point triple.  Log depth: add adjacent pairs, scan the
    half-length array recursively (the odd lanes), then one addition fixes
    the even lanes -- ~2M additions in ~2 log2(M) kernel launches."""
    if reverse:
        out = _scan_padd(tuple(c.flip(-1) for c in t))
        return tuple(c.flip(-1) for c in out)
    m = t[0].shape[-1]
    if m <= 1:
        return t
    odd = _scan_padd(g1_ops.padd(tuple(c[..., 0:m - 1:2] for c in t),
                                 tuple(c[..., 1::2] for c in t)))
    k = (m - 1) // 2  # even lanes after lane 0
    even = (g1_ops.padd(tuple(c[..., :k] for c in odd),
                        tuple(c[..., 2::2] for c in t)) if k else None)
    out = []
    for i, c in enumerate(t):
        r = torch.empty_like(c)
        r[..., 0:1] = c[..., 0:1]
        r[..., 1::2] = odd[i]
        if k:
            r[..., 2::2] = even[i]
        out.append(r)
    return tuple(out)


def _gather_lanes(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, L, M] limbs gathered along lanes by idx [B, K] -> [B, L, K]."""
    return torch.gather(t, 2, idx[:, None, :].expand(-1, t.shape[1], -1))


def _park_identity(mask: torch.Tensor, pts):
    """Lanes where mask is set become the identity (0 : 1 : 0)."""
    x, y, z = pts
    one = lf.u32_to_tensor(FQ.one_mont[:, None], x.device)
    m = mask.unsqueeze(-2)
    return (torch.where(m, 0, x), torch.where(m, one, y),
            torch.where(m, 0, z))


def _bucket_sums_dense(sb, x, y, z, half: int):
    """Bucket-sorted points -> dense bucket sums [B, 12, half].

    sb [B, M] ascending bucket ids (sentinel > half sorts last).  Inclusive
    prefix scan, then bucket sums as boundary differences (empty buckets
    cancel to the identity); slot k holds the sum of bucket k+1."""
    b = sb.shape[0]
    prefix = _scan_padd((x, y, z))
    ident = g1_ops.identity_batch((b, 1), x.device)
    pref = tuple(torch.cat([i, t], dim=-1) for i, t in zip(ident, prefix))
    targets = torch.arange(half + 1, dtype=sb.dtype, device=sb.device)
    cnt = torch.searchsorted(sb.contiguous(),
                             targets.expand(b, -1).contiguous(), right=True)
    hi = tuple(_gather_lanes(t, cnt[:, 1:]) for t in pref)
    lo = tuple(_gather_lanes(t, cnt[:, :-1]) for t in pref)
    return g1_ops.padd(hi, g1_ops.pneg(lo))


def _scatter_dense(rs, coords, half: int):
    """Rows of DISTINCT sorted bucket ids -> dense [B, 12, half] slots:
    slot k is a binary-search gather of bucket k+1 (identity if absent)."""
    b = rs.shape[0]
    targets = torch.arange(1, half + 1, dtype=rs.dtype, device=rs.device)
    targets = targets.expand(b, -1).contiguous()
    idx = torch.searchsorted(rs.contiguous(), targets).clamp_(max=half - 1)
    found = torch.gather(rs, 1, idx) == targets
    out = tuple(_gather_lanes(t, idx) for t in coords)
    return _park_identity(~found, out)


def _weighted_fold(buckets):
    """Dense bucket sums [B, 12, half] -> sum_b (b+1) S_b as [B, 12, 1]
    via suffix sums plus a lane reduction."""
    return g1_ops.sum_lanes(_scan_padd(buckets, reverse=True))


def _sorted_points(c: int, pm, pinf, limbs):
    """Digits -> one packed-key sort per row -> gathered, sign-applied,
    bucket-sorted points.  Returns (sid [B, N] int32, x, y, z [B, 12, N])."""
    s, _, n = limbs.shape
    half = 1 << (c - 1)
    sent = half + 1
    d = _signed_digit_tensors(limbs, c)
    b = s * d.shape[1]
    dflat = d.reshape(b, n)
    bucket = torch.where(dflat == 0, sent, dflat.abs())
    bucket = torch.where(pinf[None, :], sent, bucket)

    # pack (bucket, sign, index) into ONE i32 key: the keys are unique, so
    # an unstable sort gives the same order, and the sign rides along
    idx_bits = max(n - 1, 1).bit_length()
    if (sent << (idx_bits + 1)) >= (1 << 31):
        raise ValueError(f"sort key overflows i32 at n={n}, c={c}")
    iota = torch.arange(n, dtype=torch.int32, device=limbs.device)
    neg_bit = (dflat < 0).to(torch.int32) << idx_bits
    packed = torch.sort((bucket << (idx_bits + 1)) | neg_bit | iota,
                        dim=-1).values
    sid = packed >> (idx_bits + 1)
    neg = ((packed >> idx_bits) & 1) == 1
    perm = (packed & ((1 << idx_bits) - 1)).to(torch.int64)

    l = FQ.n_limbs
    g = pm.index_select(0, perm.reshape(-1))             # [B*N, 36]
    g = g.reshape(b, n, 3 * l).transpose(1, 2)           # [B, 36, N]
    x, y, z = g[:, :l], g[:, l:2 * l], g[:, 2 * l:]
    y = lf.select(neg, lf.neg(FQ, y), y)
    return (sid, *_park_identity(sid >= sent, (x, y, z)))


def _msm_pipeline(c: int, pm, pinf, limbs):
    """pm [N, 36] point-major Montgomery coordinates (x|y|z per row), pinf
    [N] infinity flags, limbs [S, 8, N] canonical scalars.  Returns the
    [S*W, 12, 1] x/y/z window sums (set-major).  Prefix-scan buckets."""
    half = 1 << (c - 1)
    sid, x, y, z = _sorted_points(c, pm, pinf, limbs)
    return _weighted_fold(_bucket_sums_dense(sid, x, y, z, half))


def _msm_ptree_pipeline(c: int, pm, pinf, limbs):
    """Same contract as `_msm_pipeline`, halving-tree bucket accumulation.

    At each level adjacent lanes merge with ONE addition where they share a
    bucket; the left lane of each bucket-boundary pair (at most one per
    bucket per level, so ids are distinct) is compacted by a key sort into
    `half` reject slots.  The residual goes through the prefix-scan tail,
    and each level's rejects scatter into dense slots and fold in with one
    addition per level."""
    half = 1 << (c - 1)
    sent = half + 1
    sid, x, y, z = _sorted_points(c, pm, pinf, limbs)
    b, _, n = x.shape
    two_adic = (n & -n).bit_length() - 1
    levels = min(max(0, (n // half).bit_length() - 1), two_adic)
    parts = []
    for _ in range(levels):
        m = x.shape[-1] // 2
        left = tuple(t[..., 0::2] for t in (x, y, z))
        right = tuple(t[..., 1::2] for t in (x, y, z))
        sl, sr = sid[:, 0::2], sid[:, 1::2]
        same = sl == sr
        x, y, z = g1_ops.pselect(same, g1_ops.padd(left, right), right)
        sid = sr
        rsid = torch.where(same, sent, sl)
        if m < half:
            rsid = F.pad(rsid, (0, half - m), value=sent)
            left = tuple(F.pad(t, (0, half - m)) for t in left)
            m = half
        # compact AND sort ascending (the dense scatter binary-searches)
        pos_bits = max(m - 1, 1).bit_length()
        riota = torch.arange(m, dtype=torch.int32, device=sid.device)
        rpacked = torch.sort((rsid << pos_bits) | riota,
                             dim=-1).values[:, :half]
        rs = rpacked >> pos_bits
        rp = (rpacked & ((1 << pos_bits) - 1)).to(torch.int64)
        rej = tuple(_gather_lanes(t, rp) for t in left)
        parts.append((rs, _park_identity(rs >= sent, rej)))

    buckets = _bucket_sums_dense(sid, x, y, z, half)
    for rs, rej in parts:
        buckets = g1_ops.padd(buckets, _scatter_dense(rs, rej, half))
    return _weighted_fold(buckets)


def _fold_windows(sums, c: int, n_sets: int,
                  set_sizes) -> list[G1Projective]:
    """Window fold (one window_fold launch) + host decode."""
    w_count = sums[0].shape[0] // n_sets
    acc = lf.tensor_to_u32(kernels.window_fold(
        c, w_count, n_sets, *(t.contiguous() for t in sums)))  # [3, 12, S]
    rinv = pow(FQ.R, -1, FQ.modulus)
    out = []
    for s_i in range(n_sets):
        if not set_sizes[s_i]:
            out.append(G1Projective.identity())
            continue
        cx, cy, cz = (lf.limbs_to_int(acc[k][:, s_i]) * rinv % FQ.modulus
                      for k in range(3))
        out.append(G1Projective(Fp(cx), Fp(cy), Fp(cz)))
    return out


def _pad_points(points, n_pad: int):
    """[12, n] point coords -> [12, n_pad], padded with identities."""
    n = points[0].shape[-1]
    if n == n_pad:
        return points
    if n > n_pad:
        return tuple(t[:, :n_pad] for t in points)
    ident = g1_ops.identity_batch((n_pad - n,), points[0].device)
    return tuple(torch.cat([t, i], dim=-1) for t, i in zip(points, ident))


# -----------------------------------------------------------------------------
# Public API
# -----------------------------------------------------------------------------

class MSMContext:
    """Holds a device-resident point set (e.g. a CommitKey's powers)."""

    def __init__(self, points: list[G1Affine], device):
        self.points = g1_ops.affine_to_device(points, device)
        self.device = self.points[0].device  # with its index ("cuda:0")
        self.n = len(points)
        self._pad_cache = {}

    def msm(self, scalars: list[Fr]) -> G1Projective:
        """MSM of the first len(scalars) points."""
        return self.msm_many([scalars])[0]

    def msm_many(self, scalar_sets: list[list[Fr]]) -> list[G1Projective]:
        """Several MSMs over (prefixes of) the point set in ONE pipeline:
        per-set digit rows stack along the window axis.  Scalar counts pad
        to a size class; dead lanes never enter a bucket."""
        sizes = [len(s) for s in scalar_sets]
        if max(sizes) > self.n:
            raise ValueError(f"{max(sizes)} scalars for {self.n} points")
        n_pad = _granule(max(sizes))
        vals = []
        for scalars in scalar_sets:
            vals.extend([s.value for s in scalars]
                        + [0] * (n_pad - len(scalars)))
        raw = FR.to_raw_array(vals, self.device)  # [8, S*n_pad]
        limbs = raw.reshape(FR.n_limbs, len(sizes), n_pad).transpose(0, 1)
        return self._run(limbs.contiguous(), sizes, n_pad)

    def msm_many_mont(self, coeff_tensors) -> list[G1Projective]:
        """MSMs from device-resident Montgomery coefficient tensors
        ([8, len_i] int32 each) -- the commit path of a device-resident
        prover (no host scalar conversion)."""
        sizes = [int(t.shape[-1]) for t in coeff_tensors]
        if max(sizes) > self.n:
            raise ValueError(f"{max(sizes)} scalars for {self.n} points")
        for t in coeff_tensors:
            if t.device != self.device:
                raise ValueError(f"coefficients on {t.device}, points on "
                                 f"{self.device}")
        n_pad = _granule(max(sizes))
        padded = torch.stack([F.pad(t, (0, n_pad - t.shape[-1]))
                              for t in coeff_tensors])  # [S, 8, n_pad]
        return self._run(lf.from_mont(FR, padded), sizes, n_pad)

    def _padded(self, n_pad: int):
        """Point-major [N, 36] matrix and infinity flags, cached per size
        class."""
        ent = self._pad_cache.get(n_pad)
        if ent is None:
            pts = _pad_points(self.points, n_pad)
            pinf = lf.is_zero(FQ, pts[2])
            pm = torch.cat(pts, dim=0).T.contiguous()  # [N, 36]
            ent = self._pad_cache[n_pad] = (pm, pinf)
        return ent

    def _run(self, limbs, sizes, n_pad) -> list[G1Projective]:
        pm, pinf = self._padded(n_pad)
        if n_pad >= PTREE_MIN_POINTS:
            c = _ptree_window_bits(n_pad)
            sums = _msm_ptree_pipeline(c, pm, pinf, limbs)
        else:
            c = _window_bits(n_pad)
            sums = _msm_pipeline(c, pm, pinf, limbs)
        return _fold_windows(sums, c, len(sizes), sizes)
