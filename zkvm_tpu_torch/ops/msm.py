"""Device Pippenger MSM: bucket accumulation by sort + segmented sums.

Counterpart of `zkvm_tpu/ops/msm.py`.  The pipeline is the reference's,
step for step:

  1. signed radix-2^c digits [S*W, N] from canonical scalar limbs, each
     as a packed i32 key (bucket, sign, index);
  2. one sort per digit row.  The `msm_digits` kernel does the integer
     work on both sides of the sort: limbs to keys, and the sorted keys
     back to (bucket, sign, index);
  3. a row gather of the point-major [N, 36] matrix by that permutation,
     negating y where the digit is negative; dead lanes (digit 0 or the
     point at infinity) are parked at the identity;
  4. bucket accumulation: an inclusive prefix scan (`_msm_pipeline`), or
     for N >= PTREE_MIN_POINTS the halving tree (`_msm_ptree_pipeline`),
     which merges adjacent same-bucket lanes with one addition per level
     and compacts the rejects.  Step 3 is the `msm_gather` kernel: on the
     tree it adds the first level's pairs as it gathers them, so the
     sorted points are never written at full width;
  5. bucket sums as differences of prefix values at bucket boundaries;
  6. the weighted fold sum_b b * S_b as suffix sums plus a lane reduction;
  7. the window fold sum_w 2^(c w) * T_w, one `window_fold` kernel launch.

Every other point addition goes through the padd kernel and the final
fold through the window_fold kernel (their plain versions for CPU
tensors).
On a mesh (`msm_sharded`, `MSMContext.msm_many_mont(mesh=...)`) each
shard runs steps 1-6 on its slice of the points with the prefix scan, and
the shards' window sums are added in shard order before step 7.

The scan is a log-depth tensor recursion of additions on strided slices,
the same code on every device.  Projective coordinates therefore differ
from the reference's (another addition order); results agree as group
elements.

Each stage is entered through a stage hook, by default the registry span
`prove/msm/<stage>` (`utils/metrics.py`): the host's time in the stage,
its launches and any wait on the device (the read-back of `host decode`;
a blocking copy of a host constant, as in `g1_ops.park_identity`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..curves.g1 import G1Affine, G1Projective
from ..fields import Fp, Fr
from ..utils import metrics

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
    w_count = kernels.digit_windows(c)
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
    return g1_ops.park_identity(~found, out)


def _weighted_fold(buckets):
    """Dense bucket sums [B, 12, half] -> sum_b (b+1) S_b as [B, 12, 1]
    via suffix sums plus a lane reduction."""
    return g1_ops.sum_lanes(_scan_padd(buckets, reverse=True))


def _span(name: str):
    """The default stage hook: the registry span `prove/msm/<name>`."""
    return metrics.GLOBAL.span(f"prove/msm/{name}")


def _digit_keys(d: torch.Tensor, pinf: torch.Tensor, half: int):
    """Signed digits [S, W, N] -> one sort key a digit, [S*W, N] int32.

    Dead lanes (digit 0, the point at infinity) take the sentinel bucket
    half + 1 and sort last.  Where `packed_key_fits`, (bucket, sign, index)
    packed into one key: the keys are unique, so an unstable sort gives the
    same order, and the sign rides along.  Else (bucket, sign) alone, for a
    stable sort, which keeps the index order within each key."""
    sent = half + 1
    b, n = d.shape[0] * d.shape[1], d.shape[2]
    dflat = d.reshape(b, n)
    bucket = torch.where(dflat == 0, sent, dflat.abs())
    bucket = torch.where(pinf[None, :], sent, bucket)
    neg_bit = (dflat < 0).to(torch.int32)
    if not kernels.packed_key_fits(half, n):
        return (bucket << 1) | neg_bit
    idx_bits = kernels.key_index_bits(n)
    iota = torch.arange(n, dtype=torch.int32, device=d.device)
    return (bucket << (idx_bits + 1)) | (neg_bit << idx_bits) | iota


def _sort_keys(keys: torch.Tensor, half: int):
    """One sort per key row [B, N] of `_digit_keys`.

    Returns (sid [B, N] ascending bucket ids, neg [B, N] sign flags, perm
    [B, N] point indices).  Within a bucket the positive digits come
    first, each sign in index order."""
    if kernels.packed_key_fits(half, keys.shape[-1]):
        return kernels.msm_digits(torch.sort(keys, dim=-1).values,
                                  unpack=True)
    return _sort_stable(keys)


def _sort_stable(keys: torch.Tensor):
    """The order of the packed key at any lane count: a stable sort of the
    (bucket, sign) keys keeps the index order within each key."""
    key, perm = torch.sort(keys, dim=-1, stable=True)
    return key >> 1, (key & 1) == 1, perm


def _sort_digits(d: torch.Tensor, pinf: torch.Tensor, half: int):
    """Signed digits [S, W, N] -> one sort per digit row: `_sort_keys` of
    `_digit_keys`."""
    return _sort_keys(_digit_keys(d, pinf, half), half)


def _sorted_digits(c: int, pinf, limbs, stage=_span):
    """Limbs -> keys -> one sort per row: (sid, neg, perm) [B, N]."""
    with stage("signed digits"):
        keys = kernels.msm_digits(limbs, pinf, c)
    with stage("sort"):
        return _sort_keys(keys, 1 << (c - 1))


def _sorted_points(c: int, pm, pinf, limbs, stage=_span):
    """Digits -> sort -> gathered, sign-applied, bucket-sorted points (the
    `msm_gather` kernel in gather mode).  Returns (sid [B, N] int32, x, y,
    z [B, 12, N])."""
    sid, neg, perm = _sorted_digits(c, pinf, limbs, stage)
    with stage("gather"):
        x, y, z = kernels.msm_gather(pm, sid, neg, perm, 1 << (c - 1))
    return sid, x, y, z


def _msm_pipeline(c: int, pm, pinf, limbs, stage=_span):
    """pm [N, 36] point-major Montgomery coordinates (x|y|z per row), pinf
    [N] infinity flags, limbs [S, 8, N] canonical scalars.  Returns the
    [S*W, 12, 1] x/y/z window sums (set-major).  Prefix-scan buckets.
    `stage(name)` is a context entered around each stage."""
    half = 1 << (c - 1)
    sid, x, y, z = _sorted_points(c, pm, pinf, limbs, stage)
    with stage("scan tail"):
        buckets = _bucket_sums_dense(sid, x, y, z, half)
    with stage("weighted fold"):
        return _weighted_fold(buckets)


def _compact_rejects(rsid, half: int):
    """A level's left-lane ids [B, m] (sentinel where merged; the others at
    most one per bucket, so distinct) -> compacted AND sorted ascending
    into `half` slots (the dense scatter binary-searches): (rs [B, half]
    ids, rp [B, half] int32 lane positions)."""
    m = rsid.shape[-1]
    if m < half:
        rsid = F.pad(rsid, (0, half - m), value=half + 1)
        m = half
    pos_bits = max(m - 1, 1).bit_length()
    riota = torch.arange(m, dtype=torch.int32, device=rsid.device)
    rpacked = torch.sort((rsid << pos_bits) | riota, dim=-1).values[:, :half]
    return rpacked >> pos_bits, rpacked & ((1 << pos_bits) - 1)


def _first_level(pm, sid, neg, perm, half: int):
    """The halving tree's first level straight from the sort: the
    `msm_gather` kernel in merge mode, then its rejects (the left lanes of
    the bucket-boundary pairs) in gather mode.  Same returns as
    `_tree_level`."""
    pts, rsid = kernels.msm_gather(pm, sid, neg, perm, half, pairs=True)
    rs, rp = _compact_rejects(rsid, half)
    rej = kernels.msm_gather(pm, rs, neg, perm, half, src=rp * 2)
    return sid[:, 1::2], pts, (rs, rej)


def _tree_level(sid, pts, half: int):
    """One later level of the halving tree: adjacent lanes merge with ONE
    addition where they share a bucket; the left lane of each
    bucket-boundary pair (at most one per bucket, so ids are distinct) is
    compacted by a key sort into `half` reject slots.  Returns (sid, pts)
    at half the lanes and the level's rejects (rs, x/y/z)."""
    sent = half + 1
    left = tuple(t[..., 0::2] for t in pts)
    right = tuple(t[..., 1::2] for t in pts)
    sl, sr = sid[:, 0::2], sid[:, 1::2]
    same = sl == sr
    pts = g1_ops.pselect(same, g1_ops.padd(left, right), right)
    rs, rp = _compact_rejects(torch.where(same, sent, sl), half)
    m = left[0].shape[-1]
    if m < half:
        left = tuple(F.pad(t, (0, half - m)) for t in left)
    rej = tuple(_gather_lanes(t, rp.to(torch.int64)) for t in left)
    return sr, tuple(pts), (rs, g1_ops.park_identity(rs >= sent, rej))


def _msm_ptree_pipeline(c: int, pm, pinf, limbs, stage=_span):
    """Same contract as `_msm_pipeline`, halving-tree bucket accumulation:
    the first level from the sort (`_first_level`), `_tree_level` while the
    lanes outnumber the buckets, the residual through the prefix-scan tail,
    and each level's rejects scattered into dense slots and folded in with
    one addition per level."""
    half = 1 << (c - 1)
    sid, neg, perm = _sorted_digits(c, pinf, limbs, stage)
    n = sid.shape[-1]
    two_adic = (n & -n).bit_length() - 1
    levels = min(max(0, (n // half).bit_length() - 1), two_adic)
    if not levels:
        with stage("gather"):
            pts = kernels.msm_gather(pm, sid, neg, perm, half)
    parts = []
    for level in range(levels):
        with stage(f"tree level {level + 1}"):
            if level:
                sid, pts, rejects = _tree_level(sid, pts, half)
            else:
                sid, pts, rejects = _first_level(pm, sid, neg, perm, half)
        parts.append(rejects)
    with stage("scan tail"):
        buckets = _bucket_sums_dense(sid, *pts, half)
    with stage("reject folds"):
        for rs, rej in parts:
            buckets = g1_ops.padd(buckets, _scatter_dense(rs, rej, half))
    with stage("weighted fold"):
        return _weighted_fold(buckets)


def _fold_windows(sums, c: int, n_sets: int, set_sizes,
                  stage=_span) -> list[G1Projective]:
    """Window fold (one window_fold launch) + host decode."""
    w_count = sums[0].shape[0] // n_sets
    with stage("window_fold"):
        acc = kernels.window_fold(c, w_count, n_sets,
                                  *(t.contiguous() for t in sums))
    with stage("host decode"):
        acc = lf.tensor_to_u32(acc)  # [3, 12, S]
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


def _combine_gathered(gathered):
    """Sum a [D, ...] gather of window-sum triples over axis 0, in shard
    order, with one addition per shard."""
    total = tuple(t[0] for t in gathered)
    for d in range(1, gathered[0].shape[0]):
        total = g1_ops.padd(total, tuple(t[d] for t in gathered))
    return total


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

    def msm_many(self, scalar_sets: list[list[Fr]],
                 stage=_span) -> list[G1Projective]:
        """Several MSMs over (prefixes of) the point set in ONE pipeline:
        per-set digit rows stack along the window axis.  Scalar counts pad
        to a size class; dead lanes never enter a bucket.  `stage(name)`
        is a context entered around each stage of the pipeline (by
        default the span `prove/msm/<stage>`; `tools/prof_msm.py` passes
        one that synchronises and times)."""
        sizes = [len(s) for s in scalar_sets]
        if max(sizes) > self.n:
            raise ValueError(f"{max(sizes)} scalars for {self.n} points")
        n_pad = _granule(max(sizes))
        with stage("scalar conversion"):
            vals = []
            for scalars in scalar_sets:
                vals.extend([s.value for s in scalars]
                            + [0] * (n_pad - len(scalars)))
            raw = FR.to_raw_array(vals, self.device)  # [8, S*n_pad]
            limbs = raw.reshape(FR.n_limbs, len(sizes), n_pad).transpose(0, 1)
            limbs = limbs.contiguous()
        return self._run(limbs, sizes, n_pad, stage)

    def msm_many_mont(self, coeff_tensors, mesh=None,
                      axis: str | None = None) -> list[G1Projective]:
        """MSMs from device-resident Montgomery coefficient tensors
        ([8, len_i] int32 each) -- the commit path of a device-resident
        prover (no host scalar conversion).  With `mesh` (whose home is the
        context's device), points and scalars shard across the mesh and
        the shards' window sums are added on the home device (the partial
        sums of `msm_sharded`)."""
        sizes = [int(t.shape[-1]) for t in coeff_tensors]
        if max(sizes) > self.n:
            raise ValueError(f"{max(sizes)} scalars for {self.n} points")
        for t in coeff_tensors:
            if t.device != self.device:
                raise ValueError(f"coefficients on {t.device}, points on "
                                 f"{self.device}")
        if mesh is not None:
            mesh.axis(axis)
            return self._run_sharded(coeff_tensors, sizes, mesh)
        n_pad = _granule(max(sizes))
        with _span("ingest"):
            padded = torch.stack([F.pad(t, (0, n_pad - t.shape[-1]))
                                  for t in coeff_tensors])  # [S, 8, n_pad]
            limbs = lf.from_mont(FR, padded)
        return self._run(limbs, sizes, n_pad)

    def _run_sharded(self, tensors, sizes, mesh) -> list[G1Projective]:
        """Each shard pads to `_granule(ceil(n / D))` and runs the scan
        pipeline on its slice of the points and of the Montgomery scalars;
        the window sums are gathered and added in shard order."""
        if mesh.home != self.device:
            raise ValueError(f"the mesh's home is {mesh.home}, the points "
                             f"are on {self.device}")
        shard = _granule(-(-max(sizes) // mesh.size))
        n_pad = shard * mesh.size
        c = _window_bits(shard)
        pm, pinf = self._padded(n_pad)
        with _span("ingest"):
            padded = torch.stack([F.pad(t, (0, n_pad - t.shape[-1]))
                                  for t in tensors])  # [S, 8, n_pad]
            limbs = [lf.from_mont(FR, x_d) for x_d in mesh.split(padded)]
        sums = []
        for pm_d, pinf_d, x_d in zip(mesh.split(pm, 0), mesh.split(pinf),
                                     limbs):
            sums.append(_msm_pipeline(c, pm_d, pinf_d, x_d))
        gathered = tuple(mesh.gather([s[k].unsqueeze(0) for s in sums], 0)
                         for k in range(3))  # x, y, z [D, S*W, 12, 1]
        return _fold_windows(_combine_gathered(gathered), c, len(sizes),
                             sizes)

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

    def _run(self, limbs, sizes, n_pad,
             stage=_span) -> list[G1Projective]:
        pm, pinf = self._padded(n_pad)
        if n_pad >= PTREE_MIN_POINTS:
            c = _ptree_window_bits(n_pad)
            sums = _msm_ptree_pipeline(c, pm, pinf, limbs, stage)
        else:
            c = _window_bits(n_pad)
            sums = _msm_pipeline(c, pm, pinf, limbs, stage)
        return _fold_windows(sums, c, len(sizes), sizes, stage)


def msm_device(points: list[G1Affine], scalars: list[Fr],
               device) -> G1Projective:
    """One-shot MSM on `device`, the context built per call over the first
    len(scalars) points (cache an `MSMContext` for hot paths such as
    `CommitKey.commit`)."""
    if len(points) < len(scalars):
        raise ValueError(f"{len(scalars)} scalars for {len(points)} points")
    return MSMContext(points[:len(scalars)], device).msm(scalars)


# -----------------------------------------------------------------------------
# Multi-chip MSM: point shards per device, window sums combined across shards
# -----------------------------------------------------------------------------

def msm_sharded(points: list[G1Affine], scalars: list[Fr], mesh,
                axis: str | None = None) -> G1Projective:
    """MSM sharded over a device mesh: points and scalars split evenly
    across the shards, each shard runs the whole bucket pipeline on its
    slice, and the shards' window sums -- one point per window -- are
    added on the home device.  Communication: D*W points, the Pippenger
    partial-sum reduction."""
    n = len(scalars)
    if len(points) < n:
        raise ValueError(f"{n} scalars for {len(points)} points")
    ctx = MSMContext(points[:n], mesh.home)
    mont = FR.to_mont_array([s.value for s in scalars], ctx.device)
    return ctx.msm_many_mont([mont], mesh=mesh, axis=axis)[0]
