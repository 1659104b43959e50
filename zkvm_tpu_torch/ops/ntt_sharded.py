"""Distributed NTT: the 4-step (Bailey) decomposition over a device mesh.

Counterpart of `zkvm_tpu/ops/ntt_sharded.py`.  A size-N transform factors
as N = N1 * N2:

  1. each shard runs N1-point column FFTs over its part of the N2 axis,
  2. multiplies by the w^(b*c) "glue" twiddles (local),
  3. an all_to_all re-shards from columns (b) to rows (c) -- the only
     communication, one matrix transpose,
  4. each shard runs N2-point row FFTs over its part of the N1 axis.

Derivation: with n = N2*a + b, k = N1*d + c,
  X[N1*d + c] = sum_b w2^(b*d) * w^(b*c) * [ sum_a x[a, b] * w1^(a*c) ]
(w1 = w^N2 has order N1, w2 = w^N1 has order N2), so the output matrix
Z[c, d] read out d-major is exactly X.

Tensors are the port's `[*lead, 8, N]` Montgomery limbs, global on the
mesh's home device in and out.  On a shard the transformed axis is the last
one and the other index a leading batch axis: [*lead, n2loc(b), 8, N1(a)]
for step 1 and [*lead, n1loc(c), 8, N2(b)] for step 4, so each local FFT
is one `ntt.butterfly_transform` call (the staged route of `Domain`, the
`ntt_stages` kernel on the shard's device) with no transpose around it.
The per-shard tables (glue twiddles, coset factors) are built on the host
once per size and lifted once per shard, in that layout; `Domain` caches
the local transforms' twiddle tables per device.  Every step is exact field
arithmetic, so the result equals `Domain`'s bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import params
from . import limb_field as lf
from . import ntt
from .collective import Mesh
from .limb_field import FR
from .ntt import Domain

_Q = params.FR_MODULUS


def _batched_ntt(n: int, inverse: bool):
    """The n-point transform of steps 1 and 4 (the staged route): it runs
    along the last axis of a contiguous [..., 8, n] on that tensor's
    device, batched over every leading axis.  `inverse` selects the inverse
    root; the N^-1 scaling happens once, at the end of the distributed
    transform."""
    dom = Domain(n)
    return lambda t: ntt.butterfly_transform(dom, t, inverse)


@functools.lru_cache(maxsize=None)
def _glue_twiddles(n: int, n1: int, inverse: bool) -> np.ndarray:
    """w^(b*c) for every b < N2, c < N1 as Montgomery uint32 [N2, 8, N1]
    (w the size-n root, or its inverse)."""
    dom = Domain(n)
    root = dom.group_gen_inv if inverse else dom.group_gen
    vals = []
    step = 1  # root^b
    for _ in range(n // n1):
        cur = 1
        for _ in range(n1):
            vals.append(cur)
            cur = cur * step % _Q
        step = step * root % _Q
    return np.ascontiguousarray(
        FR.to_mont_array_np(vals).reshape(FR.n_limbs, n // n1, n1)
        .transpose(1, 0, 2))


def _coset_tables_np(size: int, n1: int, inverse: bool) -> np.ndarray:
    """The coset factors (GENERATOR=7 power distribution,
    fft/domain.rs:168-196) in the shard layout of the step that applies
    them:

      forward: g^i at the input, i = N2*a + b, as [N2(b), 8, N1(a)];
      inverse: g^-k * N^-1 at the output, k = N1*d + c, as
               [N1(c), 8, N2(d)]."""
    dom = Domain(size)
    n2 = size // n1
    if not inverse:
        t = dom.factor_np("coset").reshape(FR.n_limbs, n1, n2)
        return np.ascontiguousarray(t.transpose(2, 0, 1))
    t = dom.factor_np("coset_inv_scaled").reshape(FR.n_limbs, n2, n1)
    return np.ascontiguousarray(t.transpose(2, 0, 1))


class DistributedDomain:
    """Size-N NTT sharded over `mesh` (one axis), one instance per (size,
    mesh, axis)."""

    _cache: dict[tuple, "DistributedDomain"] = {}

    def __new__(cls, size: int, mesh: Mesh, axis: str | None = None):
        key = (size, mesh, mesh.axis(axis))
        inst = cls._cache.get(key)
        if inst is None:
            inst = cls._cache[key] = super().__new__(cls)
            inst._setup(size, mesh, key[2])
        return inst

    def _setup(self, size: int, mesh: Mesh, axis: str):
        self.size = size
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.size
        # N1 = local FFT length of step 1; the N2 axis is sharded.  Both
        # factors must divide the shard count, so N1 is lifted to a multiple
        # of it where the square split falls short (any pow-2 mesh works
        # once size >= n_dev^2).  Non-pow-2 meshes and domains too small to
        # split take the single-device transform on the home device.
        lb = size.bit_length() - 1
        d = self.n_dev.bit_length() - 1
        pow2_mesh = self.n_dev == (1 << d)
        self.local = not (pow2_mesh and size == (1 << lb) and lb >= 2 * d)
        self._domain = Domain(size)
        if self.local:
            return
        l1 = max(d, lb // 2)
        self.n1 = 1 << l1
        self.n2 = size >> l1
        self.n2_loc = self.n2 // self.n_dev
        self.n1_loc = self.n1 // self.n_dev
        self._tables: dict[tuple, list[torch.Tensor]] = {}

    def _shard_tables(self, key: tuple) -> list[torch.Tensor]:
        """One table per shard, on its device: the glue twiddles
        ("glue", inverse) or the coset factors ("coset", inverse), split
        along their leading axis (the sharded one)."""
        tabs = self._tables.get(key)
        if tabs is None:
            kind, inverse = key
            host = (_glue_twiddles(self.size, self.n1, inverse)
                    if kind == "glue" else
                    _coset_tables_np(self.size, self.n1, inverse))
            parts = np.split(host, self.n_dev)
            tabs = self._tables[key] = [
                lf.u32_to_tensor(p, dev)
                for p, dev in zip(parts, self.mesh.devices)]
        return tabs

    def _run(self, x: torch.Tensor, inverse: bool,
             coset: bool = False) -> torch.Tensor:
        """x: [*lead, 8, N] on the home device -> its transform there."""
        if x.shape[-1] != self.size:
            raise ValueError(f"expected [..., 8, {self.size}], got "
                             f"{tuple(x.shape)}")
        if self.local:
            dom = self._domain
            fn = ((dom.coset_ifft_device if coset else dom.ifft_device)
                  if inverse else
                  (dom.coset_fft_device if coset else dom.fft_device))
            return fn(x)
        mesh = self.mesh
        lead = x.shape[:-2]
        fft1 = _batched_ntt(self.n1, inverse)
        fft2 = _batched_ntt(self.n2, inverse)
        glue = self._shard_tables(("glue", inverse))
        pre = (self._shard_tables(("coset", False))
               if coset and not inverse else None)
        post = (self._shard_tables(("coset", True))
                if coset and inverse else None)
        # x[a, b] with n = N2*a + b, sharded over b
        parts = mesh.split(x.reshape(lead + (FR.n_limbs, self.n1, self.n2)))
        ys = []
        for i, part in enumerate(parts):
            t = part.movedim(-1, -3)                 # [.., n2loc(b), 8, a]
            if pre is not None:
                t = lf.mont_mul(FR, t, pre[i])
            y = fft1(t.contiguous())                 # FFT over a -> c
            ys.append(lf.mont_mul(FR, y, glue[i]))
        # re-shard: split the c axis, gather the whole b axis
        zs = []
        for i, y in enumerate(mesh.all_to_all(ys, split_dim=-1,
                                              concat_dim=-3)):
            z = fft2(y.transpose(-1, -3).contiguous())  # [.., c, 8, d]
            if post is not None:
                z = lf.mont_mul(FR, z, post[i])
            elif inverse:
                z = lf.mont_mul_const(FR, z, FR.mont_limbs(
                    self._domain.size_inv))
            zs.append(z)
        z = mesh.gather(zs, dim=-3)                  # [.., N1(c), 8, N2(d)]
        return z.movedim(-3, -1).reshape(lead + (FR.n_limbs, self.size))

    def fft_device(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self._run(coeffs, inverse=False)

    def ifft_device(self, evals: torch.Tensor) -> torch.Tensor:
        return self._run(evals, inverse=True)

    def coset_fft_device(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate over the coset g*H, sharded (domain.rs:168 semantics)."""
        return self._run(coeffs, inverse=False, coset=True)

    def coset_ifft_device(self, evals: torch.Tensor) -> torch.Tensor:
        """Interpolate from coset evaluations, sharded."""
        return self._run(evals, inverse=True, coset=True)
