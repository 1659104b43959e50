"""Radix-2 (i)NTT over the BLS12-381 scalar field, batched on the device.

Counterpart of `zkvm_tpu/ops/ntt.py`.  `Domain` mirrors
plonk/src/fft/domain.rs:23-284 (fft/ifft/coset variants with GENERATOR=7
cosets, vanishing-polynomial helpers, Lagrange coefficients).  Its device
transforms take the byte-plane matmul route (`ntt_mxu.MXUTransform`); the
staged butterfly transform (`butterfly_transform`: one `butterfly` kernel
launch per stage) stays beside it as a plain function for cross-checks.
Results are exact integers, hence bit-identical between the two routes and
to the reference for the same domain.

Tensors are `[*lead, 8, n]` int32 Montgomery limbs with any number of
leading batch axes.  A transform runs on its operand's device; tables are
built on the host once and cached per device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import params
from ..fields import Fr
from . import kernels
from . import limb_field as lf
from .limb_field import FR
from .ntt_mxu import MXUTransform


def bit_reverse_indices(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _ntt_impl(x, brev, even_idx, odd_idx, out_idx, tw_idx, tw_table):
    """Iterative Cooley-Tukey NTT; x: [*lead, 8, n] Montgomery; output
    natural-order evaluations.

    Every stage runs over the same flat shape (gather indices and
    twiddle-table lookups precomputed per stage on the host): two gathers,
    one `butterfly` kernel launch over [*lead, 8, n/2] with the stage's
    shared [8, n/2] twiddles, one gather of the concatenated outputs."""
    x = x.index_select(-1, brev)
    for s in range(even_idx.shape[0]):
        even = x.index_select(-1, even_idx[s])
        odd = x.index_select(-1, odd_idx[s])
        tw = tw_table.index_select(-1, tw_idx[s])
        plus, minus = kernels.butterfly(even, odd, tw)
        x = torch.cat([plus, minus], dim=-1).index_select(-1, out_idx[s])
    return x


def _scale(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Pointwise Montgomery multiply by a per-index factor array [8, n]."""
    return lf.mont_mul(FR, x, factors.expand(x.shape))


class Domain:
    """Multiplicative subgroup domain of power-of-two order over Fr."""

    _cache: dict[int, "Domain"] = {}

    def __new__(cls, size: int):
        if size in cls._cache:
            return cls._cache[size]
        inst = super().__new__(cls)
        cls._cache[size] = inst
        return inst

    def __init__(self, size: int):
        if getattr(self, "size", None) == size:
            return  # cached
        if size > (1 << params.FR_TWO_ADICITY):
            # fft/domain.rs:35-43 InvalidEvalDomainSize
            from ..plonk.errors import InvalidEvalDomainSize

            raise InvalidEvalDomainSize(size.bit_length() - 1,
                                        params.FR_TWO_ADICITY)
        if size & (size - 1) or size == 0:
            raise ValueError(f"invalid domain size {size}")
        self.size = size
        self.log_size = size.bit_length() - 1
        q = params.FR_MODULUS
        self.group_gen = pow(params.FR_ROOT_OF_UNITY,
                             1 << (params.FR_TWO_ADICITY - self.log_size), q)
        self.group_gen_inv = pow(self.group_gen, -1, q)
        self.size_inv = pow(size, -1, q)
        self.generator = params.FR_GENERATOR  # coset shift g = 7
        self.generator_inv = pow(self.generator, -1, q)
        # lazy per-use tables: host numpy once, device tensors per device
        self._factors_np: dict[str, np.ndarray] = {}
        self._factors: dict[tuple, torch.Tensor] = {}
        self._butterfly_np: tuple | None = None
        self._butterfly: dict[torch.device, tuple] = {}

    def _butterfly_tables(self, device: torch.device):
        """(brev, (even, odd, out, twiddle) stage indexes, forward and
        inverse twiddle tables) as tensors on `device`."""
        dev = self._butterfly.get(device)
        if dev is None:
            if self._butterfly_np is None:
                self._butterfly_np = (
                    bit_reverse_indices(self.size).astype(np.int64),
                    self._build_stage_indexes(),
                    self._twiddle_tables(self.group_gen),
                    self._twiddle_tables(self.group_gen_inv))
            brev, stages, fwd, inv = self._butterfly_np
            dev = self._butterfly[device] = (
                torch.from_numpy(brev).to(device),
                tuple(torch.from_numpy(t).to(device) for t in stages),
                lf.u32_to_tensor(fwd, device), lf.u32_to_tensor(inv, device))
        return dev

    def _build_stage_indexes(self):
        """Per-stage flat gather indexes for the staged butterfly.

        Stage s pairs (b*2h + t, b*2h + h + t) for h = 2^s; outputs land at
        the same positions, gathered from concat([plus, minus]).
        """
        n = self.size
        log_n = self.log_size
        even = np.zeros((log_n, n // 2), dtype=np.int64)
        odd = np.zeros((log_n, n // 2), dtype=np.int64)
        out = np.zeros((log_n, n), dtype=np.int64)
        twi = np.zeros((log_n, n // 2), dtype=np.int64)
        k = np.arange(n // 2)
        j = np.arange(n)
        for s in range(log_n):
            h = 1 << s
            b = k // h
            t = k % h
            even[s] = b * 2 * h + t
            odd[s] = b * 2 * h + h + t
            jb = j // (2 * h)
            jr = j % (2 * h)
            out[s] = np.where(jr < h, jb * h + jr, n // 2 + jb * h + jr - h)
            # stage twiddle for pair k is root^((n >> (s+1)) * (k % h))
            twi[s] = (n >> (s + 1)) * t
        return even, odd, out, twi

    def _twiddle_tables(self, root: int) -> np.ndarray:
        """[8, max(n/2, 1)] Montgomery table of root powers (host)."""
        q = params.FR_MODULUS
        powers, cur = [], 1
        for _ in range(max(self.size // 2, 1)):
            powers.append(cur)
            cur = cur * root % q
        return FR.to_mont_array_np(powers)

    def factor_np(self, key: str) -> np.ndarray:
        """A pointwise factor array on the host (Montgomery uint32 [8, n]),
        built once: "coset" g^i, "coset_inv_scaled" g^-i * n^-1 or
        "size_inv" n^-1."""
        if key not in self._factors_np:
            q = params.FR_MODULUS
            n = self.size
            if key == "coset":          # g^i
                vals = self._powers(self.generator)
            elif key == "coset_inv_scaled":  # g^{-i} * n^{-1}
                vals = [v * self.size_inv % q
                        for v in self._powers(self.generator_inv)]
            elif key == "size_inv":     # n^{-1} broadcast
                vals = [self.size_inv] * n
            else:
                raise KeyError(key)
            self._factors_np[key] = FR.to_mont_array_np(vals)
        return self._factors_np[key]

    def _factor(self, key: str, device: torch.device) -> torch.Tensor:
        """`factor_np(key)` lifted once per device."""
        dev = self._factors.get((key, device))
        if dev is None:
            dev = self._factors[(key, device)] = lf.u32_to_tensor(
                self.factor_np(key), device)
        return dev

    def _powers(self, base: int) -> list[int]:
        q = params.FR_MODULUS
        out, cur = [], 1
        for _ in range(self.size):
            out.append(cur)
            cur = cur * base % q
        return out

    # ---- device transforms (Montgomery [*lead, 8, n] tensors) ---------------
    def _run(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        if self.size == 1:
            return x
        root = self.group_gen_inv if inverse else self.group_gen
        return MXUTransform(self.size, root)(x)

    def fft_device(self, coeffs: torch.Tensor) -> torch.Tensor:
        assert coeffs.shape[-1] == self.size
        return self._run(coeffs, inverse=False)

    def ifft_device(self, evals: torch.Tensor) -> torch.Tensor:
        out = self._run(evals, inverse=True)
        return _scale(out, self._factor("size_inv", out.device))

    def coset_fft_device(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluate over the coset g*H (distribute powers of g, then FFT)."""
        shifted = _scale(coeffs, self._factor("coset", coeffs.device))
        return self._run(shifted, inverse=False)

    def coset_ifft_device(self, evals: torch.Tensor) -> torch.Tensor:
        out = self._run(evals, inverse=True)
        return _scale(out, self._factor("coset_inv_scaled", out.device))

    # ---- host conveniences (lists of Fr) -------------------------------------
    def fft(self, coeffs: list[Fr], device) -> list[Fr]:
        arr = self._lift(coeffs, device)
        return [Fr(v) for v in FR.from_mont_array(self.fft_device(arr))]

    def ifft(self, evals: list[Fr], device) -> list[Fr]:
        arr = self._lift(evals, device)
        return [Fr(v) for v in FR.from_mont_array(self.ifft_device(arr))]

    def coset_fft(self, coeffs: list[Fr], device) -> list[Fr]:
        arr = self._lift(coeffs, device)
        return [Fr(v) for v in FR.from_mont_array(self.coset_fft_device(arr))]

    def coset_ifft(self, evals: list[Fr], device) -> list[Fr]:
        arr = self._lift(evals, device)
        return [Fr(v) for v in FR.from_mont_array(self.coset_ifft_device(arr))]

    def _lift(self, xs: list[Fr], device) -> torch.Tensor:
        return FR.to_mont_array([c.value for c in self._pad(xs)], device)

    def _pad(self, xs: list[Fr]) -> list[Fr]:
        if len(xs) > self.size:
            raise ValueError("input larger than domain")
        return list(xs) + [Fr.zero()] * (self.size - len(xs))

    # ---- host-side domain analytics (domain.rs:106-284) ----------------------
    def elements(self) -> list[Fr]:
        return [Fr(v) for v in self._powers(self.group_gen)]

    def evaluate_vanishing_polynomial(self, tau: Fr) -> Fr:
        """Z_H(tau) = tau^n - 1."""
        return tau.pow(self.size) - Fr.one()

    def evaluate_all_lagrange_coefficients(self, tau: Fr) -> list[Fr]:
        """L_i(tau) for all i, batch-inverted barycentric (domain.rs:200-250)."""
        q = params.FR_MODULUS
        n = self.size
        t = tau.value
        z = (pow(t, n, q) - 1) % q
        if z == 0:
            # tau is in the domain: indicator vector
            els = self._powers(self.group_gen)
            return [Fr.one() if e == t else Fr.zero() for e in els]
        z_over_n = z * self.size_inv % q
        els = self._powers(self.group_gen)
        denoms = [(t - e) % q for e in els]
        invs = _batch_inverse(denoms, q)
        return [Fr(z_over_n * e % q * inv % q) for e, inv in zip(els, invs)]

    def compute_vanishing_poly_over_coset(self, coset_size: int) -> list[Fr]:
        """Evals of Z_H(X)=X^n - 1 over the coset g*H' of size coset_size."""
        q = params.FR_MODULUS
        big = Domain(coset_size)
        g_pow_n = pow(self.generator, self.size, q)
        w_pow_n = pow(big.group_gen, self.size, q)
        out, cur = [], g_pow_n
        for _ in range(coset_size):
            out.append(Fr((cur - 1) % q))
            cur = cur * w_pow_n % q
        return out


def butterfly_transform(domain: Domain, x: torch.Tensor,
                        inverse: bool = False) -> torch.Tensor:
    """The staged butterfly transform of x [*lead, 8, n] over `domain`:
    the same function as `Domain._run` by the other route (log2 n launches
    of the butterfly kernel), without the inverse's 1/n scaling."""
    if domain.size == 1:
        return x
    brev, (even, odd, out, twi), fwd, inv = domain._butterfly_tables(x.device)
    return _ntt_impl(x, brev, even, odd, out, twi, inv if inverse else fwd)


def _batch_inverse(vals: list[int], q: int) -> list[int]:
    """Montgomery's trick; zeros map to zero (plonk/src/util.rs batch_inversion)."""
    prefix, acc = [], 1
    for v in vals:
        prefix.append(acc)
        if v:
            acc = acc * v % q
    inv = pow(acc, -1, q)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        if vals[i]:
            out[i] = prefix[i] * inv % q
            inv = inv * vals[i] % q
    return out
