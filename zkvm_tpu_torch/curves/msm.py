"""Multi-scalar multiplication (host reference implementations).

`pippenger` mirrors coset-bls12_381/src/coset/multiscalar_mul.rs:9-141
(signed radix-2^w digits, half-size buckets); `msm_variable_base` mirrors
:143-220 (ark-style unsigned windowed bucketing -- the variant PLONK's
CommitKey.commit uses).  The TPU-sharded MSM lives in zkvm_tpu/ops/msm.py and
is tested against these.
"""

from __future__ import annotations

from ..fields import Fr
from .g1 import G1Affine, G1Projective


def _ln_without_floats(a: int) -> int:
    # log2(a) * 69 / 100 ~= ln(a) (multiscalar_mul.rs helper)
    return (a.bit_length() - 1) * 69 // 100 if a > 1 else 0


def msm_variable_base(points: list[G1Affine], scalars: list[Fr]) -> G1Projective:
    """Windowed-bucket MSM (multiscalar_mul.rs:143-220)."""
    assert len(points) == len(scalars)
    n = len(scalars)
    if n == 0:
        return G1Projective.identity()
    c = 3 if n < 32 else _ln_without_floats(n) + 2
    num_bits = 256
    windows = list(range(0, num_bits, c))
    window_sums = []
    for w_start in windows:
        buckets = [G1Projective.identity() for _ in range((1 << c) - 1)]
        res = G1Projective.identity()
        for scalar, point in zip(scalars, points):
            digit = (scalar.value >> w_start) & ((1 << c) - 1)
            if digit == 0:
                continue
            if w_start == 0 and digit == 1:
                res = res.add_mixed(point)
            else:
                buckets[digit - 1] = buckets[digit - 1].add_mixed(point)
        running = G1Projective.identity()
        for b in reversed(buckets):
            running = running + b
            res = res + running
        window_sums.append(res)
    total = window_sums[-1]
    for ws in reversed(window_sums[:-1]):
        for _ in range(c):
            total = total.double()
        total = total + ws
    return total


def msm_host(points: list[G1Affine], scalars: list[Fr]) -> G1Projective:
    """Latency-optimized host MSM: native C (Straus wNAF / Pippenger,
    zkvm_tpu/native/bls.c) when the library is available, exact-equal
    Python `msm_variable_base` otherwise.  This is the verifier's MSM
    (proof.rs:335-375 runs the same fold in native Rust)."""
    from ..native import native_msm

    if len(points) == 0:
        return G1Projective.identity()
    res = native_msm(points, scalars)
    if res is None:
        return msm_variable_base(points, scalars)
    x, y, inf = res
    if inf:
        return G1Projective.identity()
    from ..fields import Fp

    return G1Affine(Fp(x), Fp(y)).to_projective()


def pippenger(points_scalars) -> G1Projective:
    """Signed-digit Pippenger (multiscalar_mul.rs:9-141).

    Takes an iterable of (G1Projective|G1Affine, Fr) pairs.
    """
    pairs = list(points_scalars)
    size = len(pairs)
    if size == 0:
        return G1Projective.identity()
    w = 6 if size < 500 else (7 if size < 800 else 8)
    max_digit = 1 << w
    digits_count = (256 + w - 1) // w
    radix_mask = max_digit - 1

    # signed radix-2^w digit decomposition per scalar
    all_digits = []
    points = []
    for p, s in pairs:
        points.append(p.to_projective() if isinstance(p, G1Affine) else p)
        v = s.value
        digits = []
        carry = 0
        for _ in range(digits_count):
            d = (v & radix_mask) + carry
            v >>= w
            if d > max_digit // 2:
                carry = 1
                digits.append(d - max_digit)  # negative digit
            else:
                carry = 0
                digits.append(d)
        assert carry == 0 or v == 0
        all_digits.append(digits)

    buckets_count = max_digit // 2
    cols = []
    for digit_index in range(digits_count - 1, -1, -1):
        buckets = [G1Projective.identity() for _ in range(buckets_count)]
        for pt, digits in zip(points, all_digits):
            d = digits[digit_index]
            if d > 0:
                buckets[d - 1] = buckets[d - 1] + pt
            elif d < 0:
                buckets[-d - 1] = buckets[-d - 1] - pt
        running = G1Projective.identity()
        col = G1Projective.identity()
        for b in reversed(buckets):
            running = running + b
            col = col + running
        cols.append(col)
    total = G1Projective.identity()
    for col in cols:
        for _ in range(w):
            total = total.double()
        total = total + col
    return total
