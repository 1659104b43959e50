"""Peaks of one H100 and the operation and byte counts of the port's
kernels, for their roofline shares (copied from `chip_smoke.py`).

A kernel's bound is the least time the card could take: bytes moved
(every input read once, every output written once) over the memory rate,
or 32-bit multiply-adds over their peak rate, whichever is larger.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet: 3.35 TB/s of device memory; 67 TFLOP/s of
# float32 outside the tensor cores = 33.5 T fused multiply-adds a second,
# and an SM's 64 int32 lanes beside its 128 float32 lanes halve that for
# 32-bit integer multiply-adds
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 33.5e12 / 2

# Fq products of one complete G1 addition (RCB15 algorithm 7: 12 products
# of variables; the two by the constant 3b are additions)
PADD_PRODUCTS = 12
FQ_LIMBS, FR_LIMBS = 12, 8


def mont_mul_ops(n_limbs: int) -> int:
    """32-bit multiply-adds of one CIOS Montgomery product: 2 N^2 + N limb
    products of 32 x 32 -> 64 bits, a low and a high half each."""
    return 2 * (2 * n_limbs * n_limbs + n_limbs)


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / IMAD_PER_S)


def ntt_products(rows: int, log_n: int) -> int:
    """Fr products one staged transform needs: n/2 butterflies a stage,
    less the n - 1 a row whose twiddle is tw[0] = 1."""
    n = 1 << log_n
    return rows * ((n // 2) * log_n - (n - 1))


def padd_bound_s(lanes: int) -> float:
    """One `padd` launch over `lanes` additions: six coordinates in, three
    out, 12 limbs of 4 bytes each; 12 Fq products a lane."""
    return bound_s(9 * FQ_LIMBS * 4 * lanes,
                   PADD_PRODUCTS * mont_mul_ops(FQ_LIMBS) * lanes)


def ntt_bound_s(rows: int, log_n: int) -> float:
    """One `ntt_stages` transform of `rows` rows of 2^log_n: the operand in
    and the result out, the [8, n/2] twiddle table read once."""
    n = 1 << log_n
    return bound_s((2 * rows * FR_LIMBS * n + FR_LIMBS * n // 2) * 4,
                   ntt_products(rows, log_n) * mont_mul_ops(FR_LIMBS))
