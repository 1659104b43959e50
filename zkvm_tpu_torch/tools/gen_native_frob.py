"""Generate the Montgomery-form Frobenius constants of
`zkvm_tpu_torch/native/bls.c`.

The port's copy of `tools/gen_native_frob.py`, with the same output:
FROB6_C1 = (u+1)^((p-1)/3), FROB6_C2 = (u+1)^(2(p-1)/3), FROB12_C1 =
(u+1)^((p-1)/6), each an Fp2 element printed as C limb initializers (6 x
u64 little-endian, Montgomery form value * R mod p), lines that stand
verbatim in `bls.c`.

    python3 -m zkvm_tpu_torch.tools.gen_native_frob
"""

from __future__ import annotations

from ..params import FP_MODULUS as P

R = 1 << 384


def fp2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def fp2_pow(base, e):
    r = (1, 0)
    b = base
    while e:
        if e & 1:
            r = fp2_mul(r, b)
        b = fp2_mul(b, b)
        e >>= 1
    return r


def limbs(x: int) -> str:
    x = x * R % P  # to Montgomery
    return ", ".join(
        f"0x{(x >> (64 * i)) & ((1 << 64) - 1):016x}ULL" for i in range(6))


def emit(name: str, v) -> list[str]:
    return [f"static const fp2 {name} = {{",
            f"    {{{{{limbs(v[0])}}}}},",
            f"    {{{{{limbs(v[1])}}}}}}};"]


def lines() -> list[str]:
    """The three constants' C lines, in `bls.c`'s order."""
    return (emit("FROB6_C1", fp2_pow((1, 1), (P - 1) // 3))
            + emit("FROB6_C2", fp2_pow((1, 1), 2 * (P - 1) // 3))
            + emit("FROB12_C1", fp2_pow((1, 1), (P - 1) // 6)))


if __name__ == "__main__":
    print("\n".join(lines()))
