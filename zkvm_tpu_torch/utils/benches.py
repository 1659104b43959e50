"""Per-operation benchmark suite of the port.

The rows of `zkvm_tpu/utils/benches.py`: the reference's criterion
harnesses -- groups.rs (pairing phases + G1/G2 op set), hash_to_curve.rs,
and the jubjub fq/fr/point benches -- on the port's host layer, and the
device rows (Poseidon, NTT, MSM, the end-to-end prove/verify) on the
port's kernels.  Each benchmark prints ONE JSON line: {"metric", "value",
"unit"}.  A device row takes its `device` and synchronises it before it
reads the clock; nothing probes for a card, and an error ends the run.

    python -m zkvm_tpu_torch.utils.benches [--only poseidon,ntt] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random
import time

import torch


def _emit(metric: str, value: float, unit: str, **extra) -> dict:
    row = {"metric": metric, "value": round(value, 4), "unit": unit}
    row.update(extra)
    print(json.dumps(row), flush=True)
    return row


def sync(device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def msm_inputs(n: int, device, seed: int = 42):
    """n points s_i * G for `random.Random(seed)` scalars, made on `device`
    by the fixed-base kernel path (`g1_ops.batch_scalar_mul_base`), then n
    MSM scalars from the same stream: the root `bench.py`'s inputs at the
    default seed.  Returns (points, scalars)."""
    from ..curves.g1 import G1Affine
    from ..fields import Fr
    from ..ops.g1_ops import batch_scalar_mul_base

    rng = random.Random(seed)
    points = batch_scalar_mul_base(
        G1Affine.generator(),
        [Fr(rng.randrange(Fr.MODULUS)) for _ in range(n)], device)
    scalars = [Fr(rng.randrange(Fr.MODULUS)) for _ in range(n)]
    return points, scalars


def _time_op(fn, reps: int, warmup: int = 2, device=None) -> float:
    """Mean per-op seconds over `reps` calls (after `device` synchronises,
    when one is given)."""
    for _ in range(warmup):
        fn()
    if device is not None:
        sync(device)
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    if device is not None:
        sync(device)
    return (time.monotonic() - t0) / reps


def bench_host_fields() -> list[dict]:
    """fq_bench.rs / fr_bench.rs / scalar field ops (host path)."""
    from ..fields import Fp, Fr, JubjubFr

    rng = random.Random(11)
    rows = []
    for name, cls in (("fr", Fr), ("fp", Fp), ("jubjub_fr", JubjubFr)):
        a = cls(rng.randrange(cls.MODULUS))
        b = cls(rng.randrange(cls.MODULUS))
        for op, fn, reps in (("add", lambda: a + b, 20000),
                             ("sub", lambda: a - b, 20000),
                             ("mul", lambda: a * b, 20000),
                             ("square", lambda: a.square(), 20000),
                             ("invert", lambda: a.invert(), 2000),
                             ("sqrt", lambda: (a * a).sqrt(), 200)):
            rows.append(_emit(f"host/{name}/{op}",
                              _time_op(fn, reps) * 1e9, "ns/op"))
    return rows


def bench_host_groups() -> list[dict]:
    """groups.rs:31-173 G1/G2 op set (host path)."""
    from ..curves.g1 import G1Affine, G1Projective
    from ..curves.g2 import G2Affine, G2Projective
    from ..fields import Fr

    rng = random.Random(12)
    s = Fr(rng.randrange(Fr.MODULUS))
    rows = []
    for name, aff, proj in (("g1", G1Affine, G1Projective),
                            ("g2", G2Affine, G2Projective)):
        a = (proj.generator() * Fr(rng.randrange(Fr.MODULUS)))
        b = (proj.generator() * Fr(rng.randrange(Fr.MODULUS)))
        a_aff = a.to_affine()
        enc = a_aff.to_bytes()
        for op, fn, reps in (
                ("add", lambda: a + b, 2000),
                ("double", lambda: a.double(), 2000),
                ("add_mixed",
                 (lambda: a.add_mixed(a_aff)) if hasattr(a, "add_mixed")
                 else (lambda: a + a_aff.to_projective()), 2000),
                ("scalar_mul", lambda: a * s, 20),
                ("is_on_curve", lambda: a_aff.is_on_curve(), 2000),
                ("is_torsion_free", lambda: a_aff.is_torsion_free(), 20),
                ("deserialize", lambda: aff.from_bytes(enc), 20),
                ("batch_normalize",
                 lambda: proj.batch_normalize([a] * 64), 10)):
            rows.append(_emit(f"host/{name}/{op}",
                              _time_op(fn, reps) * 1e6, "us/op"))
    return rows


def bench_host_jubjub_points() -> list[dict]:
    """point_bench.rs (jubjub Edwards ops)."""
    from ..curves.jubjub import JubjubExtended
    from ..fields import JubjubFr

    rng = random.Random(13)
    a = JubjubExtended.generator() * JubjubFr(rng.getrandbits(250))
    b = JubjubExtended.generator() * JubjubFr(rng.getrandbits(250))
    s = JubjubFr(rng.getrandbits(250))
    return [_emit(f"host/jubjub_point/{op}", _time_op(fn, reps) * 1e6,
                  "us/op")
            for op, fn, reps in (("add", lambda: a + b, 5000),
                                 ("double", lambda: a.double(), 5000),
                                 ("scalar_mul", lambda: a * s, 50))]


def bench_pairing_phases() -> list[dict]:
    """groups.rs:10-29: full pairing, G2 prep, miller loop, final exp."""
    from ..curves.g1 import G1Projective
    from ..curves.g2 import G2Projective
    from ..curves.pairing import (G2Prepared, final_exponentiation,
                                  multi_miller_loop, pairing)
    from ..fields import Fr

    rng = random.Random(14)
    p = (G1Projective.generator() * Fr(rng.getrandbits(100))).to_affine()
    q = (G2Projective.generator() * Fr(rng.getrandbits(100))).to_affine()
    prep = G2Prepared(q)
    f = multi_miller_loop([(p, prep)])
    return [_emit(f"host/pairing/{op}", _time_op(fn, reps) * 1e3, "ms/op")
            for op, fn, reps in (
                ("full_pairing", lambda: pairing(p, q), 5),
                ("g2_preparation", lambda: G2Prepared(q), 10),
                ("miller_loop", lambda: multi_miller_loop([(p, prep)]), 10),
                ("final_exponentiation",
                 lambda: final_exponentiation(f), 10))]


def bench_hash_to_curve() -> list[dict]:
    """hash_to_curve.rs: XMD expansion + SSWU map, G1 and G2."""
    from ..curves.hash_to_curve import hash_to_curve_g1 as h2c_g1
    from ..curves.hash_to_curve import hash_to_curve_g2

    msg = b"benchmark message"
    dst = b"BLS12381G1_XMD:SHA-256_SSWU_RO_BENCH"
    return [_emit("host/hash_to_curve/g1", _time_op(
                lambda: h2c_g1(msg, dst), 20) * 1e3, "ms/op"),
            _emit("host/hash_to_curve/g2", _time_op(
                lambda: hash_to_curve_g2(msg, dst), 5) * 1e3, "ms/op")]


def bench_poseidon_device(device, batch: int = 1 << 14) -> list[dict]:
    """The Hades permutation on `batch` width-5 states (the `hades_permute`
    kernel on a CUDA device)."""
    from ..ops import poseidon
    from ..ops.limb_field import FR

    flat = FR.to_mont_array(list(range(1, batch * 5 + 1)), device)
    state = flat.reshape(FR.n_limbs, batch, 5).permute(2, 0, 1).contiguous()
    per = _time_op(lambda: poseidon.hades_permute_batch(state), 5,
                   device=device)
    return [_emit("device/poseidon/permutation", batch / per, "hashes/s",
                  batch=batch)]


def bench_ntt_device(device,
                     sizes=(1 << 12, 1 << 14, 1 << 16)) -> list[dict]:
    """`Domain.fft_device` of one polynomial at each size."""
    from .. import params
    from ..ops.limb_field import FR
    from ..ops.ntt import Domain

    rng = random.Random(15)
    rows = []
    for n in sizes:
        dom = Domain(n)
        x = FR.to_mont_array(
            [rng.randrange(params.FR_MODULUS) for _ in range(n)], device)
        per = _time_op(lambda: dom.fft_device(x), 5, device=device)
        rows.append(_emit(f"device/ntt/2^{n.bit_length() - 1}",
                          n / per / 1e6, "M elems/s",
                          ms_per_call=round(per * 1e3, 2)))
    return rows


def bench_msm_device(device,
                     sizes=(1 << 12, 1 << 14, 1 << 16)) -> list[dict]:
    """`MSMContext.msm` of a prefix of one point set at each size (its
    result is decoded on the host, which synchronises).  The points are
    seeded multiples of the generator made on `device` (the reference's
    row makes them by a host chain of additions: set-up, not timed)."""
    from ..ops.msm import MSMContext

    points, scalars = msm_inputs(max(sizes), device, seed=16)
    ctx = MSMContext(points, device)
    rows = []
    for n in sizes:
        sc = scalars[:n]
        ctx.msm(sc)  # size-class caches and first launches
        per = _time_op(lambda: ctx.msm(sc), 3, warmup=0, device=device)
        rows.append(_emit(f"device/msm/2^{n.bit_length() - 1}", n / per,
                          "points/s", ms_per_call=round(per * 1e3, 1)))
    return rows


def bench_prove_verify(device, capacity_log2: int = 12) -> list[dict]:
    """SRS setup, compile, first and warm prove, verify of one membership
    in a height-3 tree."""
    from ..fields import Fr
    from ..merkle.poseidon_tree import Item, PoseidonTree
    from ..plonk import Compiler, PublicParameters
    from ..rng import StdRng
    from ..service.batch import OpeningCircuit

    tree = PoseidonTree(3)
    for i in range(9):
        tree.insert(i, Item(Fr(1000 + i)))
    leaf = Item(Fr(1004))
    opening = tree.opening(4)

    rows = []
    t0 = time.monotonic()
    pp = PublicParameters.setup(1 << capacity_log2, StdRng(42), device)
    sync(device)
    rows.append(_emit("e2e/srs_setup", time.monotonic() - t0, "s",
                      capacity=f"2^{capacity_log2}"))
    t0 = time.monotonic()
    prover, verifier = Compiler.compile_with_circuit(
        pp, b"bench", OpeningCircuit(opening, leaf))
    sync(device)
    rows.append(_emit("e2e/compile", time.monotonic() - t0, "s",
                      gates=prover.constraints, domain=prover.size))
    circ = OpeningCircuit(opening, leaf)
    t0 = time.monotonic()
    proof, pis = prover.prove(StdRng(7), circ)
    sync(device)
    rows.append(_emit("e2e/prove_first", time.monotonic() - t0, "s"))
    per = _time_op(lambda: prover.prove(StdRng(7), circ), 3, warmup=0,
                   device=device)
    rows.append(_emit("e2e/prove_warm", per, "s"))
    per = _time_op(lambda: verifier.verify(proof, pis), 3, warmup=1)
    rows.append(_emit("e2e/verify", per * 1e3, "ms"))
    return rows


def run_flagship(device, count: int = 21, capacity_log2: int = 17,
                 reps: int = 3, region=contextlib.nullcontext) -> dict:
    """The flagship's timed steps: SRS setup 2^capacity_log2 (StdRng(42)),
    compile of `MultiOpeningCircuit.default_for(3, count)` (2^16 gates at
    21 openings), a first prove and `reps` warm proves (StdRng(7), their
    proofs byte-identical), verify.  A setup of 2^8 runs first, untimed,
    so that the process's first device work (context, libraries, the
    kernels' library) lands outside the setup timer.  `region()` is a
    context entered around the first warm prove alone.

    Returns the prover, verifier, circuit, the last proof and its public
    inputs, and setup_s, compile_s, prove_first_s, warm_s (each warm
    prove), spans (`metrics` of the warm proves), peak_gib (of the proves)
    and verify_ms."""
    from ..plonk import Compiler, PublicParameters
    from ..rng import StdRng
    from ..service.batch import MultiOpeningCircuit
    from . import metrics

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    out = {"circuit": MultiOpeningCircuit.default_for(3, count)}
    PublicParameters.setup(1 << 8, StdRng(0), dev)
    sync(dev)
    t0 = time.perf_counter()
    pp = PublicParameters.setup(1 << capacity_log2, StdRng(42), dev)
    sync(dev)
    out["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prover, verifier = Compiler.compile_with_circuit(pp, b"flagship",
                                                     out["circuit"])
    sync(dev)
    out["compile_s"] = time.perf_counter() - t0
    out["prover"], out["verifier"] = prover, verifier

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prover.prove(StdRng(7), out["circuit"])
    sync(dev)
    out["prove_first_s"] = time.perf_counter() - t0
    metrics.GLOBAL.reset()
    out["warm_s"], blobs = [], set()
    for i in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        with region() if i == 0 else contextlib.nullcontext():
            proof, pis = prover.prove(StdRng(7), out["circuit"])
            sync(dev)
        out["warm_s"].append(time.perf_counter() - t0)
        blobs.add(proof.to_bytes())
    out["spans"] = metrics.report()
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                       if cuda else None)
    if len(blobs) != 1:
        raise AssertionError("the warm flagship proofs differ")
    out["proof"], out["pis"] = proof, pis
    t0 = time.perf_counter()
    verifier.verify(proof, pis)
    out["verify_ms"] = (time.perf_counter() - t0) * 1e3
    return out


HOST_ROWS = {
    "host-fields": bench_host_fields,
    "host-groups": bench_host_groups,
    "host-jubjub": bench_host_jubjub_points,
    "pairing": bench_pairing_phases,
    "hash-to-curve": bench_hash_to_curve,
}
DEVICE_ROWS = {
    "poseidon": bench_poseidon_device,
    "ntt": bench_ntt_device,
    "msm": bench_msm_device,
    "prove": bench_prove_verify,
}
ALL = list(HOST_ROWS) + list(DEVICE_ROWS)


def run_all(only=None, device="cuda") -> list[dict]:
    """Every row (or those named in `only`), in the reference's order; the
    device rows on `device`.  Returns the rows it printed; an exception
    ends the run."""
    unknown = set(only or ()) - set(ALL)
    if unknown:
        raise ValueError(f"unknown benchmark rows: {sorted(unknown)}")
    rows = []
    for name in ALL:
        if only and name not in only:
            continue
        if name in DEVICE_ROWS:
            rows += DEVICE_ROWS[name](device)
        else:
            rows += HOST_ROWS[name]()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m zkvm_tpu_torch.utils.benches",
        description="per-operation benchmarks of the port, one JSON line "
                    "a row")
    parser.add_argument("--only", default="",
                        help="comma-separated rows: " + ",".join(ALL))
    parser.add_argument("--device", default="cuda",
                        help="torch device of the device rows")
    args = parser.parse_args(argv)
    only = [s for s in args.only.split(",") if s]
    run_all(only=only or None, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
