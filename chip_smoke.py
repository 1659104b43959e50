#!/usr/bin/env python3
"""Drive the port's KZG commitment path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own error):

  1. device: the card's name and power limit (nvidia-smi) and versions;
     refuses to run without CUDA;
  2. build: compiles the three CUDA kernels from zkvm_tpu_torch/csrc/;
  3. kernel parity: each kernel against its plain PyTorch version, bit for
     bit -- on edge-case batches against the plain version on a CPU copy,
     and at the slice's shapes against the plain version on the card, with
     both timed there;
  4. slice: PublicParameters.setup(2^16) on the card (a sample of 64 powers
     checked against host group arithmetic), then commit_many_mont of four
     and of one polynomial of 2^16 coefficients, each commitment checked
     against the native host MSM over the full 2^16;
  5. every kernel's launch count during the slice must be above zero.

The last lines are the kernels' JSON record, the card's nvidia-smi line and
{"ok": true, "device": {...}}.  JAX is blocked for the whole run: the port
must not need it.
"""

import sys

sys.modules["jax"] = None  # any import of jax now fails

import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zkvm_tpu.curves.g1 import G1Affine, G1Projective  # noqa: E402
from zkvm_tpu.fields import Fp, Fr  # noqa: E402
from zkvm_tpu.native import native_msm  # noqa: E402
from zkvm_tpu.rng import StdRng  # noqa: E402
from zkvm_tpu_torch.ops import g1_ops, kernels  # noqa: E402
from zkvm_tpu_torch.ops import limb_field as lf  # noqa: E402
from zkvm_tpu_torch.ops.limb_field import FQ, FR  # noqa: E402
from zkvm_tpu_torch.plonk.kzg10 import PublicParameters  # noqa: E402

SEED = 2026
LOG_N = 16
N = 1 << LOG_N

# name -> (CUDA source, the Pallas kernel it replaces: mont_mul_pallas,
# padd_pallas_2l, window_fold_pallas)
KERNELS = {
    "mont_mul": ("zkvm_tpu_torch/csrc/mont_mul.cu",
                 "zkvm_tpu/ops/pallas_field.py:232"),
    "padd": ("zkvm_tpu_torch/csrc/padd.cu",
             "zkvm_tpu/ops/pallas_field.py:497"),
    "window_fold": ("zkvm_tpu_torch/csrc/window_fold.cu",
                    "zkvm_tpu/ops/pallas_field.py:726"),
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def rand_field(spec, shape, rng) -> np.ndarray:
    """Uniform-ish uint32 limbs [..., L, B] of values below p (the top limb
    stays below p's top limb)."""
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    a = a.astype(np.uint32)
    top = int(spec.p_limbs[-1])
    a[..., -1, :] = rng.integers(0, top, size=a[..., -1, :].shape)
    return a


def set_lanes(arr: np.ndarray, spec, lane_values) -> None:
    """Overwrite the first lanes of [L, B] with given field values."""
    for j, v in enumerate(lane_values):
        arr[:, j] = lf.int_to_limbs(v, spec.n_limbs)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """Largest limb difference (0 when bit-identical)."""
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    err = 0
    for x, y in pairs:
        d = (x.cpu().to(torch.int64) & lf.M32) - (y.cpu().to(torch.int64)
                                                   & lf.M32)
        err = max(err, int(d.abs().max()))
    return err


def host_points(n: int, rng) -> list[G1Affine]:
    """n points A + i*S for random multiples A, S of the generator."""
    g = G1Projective.generator()
    a = g * int(rng.integers(1, 1 << 62))
    s = g * int(rng.integers(1, 1 << 62))
    out = []
    for _ in range(n):
        out.append(a)
        a = a + s
    return G1Projective.batch_normalize(out)


def phase_parity(rng, dev) -> dict:
    """Kernel vs plain version, bit for bit; times at the slice's shapes."""
    rec = {}

    # -- mont_mul: edge lanes on a ragged batch, both fields (CPU plain)
    err = 0
    for spec in (FR, FQ):
        a = rand_field(spec, (spec.n_limbs, 4099), rng)
        b = rand_field(spec, (spec.n_limbs, 4099), rng)
        p = spec.modulus
        set_lanes(a, spec, [0, 1, p - 1, p - 1, spec.R, 1, 0])
        set_lanes(b, spec, [5, 1, p - 1, 1, spec.R, p - 1, 0])
        ta, tb = lf.u32_to_tensor(a, "cpu"), lf.u32_to_tensor(b, "cpu")
        got = kernels.mont_mul(spec, ta.to(dev), tb.to(dev))
        err = max(err, max_abs_err(got, kernels.mont_mul_plain(spec, ta, tb)))
    # slice shape: Fq [12, 2^16 + 7], the SRS normalisation (Fermat chain)
    a = lf.u32_to_tensor(rand_field(FQ, (12, N + 7), rng), dev)
    b = lf.u32_to_tensor(rand_field(FQ, (12, N + 7), rng), dev)
    err = max(err, max_abs_err(kernels.mont_mul(FQ, a, b),
                               kernels.mont_mul_plain(FQ, a, b)))
    ms = cuda_ms(lambda: kernels.mont_mul(FQ, a, b), 50)
    plain_ms = cuda_ms(lambda: kernels.mont_mul_plain(FQ, a, b), 3)
    rec["mont_mul"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           shape="Fq [12, 65543]")

    # -- padd: identity, P+P, P+(-P), Q+identity on a ragged batch (CPU plain)
    n = 1000
    pts = host_points(2 * n, rng)
    lhs = pts[:n]
    rhs = pts[n:]
    lhs[0] = G1Affine.identity()                 # O + Q
    rhs[1] = G1Affine.identity()                 # P + O
    lhs[2] = rhs[2] = G1Affine.identity()        # O + O
    rhs[3] = lhs[3]                              # P + P
    rhs[4] = -lhs[4]                             # P + (-P)
    p_cpu = g1_ops.affine_to_device(lhs, "cpu")
    q_cpu = g1_ops.affine_to_device(rhs, "cpu")
    got = kernels.padd(tuple(t.to(dev) for t in p_cpu),
                       tuple(t.to(dev) for t in q_cpu))
    err = max_abs_err(got, kernels.padd_plain(p_cpu, q_cpu))
    want = [(a.to_projective() + b.to_projective()) for a, b in zip(lhs, rhs)]
    for i in range(8):
        if g1_ops.device_to_projective(got, i) != want[i]:
            raise AssertionError(f"padd lane {i} disagrees with the host")
    # slice shape: first halving-tree level of one 2^16 commitment
    shape = (24, 12, N // 2)
    p = tuple(lf.u32_to_tensor(rand_field(FQ, shape, rng), dev)
              for _ in range(3))
    q = tuple(lf.u32_to_tensor(rand_field(FQ, shape, rng), dev)
              for _ in range(3))
    err = max(err, max_abs_err(kernels.padd(p, q), kernels.padd_plain(p, q)))
    ms = cuda_ms(lambda: kernels.padd(p, q), 10)
    plain_ms = cuda_ms(lambda: kernels.padd_plain(p, q), 1)
    rec["padd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       shape="[24, 12, 32768]")
    del p, q

    # -- window_fold: 4 sets x 24 windows, c = 11 (the 4-set commit), with
    # identity rows; CPU plain and card plain
    c, w_count, n_sets = 11, 24, 4
    rows = host_points(w_count * n_sets, rng)
    rows[0] = rows[5] = G1Affine.identity()
    sums = tuple(t.T.reshape(w_count * n_sets, 12, 1).contiguous()
                 for t in g1_ops.affine_to_device(rows, "cpu"))
    got = kernels.window_fold(c, w_count, n_sets, *(t.to(dev) for t in sums))
    err = max_abs_err(got, kernels.window_fold_plain(c, w_count, n_sets,
                                                     *sums))
    sd = tuple(t.to(dev) for t in sums)
    ms = cuda_ms(lambda: kernels.window_fold(c, w_count, n_sets, *sd), 10)
    plain_ms = cuda_ms(lambda: kernels.window_fold_plain(c, w_count, n_sets,
                                                         *sd), 1)
    rec["window_fold"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              shape="S=4, W=24, c=11")

    for name, r in rec.items():
        log(f"parity {name}: max_abs_err={r['max_abs_err']} (tolerance 0: "
            f"bit for bit), kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms at {r['shape']}")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version (max_abs_err={r['max_abs_err']})")
    return rec


def native_commit(points, coeffs) -> G1Projective:
    res = native_msm(points, coeffs)
    if res is None:
        raise RuntimeError("native MSM library unavailable (no C compiler?)")
    x, y, inf = res
    return G1Projective.identity() if inf else G1Projective(Fp(x), Fp(y),
                                                             Fp.one())


def phase_slice(rng, dev) -> dict:
    out = {}

    # inputs: four polynomials of 2^16 coefficients, Montgomery on the card
    raw = rng.integers(0, 1 << 63, size=(4, 4, N), dtype=np.uint64)
    polys = []
    for k in range(4):
        vals = [int(a) | int(b) << 63 | int(c) << 126 | int(d) << 189
                for a, b, c, d in zip(*raw[k].tolist())]
        polys.append([Fr(v) for v in vals])  # reduced mod r
    mont = [FR.to_mont_array([f.value for f in poly], dev) for poly in polys]
    torch.cuda.synchronize()

    kernels.reset_launches()
    # ---- main path: setup -> commit 4 -> commit 1 ----
    t0 = time.perf_counter()
    pp = PublicParameters.setup(N, StdRng(SEED), dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    ck = pp.commit_key
    log(f"setup 2^{LOG_N}: {ck.max_degree() + 1} powers in "
        f"{out['setup_s']:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got4 = ck.commit_many_mont(mont)
    torch.cuda.synchronize()
    out["commit4_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got4 = ck.commit_many_mont(mont)
    torch.cuda.synchronize()
    out["commit4_s"] = time.perf_counter() - t0
    out["commit4_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    ck.commit_many_mont(mont[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got1 = ck.commit_many_mont(mont[:1])
    torch.cuda.synchronize()
    out["commit1_s"] = time.perf_counter() - t0
    out["commit1_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(kernels.LAUNCHES)
    # ---- end of main path ----

    log(f"commit 4 x 2^{LOG_N}: first {out['commit4_first_s']:.3f} s, warm "
        f"{out['commit4_s']:.3f} s = {4 * N / out['commit4_s']:.1f} points/s,"
        f" peak {out['commit4_peak_gib']:.2f} GiB")
    log(f"commit 1 x 2^{LOG_N}: warm {out['commit1_s']:.3f} s = "
        f"{N / out['commit1_s']:.1f} points/s, peak "
        f"{out['commit1_peak_gib']:.2f} GiB")
    log(f"launches on the main path: {launches}")

    # ---- checks ----
    check = StdRng(SEED)
    x = Fr.random(check)
    g = G1Affine.generator() * Fr.random(check)
    sample = {0, 1, 2, ck.max_degree()} | set(
        rng.choice(np.arange(3, ck.max_degree()), 60, replace=False).tolist())
    for i in sorted(sample):
        if ck.powers_of_g[i] != (g * x.pow(i)).to_affine():
            raise AssertionError(f"SRS power {i} disagrees with the host")
    log(f"setup: {len(sample)} sampled powers equal host scalar "
        f"multiplication")

    points = ck.powers_of_g[:N]
    for k, (poly, c) in enumerate(zip(polys, got4)):
        if c.point != native_commit(points, poly).to_affine():
            raise AssertionError(f"commitment {k} of 4 disagrees with the "
                                 f"native MSM")
    if got1[0] != got4[0]:
        raise AssertionError("single-set commitment disagrees")
    log("commit: 4 + 1 commitments equal the native host MSM over 2^16")

    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    out["launches"] = launches
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs only on an NVIDIA GPU")
    log(card_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rec = phase_parity(rng, dev)
    sl = phase_slice(rng, dev)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": sl["launches"][name],
         "max_abs_err": rec[name]["max_abs_err"], "ms": rec[name]["ms"],
         "plain_ms": rec[name]["plain_ms"]} for name in KERNELS]}
    log(json.dumps(record))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
