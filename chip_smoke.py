#!/usr/bin/env python3
"""Drive the port's PLONK prover (setup -> compile -> prove -> verify), on
one device and over a mesh, its batch Merkle-membership service, its KZG
commitment path, the polynomial path of a prover round and the
Poseidon/Merkle path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; no phase catches its own error):

  1. device: the card's name and power limit (nvidia-smi) and versions;
     refuses to run without CUDA;
  2. build: compiles the ten CUDA kernels from zkvm_tpu_torch/csrc/;
  3. kernel parity: each kernel against its plain PyTorch version, bit for
     bit -- on edge-case batches against the plain version on a CPU copy,
     and at the slice's shapes against the plain version on the card, with
     both timed there; mont_mul also on broadcast and strided operands read
     in place (a constant column, a table shared by every group, an [L, 1]
     lane broadcast, every second lane), with a profile that must show no
     copy kernel, and beside an empty launch of its grid; mont_pow at the
     SRS normalisation's shape (exponent p - 2) and at small exponents;
     hades_permute on both sides of the lane count at which hades.cu
     changes kernels; field_addsub (add, sub, neg; Fr at [8, 2^19], Fq at
     [12, 65543]) with and without its lane mask, on contiguous operands,
     an [L, 1] column, a lane broadcast, every second lane and limbs
     innermost, at the edge values 0, 1, p - 1 and R mod p, beside its byte
     bound and an empty launch of its grid, under a profile that must show
     that kernel alone; padd also on strided operands read in place (even /
     odd lanes, halves, limbs innermost) and under each of its launch
     bounds; window_fold at four sets and at one, with the time of one
     addition of its chain beside the latency of one dependent Fq product
     in one thread (a probe kernel), which gives the chain's floor; then
     the byte-plane matmul at its worst case (m = 256, every byte 255)
     against an int64 product;
  4. commitment path: PublicParameters.setup(2^16) on the card (a sample of
     64 powers checked against host group arithmetic), then
     commit_many_mont of four and of one polynomial of 2^16 coefficients,
     each commitment checked against the native host MSM over the full
     2^16; after the counted run, what the two commits are made of: every
     padd launch by its lanes (a histogram, with the kernel's time at each
     size), padd against padd_ilp inside a commit, and a torch.profiler
     breakdown into hand-written kernels, torch glue and idle share;
  5. polynomial path at n = 2^16 / 8n = 2^19: four evaluation vectors ->
     batched ifft -> blinders -> commit -> pad -> coset fft and back ->
     evaluations at z -> linear combination -> division by (X - z) ->
     commit of the witness -> AggregateProof.flatten -> OpeningKey.check
     (true, and false after one evaluation is altered); the staged
     butterfly transform and the unfused leaf reduction each redo a whole
     2^16 transform and must equal the matmul route bit for bit; sampled
     evaluations are checked against host big-int Horner;
  6. Merkle path: 4^10 seeded leaves -> PoseidonTree.from_leaves(10, ...,
     "cuda") -> root, openings (verify true, false for a wrong leaf, wire
     bytes round trip); 16 sampled nodes of every level and the root are
     recomputed on the host by Hash.digest(Domain.Merkle4) from the
     device's own children; then merkle_tree_levels alone at 4^12 leaves
     made on the card, with the same sampled host check;
  7. padd comparison: the 2^16 SRS points on the card summed by a halving
     tree, once with padd and once with padd_ilp; both must equal the
     native host sum;
  8. transform times, both routes, 1 and 4 polynomials;
     with --profile, also where the device time goes (torch.profiler);
  9. the dryrun prove: PublicParameters.setup(2^11, StdRng(42), "cuda"),
     Compiler.compile_with_circuit of the height-1 opening circuit with the
     label b"dryrun", prove under StdRng(7): the proof bytes must equal
     tests/fixtures/dryrun_proof_v1.bin (read as a file) and the public
     inputs its tail; the port's Verifier accepts the proof and refuses it
     with a public input changed;
 10. the flagship prove at full width through benches.run_flagship (what
     tools/bench_flagship.py times): MultiOpeningCircuit.default_for(3, 21)
     (2^16 gates), setup 2^17 under StdRng(42) after an untimed setup of
     2^8, compile with the label b"flagship", a first prove and three warm
     proves under StdRng(7) (the three proofs byte-identical), verify and
     the refusal of a changed public input; it prints setup, compile, first and warm prove times,
     the per-round spans averaged over the warm proves, verify ms, peak
     device memory, the device's busy share of one warm prove
     (torch.profiler), the gates and the domain size;
 11. the mesh: the flagship prover of phase 10 (setup and compile reused)
     over a mesh of four logical shards of the card (Mesh([cuda:0] * 4)),
     and over the real cards where torch.cuda.device_count() >= 2: a first
     and three warm mesh proves under StdRng(7), each byte-identical to the
     flagship's warm proof, verified, a changed public input refused, with
     single-device warm proves before and after in the same call; then
     DistributedDomain(2^19) coset fft / coset ifft on [8, 2^19] bit for
     bit against Domain(2^19), msm_sharded of 2^16 seeded points (the SRS
     powers, seeded scalars) against the native host MSM, the forest of
     4^10 leaves over four shards against merkle_tree_levels' root, and
     dryrun_multichip on meshes of 2, 4 and 8 shards, each equal to
     tests/fixtures/dryrun_proof_v1.bin.  It prints the mesh prove's first
     and warm times and spans, the single-device warm prove, the peak
     device memory of the warm mesh proves and each component's ms, each
     beside the card's name and power limit, and which meshes ran;
 12. the batch service at full width, through its CLI
     (zkvm_tpu_torch.service.cli): make-input of 32 leaves of a height-17
     tree, two bad leaves appended (a leaf that is not the opened one, an
     opening of another tree), then `batch --capacity 15 --height 17
     --device cuda` twice into fresh directories -- the first sets up
     2^15, compiles the 17,158-gate circuit and writes the cache, the
     second loads the cache; each proves exactly the 32 good leaves, and
     the second run's 64 proof and public-input files equal the first
     run's byte for byte; `verify` returns 0 on every proof and 1 on one
     with a changed public-input byte.  It prints setup, compile, the
     cache's bytes and its write and load times, the first leaf's prove,
     the mean warm prove, leaves/s, verify ms and peak device memory, each
     beside the card's name and power limit;
 13. the device rows of the benches (utils/benches.py: poseidon, ntt, msm,
     prove) once on the card, each value finite and positive, the poseidon
     row launching hades_permute;
 14. every kernel's launch count must be above zero in some region.  The
     counts are set to 0 just before each region and read just after it;
     the regions are the commitment path, one warm polynomial path, the two
     whole-transform cross-checks (the only callers of butterfly and fold),
     the Merkle path, the padd comparison, one warm flagship prove, the
     mesh (one warm mesh prove and one run of each mesh component) and the
     first service run (compile and 32 proves), reported apart.

The last lines are the kernels' JSON record, the card's nvidia-smi line and
{"ok": true, "device": {...}}.  JAX and the JAX package are blocked for the
whole run: the port must need neither.
"""

import sys

sys.modules["jax"] = None  # any import of jax now fails
sys.modules["zkvm_tpu"] = None  # and any import of the JAX package

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from zkvm_tpu_torch.curves.g1 import G1Affine, G1Projective  # noqa: E402
from zkvm_tpu_torch.fields import Fp, Fr  # noqa: E402
from zkvm_tpu_torch.hashes import Domain, Hash, hades_permute  # noqa: E402
from zkvm_tpu_torch.merkle import (Item, PoseidonTree,  # noqa: E402
                                   poseidon_opening_from_slice)
from zkvm_tpu_torch.native import native_msm  # noqa: E402
from zkvm_tpu_torch.ops import (g1_ops, kernels, msm, ntt,  # noqa: E402
                                ntt_mxu, poseidon)
from zkvm_tpu_torch.ops.collective import Mesh  # noqa: E402
from zkvm_tpu_torch.ops.ntt_sharded import DistributedDomain  # noqa: E402
from zkvm_tpu_torch.ops import limb_field as lf  # noqa: E402
from zkvm_tpu_torch.ops.limb_field import FQ, FR  # noqa: E402
from zkvm_tpu_torch.plonk import PlonkError, Proof, dpoly, kzg10  # noqa: E402
from zkvm_tpu_torch.plonk.kzg10 import (AggregateProof,  # noqa: E402
                                        PublicParameters, powers_of)
from zkvm_tpu_torch.rng import StdRng  # noqa: E402
from zkvm_tpu_torch.service import cli as service_cli  # noqa: E402
from zkvm_tpu_torch.service.formats import (LeafInfo,  # noqa: E402
                                            MultipleLeavesData)
from zkvm_tpu_torch.utils import benches, dryrun, metrics  # noqa: E402
from zkvm_tpu_torch.utils.dryrun import forest_root  # noqa: E402

SEED = 2026
LOG_N = 16
N = 1 << LOG_N
N8 = 8 * N
Q = FR.modulus
MERKLE_HEIGHT = 10        # PoseidonTree.from_leaves: 4^10 leaves
LEVELS_HEIGHT = 12        # merkle_tree_levels alone: 4^12 leaves
HADES_LANES = 1 << 14     # the permutation's own shape, [5, 8, 2^14]
# the flagship circuit (benches.run_flagship): 21 openings of a height-3
# tree in one circuit, 2^16 gates, on an SRS of 2^17
FLAGSHIP_COUNT, FLAGSHIP_SETUP_LOG = 21, 17
FLAGSHIP_WARM_PROVES = 3
# the mesh phase: the flagship over 4 logical shards of the card; then
# dryrun_multichip over 2, 4 and 8
MESH_SHARDS, MESH_WARM_PROVES = 4, 3
DRYRUN_MESH_SHARDS = (2, 4, 8)
# the batch service at its own tree height (DEFAULT_TREE_HEIGHT): the
# height-17 opening circuit has 17,158 gates, a domain of 2^15, and needs an
# SRS of 2^15 (the default capacity, 13, cannot hold it)
SERVICE_LEAVES, SERVICE_HEIGHT, SERVICE_CAPACITY = 32, 17, 15
BENCH_ROWS = ("poseidon", "ntt", "msm", "prove")
# 32-bit multiply-adds of one permutation.  The kernel's arithmetic: an S-box
# is three Fr products of 272, a row of the MDS step ONE Montgomery dot
# product of five pairs (5 x 64 limb products and 72 of the reduction, a low
# and a high half each: 784); 8 full rounds of 15 products and 5 rows, 60
# partial rounds of 3 products and 5 rows.  This bounds the kernel.  The
# earlier bound counted the arithmetic of the first port, 25 products and 20
# additions an MDS step, 2000 products a permutation; it is kept so that
# the times of earlier rounds can be read against it.
HADES_MULTIPLY_ADDS = 8 * (15 * 272 + 5 * 784) + 60 * (3 * 272 + 5 * 784)
HADES_MULTIPLY_ADDS_2000_PRODUCTS = (8 * (15 + 25) + 60 * (3 + 25)) * 272
# Fq products of one complete G1 addition: RCB15 algorithm 7 has 12 products
# of variables and 2 by the constant 3b = 12, which four additions replace
PADD_PRODUCTS = 12
# the largest byte column the matmul route can make: 32 byte pairs, each a
# sum of 256 products of 255 * 255
WORST_COLUMN = 32 * 256 * 255 * 255

# name -> (CUDA source, the Pallas kernel it replaces: mont_mul_pallas,
# a chain of mont_mul_pallas calls that jit fuses (limb_field.mont_pow),
# padd_pallas_2l, window_fold_pallas, butterfly_pallas, _carry_fold_pallas,
# _fold_pallas, hades_permute_pallas, padd_pallas_ilp / padd_pallas_ilp2l,
# and the field additions that jit fuses into every program: add / sub / neg
# of limb_field, which have no Pallas site of their own)
KERNELS = {
    "mont_mul": ("zkvm_tpu_torch/csrc/mont_mul.cu",
                 "zkvm_tpu/ops/pallas_field.py:232"),
    "mont_pow": ("zkvm_tpu_torch/csrc/mont_mul.cu",
                 "zkvm_tpu/ops/pallas_field.py:232"),
    "padd": ("zkvm_tpu_torch/csrc/padd.cu",
             "zkvm_tpu/ops/pallas_field.py:497"),
    "window_fold": ("zkvm_tpu_torch/csrc/window_fold.cu",
                    "zkvm_tpu/ops/pallas_field.py:726"),
    "butterfly": ("zkvm_tpu_torch/csrc/butterfly.cu",
                  "zkvm_tpu/ops/pallas_field.py:676"),
    "carry_fold": ("zkvm_tpu_torch/csrc/ntt_fold.cu",
                   "zkvm_tpu/ops/ntt_mxu.py:199"),
    "fold": ("zkvm_tpu_torch/csrc/ntt_fold.cu",
             "zkvm_tpu/ops/ntt_mxu.py:165"),
    "hades_permute": ("zkvm_tpu_torch/csrc/hades.cu",
                      "zkvm_tpu/ops/pallas_field.py:308"),
    "padd_ilp": ("zkvm_tpu_torch/csrc/padd_ilp.cu",
                 "zkvm_tpu/ops/pallas_field.py:626"),
    "field_addsub": ("zkvm_tpu_torch/csrc/field_addsub.cu",
                     "zkvm_tpu/ops/limb_field.py:205"),
}
# how the port's CUDA kernels are named in a profile
OUR_KERNELS = ("mont_mul_kernel", "mont_pow_kernel", "padd_kernel",
               "padd_ilp_kernel", "window_fold_kernel", "butterfly_kernel",
               "fold_kernel", "hades_kernel", "hades_coop_kernel",
               "field_addsub_kernel")
REGIONS = ("commit_path", "poly_path", "crosscheck", "merkle_path",
           "padd_comparison", "prove_path", "mesh", "service")

# The card's published peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of
# device memory, 67 TFLOP/s of float32 outside the tensor cores = 33.5 T
# fused multiply-adds a second.  An SM has 64 int32 lanes beside its 128
# float32 lanes, so 32-bit integer multiply-adds peak at half of that.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 33.5e12 / 2


def mont_mul_ops(n_limbs: int) -> int:
    """32-bit multiply-adds of one CIOS Montgomery product: 2 N^2 + N limb
    products of 32 x 32 -> 64 bits, a low and a high half each."""
    return 2 * (2 * n_limbs * n_limbs + n_limbs)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes moved (every input read
    once, every output written once) over the memory rate, or integer
    multiply-adds over their peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / IMAD_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
    """Mean device time of fn() over reps calls (CUDA events, one warm-up).
    The card first spins for about 10 ms while the host enqueues, so that
    launches shorter than the wrapper's enqueue time (~0.02 ms) are timed
    back to back and not by the rate at which Python issues them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # cycles
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
    # an empty kernel of the same grid: what of the launch is the launch
    threads = 128
    empty_ms = cuda_ms(lambda: kernels.empty_launch(
        -(-a.shape[-1] // threads), threads, dev), 50)
    rec["mont_mul"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           shape="Fq [12, 65543]", empty_launch_ms=empty_ms,
                           **bound(3 * a.numel() * 4,
                                   mont_mul_ops(12) * a.shape[-1]))
    del a, b
    phase_parity_broadcast(rng, dev, rec)
    phase_parity_pow(rng, dev, rec)
    phase_parity_addsub(rng, dev, rec)

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
    p_dev = tuple(t.to(dev) for t in p_cpu)
    q_dev = tuple(t.to(dev) for t in q_cpu)
    got = kernels.padd(p_dev, q_dev)
    got_ilp = kernels.padd_ilp(p_dev, q_dev)
    err = max_abs_err(got, kernels.padd_plain(p_cpu, q_cpu))
    err_ilp = max(max_abs_err(got_ilp, kernels.padd_ilp_plain(p_cpu, q_cpu)),
                  max_abs_err(got_ilp, got))
    want = [(a.to_projective() + b.to_projective()) for a, b in zip(lhs, rhs)]
    for i in range(8):
        if not (g1_ops.device_to_projective(got, i) == want[i]
                == g1_ops.device_to_projective(got_ilp, i)):
            raise AssertionError(f"padd lane {i} disagrees with the host")
    # slice shape: first halving-tree level of one 2^16 commitment
    shape = (24, 12, N // 2)
    p = tuple(lf.u32_to_tensor(rand_field(FQ, shape, rng), dev)
              for _ in range(3))
    q = tuple(lf.u32_to_tensor(rand_field(FQ, shape, rng), dev)
              for _ in range(3))
    want_plain = kernels.padd_plain(p, q)
    got = kernels.padd(p, q)
    got_ilp = kernels.padd_ilp(p, q)
    err = max(err, max_abs_err(got, want_plain))
    err_ilp = max(err_ilp, max_abs_err(got_ilp, want_plain),
                  max_abs_err(got_ilp, got))
    del want_plain, got, got_ilp
    # the function needs 12 Montgomery products a lane (the two by the
    # constant 3b are additions), whichever kernel computes it; in turns:
    # padd, padd_ilp, padd_ilp, padd
    b = bound(9 * p[0].numel() * 4,
              PADD_PRODUCTS * mont_mul_ops(12) * p[0].numel() // 12)
    ms = cuda_ms(lambda: kernels.padd(p, q), 10)
    ms_ilp = cuda_ms(lambda: kernels.padd_ilp(p, q), 10)
    ms_ilp = (ms_ilp + cuda_ms(lambda: kernels.padd_ilp(p, q), 10)) / 2
    ms = (ms + cuda_ms(lambda: kernels.padd(p, q), 10)) / 2
    plain_ms = cuda_ms(lambda: kernels.padd_plain(p, q), 1)
    plain_ilp_ms = cuda_ms(lambda: kernels.padd_ilp_plain(p, q), 1)
    rec["padd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       shape="[24, 12, 32768]", **b)
    rec["padd_ilp"] = dict(max_abs_err=err_ilp, ms=ms_ilp,
                           plain_ms=plain_ilp_ms, shape="[24, 12, 32768]",
                           **b)
    del p, q
    # strided operands read in place, as the halving tree, the scan and the
    # lane sum hand them over: even / odd lanes and the two halves of one
    # tensor, and lanes whose limbs are innermost (a transposed gather)
    wide = tuple(lf.u32_to_tensor(rand_field(FQ, (24, 12, N), rng), dev)
                 for _ in range(3))
    turned = tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in wide)
    views = {
        "even / odd lanes": (tuple(t[..., 0::2] for t in wide),
                             tuple(t[..., 1::2] for t in wide)),
        "two halves": (tuple(t[..., :N // 2] for t in wide),
                       tuple(t[..., N // 2:] for t in wide)),
        "even / odd lanes, limbs innermost": (
            tuple(t[..., 0::2] for t in turned),
            tuple(t[..., 1::2] for t in turned)),
    }
    strided_ms = {}
    for name, (vp, vq) in views.items():
        if vp[0].is_contiguous() or kernels.padd_layout(vp) is None:
            raise AssertionError(f"padd: {name} is not a strided view")
        err = max_abs_err(kernels.padd(vp, vq), kernels.padd_plain(vp, vq))
        rec["padd"]["max_abs_err"] = max(rec["padd"]["max_abs_err"], err)
        strided_ms[name] = cuda_ms(lambda: kernels.padd(vp, vq), 10)
    copy_ms = cuda_ms(lambda: [t.contiguous() for v in views[
        "even / odd lanes"] for t in v], 10)
    log("padd on strided operands at [24, 12, 32768], read in place: "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in strided_ms.items())
        + f"; contiguous {ms:.4f} ms; the six copies they replace "
        f"{copy_ms:.4f} ms")
    rec["padd"]["strided_ms"] = strided_ms["even / odd lanes"]
    del wide, turned, views

    # -- window_fold: 4 sets x 24 windows, c = 11 (the 4-set commit), with
    # identity rows, and its first set alone (the 1-set commit); CPU plain
    # and card plain
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
    s1 = tuple(t[:w_count].contiguous() for t in sd)
    got1 = kernels.window_fold(c, w_count, 1, *s1)
    err = max(err, max_abs_err(got1, kernels.window_fold_plain(c, w_count, 1,
                                                               *s1)),
              max_abs_err(got1, got[:, :, :1]))
    ms1 = cuda_ms(lambda: kernels.window_fold(c, w_count, 1, *s1), 10)
    # the chain: W (c + 1) dependent additions a set, each two products
    # deep, which no bound of bytes or operations sees; its floor is the
    # latency of one dependent Fq product in one thread
    probe = phase_product_latency(rng, dev)
    adds = w_count * (c + 1)
    rec["window_fold"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, shape="S=4, W=24, c=11",
        ms_one_set=ms1, us_per_addition=ms * 1e3 / adds,
        chain_floor_ms=adds * 2 * probe["lazy_us"] / 1e3, **probe,
        **bound((3 * sums[0].numel() + 3 * 12 * n_sets) * 4,
                n_sets * adds * PADD_PRODUCTS * mont_mul_ops(12)))
    log(f"window_fold chain: {adds} dependent additions a set; S = 4 "
        f"{ms:.4f} ms = {ms * 1e3 / adds:.4f} us an addition, S = 1 "
        f"{ms1:.4f} ms = {ms1 * 1e3 / adds:.4f} us an addition; one dependent "
        f"Fq product in one thread {probe['lazy_us']:.4f} us (carry-flag "
        f"product of fq_lazy.cuh), {probe['cios_us']:.4f} us (field.cuh's); "
        f"chain floor {adds} x 2 products x {probe['lazy_us']:.4f} us = "
        f"{rec['window_fold']['chain_floor_ms']:.4f} ms")

    phase_parity_ntt(rng, dev, rec)
    phase_parity_hades(rng, dev, rec)

    for name, r in rec.items():
        log(f"parity {name}: max_abs_err={r['max_abs_err']} (tolerance 0: "
            f"bit for bit), kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']}, at {r['shape']}")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version (max_abs_err={r['max_abs_err']})")
    return rec


def phase_parity_broadcast(rng, dev, rec) -> None:
    """mont_mul on operands it reads in place -- a constant column, a table
    shared by every group, an [L, 1] lane broadcast, every second lane --
    against the plain version on the same views (CPU copy), both fields;
    then the shared table at the polynomial path's largest shape, timed
    against the copy it replaces, under a profile that must show one kernel
    and no copy."""
    err = rec["mont_mul"]["max_abs_err"]
    for spec in (FR, FQ):
        n = spec.n_limbs
        a = lf.u32_to_tensor(rand_field(spec, (3, n, 1027), rng), dev)
        b = lf.u32_to_tensor(rand_field(spec, (3, n, 2054), rng), dev)
        views = {"a constant column": b[0, :, :1],
                 "a shared table": b[1, :, :1027],
                 "a lane broadcast": b[:, :, 7:8],
                 "every second lane": b[:, :, 1::2],
                 "limbs innermost": b[:, :, :1027].transpose(1, 2)
                 .contiguous().transpose(1, 2)}
        for name, v in views.items():
            if v.is_contiguous() and v.shape == a.shape:
                raise AssertionError(f"mont_mul: {name} is a plain operand")
            before = kernels.LAUNCHES["mont_mul"]
            for x, y in ((a, v), (v, a)):
                got = lf.mont_mul(spec, x, y)
                want = kernels.mont_mul_plain(spec, x.cpu(), y.cpu())
                if not got.is_contiguous() or got.shape != a.shape:
                    raise AssertionError(f"mont_mul by {name}: bad output")
                err = max(err, max_abs_err(got, want))
            if kernels.LAUNCHES["mont_mul"] != before + 2:
                raise AssertionError(f"mont_mul by {name} did not launch once")
    rec["mont_mul"]["max_abs_err"] = err

    # the polynomial path's largest broadcast: four 2^19 polynomials by one
    # [8, 2^19] table of coset factors (`ntt._scale`)
    x = lf.u32_to_tensor(rand_field(FR, (4, 8, N8), rng), dev)
    table = lf.u32_to_tensor(rand_field(FR, (8, N8), rng), dev)
    view = table.expand(x.shape)
    if not torch.equal(lf.mont_mul(FR, x, view),
                       kernels.mont_mul_plain(FR, x, view)):
        raise AssertionError("mont_mul by a shared table disagrees with its "
                             "plain version at [4, 8, 2^19]")
    in_place = cuda_ms(lambda: lf.mont_mul(FR, x, view), 20)
    copied = cuda_ms(lambda: kernels.mont_mul(FR, x, view.contiguous()), 20)
    b = bound((2 * x.numel() + table.numel()) * 4,
              mont_mul_ops(8) * x.numel() // 8)
    rows = profiled("mont_mul [4, 8, 2^19] by a shared [8, 2^19] table",
                    lambda: lf.mont_mul(FR, x, view), top=4)
    if [key for key, _, _ in rows if "mont_mul_kernel" not in key]:
        raise AssertionError(f"something ran beside the mont_mul kernel: "
                             f"{rows}")
    col = FR.mont_limbs(12345)
    rows = profiled("mont_mul_const [4, 8, 2^19] by a host constant",
                    lambda: lf.mont_mul_const(FR, x, col), top=4)
    if any("mont_mul_kernel" not in key and "Memcpy HtoD" not in key
           for key, _, _ in rows):
        raise AssertionError(f"a copy kernel ran before mont_mul_const: "
                             f"{rows}")
    log(f"mont_mul at [4, 8, {N8}] by a shared [8, {N8}] table: read in "
        f"place {in_place:.4f} ms, bound of the bytes it moves "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
        f"({in_place / b['bound_ms']:.2f} x); the table copied out first, "
        f"as before, {copied:.4f} ms")
    rec["mont_mul"].update(shared_table_ms=in_place,
                           shared_table_bound_ms=b["bound_ms"],
                           shared_table_copied_ms=copied)

def phase_parity_addsub(rng, dev, rec) -> None:
    """field_addsub against its plain version on the same card tensors, bit
    for bit: add, sub and neg, with and without the lane mask, on every
    layout the kernel reads in place, at the edge values 0, 1, p - 1 and
    R mod p; Fr at the quotient round's [8, 2^19], Fq at [12, 65543].
    Then its time against the byte bound and an empty launch of its grid,
    and a profile that must show that kernel alone (no copy before it)."""
    err = 0
    shapes = {"Fr": (FR, N8), "Fq": (FQ, N + 7)}
    for spec, lanes in shapes.values():
        n, p = spec.n_limbs, spec.modulus
        edges = [0, 1, p - 1, spec.R]
        arr = rand_field(spec, (n, 2 * lanes), rng)
        set_lanes(arr, spec, edges * 2)
        b2 = lf.u32_to_tensor(arr, dev)
        arr = rand_field(spec, (n, lanes), rng)
        set_lanes(arr, spec, [v for v in edges for _ in edges])
        a = lf.u32_to_tensor(arr, dev)
        b = b2[:, :lanes]
        small = lf.u32_to_tensor(rand_field(spec, (3, n, 1027), rng), dev)
        views = {"contiguous": (a, b.contiguous()),
                 "an [L, 1] column": (a, b[:, 5:6]),
                 "every second lane": (a, b2[:, 1::2]),
                 "limbs innermost": (a, b.T.contiguous().T),
                 "a lane broadcast": (small, small[:, :, 2:3])}
        for masked in (False, True):
            for name, (x, y) in views.items():
                mask = (torch.rand(x.shape[:-2] + x.shape[-1:], device=dev)
                        < 0.5) if masked else None
                for op in ("add", "sub", "neg"):
                    second = None if op == "neg" else y
                    before = kernels.LAUNCHES["field_addsub"]
                    got = kernels.field_addsub(spec, op, x, second, mask)
                    if kernels.LAUNCHES["field_addsub"] != before + 1:
                        raise AssertionError(f"field_addsub {op} by {name} "
                                             f"did not launch once")
                    want = kernels.field_addsub_plain(spec, op, x, second,
                                                      mask)
                    if not got.is_contiguous():
                        raise AssertionError("field_addsub: bad output")
                    err = max(err, max_abs_err(got, want))
        # the edge values against the host, once, on a CPU copy
        host = [lf.raw_to_ints(spec, kernels.field_addsub(
            spec, op, a[:, :16], None if op == "neg" else b[:, :16]))
            for op in ("add", "sub", "neg")]
        xs, ys = (lf.raw_to_ints(spec, t[:, :16]) for t in (a, b))
        if host != [[(u + v) % p for u, v in zip(xs, ys)],
                    [(u - v) % p for u, v in zip(xs, ys)],
                    [(-u) % p for u in xs]]:
            raise AssertionError(f"field_addsub {spec.name} disagrees with "
                                 f"the host at the edge values")
        if spec is FR:
            fr = (a, b)
    if err:
        raise AssertionError(f"field_addsub disagrees with its plain version "
                             f"(max limb difference {err})")
    a, b = fr
    ms = cuda_ms(lambda: kernels.field_addsub(FR, "add", a, b), 50)
    plain_ms = cuda_ms(lambda: kernels.field_addsub_plain(FR, "add", a, b), 3)
    threads = 128
    empty_ms = cuda_ms(lambda: kernels.empty_launch(
        -(-a.shape[-1] // threads), threads, dev), 50)
    col = b[:, 5:6]
    mask = torch.rand(a.shape[-1], device=dev) < 0.5
    times = {"sub by an [8, 1] column":
             cuda_ms(lambda: kernels.field_addsub(FR, "sub", a, col), 50),
             "masked neg": cuda_ms(
                 lambda: kernels.field_addsub(FR, "neg", a, None, mask), 50)}
    for label, fn in (("field_addsub sub by an [8, 1] column",
                       lambda: lf.sub(FR, a, col)),
                      ("field_addsub masked neg of every second lane",
                       lambda: lf.neg(FR, b[:, ::2],
                                      mask=mask[:a.shape[-1] // 2]))):
        rows = profiled(label, fn, top=4, reps=20)
        if [key for key, _, _ in rows if "field_addsub_kernel" not in key]:
            raise AssertionError(f"something ran beside the field_addsub "
                                 f"kernel: {rows}")
    b_ = bound(3 * a.numel() * 4, 0)
    log(f"field_addsub Fr [8, {N8}] add: {ms:.4f} ms, bound "
        f"{b_['bound_ms']:.4f} ms by {b_['bound_by']} "
        f"({b_['bound_ms'] / ms:.2f} of it), an empty launch of its grid "
        f"{empty_ms:.4f} ms, plain {plain_ms:.3f} ms; "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    rec["field_addsub"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               shape=f"Fr [8, {N8}]", empty_launch_ms=empty_ms,
                               **{k.replace(" ", "_").replace("[", "")
                                  .replace("]", "").replace(",", "")
                                  + "_ms": v for k, v in times.items()},
                               **b_)


def pow_products(e: int) -> int:
    """Products of MSB-first square-and-multiply from 1: one squaring a bit,
    one product a set bit."""
    return e.bit_length() + bin(e).count("1")


def phase_parity_pow(rng, dev, rec) -> None:
    """mont_pow against its plain version: both fields at [L, 65543] with
    the exponent p - 2 (zero lanes stay zero, the others times the operand
    give 1) and at the exponents 0, 1, 2, 5 on a ragged batch (CPU plain)."""
    err = 0
    for spec in (FR, FQ):
        n, p = spec.n_limbs, spec.modulus
        small = rand_field(spec, (3, n, 259), rng)
        small[:, :, 0] = 0
        small[0, :, 1] = lf.int_to_limbs(p - 1, n)
        ts = lf.u32_to_tensor(small, "cpu")
        for e in (0, 1, 2, 5, 0b1100101):
            got = kernels.mont_pow(spec, ts.to(dev), e)
            err = max(err, max_abs_err(got, kernels.mont_pow_plain(spec, ts,
                                                                   e)))
        a = rand_field(spec, (n, N + 7), rng)
        a[:, :3] = 0
        ad = lf.u32_to_tensor(a, dev)
        inv = lf.mont_inv(spec, ad)
        err = max(err, max_abs_err(inv, kernels.mont_pow_plain(spec, ad,
                                                               p - 2)))
        if inv[:, :3].any():
            raise AssertionError("mont_inv of zero is not zero")
        one = lf.mont_mul(spec, inv[:, 3:], ad[:, 3:])
        if not torch.equal(one, lf.const_tensor(spec, spec.one_mont,
                                                one.shape, dev)):
            raise AssertionError(f"{spec.name}: a * a^(p-2) is not 1")
        ms = cuda_ms(lambda: kernels.mont_pow(spec, ad, p - 2), 5)
        plain_ms = cuda_ms(lambda: kernels.mont_pow_plain(spec, ad, p - 2), 1)

        # the chain it replaces: one mont_mul launch a product, as before
        def chain():
            acc = lf.const_tensor(spec, spec.one_mont, ad.shape, dev)
            for i in range((p - 2).bit_length() - 1, -1, -1):
                acc = kernels.mont_mul(spec, acc, acc)
                if ((p - 2) >> i) & 1:
                    acc = kernels.mont_mul(spec, acc, ad)
            return acc
        if not torch.equal(chain(), inv):
            raise AssertionError("mont_pow disagrees with the chain of "
                                 "mont_mul launches")
        chain_ms = cuda_ms(chain, 2)
        b = bound(2 * ad.numel() * 4,
                  pow_products(p - 2) * mont_mul_ops(n) * ad.shape[-1])
        log(f"mont_pow {spec.name} [{n}, {N + 7}], exponent p - 2 "
            f"({pow_products(p - 2)} products): one launch {ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']}; the same chain as "
            f"{pow_products(p - 2)} mont_mul launches {chain_ms:.4f} ms; "
            f"plain {plain_ms:.1f} ms")
        if spec is FQ:
            rec["mont_pow"] = dict(ms=ms, plain_ms=plain_ms,
                                   shape=f"Fq [12, {N + 7}], exponent q - 2",
                                   chain_of_mont_mul_ms=chain_ms, **b)
        else:
            fr_ms = ms
    rec["mont_pow"].update(max_abs_err=err, fr_ms=fr_ms)


def phase_product_latency(rng, dev) -> dict:
    """The latency of one dependent Fq product in one thread: one warp walks
    x <- x a / R a few thousand times in one launch, by each of the two
    device multiplies; the result is held against the plain chain."""
    iters = 4000
    a = lf.u32_to_tensor(rand_field(FQ, (12, 32), rng), "cpu")
    want = kernels.fq_mul_chain_plain(a, 64)
    ad = a.to(dev)
    out = {}
    for key, lazy in (("cios_us", False), ("lazy_us", True)):
        if not torch.equal(kernels.fq_mul_chain(ad, 64, lazy).cpu(), want):
            raise AssertionError(f"the product chain ({key}) disagrees with "
                                 f"its plain version")
        ms = cuda_ms(lambda: kernels.fq_mul_chain(ad, iters, lazy), 5)
        out[key] = ms * 1e3 / iters
    # the closed form: in Montgomery form every step multiplies the values
    got = FQ.from_mont_array(kernels.fq_mul_chain(ad, iters, True))
    vals = FQ.from_mont_array(a)
    for j in (0, 31):
        if got[j] != pow(vals[j], iters + 1, FQ.modulus):
            raise AssertionError("the product chain disagrees with the host")
    return out


def byte_columns(rng, lanes: int) -> np.ndarray:
    """[68, lanes] int32 byte columns of matmul scale: 63 columns below
    2^24, the top five zero so that the final carry dies."""
    d = np.zeros((kernels.N_COLUMNS, lanes), dtype=np.int32)
    d[:63] = rng.integers(0, 1 << 24, size=(63, lanes))
    return d


def phase_parity_ntt(rng, dev, rec) -> None:
    """butterfly, carry_fold and fold against their plain versions."""
    rinv = pow(1 << 256, -1, Q)

    # -- butterfly: edge lanes on a ragged batch (CPU plain): zeros, ones,
    # r - 1, a sum >= r (lane 3: e = r - 1, t = 1) and a difference < 0
    # (lane 4: e = 0, t = 1)
    e = rand_field(FR, (8, 4099), rng)
    o = rand_field(FR, (8, 4099), rng)
    w = rand_field(FR, (8, 4099), rng)
    set_lanes(e, FR, [0, 1, Q - 1, Q - 1, 0, 5, Q - 1])
    set_lanes(o, FR, [0, 1, Q - 1, rinv, rinv, 0, Q - 1])
    set_lanes(w, FR, [7, 1, Q - 1, FR.R, FR.R, 3, 1])
    te, to, tw = (lf.u32_to_tensor(t, "cpu") for t in (e, o, w))
    got = kernels.butterfly(te.to(dev), to.to(dev), tw.to(dev))
    err = max_abs_err(got, kernels.butterfly_plain(te, to, tw))
    # a [3, 8, B] batch with one shared [8, B] twiddle table
    be = lf.u32_to_tensor(rand_field(FR, (3, 8, 1027), rng), "cpu")
    bo = lf.u32_to_tensor(rand_field(FR, (3, 8, 1027), rng), "cpu")
    bw = lf.u32_to_tensor(rand_field(FR, (8, 1027), rng), "cpu")
    got = kernels.butterfly(be.to(dev), bo.to(dev), bw.to(dev))
    err = max(err, max_abs_err(got, kernels.butterfly_plain(be, bo, bw)))
    # slice shapes: one stage of a 2^16 and of a 2^19 transform
    for lanes in (N // 2, N8 // 2):
        e, o, w = (lf.u32_to_tensor(rand_field(FR, (8, lanes), rng), dev)
                   for _ in range(3))
        err = max(err, max_abs_err(kernels.butterfly(e, o, w),
                                   kernels.butterfly_plain(e, o, w)))
        ms = cuda_ms(lambda: kernels.butterfly(e, o, w), 50)
        plain_ms = cuda_ms(lambda: kernels.butterfly_plain(e, o, w), 3)
        b = bound(5 * e.numel() * 4, mont_mul_ops(8) * lanes)
        if lanes == N // 2:
            rec["butterfly"] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms,
                                    shape=f"[8, {lanes}]", **b)
        else:
            log(f"butterfly at [8, {lanes}]: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms by "
                f"{b['bound_by']}")
    rec["butterfly"]["max_abs_err"] = err

    # -- carry_fold: ragged batch with every column at 2^24 - 1, zeros, and
    # single columns (CPU plain); lanes 3 and 4 at the matmul route's
    # largest columns, 32 byte pairs of 256 * 255^2 each (just below 2^29)
    d = byte_columns(rng, 4099)
    d[:63, 0] = (1 << 24) - 1
    d[:, 1] = 0
    d[:, 2] = 0
    d[62, 2] = (1 << 24) - 1
    d[:63, 3] = WORST_COLUMN
    d[:, 4] = 0
    d[62, 4] = WORST_COLUMN
    td = torch.from_numpy(d)
    got = kernels.carry_fold(td.to(dev))
    err = max_abs_err(got, kernels.carry_fold_plain(td))
    host = lf.tensor_to_u32(got)
    for j in range(8):
        value = sum(int(c) << (8 * t) for t, c in enumerate(d[:, j].tolist()))
        if lf.limbs_to_int(host[:, j]) != value % Q:
            raise AssertionError(f"carry_fold lane {j} disagrees with the "
                                 f"host")
    # slice shapes: the leaves of one 2^16 transform and of four 2^19
    for lanes in (N, 4 * N8):
        dd = torch.from_numpy(byte_columns(rng, lanes)).to(dev)
        err = max(err, max_abs_err(kernels.carry_fold(dd),
                                   kernels.carry_fold_plain(dd)))
        ms = cuda_ms(lambda: kernels.carry_fold(dd), 20)
        plain_ms = cuda_ms(lambda: kernels.carry_fold_plain(dd), 1)
        b = bound((kernels.N_COLUMNS + 8) * lanes * 4,
                  2 * mont_mul_ops(8) * lanes)
        if lanes == 4 * N8:
            rec["carry_fold"] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms,
                                     shape=f"[68, {lanes}]", **b)
        else:
            log(f"carry_fold at [68, {lanes}]: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms by "
                f"{b['bound_by']}")
        del dd
    rec["carry_fold"]["max_abs_err"] = err

    # -- fold: ragged batch; lo = r, in [r, 2r), 2r, in [2r, 2^256), all
    # ones (CPU plain)
    v = rng.integers(0, 1 << 32, size=(kernels.N_WORDS, 4099),
                     dtype=np.uint64).astype(np.uint32)
    edge = [0, 1, Q, Q + 5, 2 * Q - 1, 2 * Q, 2 * Q + 9, (1 << 256) - 1,
            (1 << 544) - 1]
    for j, val in enumerate(edge):
        v[:, j] = lf.int_to_limbs(val if val >> 256 else val
                                  | (int(rng.integers(1, 1 << 62)) << 256),
                                  kernels.N_WORDS)
    tv = lf.u32_to_tensor(v, "cpu")
    err = max_abs_err(kernels.fold(tv.to(dev)), kernels.fold_plain(tv))
    host = lf.tensor_to_u32(kernels.fold(tv.to(dev)))
    for j in range(len(edge)):
        if lf.limbs_to_int(host[:, j]) != lf.limbs_to_int(v[:, j]) % Q:
            raise AssertionError(f"fold lane {j} disagrees with the host")
    # slice shape: the leaves of one 2^16 transform
    fv = lf.u32_to_tensor(rng.integers(
        0, 1 << 32, size=(kernels.N_WORDS, N), dtype=np.uint64).astype(
            np.uint32), dev)
    err = max(err, max_abs_err(kernels.fold(fv), kernels.fold_plain(fv)))
    ms = cuda_ms(lambda: kernels.fold(fv), 50)
    plain_ms = cuda_ms(lambda: kernels.fold_plain(fv), 3)
    rec["fold"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       shape=f"[17, {N}]",
                       **bound((kernels.N_WORDS + 8) * N * 4,
                               2 * mont_mul_ops(8) * N))


def hades_bounds(lanes: int) -> dict:
    """The kernel's bound (its own arithmetic) and the earlier one (2000
    products a permutation), same bytes."""
    b = bound(2 * 5 * 8 * lanes * 4, HADES_MULTIPLY_ADDS * lanes)
    old = bound(2 * 5 * 8 * lanes * 4,
                HADES_MULTIPLY_ADDS_2000_PRODUCTS * lanes)
    return dict(bound_2000_products_ms=old["bound_ms"], **b)


def phase_parity_hades(rng, dev, rec) -> None:
    """hades_permute against its plain version and the host permutation, at
    sizes on both sides of the lane count at which hades.cu changes from
    five threads a permutation to one thread a lane."""
    consts = poseidon.hades_consts(dev)
    cut = kernels.hades_coop_max_lanes()
    sizes = [1, 5, 31, 259, cut - 1, cut, cut + 1, HADES_LANES, 1 << 15]
    if not (259 < cut < HADES_LANES):
        raise AssertionError(f"dispatch constant {cut} is not between the "
                             f"sizes this phase checks on either side")
    err = 0
    times = {}
    for lanes in sizes:
        # edge lanes first: the all-zero state, every word r - 1, and two
        # lanes that are equal
        s = rand_field(FR, (5, 8, lanes), rng)
        s[:, :, 0] = 0
        if lanes >= 4:
            s[:, :, 1] = lf.int_to_limbs(Q - 1, 8)
            s[:, :, 3] = s[:, :, 2]
        ts = lf.u32_to_tensor(s, "cpu")
        st = ts.to(dev)
        got = kernels.hades_permute(st, consts)
        if lanes <= 259:   # CPU plain
            want = kernels.hades_permute_plain(ts, consts.cpu())
        else:              # card plain
            want = kernels.hades_permute_plain(st, consts)
        err = max(err, max_abs_err(got, want))
        if lanes >= 4 and not torch.equal(got[:, :, 2], got[:, :, 3]):
            raise AssertionError("hades_permute: equal lanes give unequal "
                                 "states")
        # the first lanes against the host permutation, through Montgomery
        # form
        k = min(lanes, 3)
        ints = [FR.from_mont_array(ts[w, :, :k].contiguous())
                for w in range(5)]
        outs = [FR.from_mont_array(got[w, :, :k].contiguous())
                for w in range(5)]
        for j in range(k):
            if [o[j] for o in outs] != hades_permute([v[j] for v in ints]):
                raise AssertionError(f"hades_permute lane {j} of {lanes} "
                                     f"disagrees with the host permutation")
        times[lanes] = cuda_ms(lambda: kernels.hades_permute(st, consts), 10)
        if lanes == HADES_LANES:
            plain_ms = cuda_ms(
                lambda: kernels.hades_permute_plain(st, consts), 1)
    log(f"hades_permute, five threads a permutation up to {cut} lanes, one "
        f"thread a lane above; kernel ms by lanes: "
        + ", ".join(f"{n}: {ms:.4f}" for n, ms in times.items())
        + "; every size equals the plain version and the host permutation")
    rec["hades_permute"] = dict(
        max_abs_err=err, ms=times[HADES_LANES], plain_ms=plain_ms,
        shape=f"[5, 8, {HADES_LANES}]", dispatch_lanes=cut,
        ms_by_lanes={str(n): ms for n, ms in times.items()},
        **hades_bounds(HADES_LANES))


def phase_matmul_exact(dev) -> None:
    """The byte-plane product at its worst case -- m = 256, every byte 255,
    so every sum is 256 * 255^2 = 16,646,400 < 2^24 -- and on random bytes,
    against an int64 product that uses no tensor core: broadcast
    multiply-add in integer arithmetic."""
    m, cols = 256, 32
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    for name, a, b in (
            ("all bytes 255", torch.full((32 * m, m), 255),
             torch.full((m, cols), 255)),
            ("random bytes", torch.randint(0, 256, (32 * m, m), generator=gen),
             torch.randint(0, 256, (m, cols), generator=gen))):
        a, b = a.to(dev), b.to(dev)
        got = torch.matmul(a.to(torch.float32), b.to(torch.float32))
        if got.dtype != torch.float32:
            raise AssertionError(f"matmul returned {got.dtype}")
        want = (a.to(torch.int64).unsqueeze(-1)
                * b.to(torch.int64).unsqueeze(0)).sum(dim=1)
        if not torch.equal(got.to(torch.int64), want):
            raise AssertionError(f"float32 matmul is not exact ({name})")
        log(f"matmul exact at m = {m}, {name}: max sum {int(want.max())}")
    # the port's own function, both branches: limbs of all ones against a
    # table of all 255 give D[t] = (pairs k + p = t) * 16,646,400
    x = torch.full((4, 8, m), -1, dtype=torch.int32, device=dev)
    table = torch.full((32 * m, m), 255.0, device=dev)
    pairs = torch.tensor([max(0, min(t, 62 - t) + 1) for t in range(68)],
                         dtype=torch.int64, device=dev)
    want = (pairs * 256 * 255 * 255).view(68, 1, 1).expand(68, m, 4)
    if int(want.max()) != WORST_COLUMN:
        raise AssertionError("the worst column is not 32 * 256 * 255^2")
    value = sum(int(c) << (8 * t) for t, c in enumerate(want[:, 0, 0].tolist()))
    for whole in (True, False):
        d = ntt_mxu._byte_columns(x, table, whole=whole)
        if not torch.equal(d.to(torch.int64), want):
            raise AssertionError("byte columns wrong at the worst case")
        # the columns at their largest through the reduction kernel
        got = kernels.carry_fold(d)
        if not (torch.equal(got, kernels.carry_fold_plain(d))
                and torch.equal(got.cpu(), kernels.carry_fold_plain(d.cpu()))):
            raise AssertionError("carry_fold disagrees with its plain "
                                 "version at the worst case")
        host = lf.tensor_to_u32(got.reshape(8, -1))
        if any(lf.limbs_to_int(host[:, j]) != value % Q
               for j in (0, 1, host.shape[1] - 1)):
            raise AssertionError("carry_fold disagrees with the host at the "
                                 "worst case")
    log("byte columns exact at the worst case on both branches (largest "
        f"column {WORST_COLUMN} < 2^29); carry_fold of them equals its plain "
        f"version and the host's big-int value mod r")


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
    log(f"launches on the commitment path: {launches}")

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

    require_launched(launches, ("mont_mul", "mont_pow", "padd",
                                "window_fold", "field_addsub"),
                     "commitment path")
    out["launches"] = launches
    out["commit_key"] = ck
    out["opening_key"] = pp.opening_key
    out["mont"] = mont
    return out


def phase_commit_breakdown(ck, mont) -> dict:
    """What the commit cells are made of, measured after the counted run:

    the lanes of every padd launch of one warm commit of four sets and of
    one set, as a histogram, each launch timed on the operands the path
    handed it (so that a launch count stops standing for one shape); both
    commits again with `kernels.padd` replaced by the grouped kernel on contiguous copies, in
    turns (which of the two `g1_ops.padd` should take, inside a commit);
    and both under torch.profiler: kernels, torch glue, idle share."""
    cells = {"commit4": lambda: ck.commit_many_mont(mont),
             "commit1": lambda: ck.commit_many_mont(mont[:1])}
    real_padd = kernels.padd

    # ---- the launches of one warm commit, by size ----
    # every launch is timed again, then and there, on the very operands the
    # path handed it (strided views included)
    seen = []

    def recording(p, q, layouts=None):
        lanes = p[0].shape[-1]
        seen.append((p[0].numel() // (12 * lanes), lanes,
                     p[0].is_contiguous() and q[0].is_contiguous(),
                     cuda_ms(lambda: real_padd(p, q, layouts), 3)))
        return real_padd(p, q, layouts)

    # points that g1_ops.padd still had to copy (their coordinates do not
    # share one layout)
    real_in_place = g1_ops._in_place
    copied = []

    def counting(point):
        res = real_in_place(point)
        copied.append(res[0] is not point)
        return res

    shapes, copies = {}, {}
    for name, fn in cells.items():
        fn()
        torch.cuda.synchronize()
        seen.clear()
        copied.clear()
        kernels.padd, g1_ops._in_place = recording, counting
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            kernels.padd, g1_ops._in_place = real_padd, real_in_place
        shapes[name] = list(seen)
        copies[name] = sum(copied)
    out = {}
    for name, launched in shapes.items():
        hist = {}
        for groups, lanes, _, ms_launch in launched:
            size = groups * lanes
            n, ms = hist.get(size, (0, 0.0))
            hist[size] = (n + 1, ms + ms_launch)
        total = sum(ms for _, ms in hist.values())
        lanes_all = sum(size * n for size, (n, _) in hist.items())
        out[name] = dict(
            launches=len(launched), padd_ms=total,
            padd_bound_ms=bound(
                9 * 12 * 4 * lanes_all,
                PADD_PRODUCTS * mont_mul_ops(12) * lanes_all)["bound_ms"],
            contiguous=sum(1 for s in launched if s[2]),
            points_copied=copies[name],
            histogram=[[size, n, ms] for size, (n, ms)
                       in sorted(hist.items(), reverse=True)])
    log(json.dumps({"padd_launches_by_lanes": {
        "columns": ["lanes (groups x lanes)", "launches",
                    "kernel ms summed over them, each launch timed on the "
                    "operands the path passed"], **out}}))
    for name, r in out.items():
        log(f"{name}: {r['launches']} padd launches ({r['contiguous']} on "
            f"contiguous operands, the others read in place; "
            f"{r['points_copied']} of {2 * r['launches']} points copied "
            f"first), kernel time summed over the launches, each timed on "
            f"its own operands, {r['padd_ms']:.4f} ms against a bound of "
            f"{r['padd_bound_ms']:.4f} ms for the same lanes")

    # ---- padd against padd_ilp inside a commit, in turns ----
    def grouped(p, q, layouts=None):
        return kernels.padd_ilp(tuple(t.contiguous() for t in p),
                                tuple(t.contiguous() for t in q))

    for name, fn in cells.items():
        times = []
        for label, add in (("padd", real_padd), ("padd_ilp", grouped),
                           ("padd_ilp", grouped), ("padd", real_padd)):
            kernels.padd = add
            try:
                times.append((label, cuda_ms(fn, 10), host_ms(fn, 10)))
            finally:
                kernels.padd = real_padd
        log(f"{name} with each addition kernel under g1_ops.padd, in turns: "
            + "; ".join(f"{label} device {d:.3f} ms, wall {w:.3f} ms"
                        for label, d, w in times))
        out[name]["by_kernel"] = times

    # ---- kernels, glue and host ----
    for name, fn in cells.items():
        rows = profiled(f"{name} x 2^{LOG_N}, warm", fn, top=12)
        ours = sum(us for key, us, _ in rows
                   if any(k in key for k in OUR_KERNELS)) / 1e3
        busy = sum(us for _, us, _ in rows) / 1e3
        copies = [(us, n) for key, us, n in rows
                  if "copy" in key.lower() or "Memcpy" in key]
        log(f"  {name}: hand-written kernels {ours:.3f} ms, torch glue "
            f"{busy - ours:.3f} ms of which copies "
            f"{sum(us for us, _ in copies) / 1e3:.3f} ms in "
            f"{sum(n for _, n in copies)} launches")
        out[name].update(kernels_ms=ours, glue_ms=busy - ours)
    return out


def require_launched(launches, names, path: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path}")


def mont_ints(t: torch.Tensor) -> list[int]:
    """[8, m] Montgomery tensor -> canonical Python ints."""
    return FR.from_mont_array(t)


def horner(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % Q
    return acc


def poly_path(ck, ok, evals, rng_seed: int, z: Fr, v: Fr) -> dict:
    """The polynomial path of a prover round through the port's entry
    points; everything stays on the card but the transcript scalars and
    the commitment points."""
    dev = evals.device
    rng = StdRng(rng_seed)
    dom, dom8 = ntt.Domain(N), ntt.Domain(N8)
    coeffs = dom.ifft_device(evals)                          # [4, 8, n]
    blinded = [dpoly.apply_blinders_device(rng, coeffs[k], 1)
               for k in range(4)]                            # [8, n + 2]
    commits = ck.commit_many_mont(blinded)                   # round-1 shape
    padded = torch.stack([F.pad(t, (0, N8 - t.shape[-1])) for t in blinded])
    coset = dom8.coset_fft_device(padded)                    # [4, 8, 8n]
    back = dom8.coset_ifft_device(coset)
    at_z = dpoly.eval_stack(torch.stack(blinded), z)
    numerator = dpoly.lin_comb(list(zip(blinded, powers_of(v, 3))), N + 2,
                               dev)
    witness = dpoly.ruffini_device(numerator, z)
    w_commit = ck.commit_many_mont([witness])[0]
    agg = AggregateProof(w_commit)
    for e, c in zip(at_z, commits):
        agg.add_part(e, c)
    verified = ok.check(z, agg.flatten(v))
    torch.cuda.synchronize()
    return dict(coeffs=coeffs, blinded=blinded, commits=commits,
                padded=padded, coset=coset, back=back, at_z=at_z,
                witness=witness, w_commit=w_commit, agg=agg,
                verified=verified)


def phase_poly(rng, dev, ck, ok) -> dict:
    out = {}
    evals = lf.u32_to_tensor(rand_field(FR, (4, 8, N), rng), dev)
    z = Fr(int(rng.integers(1, 1 << 62)) << 130 | 0x1234567)
    v = Fr(int(rng.integers(1, 1 << 62)) << 120 | 0x7654321)

    # host tables, built once per (n, root): apart from the transform times
    t0 = time.perf_counter()
    for dom in (ntt.Domain(N), ntt.Domain(N8)):
        for root in (dom.group_gen, dom.group_gen_inv):
            ntt_mxu.MXUTransform(dom.size, root)
    out["mxu_tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntt.Domain(N)._factor("size_inv", dev)
    ntt.Domain(N8)._factor("coset", dev)
    ntt.Domain(N8)._factor("coset_inv_scaled", dev)
    out["factor_tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntt.Domain(N)._butterfly_tables(dev)
    out["butterfly_tables_s"] = time.perf_counter() - t0
    log(f"host tables: matmul route 2^16 + 2^19, forward and inverse "
        f"{out['mxu_tables_s']:.3f} s; coset and 1/n factors "
        f"{out['factor_tables_s']:.3f} s; staged butterfly 2^16 "
        f"{out['butterfly_tables_s']:.3f} s")
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    poly_path(ck, ok, evals, SEED + 1, z, v)
    out["path_first_s"] = time.perf_counter() - t0

    kernels.reset_launches()
    # ---- main path: the polynomial path, one warm call ----
    t0 = time.perf_counter()
    r = poly_path(ck, ok, evals, SEED + 1, z, v)
    out["path_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # ---- end of main path ----

    kernels.reset_launches()
    # ---- cross-checks: the other route and the unfused reduction, each
    # over a whole 2^16 transform, forward and inverse ----
    dom = ntt.Domain(N)
    x = r["coeffs"][0]
    fwd = dom.fft_device(x)
    inv = dom._run(fwd, inverse=True)
    routes_agree = (
        torch.equal(ntt.butterfly_transform(dom, x), fwd)
        and torch.equal(ntt.butterfly_transform(dom, fwd, inverse=True), inv))
    t_fwd = ntt_mxu.MXUTransform(N, dom.group_gen)
    t_inv = ntt_mxu.MXUTransform(N, dom.group_gen_inv)
    unfused_agrees = (
        torch.equal(ntt_mxu.transform_unfused(t_fwd, x), fwd)
        and torch.equal(ntt_mxu.transform_unfused(t_inv, fwd), inv))
    torch.cuda.synchronize()
    crosscheck = dict(kernels.LAUNCHES)
    # ---- end of cross-checks ----
    log(f"polynomial path 2^{LOG_N} / 2^{LOG_N + 3}: first "
        f"{out['path_first_s']:.3f} s, warm {out['path_s']:.3f} s")
    log(f"launches on one polynomial path: {launches}")
    log(f"launches of the whole-transform cross-checks: {crosscheck}")

    # ---- checks ----
    if not r["verified"]:
        raise AssertionError("the opening does not verify")
    bad = AggregateProof(r["w_commit"])
    for k, (e, c) in enumerate(zip(r["at_z"], r["commits"])):
        bad.add_part(e + Fr.one() if k == 2 else e, c)
    if ok.check(z, bad.flatten(v)):
        raise AssertionError("an altered evaluation still verifies")
    log("opening: OpeningKey.check is true, and false after one evaluation "
        "is altered")
    if not torch.equal(r["back"], r["padded"]):
        raise AssertionError("coset_ifft(coset_fft(p)) != p at 2^19")
    if not torch.equal(fwd, evals[0]):
        raise AssertionError("fft(ifft(evals)) != evals at 2^16")
    if not routes_agree:
        raise AssertionError("the staged butterfly transform disagrees "
                             "with the matmul transform at 2^16")
    if not unfused_agrees:
        raise AssertionError("the unfused leaf reduction disagrees with "
                             "carry_fold over a 2^16 transform")
    log("routes: staged butterfly == matmul and unfused fold == fused, bit "
        "for bit, 2^16 forward and inverse; both round trips exact")

    # sampled evaluations against host big-int Horner
    c0 = mont_ints(x)
    e0 = mont_ints(fwd)
    ks = [0, 1, N - 1] + rng.integers(2, N - 1, 13).tolist()
    for k in ks:
        if e0[k] != horner(c0, pow(dom.group_gen, k, Q)):
            raise AssertionError(f"fft_device disagrees with Horner at "
                                 f"omega^{k}")
    dom8 = ntt.Domain(N8)
    b0 = mont_ints(r["blinded"][0])
    ks8 = [0, 1, N8 - 1] + rng.integers(2, N8 - 1, 13).tolist()
    sample = mont_ints(r["coset"][0].index_select(
        -1, torch.tensor(ks8, device=dev)))
    for got, k in zip(sample, ks8):
        point = dom8.generator * pow(dom8.group_gen, k, Q) % Q
        if got != horner(b0, point):
            raise AssertionError(f"coset_fft_device disagrees with Horner "
                                 f"at g omega^{k}")
    for k in range(4):
        if r["at_z"][k].value != horner(mont_ints(r["blinded"][k]), z.value):
            raise AssertionError(f"eval_stack disagrees with Horner for "
                                 f"polynomial {k}")
    log("host checks: fft at 16 points of the 2^16 domain, coset_fft at 16 "
        "points of the 2^19 coset, eval_stack of 4 polynomials equal "
        "big-int Horner")
    points = ck.powers_of_g[:N + 2]
    if r["commits"][0].point != native_commit(
            points, [Fr(c) for c in b0]).to_affine():
        raise AssertionError("blinded commitment disagrees with the native "
                             "MSM")
    log("commit: the first blinded commitment equals the native host MSM")

    require_launched(launches, ("mont_mul", "padd", "window_fold",
                                "carry_fold"), "polynomial path")
    require_launched(crosscheck, ("mont_mul", "butterfly", "carry_fold",
                                  "fold"), "whole-transform cross-checks")
    out["launches"] = launches
    out["crosscheck"] = crosscheck
    return out


def random_leaves(rng, n: int) -> list[int]:
    """n values below r from the seeded numpy generator."""
    blob = rng.bytes(32 * n)
    return [int.from_bytes(blob[32 * i:32 * i + 32], "little") % Q
            for i in range(n)]


def digest4(children: list[int]) -> int:
    """The host's Merkle4 digest of four canonical ints."""
    return Hash.digest(Domain.Merkle4, [Fr(c) for c in children])[0].value


def check_levels(levels, rng, what: str) -> None:
    """16 sampled nodes of every level above the leaves, and the root,
    recomputed on the host from the device's own children."""
    dev = levels[0].device
    n_checked = 0
    for lower, upper in zip(levels, levels[1:]):
        m = upper.shape[-1]
        idx = sorted(set(rng.integers(0, m, 16).tolist()) | {0, m - 1})
        it = torch.tensor(idx, device=dev)
        kids = FR.from_mont_array(lower.index_select(
            -1, (4 * it.unsqueeze(1) + torch.arange(4, device=dev)).flatten()))
        nodes = FR.from_mont_array(upper.index_select(-1, it))
        for k, node in enumerate(nodes):
            if node != digest4(kids[4 * k:4 * k + 4]):
                raise AssertionError(f"{what}: node {idx[k]} of a level of "
                                     f"{m} disagrees with the host hash")
        n_checked += len(idx)
    log(f"{what}: {n_checked} sampled nodes over {len(levels) - 1} levels, "
        f"the root among them, equal the host's Hash.digest(Merkle4) of the "
        f"device's own children")


def tree_node(tree, depth: int, index: int):
    """The node `index` of the level `depth` below the root."""
    node = tree.root_node
    for d in range(depth):
        node = node.children[index // 4 ** (depth - 1 - d) % 4]
    return node


def phase_merkle(rng, dev) -> dict:
    """The Merkle path through PoseidonTree.from_leaves at 4^10 leaves, then
    merkle_tree_levels alone at 4^12."""
    out = {}
    h = MERKLE_HEIGHT
    n = 4 ** h
    n_hashes = (n - 1) // 3
    values = random_leaves(rng, n)
    leaves = [Fr(v) for v in values]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    # ---- main path: leaves -> tree -> root -> openings ----
    t0 = time.perf_counter()
    tree = PoseidonTree.from_leaves(h, leaves, "cuda")
    root = tree.root()
    torch.cuda.synchronize()
    out["from_leaves_s"] = time.perf_counter() - t0
    positions = [0, 1, n - 1] + rng.integers(2, n - 1, 5).tolist()
    t0 = time.perf_counter()
    openings = [tree.opening(pos) for pos in positions]
    verified = [o.verify(Item(leaves[pos]))
                for o, pos in zip(openings, positions)]
    out["openings_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # ---- end of main path ----
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # device time: the whole level-wise build (glue included) and the ten
    # permutation launches alone, each at its level's shape
    mont = FR.to_mont_array(values, dev)
    consts = poseidon.hades_consts(dev)
    levels_ms = cuda_ms(lambda: poseidon.merkle_tree_levels(mont), 3)
    launch_ms = []
    for k in range(h - 1, -1, -1):
        st = lf.u32_to_tensor(rand_field(FR, (5, 8, 4 ** k), rng), dev)
        launch_ms.append(cuda_ms(lambda: kernels.hades_permute(st, consts),
                                 3 if k >= 8 else 20))
    out["levels_ms"] = levels_ms
    out["launches_ms"] = sum(launch_ms)
    launch_bound = sum(hades_bounds(4 ** k)["bound_ms"] for k in range(h))
    wall = out["from_leaves_s"]
    log(f"merkle path, height {h}: {n} leaves, {n_hashes} permutations in "
        f"{launches['hades_permute']} launches; from_leaves + root wall "
        f"{wall:.3f} s = {n_hashes / wall:.1f} hashes/s; device time of the "
        f"level-wise build {levels_ms:.3f} ms ({sum(launch_ms):.3f} ms in the "
        f"{h} permutation launches: "
        f"{', '.join(f'{ms:.4f}' for ms in launch_ms)}; bound of the same "
        f"{n_hashes} permutations {launch_bound:.3f} ms) = "
        f"{n_hashes / levels_ms * 1e3:.1f} hashes/s; host share "
        f"{1 - levels_ms / 1e3 / wall:.4f}; peak {out['peak_gib']:.3f} GiB; "
        f"{len(positions)} openings + verify {out['openings_s']:.3f} s")
    log(f"launches on the merkle path: {launches}")

    # ---- checks ----
    if not all(verified):
        raise AssertionError("an opening of the tree does not verify")
    for o, pos in zip(openings, positions):
        if o.verify(Item(leaves[pos] + Fr.one())):
            raise AssertionError("an opening verifies a wrong leaf")
        wire = o.to_var_bytes()
        back = poseidon_opening_from_slice(wire, h)
        if not (back.verify(Item(leaves[pos])) and back.to_var_bytes() == wire
                and back.root == root):
            raise AssertionError("an opening does not survive its wire bytes")
    log(f"openings: {len(positions)} verify, none verifies a wrong leaf, all "
        f"survive to_var_bytes -> poseidon_opening_from_slice")
    n_checked = 0
    for depth in range(h):
        m = 4 ** depth
        for index in sorted(set(rng.integers(0, m, 16).tolist())):
            node = tree_node(tree, depth, index)
            kids = [c.item.hash.value for c in node.children]
            if node.item.hash.value != digest4(kids):
                raise AssertionError(f"tree node {index} at depth {depth} "
                                     f"disagrees with the host hash")
            n_checked += 1
    if root != tree_node(tree, 0, 0).item:
        raise AssertionError("root() is not the cached root node")
    if [tree_node(tree, h, pos).item.hash for pos in positions] != [
            leaves[pos] for pos in positions]:
        raise AssertionError("the tree does not hold the leaves")
    levels = poseidon.merkle_tree_levels(mont)
    if FR.from_mont_array(levels[-1]) != [root.hash.value]:
        raise AssertionError("merkle_tree_levels disagrees with the tree")
    log(f"tree: {n_checked} sampled nodes on {h} levels, the root among "
        f"them, equal the host's Hash.digest(Merkle4) of their children")
    require_launched(launches, ("mont_mul", "hades_permute"), "merkle path")
    out["launches"] = launches
    del tree, openings, mont

    # where from_leaves spends its wall time: its stages run again, apart
    # (host clock, synchronised)
    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    mont, to_s = timed(lambda: FR.to_mont_array(values, dev))
    levels, levels_s = timed(lambda: poseidon.merkle_tree_levels(mont))
    host_levels, from_s = timed(lambda: [
        [Fr(v) for v in FR.from_mont_array(lvl)] for lvl in levels])
    again = PoseidonTree(h)
    _, insert_s = timed(lambda: [again.insert(i, Item(leaf, None))
                                 for i, leaf in enumerate(leaves)])
    _, install_s = timed(lambda: again._install_cached_hashes(host_levels))
    if again.root() != root:
        raise AssertionError("the staged rebuild disagrees with from_leaves")
    log(f"stages of from_leaves at height {h}, run again apart: ints -> "
        f"Montgomery tensor {to_s:.3f} s, level-wise build {levels_s:.3f} s, "
        f"levels -> Fr objects {from_s:.3f} s, {n} inserts {insert_s:.3f} s, "
        f"install the cached hashes {install_s:.3f} s")
    del again, host_levels, leaves, values, mont, levels

    # ---- merkle_tree_levels alone at 4^12, leaves made on the card ----
    h2 = LEVELS_HEIGHT
    n2 = 4 ** h2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = torch.randint(-(1 << 31), 1 << 31, (8, n2), generator=gen,
                        device=dev, dtype=torch.int64).to(torch.int32)
    big[-1] = torch.randint(0, int(FR.p_limbs[-1]), (n2,), generator=gen,
                            device=dev, dtype=torch.int64).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    levels = poseidon.merkle_tree_levels(big)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del levels
    dev_ms = cuda_ms(lambda: poseidon.merkle_tree_levels(big), 2)
    wall_ms = host_ms(lambda: poseidon.merkle_tree_levels(big), 2)
    st = torch.cat([big[:, :n2 // 4]] * 5).reshape(5, 8, n2 // 4)
    top_ms = cuda_ms(lambda: kernels.hades_permute(st, consts), 2)
    b = hades_bounds(n2 // 4)
    del st
    n_hashes2 = (n2 - 1) // 3
    out["levels12_ms"] = dev_ms
    log(f"merkle_tree_levels, height {h2}: {n2} leaves, {n_hashes2} "
        f"permutations; first call {first_s:.3f} s, device {dev_ms:.3f} ms, "
        f"wall {wall_ms:.3f} ms = {n_hashes2 / wall_ms * 1e3:.1f} hashes/s, "
        f"peak {peak:.3f} GiB; hades_permute at [5, 8, {n2 // 4}]: "
        f"{top_ms:.3f} ms, bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
        f"({b['bound_2000_products_ms']:.3f} ms by the earlier count of 2000 "
        f"products a permutation)")
    out["levels12_top_ms"] = top_ms
    check_levels(poseidon.merkle_tree_levels(big), rng,
                 f"merkle_tree_levels at height {h2}")
    return out


def phase_padd_comparison(ck) -> dict:
    """The 2^16 SRS points on the card summed to one point by a halving
    tree, once with each addition kernel; both against the host sum."""
    pts = tuple(t[:, :N].contiguous() for t in kzg10._device_ctx(ck).points)
    torch.cuda.synchronize()
    kernels.reset_launches()
    # ---- main path: one halving tree by each kernel ----
    serial = g1_ops.device_to_projective(g1_ops.sum_lanes(pts, g1_ops.padd))
    grouped = g1_ops.device_to_projective(
        g1_ops.sum_lanes(pts, g1_ops.padd_ilp))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # ---- end of main path ----
    want = native_commit(ck.powers_of_g[:N], [Fr.one()] * N)
    if not (serial == want == grouped):
        raise AssertionError("a halving-tree sum disagrees with the host sum")
    times = {}
    for name, add in (("padd", g1_ops.padd), ("padd_ilp", g1_ops.padd_ilp),
                      ("padd_ilp again", g1_ops.padd_ilp),
                      ("padd again", g1_ops.padd)):
        # five sums are enqueued within the time the card spins
        times[name] = (cuda_ms(lambda: g1_ops.sum_lanes(pts, add), 5),
                       host_ms(lambda: g1_ops.sum_lanes(pts, add), 10))
    log("padd comparison, 2^16 points summed by a halving tree (16 levels): "
        + "; ".join(f"{name} device {d:.4f} ms, wall {w:.4f} ms"
                    for name, (d, w) in times.items())
        + "; both sums equal the native host sum")
    log(f"launches of the padd comparison: {launches}")
    require_launched(launches, ("mont_mul", "padd", "padd_ilp"),
                     "padd comparison")
    return dict(launches=launches)


def host_ms(fn, reps: int) -> float:
    """Mean wall time of fn() (host work included), synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_times(rng, dev) -> None:
    """Transform times, warm, both routes, 1 and 4 polynomials: device time
    (CUDA events, launches back to back) and wall time (host clock,
    synchronised: what a caller waits, Python's enqueueing included); the
    dpoly functions and the int64 add/sub glue at 2^16; peak memory."""
    def butterfly_route(dom, name):
        def run(x):
            if name == "coset_fft":
                x = ntt._scale(x, dom._factor("coset", dev))
            y = ntt.butterfly_transform(dom, x, inverse=name == "coset_ifft")
            if name == "coset_ifft":
                y = ntt._scale(y, dom._factor("coset_inv_scaled", dev))
            return y
        return run

    for size, names in ((1 << 14, ("fft",)), (N, ("fft",)),
                        (N8, ("coset_fft", "coset_ifft"))):
        dom = ntt.Domain(size)
        t0 = time.perf_counter()
        dom._butterfly_tables(dev)
        for root in (dom.group_gen, dom.group_gen_inv):
            ntt_mxu.MXUTransform(size, root)
        tables_s = time.perf_counter() - t0
        for batch in (1, 4):
            x = lf.u32_to_tensor(rand_field(FR, (batch, 8, size), rng), dev)
            for name in names:
                mxu = getattr(dom, name + "_device")
                bfly = butterfly_route(dom, name)
                if not torch.equal(mxu(x), bfly(x)):
                    raise AssertionError(f"routes disagree: {name} 2^"
                                         f"{size.bit_length() - 1} x {batch}")
                reps = 3 if size == N8 else 10
                line = f"time {name} 2^{size.bit_length() - 1} x {batch}:"
                for route, fn in (("matmul", mxu), ("butterfly", bfly)):
                    torch.cuda.reset_peak_memory_stats()
                    dev_ms = cuda_ms(lambda: fn(x), reps)
                    wall_ms = host_ms(lambda: fn(x), reps)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    line += (f" {route} route device {dev_ms:.4f} ms, wall "
                             f"{wall_ms:.4f} ms, peak {peak:.3f} GiB;")
                log(f"{line} remaining host tables {tables_s:.3f} s")
            del x

    z = Fr(0x1F2E3D4C5B6A79880123456789ABCDEF)
    c = lf.u32_to_tensor(rand_field(FR, (8, N + 2), rng), dev)
    stack = torch.stack([c, c, c, c])
    log(f"time eval_stack 4 x (2^16 + 2): "
        f"{host_ms(lambda: dpoly.eval_stack(stack, z), 3):.3f} ms; "
        f"ruffini_device 2^16 + 2: "
        f"{host_ms(lambda: dpoly.ruffini_device(c, z), 3):.3f} ms "
        f"(host clock, synchronised)")
    a = lf.u32_to_tensor(rand_field(FR, (8, N), rng), dev)
    b = lf.u32_to_tensor(rand_field(FR, (8, N), rng), dev)
    log(f"time at [8, 2^16]: lf.add (field_addsub kernel) "
        f"{cuda_ms(lambda: lf.add(FR, a, b), 20):.4f} ms, lf.sub "
        f"{cuda_ms(lambda: lf.sub(FR, a, b), 20):.4f} ms, the int64 chain "
        f"they replace "
        f"{cuda_ms(lambda: kernels.field_addsub_plain(FR, 'add', a, b), 20):.4f}"
        f" ms, mont_mul kernel "
        f"{cuda_ms(lambda: lf.mont_mul(FR, a, b), 20):.4f} ms")

def refuses_changed_input(verifier, proof, pis) -> bool:
    """The verifier refuses the proof with its first public input + 1."""
    try:
        verifier.verify(proof, [pis[0] + Fr.one()] + pis[1:])
    except PlonkError:
        return True
    return False


def phase_prove_dryrun(dev) -> None:
    """Gate 2 on the card: setup 2^11, compile and prove of the dryrun
    circuit through the port's entry points; the proof bytes must equal the
    committed fixture (read as a file), the public inputs its tail."""
    t0 = time.perf_counter()
    prover, verifier = dryrun.dryrun_prover(dev)
    setup_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, pis = dryrun.prove_dryrun(prover)
    prove_s = time.perf_counter() - t0
    fixture = dryrun.fixture_path(
        str(Path(__file__).resolve().parent))
    with open(fixture, "rb") as f:
        buf = f.read()
    plen = int.from_bytes(buf[:4], "little")
    want_proof = buf[4:4 + plen]
    tail = buf[4 + plen:]
    n_pis = int.from_bytes(tail[:4], "little")
    want_pis = [tail[4 + 32 * i: 36 + 32 * i] for i in range(n_pis)]
    if proof.to_bytes() != want_proof:
        raise AssertionError("the dryrun proof on the card differs from "
                             "tests/fixtures/dryrun_proof_v1.bin")
    if [p.to_bytes() for p in pis] != want_pis:
        raise AssertionError("the dryrun public inputs differ from the "
                             "fixture's tail")
    verifier.verify(proof, pis)
    if not refuses_changed_input(verifier, proof, pis):
        raise AssertionError("the verifier accepted a changed public input")
    log(f"dryrun prove (capacity 2^11, {prover.constraints} gates, domain "
        f"{prover.size}): setup + compile {setup_compile_s:.3f} s, prove "
        f"{prove_s:.3f} s; proof bytes ({len(want_proof)}) and {n_pis} "
        f"public input equal the fixture; verified, a changed public input "
        f"refused")


def phase_prove_flagship(dev) -> dict:
    """The flagship at full width through `benches.run_flagship` (the
    steps `tools/bench_flagship.py` times): setup 2^17, compile the
    2^16-gate circuit, a first and three warm proves (byte-identical),
    verify; then the refusal of a changed public input.  The first warm
    prove is the counted region `prove_path`; one more is profiled."""
    launches = {}

    @contextlib.contextmanager
    def main_path():
        # ---- main path: one warm flagship prove ----
        kernels.reset_launches()
        yield
        launches.update(kernels.LAUNCHES)
        # ---- end of main path ----

    r = benches.run_flagship(dev, FLAGSHIP_COUNT, FLAGSHIP_SETUP_LOG,
                             FLAGSHIP_WARM_PROVES, region=main_path)
    prover, verifier = r["prover"], r["verifier"]
    proof, pis, circuit = r["proof"], r["pis"], r["circuit"]
    out = {k: r[k] for k in ("setup_s", "compile_s", "prove_first_s",
                             "peak_gib", "verify_ms")}
    log(f"flagship: {prover.constraints} gates, domain {prover.size} "
        f"(8n = {8 * prover.size}); setup 2^{FLAGSHIP_SETUP_LOG} "
        f"{out['setup_s']:.3f} s, compile {out['compile_s']:.3f} s")
    if prover.size != N:
        raise AssertionError(f"the flagship domain is {prover.size}, not "
                             f"2^{LOG_N}")
    walls = r["warm_s"]
    out["prove_warm_s"] = sum(walls) / len(walls)
    log(f"flagship prove: first {out['prove_first_s']:.3f} s, warm "
        + ", ".join(f"{w:.3f}" for w in walls)
        + f" s (mean {out['prove_warm_s']:.3f} s), the "
        f"{FLAGSHIP_WARM_PROVES} warm proofs byte-identical; peak device "
        f"memory {out['peak_gib']:.3f} GiB")
    log("flagship spans, averaged over the warm proves: "
        + "; ".join(f"{k} {v['total_s'] / v['count']:.4f} s"
                    for k, v in r["spans"].items()))
    log(f"launches of one warm flagship prove: {launches}")

    if not refuses_changed_input(verifier, proof, pis):
        raise AssertionError("the flagship verifier accepted a changed "
                             "public input")
    log(f"flagship verify: {out['verify_ms']:.1f} ms ({len(pis)} public "
        f"inputs); a changed public input refused")

    rows = profiled("one warm flagship prove",
                    lambda: prover.prove(StdRng(7), circuit), top=14)
    busy = sum(us for _, us, _ in rows) / 1e3
    ours = sum(us for key, us, _ in rows
               if any(k in key for k in OUR_KERNELS)) / 1e3
    out["busy_share"] = busy / (out["prove_warm_s"] * 1e3)
    log(f"  of its device time, the port's kernels {ours:.3f} ms; busy "
        f"share of a warm prove {out['busy_share']:.4f} (device busy "
        f"{busy:.3f} ms over the mean warm wall without the profiler)")
    require_launched(launches, ("mont_mul", "padd", "window_fold",
                                "carry_fold", "field_addsub"),
                     "flagship prove")
    out["launches"] = launches
    out.update(prover=prover, verifier=verifier, circuit=circuit,
               proof_bytes=proof.to_bytes())
    return out


def mesh_prove(prover, circuit, mesh) -> tuple[float, bytes, list]:
    """One flagship prove over `mesh`: (wall s, proof bytes, public
    inputs)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof, pis = prover.prove(StdRng(7), circuit, mesh=mesh)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, proof.to_bytes(), pis


def phase_mesh(rng, dev, fl) -> dict:
    """The flagship prover of the flagship phase (its setup and compile
    reused) over a mesh of MESH_SHARDS logical shards of the card, and over
    the real cards where there are two or more: a first and three warm
    mesh proves, each byte-identical to the flagship's warm proof, verified,
    a changed public input refused; single-device warm proves before and
    after, in the same call.  Then the mesh's components at the flagship's
    sizes, each against its single-device counterpart: DistributedDomain
    (2^19) coset fft and coset ifft against Domain, msm_sharded of 2^16
    seeded points against the native host MSM, the forest of 4^10 leaves
    against merkle_tree_levels; and dryrun_multichip at 2, 4 and 8
    shards.  The counted region `mesh` is the first warm mesh prove and
    one run of each component."""
    t_phase = time.perf_counter()
    prover, verifier, circuit = fl["prover"], fl["verifier"], fl["circuit"]
    want = fl["proof_bytes"]
    mesh = Mesh([dev] * MESH_SHARDS)
    card = card_line()
    out = {}

    def check(blob, what):
        if blob != want:
            raise AssertionError(f"the {what} proof differs from the "
                                 f"single-device flagship proof")

    def single_prove() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof, _ = prover.prove(StdRng(7), circuit)
        torch.cuda.synchronize()
        check(proof.to_bytes(), "single-device")
        return time.perf_counter() - t0

    out["first_s"], blob, pis = mesh_prove(prover, circuit, mesh)
    check(blob, "first mesh")
    singles = [single_prove()]

    n8 = 8 * prover.size
    dd8 = DistributedDomain(n8, mesh)
    x = lf.u32_to_tensor(rand_field(FR, (FR.n_limbs, n8), rng), dev)
    points = prover.commit_key.powers_of_g[:N]
    scalars = [Fr(v) for v in random_leaves(rng, N)]
    leaves = lf.u32_to_tensor(rand_field(FR, (FR.n_limbs, 4 ** MERKLE_HEIGHT),
                                          rng), dev)

    metrics.GLOBAL.reset()
    kernels.reset_launches()
    # ---- main path: one warm mesh prove and the mesh's components ----
    wall, blob, pis = mesh_prove(prover, circuit, mesh)
    evals = dd8.coset_fft_device(x)
    back = dd8.coset_ifft_device(evals)
    msm_point = msm.msm_sharded(points, scalars, mesh)
    root = forest_root(leaves, mesh)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # ---- end of main path ----
    check(blob, "warm mesh")
    warm = [wall]
    # outside the region: the launches of one warm mesh prove alone, and the
    # peak device memory of the warm mesh proves and of a single-device one
    torch.cuda.reset_peak_memory_stats()
    for i in range(MESH_WARM_PROVES - 1):
        kernels.reset_launches()
        wall, blob, pis = mesh_prove(prover, circuit, mesh)
        if i == 0:
            prove_launches = dict(kernels.LAUNCHES)
        check(blob, "warm mesh")
        warm.append(wall)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    spans = metrics.report()
    torch.cuda.reset_peak_memory_stats()
    singles.append(single_prove())
    out["single_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["warm_s"] = sum(warm) / len(warm)
    out["single_warm_s"] = sum(singles) / len(singles)
    proof = Proof.from_bytes(blob)
    verifier.verify(proof, pis)
    if not refuses_changed_input(verifier, proof, pis):
        raise AssertionError("the verifier accepted a changed public input "
                             "of a mesh proof")
    log(f"mesh prove ({card}): {mesh}, flagship {prover.constraints} gates, "
        f"first {out['first_s']:.3f} s, warm "
        + ", ".join(f"{w:.3f}" for w in warm)
        + f" s (mean {out['warm_s']:.3f} s); single-device warm in the same "
        f"call " + ", ".join(f"{w:.3f}" for w in singles)
        + f" s (mean {out['single_warm_s']:.3f} s); the {1 + len(warm)} mesh "
        f"proofs equal the single-device proof byte for byte, verified, a "
        f"changed public input refused; peak device memory of the warm "
        f"mesh proves {out['peak_gib']:.3f} GiB, of a warm single-device "
        f"prove {out['single_peak_gib']:.3f} GiB")
    log(f"mesh prove spans ({card}), averaged over the warm mesh proves: "
        + "; ".join(f"{k} {v['total_s'] / v['count']:.4f} s"
                    for k, v in spans.items()))
    log(f"launches of one warm mesh prove: {prove_launches}")
    rows = profiled("one warm mesh prove",
                    lambda: prover.prove(StdRng(7), circuit, mesh=mesh),
                    top=14)
    busy = sum(us for _, us, _ in rows) / 1e3
    out["busy_share"] = busy / (out["warm_s"] * 1e3)
    log(f"  busy share of a warm mesh prove {out['busy_share']:.4f} (device "
        f"busy {busy:.3f} ms over the mean warm wall without the profiler)")
    log(f"launches of the mesh region (one warm mesh prove, the 2^19 coset "
        f"pair, msm_sharded of 2^16, the 4^{MERKLE_HEIGHT} forest): "
        f"{launches}")

    # ---- checks of the components against one device ----
    dom8 = ntt.Domain(n8)
    if not torch.equal(evals, dom8.coset_fft_device(x)):
        raise AssertionError("DistributedDomain coset_fft differs from "
                             "Domain's")
    if not (torch.equal(back, dom8.coset_ifft_device(evals))
            and torch.equal(back, x)):
        raise AssertionError("DistributedDomain coset_ifft differs from "
                             "Domain's")
    if msm_point != native_commit(points, scalars):
        raise AssertionError("msm_sharded differs from the native host MSM")
    if not torch.equal(root, poseidon.merkle_tree_levels(leaves)[-1]):
        raise AssertionError("the forest root differs from "
                             "merkle_tree_levels' root")
    ctx = msm.MSMContext(points, dev)
    coeffs = [FR.to_mont_array([v.value for v in scalars], dev)]
    ms = {
        "coset_fft": cuda_ms(lambda: dd8.coset_fft_device(x), 3),
        "coset_fft_one_device": cuda_ms(lambda: dom8.coset_fft_device(x), 3),
        "coset_ifft": cuda_ms(lambda: dd8.coset_ifft_device(evals), 3),
        "coset_ifft_one_device": cuda_ms(
            lambda: dom8.coset_ifft_device(evals), 3),
        "msm_sharded": cuda_ms(lambda: msm.msm_sharded(points, scalars,
                                                       mesh), 2),
        "msm_many_mont_mesh": cuda_ms(
            lambda: ctx.msm_many_mont(coeffs, mesh=mesh), 3),
        "msm_many_mont_one_device": cuda_ms(
            lambda: ctx.msm_many_mont(coeffs), 3),
        "forest": cuda_ms(lambda: forest_root(leaves, mesh), 2),
        "levels_one_device": cuda_ms(
            lambda: poseidon.merkle_tree_levels(leaves), 2),
    }
    out["component_ms"] = ms
    log(f"mesh components ({card}), ms by CUDA events: "
        f"DistributedDomain(2^{n8.bit_length() - 1}) coset_fft "
        f"{ms['coset_fft']:.3f} (Domain {ms['coset_fft_one_device']:.3f}), "
        f"coset_ifft {ms['coset_ifft']:.3f} (Domain "
        f"{ms['coset_ifft_one_device']:.3f}), bit for bit; msm_sharded of "
        f"{N} points {ms['msm_sharded']:.3f} (host encoding and decoding "
        f"included), equal to the native host MSM; one set of 2^16 "
        f"Montgomery coefficients on a built context (the commits' call) "
        f"{ms['msm_many_mont_mesh']:.3f} over the mesh, "
        f"{ms['msm_many_mont_one_device']:.3f} on one device; forest of "
        f"4^{MERKLE_HEIGHT} leaves over {MESH_SHARDS} shards "
        f"{ms['forest']:.3f} (merkle_tree_levels {ms['levels_one_device']:.3f}"
        f"), the same root")

    for shards in DRYRUN_MESH_SHARDS:
        t0 = time.perf_counter()
        dryrun.dryrun_multichip(Mesh([dev] * shards))
        log(f"dryrun_multichip on {shards} logical shards of {dev}: forest, "
            f"msm_sharded, DistributedDomain and the mesh prove equal to "
            f"tests/fixtures/dryrun_proof_v1.bin, verified "
            f"({time.perf_counter() - t0:.3f} s)")
    meshes = [str(mesh)] + [f"{s} logical shards of {dev}"
                            for s in DRYRUN_MESH_SHARDS]
    if torch.cuda.device_count() >= 2:
        cards = Mesh([f"cuda:{i}" for i in range(torch.cuda.device_count())])
        wall, blob, _ = mesh_prove(prover, circuit, cards)
        check(blob, "multi-card mesh")
        dryrun.dryrun_multichip(cards)
        log(f"mesh prove over the cards {cards}: {wall:.3f} s, equal to the "
            f"single-device proof; dryrun_multichip passed")
        meshes.append(str(cards))
    log(f"meshes that ran: {meshes}; the mesh phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    require_launched(launches, ("padd", "window_fold", "mont_mul",
                                "carry_fold", "field_addsub",
                                "hades_permute"), "mesh path")
    out["launches"] = launches
    return out


def service_batch(args: list[str]) -> float:
    """One `batch` call of the service's CLI: its wall s."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = service_cli.main(["batch", *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(out.getvalue().strip())
    if rc != 0:
        raise AssertionError(f"the service's batch returned {rc}: "
                             f"{out.getvalue()!r}")
    return wall


def service_verify(work: Path, proof: str, pis: str) -> tuple[int, float]:
    """One `verify` call of the service's CLI on files under `work`, which
    holds the verifier file: (exit code, ms)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = service_cli.main(["verify", "--proof", str(work / proof),
                               "--public-inputs", str(work / pis),
                               "--verifier", str(work / "verifier.bin")])
    return rc, (time.perf_counter() - t0) * 1e3


def phase_service(dev, root: Path) -> dict:
    """The batch Merkle-membership service at full width through its CLI:
    make-input of 32 leaves of a height-17 tree, two bad leaves appended
    (a leaf that is not the opened one, an opening of another tree), then
    `batch --capacity 15 --height 17 --device cuda` twice into fresh
    directories: the first compiles and writes the cache (the counted
    region `service`), the second loads it; both prove the 32 good leaves
    and write the same 64 files byte for byte.  `verify` accepts every
    proof and refuses one with a changed public-input byte."""
    work = root / "zkvm_tpu_torch" / "build" / "service_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    merkle = work / "merkle_some.bin"
    if service_cli.main(["make-input", "--leaves", str(SERVICE_LEAVES),
                         "--height", str(SERVICE_HEIGHT),
                         "--out", str(merkle)]) != 0:
        raise AssertionError("make-input failed")
    data = MultipleLeavesData.from_rkyv_bytes(merkle.read_bytes())
    other = PoseidonTree(SERVICE_HEIGHT)
    other.insert(0, Item(Fr(5000), None))
    data.leaves_info += [
        LeafInfo(0, Fr(4242).to_bytes(), data.leaves_info[0].proof_bytes),
        LeafInfo(0, Fr(5000).to_bytes(), other.opening(0).to_var_bytes())]
    merkle.write_bytes(data.to_rkyv_bytes())
    common = ["--input", str(merkle),
              "--circuit-cache", str(work / "circuit_prove.bin"),
              "--verifier-file", str(work / "verifier.bin"),
              "--capacity", str(SERVICE_CAPACITY),
              "--height", str(SERVICE_HEIGHT), "--device", dev.type]
    runs = []
    for run in ("run1", "run2"):
        metrics.GLOBAL.reset()
        torch.cuda.reset_peak_memory_stats()
        if run == "run1":
            kernels.reset_launches()
        # ---- main path (run1): the first batch, which compiles ----
        wall = service_batch(common + ["--out", str(work / run)])
        if run == "run1":
            launches = dict(kernels.LAUNCHES)
        # ---- end of main path ----
        report = metrics.report()
        spans = {k.split("/", 1)[1]: v for k, v in report.items()
                 if k.startswith("service/") and k.count("/") == 1}
        files = {p.name: p.read_bytes()
                 for p in sorted((work / run).iterdir())}
        proven = spans["first_prove"]["count"] + spans["prove"]["count"]
        runs.append(dict(proven=proven, wall=wall, spans=spans,
                         prove_spans={
                             k[len("service/prove/"):]: v
                             for k, v in report.items()
                             if k.startswith("service/prove/")},
                         files=files,
                         peak_gib=torch.cuda.max_memory_allocated()
                         / 2**30))
        if proven != SERVICE_LEAVES or len(files) != 2 * SERVICE_LEAVES:
            raise AssertionError(f"{run}: {proven} leaves proven, "
                                 f"{len(files)} files written")
    if runs[1]["files"] != runs[0]["files"]:
        raise AssertionError("the cached prover's files differ from the "
                             "compiled prover's")
    if ("compile" not in runs[0]["spans"]
            or "cache_load" not in runs[1]["spans"]):
        raise AssertionError("the first run did not compile or the second "
                             "did not load the cache")

    card = card_line()
    cache_bytes = (work / "circuit_prove.bin").stat().st_size
    sp0, sp1 = runs[0]["spans"], runs[1]["spans"]
    log(f"service-h17 ({card}): {SERVICE_LEAVES} of "
        f"{len(data.leaves_info)} leaves proven in each run, height "
        f"{SERVICE_HEIGHT}, capacity 2^{SERVICE_CAPACITY}; the second run's "
        f"{2 * SERVICE_LEAVES} proof and public-input files (from the "
        f"cache) byte-identical to the first run's")
    log(f"service-h17 ({card}): setup 2^{SERVICE_CAPACITY} "
        f"{sp0['setup']['total_s']:.3f} s, compile "
        f"{sp0['compile']['total_s']:.3f} s; cache file {cache_bytes} bytes, "
        f"write {sp0['cache_write']['total_s']:.3f} s, load "
        f"(Prover.try_from_bytes + Verifier) "
        f"{sp1['cache_load']['total_s']:.3f} s")
    for i, r in enumerate(runs):
        sp = r["spans"]
        n = sp["prove"]["count"]
        load = sum(sp[k]["total_s"] for k in ("setup", "compile",
                                              "cache_write", "cache_load")
                   if k in sp)
        log(f"service-h17 run {i + 1} ({card}): wall {r['wall']:.3f} s, "
            f"circuit {'compile' if i == 0 else 'load'} {load:.3f} s; first "
            f"leaf's prove {sp['first_prove']['total_s']:.3f} s, mean warm "
            f"prove {sp['prove']['total_s'] / n:.4f} s a leaf ({n} leaves), "
            f"{r['proven'] / (r['wall'] - load):.3f} leaves/s over the "
            f"batch, verify in the batch "
            f"{sp['verify']['total_s'] / sp['verify']['count'] * 1e3:.2f} "
            f"ms; peak device memory {r['peak_gib']:.3f} GiB")

    log(f"service-h17 run 2 ({card}), spans averaged over its "
        f"{runs[1]['spans']['prove']['count']} warm proves: "
        + "; ".join(f"{k} {v['total_s'] / v['count']:.4f} s"
                    for k, v in runs[1]["prove_spans"].items()))

    verify_ms = []
    for i in range(1, SERVICE_LEAVES + 1):
        rc, ms = service_verify(work, f"run2/plonk_proof_{i}.bin",
                                f"run2/plonk_publicinputs_{i}.bin")
        if rc != 0:
            raise AssertionError(f"verify refused proof {i}")
        verify_ms.append(ms)
    changed = bytearray(runs[1]["files"]["plonk_publicinputs_1.bin"])
    changed[0] ^= 1
    (work / "changed.bin").write_bytes(bytes(changed))
    rc, _ = service_verify(work, "run2/plonk_proof_1.bin", "changed.bin")
    if rc != 1:
        raise AssertionError(f"verify returned {rc} on a changed public "
                             f"input")
    log(f"service-h17 ({card}): CLI verify 0 on all {SERVICE_LEAVES} "
        f"proofs, mean {sum(verify_ms) / len(verify_ms):.1f} ms a call (the "
        f"verifier file read and parsed each time), 1 on a changed public "
        f"input byte")
    log(f"launches of the first service run (compile + {SERVICE_LEAVES} "
        f"proves): {launches}")
    require_launched(launches, ("mont_mul", "mont_pow", "padd",
                                "window_fold", "carry_fold", "field_addsub"),
                     "service run")
    shutil.rmtree(work)
    return {"launches": launches}


def phase_benches(dev) -> None:
    """The device rows of the benches (`utils/benches.py`) once, on the
    card: every value finite and positive; the poseidon row launches
    hades_permute."""
    card = card_line()
    log(f"benches ({card}): run_all(only={list(BENCH_ROWS)})")
    kernels.reset_launches()
    rows = benches.run_all(only=BENCH_ROWS, device=dev.type)
    launches = dict(kernels.LAUNCHES)
    for row in rows:
        if not (math.isfinite(row["value"]) and row["value"] > 0):
            raise AssertionError(f"bench row {row} is not finite and "
                                 f"positive")
    if len(rows) != 1 + 3 + 3 + 5:
        raise AssertionError(f"{len(rows)} bench rows")
    log(f"benches: {len(rows)} rows finite and positive; launches {launches}")
    require_launched(launches, ("hades_permute",), "poseidon bench row")


def device_rows(prof) -> list[tuple[str, float, int]]:
    """(name, device microseconds, count) of every kernel and copy that
    ran on the card under `prof`, largest first."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (e.self_device_time_total if hasattr(e, "self_device_time_total")
              else e.self_cuda_time_total)
        rows.append((e.key, float(us), e.count))
    return sorted(rows, key=lambda r: -r[1])


def profiled(label: str, fn, top: int = 10,
             reps: int = 1) -> list[tuple[str, float, int]]:
    """`reps` warm calls of fn() under torch.profiler: wall time, device
    busy time and idle share, and the largest device items by name (a
    window of one short launch can come back empty, so the checks of what
    runs beside one kernel take a few)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    log(f"profile {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, us, count in rows[:top]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
            f"x{count:<5d} {name[:90]}")
    return rows


def phase_profile(rng, dev, ck, ok) -> None:
    """`--profile`: where the device time goes (torch.profiler) on one warm
    polynomial path, on one 2^19 x 4 coset fft by each route and on the
    level-wise tree build, and each
    kernel's device time per launch at the slice's shapes (its CUDA-event
    time above includes the wrapper's enqueue time, which exceeds the
    short kernels')."""
    evals = lf.u32_to_tensor(rand_field(FR, (4, 8, N), rng), dev)
    z, v = Fr(0x1234567 << 100 | 5), Fr(0x7654321 << 90 | 7)
    profiled("polynomial path 2^16 / 2^19",
             lambda: poly_path(ck, ok, evals, SEED + 2, z, v), top=16)
    dom8 = ntt.Domain(N8)
    x = lf.u32_to_tensor(rand_field(FR, (4, 8, N8), rng), dev)
    profiled("coset_fft 2^19 x 4, matmul route",
             lambda: dom8.coset_fft_device(x))
    profiled("coset_fft 2^19 x 4, butterfly route",
             lambda: ntt.butterfly_transform(
                 dom8, ntt._scale(x, dom8._factor("coset", dev))))
    del x

    def field(spec, shape):
        return lf.u32_to_tensor(rand_field(spec, shape, rng), dev)

    a, b = field(FQ, (12, N + 7)), field(FQ, (12, N + 7))
    p = tuple(field(FQ, (24, 12, N // 2)) for _ in range(3))
    q = tuple(field(FQ, (24, 12, N // 2)) for _ in range(3))
    e, o, w = (field(FR, (8, N // 2)) for _ in range(3))
    e8, o8, w8 = (field(FR, (8, N8 // 2)) for _ in range(3))
    d1 = torch.from_numpy(byte_columns(rng, N)).to(dev)
    d4 = torch.from_numpy(byte_columns(rng, 4 * N8)).to(dev)
    fv = field(FR, (8, N))
    fv = torch.cat([fv, fv, fv[:1]])  # [17, 2^16] words

    # the level-wise tree build at 4^10 leaves: the permutation against the
    # glue (permuted copy of the children, concatenation with the tag row)
    leaves10 = field(FR, (8, 4 ** MERKLE_HEIGHT))
    profiled(f"merkle_tree_levels, height {MERKLE_HEIGHT}",
             lambda: poseidon.merkle_tree_levels(leaves10))
    st = field(FR, (5, 8, HADES_LANES))
    st_small = field(FR, (5, 8, 4096))
    consts = poseidon.hades_consts(dev)

    from torch.profiler import ProfilerActivity, profile

    for label, fn in (
            ("mont_mul Fq [12, 65543]", lambda: kernels.mont_mul(FQ, a, b)),
            ("mont_pow Fq [12, 65543], exponent q - 2",
             lambda: kernels.mont_pow(FQ, a, FQ.modulus - 2)),
            ("hades_permute [5, 8, 4096]",
             lambda: kernels.hades_permute(st_small, consts)),
            ("padd [24, 12, 32768]", lambda: kernels.padd(p, q)),
            ("padd_ilp [24, 12, 32768]", lambda: kernels.padd_ilp(p, q)),
            (f"hades_permute [5, 8, {HADES_LANES}]",
             lambda: kernels.hades_permute(st, consts)),
            ("butterfly [8, 2^15]", lambda: kernels.butterfly(e, o, w)),
            ("butterfly [8, 2^18]", lambda: kernels.butterfly(e8, o8, w8)),
            ("carry_fold [68, 2^16]", lambda: kernels.carry_fold(d1)),
            ("carry_fold [68, 2^21]", lambda: kernels.carry_fold(d4)),
            ("fold [17, 2^16]", lambda: kernels.fold(fv))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        name, us, count = next(r for r in device_rows(prof)
                               if "_kernel" in r[0])
        log(f"  device time per launch, {label}: {us / count / 1e3:.5f} ms "
            f"(x{count}, {name[:60]})")


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
    entry = ""
    for line in kernels.BUILD_LOG.splitlines():
        found = re.search(r"\d([a-z_]+_kernel)(?:IN2zk2(F[rq]))?", line)
        if found:
            entry = found.group(1) + (f"<{found.group(2)}>" if found.group(2)
                                      else "")
        elif "registers" in line or "spill" in line:
            log(f"  {entry}: {line.split(':', 1)[-1].strip()}")

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)  # the home device of the meshes
    rec = phase_parity(rng, dev)
    phase_matmul_exact(dev)
    sl = phase_slice(rng, dev)
    phase_commit_breakdown(sl["commit_key"], sl["mont"])
    po = phase_poly(rng, dev, sl["commit_key"], sl["opening_key"])
    me = phase_merkle(rng, dev)
    pc = phase_padd_comparison(sl["commit_key"])
    phase_times(rng, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(rng, dev, sl["commit_key"], sl["opening_key"])
    phase_prove_dryrun(dev)
    fl = phase_prove_flagship(dev)
    mh = phase_mesh(rng, dev, fl)
    sv = phase_service(dev, Path(__file__).resolve().parent)
    phase_benches(dev)

    # launches: the sum of the counted regions, each also given apart; no
    # single PyTorch call computes any of the ten functions (a Montgomery
    # product or power on limbs, a curve addition, a permutation over Fr, a
    # modular addition on limbs), so there is no library time
    regions = dict(zip(REGIONS, (sl["launches"], po["launches"],
                                 po["crosscheck"], me["launches"],
                                 pc["launches"], fl["launches"],
                                 mh["launches"], sv["launches"])))
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": sum(r[name] for r in regions.values()),
         **{f"launches_{region}": r[name] for region, r in regions.items()},
         "max_abs_err": rec[name]["max_abs_err"], "ms": rec[name]["ms"],
         "plain_ms": rec[name]["plain_ms"],
         "bound_ms": rec[name]["bound_ms"],
         "bound_by": rec[name]["bound_by"], "library_ms": None,
         **{k: v for k, v in rec[name].items()
            if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by")}} for name in KERNELS]}
    for k in record["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was launched on no path")
    log(json.dumps(record))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
