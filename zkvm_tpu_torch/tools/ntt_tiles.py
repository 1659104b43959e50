"""Sweep the tiles and launch bounds of the ntt_stages kernel on the card.

    python3 -m zkvm_tpu_torch.tools.ntt_tiles

`csrc/ntt.cu` fixes its block size and blocks an SM as two constants, and
`kernels.ntt_log_tile` the tile of each transform (2^9 or 2^10 Fr
elements).  This script builds a copy of that source for each candidate
(threads, blocks an SM, tile: the two constants replaced in the text, the
plan's tile given to `kernels.ntt_plan`), prints what `ptxas -v` says of
each, holds each against the plain version bit for bit and times them in
turns at the prover's transform shapes and at 2^20.  At each shape the
tile `kernels.ntt_log_tile` picks, under the constants the source carries,
should be the fastest printed.  Then it times each pass of that plan
alone.

It also appends a probe to the first copy: the kernel's own four
butterflies of a stage pair, repeated on registers with no tile, no
barrier and no twiddle load, at the occupancy of the source's constants
(four blocks of 128 threads an SM).  Its share of the
multiply-add bound is what the arithmetic alone reaches; the kernel's share
beside it says what the passes around it cost.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import kernels, ntt
from ..ops import limb_field as lf
from ..ops.limb_field import FR
from . import card

# threads, blocks an SM, tile (log2 of its Fr elements); each fits the SM's
# 227 KB of shared memory and 64 K registers at 128 a thread
CANDIDATES = ((128, 4, 9), (128, 4, 10), (256, 2, 11), (512, 1, 12))
SHAPES = ((4, 19), (1, 19), (7, 19), (1, 16), (4, 16), (15, 16), (1, 20),
          (4, 20))
REPS = 10
PROBE_ITERS = 200

# the probe: every thread walks PROBE_ITERS stage pairs of one quad on
# registers (values below r: the top word masked), then stores one word
PROBE = r"""
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
butterfly_rate_kernel(uint32_t* out, int iters) {
  uint32_t x[4][N], w[3][N];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int l = 0; l < N; ++l)
      x[m][l] = (threadIdx.x * 7 + m * 3 + l) & (l == N - 1 ? 0xffffu : ~0u);
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int l = 0; l < N; ++l)
      w[m][l] = (blockIdx.x * 5 + m + l * 11) & (l == N - 1 ? 0xffffu : ~0u);
  for (int it = 0; it < iters; ++it) {
    butterfly(x[0], x[1], w[0]);
    butterfly(x[2], x[3], w[0]);
    butterfly(x[0], x[2], w[1]);
    butterfly(x[1], x[3], w[2]);
  }
  uint32_t acc = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int l = 0; l < N; ++l) acc ^= x[m][l];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
}  // namespace
extern "C" int zk_butterfly_rate(void* out, int blocks, int iters) {
  butterfly_rate_kernel<<<blocks, kMaxThreads>>>((uint32_t*)out, iters);
  return (int)cudaGetLastError();
}
namespace {
"""


def build_with(threads: int, blocks: int, probe: bool = False):
    """`zk_ntt_pass` of a copy of ntt.cu with these launch bounds (and the
    probe's entry, `zk_butterfly_rate`, appended where asked)."""
    src = (kernels.CSRC / "ntt.cu").read_text()
    src, n1 = re.subn(r"constexpr int kMaxThreads = \d+;",
                      f"constexpr int kMaxThreads = {threads};", src)
    src, n2 = re.subn(r"constexpr int kBlocksPerSm = \d+;",
                      f"constexpr int kBlocksPerSm = {blocks};", src)
    if (n1, n2) != (1, 1):
        raise RuntimeError("ntt.cu no longer names its two constants")
    if probe:
        at = src.index("}  // namespace")
        src = src[:at] + PROBE + src[at:]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD_DIR / f"ntt_{threads}x{blocks}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    r = subprocess.run(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-shared", "-I", str(kernels.CSRC), "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    usage = "; ".join(line.split(":", 1)[-1].strip()
                      for line in (r.stdout + r.stderr).splitlines()
                      if "registers" in line or "spill" in line)
    lib = ctypes.CDLL(str(so))
    fn = lib.zk_ntt_pass
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if probe:
        lib.zk_butterfly_rate.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
        lib.zk_butterfly_rate.restype = ctypes.c_int
        return fn, usage, lib.zk_butterfly_rate
    return fn, usage


def launcher(fn, log_tile: int, x, tw, only=None):
    """A call that transforms the contiguous [rows, 8, n] x by `fn`, over
    the passes of `kernels.ntt_plan` for tiles of 2^log_tile (or only its
    pass `only`, which a later pass runs in place on the last output)."""
    rows, _, n = x.shape
    log_n = n.bit_length() - 1
    plan = kernels.ntt_plan(log_n, log_tile)
    steps = plan if only is None else plan[only:only + 1]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        for s0, k, c in steps:
            rc = fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(), rows,
                    log_n, s0, k, c, stream)
            if rc != 0:
                raise RuntimeError(f"zk_ntt_pass launch failed ({rc})")
        return out

    return run, len(plan)


def device_ms(run) -> float:
    """Mean device time over REPS calls enqueued while the card spins."""
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(REPS):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def probe_rate(rate, cand) -> None:
    """Time the probe at the candidate's occupancy and print its share of
    the bound (`chip_smoke.bound`'s rate: 272 multiply-adds a product at
    16.75 T/s)."""
    threads, per_sm, _ = cand
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * per_sm
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")

    def run():
        if rate(out.data_ptr(), blocks, PROBE_ITERS) != 0:
            raise RuntimeError("zk_butterfly_rate launch failed")

    ms = device_ms(run)
    products = blocks * threads * PROBE_ITERS * 4
    bound_ms = products * 272 / (33.5e12 / 2) * 1e3
    print(f"butterflies on registers alone ({threads} threads x {per_sm} "
          f"blocks an SM, {sms} SMs): {products} in {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_ms / ms:.3f} of it)")


def field(shape, rng):
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    a[..., -1, :] = rng.integers(0, int(FR.p_limbs[-1]),
                                 size=a[..., -1, :].shape)
    return lf.u32_to_tensor(a, "cuda")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ntt_tiles: needs an NVIDIA GPU")
    print(card())
    rng = np.random.default_rng(5)
    small = field((3, 8, 1 << 13), rng)
    small_tw = ntt.Domain(1 << 13)._butterfly_tables(torch.device("cuda"))[0]
    want = kernels.ntt_stages_plain(small, small_tw)
    inputs = {}
    for rows, log_n in SHAPES:
        tw = ntt.Domain(1 << log_n)._butterfly_tables(torch.device("cuda"))[0]
        inputs[rows, log_n] = (field((rows, 8, 1 << log_n), rng), tw)
    built = {}
    fn, _, rate = build_with(*CANDIDATES[0][:2], probe=True)
    probe_rate(rate, CANDIDATES[0])
    for cand in CANDIDATES:
        fn, usage = build_with(*cand[:2])
        got = launcher(fn, cand[2], small, small_tw)[0]()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{cand}: disagrees with the plain version")
        built[cand] = (fn, usage)
    for shape, (x, tw) in inputs.items():
        runs = {c: launcher(built[c][0], c[2], x, tw) for c in CANDIDATES}
        first = runs[CANDIDATES[0]][0]()
        for c, (run, _) in runs.items():
            if not torch.equal(run(), first):
                raise AssertionError(f"{c}: disagrees at {shape}")
        ms = {c: device_ms(run) for c, (run, _) in runs.items()}
        for c in reversed(CANDIDATES):  # in turns: forwards, then backwards
            ms[c] = (ms[c] + device_ms(runs[c][0])) / 2
        print(f"ntt_stages [{shape[0]}, 8, 2^{shape[1]}] (the source's tile "
              f"2^{kernels.ntt_log_tile(shape[1])}): " + "; ".join(
                  f"{c[0]} threads x {c[1]} blocks, tile 2^{c[2]} "
                  f"({runs[c][1]} passes) {ms[c]:.4f} ms"
                  for c in CANDIDATES))
    # each pass of the source's plan alone, under the source's constants
    fn = built[CANDIDATES[0]][0]
    for (rows, log_n), (x, tw) in inputs.items():
        log_tile = kernels.ntt_log_tile(log_n)
        plan = kernels.ntt_plan(log_n, log_tile)
        times = []
        for i in range(len(plan)):
            run = launcher(fn, log_tile, x, tw, only=i)[0]
            launcher(fn, log_tile, x, tw)[0]()  # the output the pass reads
            times.append(device_ms(run))
        print(f"ntt_stages [{rows}, 8, 2^{log_n}], each pass alone: "
              + "; ".join(f"stages {s0}-{s0 + k - 1}, 2^{c} columns "
                          f"{ms:.4f} ms" for (s0, k, c), ms in zip(plan,
                                                                  times)))
    for c in CANDIDATES:
        print(f"ptxas {c[0]} x {c[1]}: {built[c][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
