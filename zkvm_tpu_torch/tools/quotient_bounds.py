"""Sweep the launch bounds of the quotient kernel on the card.

    python3 -m zkvm_tpu_torch.tools.quotient_bounds

`csrc/quotient.cu` fixes its block size and blocks an SM as two constants;
the block count caps the registers a thread may take (255 at two blocks of
128 threads, 168 at three, 128 at four), and what does not fit spills.
This script builds a copy of that source for each candidate pair (the
constants replaced in the text, nothing else), prints what `ptxas -v` says
of each, holds each against the plain version bit for bit and times them in
turns at the flagship's [8, 2^19] x 28 operands.  The pair the source
carries should be the fastest one printed here.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import kernels
from ..ops import limb_field as lf
from ..ops import quotient_kernel as qk
from ..ops.limb_field import FR

# (threads, blocks an SM)
BOUNDS = ((128, 2), (128, 3), (128, 4), (128, 5), (256, 2), (128, 6))
LANES = 1 << 19
REPS = 10


def build_with(threads: int, blocks: int):
    """`zk_quotient` of a copy of quotient.cu with these launch bounds."""
    src = (kernels.CSRC / "quotient.cu").read_text()
    src, n1 = re.subn(r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {threads};", src)
    src, n2 = re.subn(r"constexpr int kBlocksPerSm = \d+;",
                      f"constexpr int kBlocksPerSm = {blocks};", src)
    if (n1, n2) != (1, 1):
        raise RuntimeError("quotient.cu no longer names its two constants")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD_DIR / f"quotient_{threads}x{blocks}.cu"
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
    fn = ctypes.CDLL(str(so)).zk_quotient
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, usage


def launcher(fn, operands, table):
    """A call of `fn` on the operands (contiguous [8, L]) and the table."""
    lanes = operands[0].shape[-1]
    out = torch.empty((FR.n_limbs, lanes), dtype=torch.int32,
                      device=operands[0].device)
    count = len(operands)
    ptrs = (ctypes.c_void_p * count)(*(t.data_ptr() for t in operands))
    strides = (ctypes.c_longlong * count)(*(lanes,) * count)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(ptrs, strides, table.data_ptr(), out.data_ptr(), lanes,
                stream)
        if rc != 0:
            raise RuntimeError(f"zk_quotient launch failed ({rc})")
        return out

    return run


def device_ms(run) -> float:
    """Mean device time over REPS launches enqueued while the card spins."""
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


def operands(lanes: int, rng):
    """28 canonical [8, lanes] operands on the card and a seeded table."""
    ops = []
    for _ in kernels.QUOTIENT_OPERANDS:
        a = rng.integers(0, 1 << 32, size=(8, lanes), dtype=np.uint64).astype(
            np.uint32)
        a[-1] = rng.integers(0, int(FR.p_limbs[-1]), size=lanes)
        ops.append(lf.u32_to_tensor(a, "cuda"))
    chals = {n: int.from_bytes(rng.bytes(40), "little") % FR.modulus
             for n in qk.CHALLENGES}
    return ops, qk.challenge_table(chals, "cuda")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("quotient_bounds: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(12)
    ops, table = operands(LANES, rng)
    want = kernels.quotient_plain(ops, table)
    runs = {}
    for bounds in BOUNDS:
        fn, usage = build_with(*bounds)
        got = launcher(fn, ops, table)()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{bounds}: disagrees with the plain version")
        runs[bounds] = (launcher(fn, ops, table), usage)
    ms = {b: device_ms(run) for b, (run, _) in runs.items()}
    for b in reversed(BOUNDS):  # in turns: forwards, then backwards
        ms[b] = (ms[b] + device_ms(runs[b][0])) / 2
    bound = kernels.quotient_multiply_adds() * LANES / (33.5e12 / 2) * 1e3
    for b in BOUNDS:
        print(f"quotient {b[0]} threads x {b[1]} blocks an SM: {ms[b]:.4f} ms "
              f"at [8, {LANES}] x {len(ops)} ({bound / ms[b]:.3f} of the "
              f"{bound:.4f} ms bound by operations); {runs[b][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
