"""Sweep the launch bounds of the padd kernel on the card.

    python3 -m zkvm_tpu_torch.tools.padd_launch_bounds

`csrc/padd.cu` fixes its block size and blocks an SM as two constants.  This
script builds a copy of that source for each candidate pair (the constants
replaced in the text, nothing else), prints what `ptxas -v` says of each,
holds each against the plain version bit for bit and times them in turns at
[24, 12, 32768], the first halving-tree level of one 2^16 commitment.  The
pair the source carries should be the fastest one printed here.
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
from ..ops.limb_field import FQ
from . import card

BOUNDS = ((128, 4), (128, 3), (128, 2), (256, 2))  # threads, blocks an SM
SHAPE = (24, 12, 32768)
REPS = 10


def build_with(threads: int, blocks: int):
    """`zk_padd` of a copy of padd.cu with these launch bounds."""
    src = (kernels.CSRC / "padd.cu").read_text()
    src, n1 = re.subn(r"constexpr int THREADS = \d+;",
                      f"constexpr int THREADS = {threads};", src)
    src, n2 = re.subn(r"constexpr int BLOCKS_PER_SM = \d+;",
                      f"constexpr int BLOCKS_PER_SM = {blocks};", src)
    if (n1, n2) != (1, 1):
        raise RuntimeError("padd.cu no longer names its two constants")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD_DIR / f"padd_{threads}x{blocks}.cu"
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
    fn = ctypes.CDLL(str(so)).zk_padd
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, usage


def launcher(fn, p, q):
    """A call that adds the contiguous batches p and q by `fn`."""
    groups, _, lanes = p[0].shape
    out = tuple(torch.empty_like(t) for t in p)
    strides = (ctypes.c_longlong * 6)(*(2 * (12 * lanes, lanes, 1)))
    ptrs = [t.data_ptr() for t in (*p, *q, *out)]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(*ptrs, groups, lanes, strides, stream)
        if rc != 0:
            raise RuntimeError(f"zk_padd launch failed ({rc})")
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


def field(shape, rng):
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    a[..., -1, :] = rng.integers(0, int(FQ.p_limbs[-1]),
                                 size=a[..., -1, :].shape)
    return lf.u32_to_tensor(a, "cuda")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("padd_launch_bounds: needs an NVIDIA GPU")
    print(card())
    rng = np.random.default_rng(4)
    small = [tuple(field((2, 12, 515), rng) for _ in range(3))
             for _ in range(2)]
    want = kernels.padd_plain(*small)
    p, q = (tuple(field(SHAPE, rng) for _ in range(3)) for _ in range(2))
    runs = {}
    for bounds in BOUNDS:
        fn, usage = build_with(*bounds)
        got = launcher(fn, *small)()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{bounds}: disagrees with the plain version")
        runs[bounds] = (launcher(fn, p, q), usage)
    ms = {b: device_ms(run) for b, (run, _) in runs.items()}
    for b in reversed(BOUNDS):  # in turns: forwards, then backwards
        ms[b] = (ms[b] + device_ms(runs[b][0])) / 2
    for b in BOUNDS:
        print(f"padd {b[0]} threads x {b[1]} blocks an SM: {ms[b]:.4f} ms at "
              f"{list(SHAPE)}; {runs[b][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
