"""Sweep the dispatch constant and the launch bounds of the Hades kernels on
the card.

    python3 -m zkvm_tpu_torch.tools.hades_dispatch

`csrc/hades.cu` holds two kernels behind `zk_hades_permute`: five threads a
permutation up to `kCoopMaxLanes` lanes, one thread a lane above, and fixes
the one-thread kernel's block size and blocks an SM as two constants.  This
script builds copies of that source with the constants replaced in the text
(nothing else) -- one that always takes the five-thread kernel, and one that
never does for each candidate pair of launch bounds -- all at once, prints
what `ptxas -v` says of each, holds each against the plain version bit for
bit and times them in turns: both kernels at a ladder of lane counts (the
crossover is where the one-thread kernel starts to win: `kCoopMaxLanes`
should be the last count before it), and the launch bounds at 2^18 and 2^22
lanes (the pair the source carries should be the fastest one printed).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import kernels, poseidon
from ..ops import limb_field as lf
from ..ops.limb_field import FR
from . import card
from .padd_launch_bounds import device_ms

# threads, blocks an SM
BOUNDS = ((128, 4), (128, 3), (128, 2), (256, 2), (256, 1), (64, 4))
LADDER = (1, 341, 1024, 4096, 8192, 10240, 12288, 14336, 16384, 24576, 32768,
          65536)
BOUNDS_LANES = (1 << 18, 1 << 22)
IN_SOURCE = (128, 2)   # the pair csrc/hades.cu carries
ALWAYS, NEVER = 1 << 40, 0


def start_build(tag: str, threads: int, blocks: int, coop_max: int):
    """Start nvcc on a copy of hades.cu with these constants."""
    src = (kernels.CSRC / "hades.cu").read_text()
    for name, value in (("THREADS", threads), ("BLOCKS_PER_SM", blocks)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"hades.cu no longer names {name}")
    src, n = re.subn(r"constexpr long long kCoopMaxLanes = \d+;",
                     f"constexpr long long kCoopMaxLanes = {coop_max}LL;", src)
    if n != 1:
        raise RuntimeError("hades.cu no longer names kCoopMaxLanes")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD_DIR / f"hades_{tag}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.Popen(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-shared", "-I", str(kernels.CSRC), "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish_build(proc, so):
    """`zk_hades_permute` of a finished build, and its kernels' usage."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    usage, name = [], ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\w*?(hades\w*kernel)",
                          line)
        if found:
            name = found.group(1)
        elif "registers" in line or "spill" in line:
            usage.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    fn = ctypes.CDLL(str(so)).zk_hades_permute
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, usage


def launcher(fn, state, consts):
    out = torch.empty_like(state)
    args = (state.data_ptr(), consts.data_ptr(), out.data_ptr(),
            state.shape[-1], torch.cuda.current_stream().cuda_stream)

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"zk_hades_permute launch failed ({rc})")
        return out

    return run


def states(lanes: int, rng) -> torch.Tensor:
    a = rng.integers(0, 1 << 32, size=(5, 8, lanes), dtype=np.uint64).astype(
        np.uint32)
    a[:, -1, :] = rng.integers(0, int(FR.p_limbs[-1]), size=(5, lanes))
    return lf.u32_to_tensor(a, "cuda")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("hades_dispatch: needs an NVIDIA GPU")
    print(card())
    builds = {("coop",): start_build("coop", 128, 3, ALWAYS)}
    for threads, blocks in BOUNDS:
        builds[(threads, blocks)] = start_build(f"{threads}x{blocks}",
                                                threads, blocks, NEVER)
    fns = {}
    for key, (proc, so) in builds.items():
        fns[key], usage = finish_build(proc, so)
        for line in usage:
            if ("coop" in line) == (key == ("coop",)):
                print(f"{key}: {line}")

    rng = np.random.default_rng(5)
    consts = poseidon.hades_consts(torch.device("cuda"))
    small = states(259, rng)
    want = kernels.hades_permute_plain(small, consts)
    for key, fn in fns.items():
        got = launcher(fn, small, consts)()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{key}: disagrees with the plain version")

    # the crossover: five threads a permutation against one, in turns
    serial = fns[IN_SOURCE]
    for lanes in LADDER:
        st = states(lanes, rng)
        runs = (launcher(fns[("coop",)], st, consts),
                launcher(serial, st, consts))
        c1, s1 = (device_ms(r) for r in runs)
        s2, c2 = (device_ms(r) for r in reversed(runs))
        print(f"hades at {lanes} lanes: five threads a permutation "
              f"{(c1 + c2) / 2:.4f} ms, one thread a lane "
              f"{(s1 + s2) / 2:.4f} ms")

    # the one-thread kernel's launch bounds, in turns
    for lanes in BOUNDS_LANES:
        st = states(lanes, rng)
        runs = {b: launcher(fns[b], st, consts) for b in BOUNDS}
        ms = {b: device_ms(run) for b, run in runs.items()}
        for b in reversed(BOUNDS):
            ms[b] = (ms[b] + device_ms(runs[b])) / 2
        for b in BOUNDS:
            print(f"hades one thread a lane, {b[0]} threads x {b[1]} blocks "
                  f"an SM: {ms[b]:.4f} ms at {lanes} lanes")
        del st, runs
    return 0


if __name__ == "__main__":
    sys.exit(main())
