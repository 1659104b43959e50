"""Sweep the launch bounds and the pairing of the quotient kernel on the
card.

    python3 -m zkvm_tpu_torch.tools.quotient_bounds

`csrc/quotient.cu` runs a lane on two threads and fixes three constants:
its block size, the blocks an SM, and the bit of the thread index in which
the two threads of a pair differ (5: warps w and w + 1; 4: threads t and t
+ 16 of a warp; 0: neighbouring threads).  The block count caps the
registers a thread may take (65,536 over the threads an SM: 128 at four
blocks of 128 threads, 96 at five, 80 at six), and what does not fit
spills.  This script builds a copy of that source for each
candidate (the constants replaced in the text, nothing else), one nvcc
each, all started together; prints what `ptxas -v` says of each and its
count of machine instructions (`cuobjdump -sass`); holds
each against the plain version bit for bit; and times them in turns at the
flagship's [8, 2^19] x 28 operands.  The candidate the source carries (the
first) should be the fastest printed here.  At the source's constants it
also builds the kernel with its product inlined (`stmt::product` not a
call), the design whose code outgrew the instruction cache.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import kernels
from ..ops import limb_field as lf
from ..ops import quotient_kernel as qk
from ..ops.limb_field import FR
from . import card

# (threads, blocks an SM, pair bit): the source's first
CONSTANTS = ("kThreads", "kBlocksPerSm", "kPairBit")
BOUNDS = ((128, 4, 5), (128, 5, 5), (128, 6, 5), (64, 8, 5), (64, 6, 5),
          (128, 4, 4), (128, 4, 0))
CALL = "__device__ __noinline__ Word8 product("
LANES = 1 << 19
REPS = 10


def variant(*values: int) -> str:
    """The text of quotient.cu with these values of CONSTANTS."""
    src = (kernels.CSRC / "quotient.cu").read_text()
    for name, value in zip(CONSTANTS, values, strict=True):
        src, n = re.subn(r"constexpr int %s = \d+;" % name,
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"quotient.cu no longer names {name}")
    return src


def tag(values) -> str:
    """A file name for a candidate: its constants, and `inlined` for the
    variant with its product inlined."""
    name = "_".join(f"{n}{v}" for n, v in zip(CONSTANTS, values))
    return name + ("_inlined" if len(values) > len(CONSTANTS) else "")


def build_all(sources: dict) -> dict:
    """{tag: (`zk_quotient` of that source text, what ptxas -v says of it)},
    one nvcc for each source, all started together."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src in sources.items():
        cu = kernels.BUILD_DIR / f"quotient_{tag}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[tag] = (so, subprocess.Popen(
            [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-shared", "-I", str(kernels.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        usage = "; ".join(line.split(":", 1)[-1].strip()
                          for line in log.splitlines()
                          if "registers" in line or "spill" in line)
        sass = subprocess.run(
            [str(Path(kernels._nvcc()).parent / "cuobjdump"), "-sass",
             str(so)], capture_output=True, text=True).stdout
        usage += (f"; {len(re.findall(r'/[*][0-9a-f]{4,}[*]/ +[A-Z@]', sass))}"
                  " instructions")
        fn = ctypes.CDLL(str(so)).zk_quotient
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[tag] = (fn, usage)
    return built


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
    print(card())
    rng = np.random.default_rng(12)
    ops, table = operands(LANES, rng)
    want = kernels.quotient_plain(ops, table)
    sources = {tag(b): variant(*b) for b in BOUNDS}
    if sources[tag(BOUNDS[0])].count(CALL) != 1:
        raise RuntimeError("quotient.cu no longer calls its product")
    inlined = BOUNDS[0] + ("product inlined",)
    sources[tag(inlined)] = sources[tag(BOUNDS[0])].replace(
        CALL, "__device__ __forceinline__ Word8 product(")
    built = build_all(sources)
    runs = {}
    for bounds in BOUNDS + (inlined,):
        fn, usage = built[tag(bounds)]
        got = launcher(fn, ops, table)()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{bounds}: disagrees with the plain version")
        runs[bounds] = (launcher(fn, ops, table), usage)
    ms = {b: device_ms(run) for b, (run, _) in runs.items()}
    for b in reversed(runs):  # in turns: forwards, then backwards
        ms[b] = (ms[b] + device_ms(runs[b][0])) / 2
    bound = kernels.quotient_multiply_adds() * LANES / (33.5e12 / 2) * 1e3
    for b in runs:
        print(f"quotient {b[0]} threads x {b[1]} blocks an SM, pair bit "
              f"{b[2]}{', ' + b[3] if len(b) > 3 else ''}: {ms[b]:.4f} ms "
              f"at [8, {LANES}] x {len(ops)} "
              f"({bound / ms[b]:.3f} of the {bound:.4f} ms bound by "
              f"operations); {runs[b][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
