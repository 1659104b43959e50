"""The `msm_digits` kernel's plain version, its C++ run on the host, and the
pipeline built on it, on the CPU.

`kernels.msm_digits` does the integer work on both sides of the MSM's
bucket sort: pack mode turns canonical scalar limbs into one sort key a
signed radix-2^c digit, unpack mode turns the sorted keys into the (bucket,
sign, point index) that `msm_gather` reads.  On the CPU it runs its plain
version, the PyTorch composition the pipeline ran before the kernel.  These
tests hold the plain version against Python integers: the digits recompose
each scalar, stay within (-half, half], and each key decodes to its bucket,
sign and lane; dead lanes (digit 0, the point at infinity) take the
sentinel bucket.

The kernel's source is compiled by the host's C++ compiler, its launches
replaced by loops over the grid, and both modes run against the plain
version; the card runs them bit for bit in `tests/test_torch_kernels_gpu.py`.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from zkvm_tpu_torch import params
from zkvm_tpu_torch.ops import kernels, msm
from zkvm_tpu_torch.ops import limb_field as lf

torch.set_num_threads(1)

SOURCE = (Path(kernels.CSRC) / "msm_digits.cu").read_text()
R = params.FR_MODULUS
WIDTHS = [8, 10, 11, 12, 13]


def edge_values(c: int) -> list[int]:
    """0, 1, r - 1, half and half + 1 (the first value that wraps), and a
    run of ones up to the top window, so that the carry sweeps through every
    window to the last (to the last that holds a bit of a scalar below r at
    c = 8, where that run would pass r)."""
    half = 1 << (c - 1)
    top = c * (kernels.digit_windows(c) - 1)
    return [0, 1, R - 1, half, half + 1, min(1 << top, 1 << 254) - 1]


def scalars(c: int, sets: int, n: int, seed: int) -> list[list[int]]:
    """sets x n canonical scalars: the edge values, random values below r,
    and the last set's tail zero (the padding of a size class)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(sets):
        row = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        row[:6] = edge_values(c)
        out.append(row)
    out[-1][n - n // 4:] = [0] * (n // 4)
    return out


def limbs_of(vals: list[list[int]]) -> torch.Tensor:
    """[S, 8, N] canonical int32 limbs, as `MSMContext` makes them."""
    flat = [v for row in vals for v in row]
    raw = lf.FR.to_raw_array(flat, "cpu")
    return raw.reshape(8, len(vals), len(vals[0])).transpose(0, 1).contiguous()


def infinity(n: int, seed: int) -> torch.Tensor:
    """The points' infinity flags: a few random lanes, and lane 2 (r - 1)."""
    pinf = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.03)
    pinf[2] = True
    return pinf


# -----------------------------------------------------------------------------
# The plain version against Python integers
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("c", WIDTHS)
def test_digits_recompose_each_scalar(c):
    """`_signed_digit_tensors`, the plain version's first step: W rows of
    digits in (-half, half] whose sum d_w 2^(c w) is the scalar."""
    vals = scalars(c, 2, 64, c)
    d = msm._signed_digit_tensors(limbs_of(vals), c)
    half = 1 << (c - 1)
    assert d.dtype == torch.int32
    assert d.shape == (2, kernels.digit_windows(c), 64)
    assert int(d.max()) <= half and int(d.min()) > -half
    for s, row in enumerate(vals):
        for i, v in enumerate(row):
            assert sum(int(x) << (c * w) for w, x in enumerate(d[s, :, i])) \
                == v
    # the run of ones carries into the top window
    top = c * (kernels.digit_windows(c) - 1)
    if (1 << top) - 1 < R:
        assert int(d[0, -1, 5]) == 1


@pytest.mark.parametrize("c", WIDTHS)
def test_keys_decode_to_bucket_sign_and_lane(c):
    """Pack mode's keys [S*W, N]: key >> (idx_bits + 1) is the bucket (|d|,
    half + 1 where d = 0 or the point is at infinity), the next bit the
    sign, the low bits the lane."""
    n = 96
    vals = scalars(c, 3, n, 10 + c)
    limbs, pinf = limbs_of(vals), infinity(n, c)
    keys = kernels.msm_digits(limbs, pinf, c)
    d = msm._signed_digit_tensors(limbs, c)
    half, w_count = 1 << (c - 1), kernels.digit_windows(c)
    ib = kernels.key_index_bits(n)
    assert kernels.packed_key_fits(half, n)
    assert keys.dtype == torch.int32 and keys.shape == (3 * w_count, n)
    keys, d, dead = keys.tolist(), d.tolist(), pinf.tolist()
    for s in range(3):
        for w in range(w_count):
            for i in range(n):
                k, digit = keys[s * w_count + w][i], d[s][w][i]
                bucket = half + 1 if digit == 0 or dead[i] else abs(digit)
                assert k >> (ib + 1) == bucket
                assert (k >> ib) & 1 == (digit < 0)
                assert k & ((1 << ib) - 1) == i


def test_stable_keys_past_the_packed_key():
    """At c = 13 and N = 2^17 + 1024 the packed key overflows i32: the keys
    are (bucket << 1) | sign, and the sort of them is the stable sort,
    which orders each row as (bucket, sign, index)."""
    c, n = 13, (1 << 17) + 1024
    half = 1 << (c - 1)
    assert not kernels.packed_key_fits(half, n)
    rng = np.random.default_rng(3)
    limbs = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (1, 8, n), dtype=np.int64)
        .astype(np.int32))
    limbs[:, 7] &= 0x3FFFFFFF  # below 2^254
    pinf = infinity(n, 4)
    keys = kernels.msm_digits(limbs, pinf, c)
    d = msm._signed_digit_tensors(limbs, c).reshape(-1, n)
    bucket = torch.where((d == 0) | pinf[None, :], half + 1, d.abs())
    assert torch.equal(keys, (bucket << 1) | (d < 0).to(torch.int32))
    sid, neg, perm = msm._sort_keys(keys, half)
    for row in (0, 9, 19):
        order = np.lexsort((np.arange(n), d[row].numpy() < 0,
                            bucket[row].numpy()))
        assert (perm[row].numpy() == order).all()
        assert (sid[row].numpy() == bucket[row].numpy()[order]).all()
        assert (neg[row].numpy() == (d[row].numpy()[order] < 0)).all()


def unpacked_as_before(packed: torch.Tensor, idx_bits: int):
    """The unpacking the pipeline ran after its sort before the kernel."""
    sid = packed >> (idx_bits + 1)
    neg = ((packed >> idx_bits) & 1) == 1
    perm = (packed & ((1 << idx_bits) - 1)).to(torch.int64)
    return sid, neg, perm


@pytest.mark.parametrize("c,n", [(8, 128), (11, 1000), (13, 4096)])
def test_unpack_mode_gives_sid_neg_perm(c, n):
    """Unpack mode on the sorted keys: the earlier unpacking, the dtypes
    `msm_gather` checks for, and each lane decoded by integers."""
    limbs, pinf = limbs_of(scalars(c, 2, n, n)), infinity(n, n)
    srt = torch.sort(kernels.msm_digits(limbs, pinf, c), dim=-1).values
    sid, neg, perm = kernels.msm_digits(srt, unpack=True)
    ib = kernels.key_index_bits(n)
    want = unpacked_as_before(srt, ib)
    assert (sid.dtype, neg.dtype, perm.dtype) == (torch.int32, torch.bool,
                                                  torch.int64)
    assert all(torch.equal(g, w) for g, w in zip((sid, neg, perm), want))
    for b, i in [(0, 0), (1, n - 1), (5, n // 2)]:
        k = int(srt[b, i])
        assert (int(sid[b, i]), bool(neg[b, i]), int(perm[b, i])) == (
            k >> (ib + 1), bool((k >> ib) & 1), k & ((1 << ib) - 1))


def test_sort_orders_bucket_sign_lane():
    """`_sorted_digits` on the plain path: each row ascending by (bucket,
    sign, lane), every lane once, a dead lane (digit 0, infinity) last."""
    c, n = 10, 512
    half = 1 << (c - 1)
    limbs, pinf = limbs_of(scalars(c, 2, n, 7)), infinity(n, 7)
    sid, neg, perm = msm._sorted_digits(c, pinf, limbs)
    d = msm._signed_digit_tensors(limbs, c).reshape(-1, n)
    for row in range(sid.shape[0]):
        p = perm[row]
        assert sorted(p.tolist()) == list(range(n))
        dig = d[row][p]
        dead = (dig == 0) | pinf[p]
        assert torch.equal(sid[row], torch.where(dead, half + 1, dig.abs()))
        assert torch.equal(neg[row], dig < 0)
        key = (sid[row].long() * 2 + neg[row].long()) * n + p
        assert (key[1:] > key[:-1]).all()


# -----------------------------------------------------------------------------
# The pipeline: what it launches
# -----------------------------------------------------------------------------

def _stub(monkeypatch):
    seen = []
    real = kernels.msm_digits
    monkeypatch.setattr(kernels, "msm_digits", lambda *a, **k: (
        seen.append("unpack" if k.get("unpack") else "pack"),
        real(*a, **k))[1])
    return seen


def test_halving_tree_launches_pack_then_unpack(monkeypatch):
    """One halving-tree pipeline call is two launches: pack mode before
    the sort, unpack mode after it; the tree's levels launch none."""
    from test_torch_msm_gather import field_rows

    seen = _stub(monkeypatch)
    pm = field_rows(512, 2)
    pinf = lf.is_zero(lf.FQ, pm[:, 24:].T.contiguous())
    rng = np.random.default_rng(4)
    limbs = torch.tensor(rng.integers(0, 1 << 31, (1, 8, 512)),
                         dtype=torch.int32)
    msm._msm_ptree_pipeline(6, pm, pinf, limbs)   # half 32: four levels
    assert seen == ["pack", "unpack"]


def test_scan_path_and_stable_key_launches(monkeypatch):
    """The scan path takes the same two; where the packed key overflows,
    pack mode alone (the stable sort returns its own permutation)."""
    from test_torch_msm_gather import field_rows

    seen = _stub(monkeypatch)
    pm = field_rows(128, 1)
    pinf = lf.is_zero(lf.FQ, pm[:, 24:].T.contiguous())
    limbs = limbs_of(scalars(8, 1, 128, 1))
    msm._sorted_points(8, pm, pinf, limbs)
    assert seen == ["pack", "unpack"]
    seen.clear()
    n = (1 << 17) + 1024
    msm._sorted_digits(13, torch.zeros(n, dtype=torch.bool),
                       torch.zeros((1, 8, n), dtype=torch.int32))
    assert seen == ["pack"]


def test_wrapper_checks_its_operands():
    limbs, pinf = limbs_of(scalars(8, 1, 16, 1)), infinity(16, 1)
    with pytest.raises(ValueError, match="expected int32"):
        kernels.msm_digits(limbs.to(torch.int64), pinf, 8)
    with pytest.raises(ValueError, match="expected int32"):
        kernels.msm_digits(limbs, unpack=True)
    with pytest.raises(ValueError, match="limb axis"):
        kernels.msm_digits(limbs[:, :4].contiguous(), pinf, 8)
    with pytest.raises(ValueError, match="pinf"):
        kernels.msm_digits(limbs, pinf[:8], 8)
    with pytest.raises(ValueError, match="pinf"):
        kernels.msm_digits(limbs, None, 8)
    with pytest.raises(ValueError, match="window width"):
        kernels.msm_digits(limbs, pinf, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.msm_digits(limbs.transpose(0, 2).contiguous()
                           .transpose(0, 2), pinf, 8)
    with pytest.raises(ValueError, match="operands on"):
        kernels.msm_digits(limbs, pinf.to("meta"), 8)


# -----------------------------------------------------------------------------
# The source: its name, its registration, and its C++ run on the host
# -----------------------------------------------------------------------------

def test_the_kernel_is_built_counted_and_named():
    assert "msm_digits.cu" in kernels._SOURCES
    assert "msm_digits" in kernels.LAUNCHES
    # a trace finds a counter's launches by the name `<counter>_kernel`:
    # both modes carry it
    assert re.findall(r"__global__ void __launch_bounds__\(THREADS\)\s*"
                      r"(\w+)\((\w+) a\)", SOURCE) == [
        ("msm_digits_kernel", "PackArgs"), ("msm_digits_kernel", "UnpackArgs")]
    assert len(re.findall(r"__global__", SOURCE)) == 2
    assert 'extern "C" int zk_msm_digits(' in SOURCE
    assert 'extern "C" int zk_msm_digits_unpack(' in SOURCE


# the CUDA names the source uses, for the host's C++ compiler
_SHIM = r"""
#include <cstdint>
#include <cstdlib>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
typedef void* cudaStream_t;
struct Index { unsigned x; };
static Index blockIdx, threadIdx;
struct int4 { int x, y, z, w; };
struct uchar4 { unsigned char x, y, z, w; };
struct longlong2 { long long x, y; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uchar4 make_uchar4(unsigned char a, unsigned char b, unsigned char c,
                          unsigned char d) { return {a, b, c, d}; }
inline longlong2 make_longlong2(long long a, long long b) { return {a, b}; }
template <class T> T __ldg(const T* p) { return *p; }
inline int cudaGetLastError() { return 0; }
"""
_COMMON = """#pragma once
namespace zk {
inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The source built for the host: each launch a loop over its grid."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("msm_digits")
    src, n = re.subn(
        r"(\w+)<<<(.*?),\s*THREADS,\s*0,\s*\(cudaStream_t\)stream>>>\(a\);",
        r"for (unsigned bx = 0; bx < (\2); ++bx)"
        r" for (unsigned tx = 0; tx < THREADS; ++tx)"
        r" { blockIdx.x = bx; threadIdx.x = tx; \1(a); }", SOURCE, flags=re.S)
    assert n == 2
    (d / "shim.h").write_text(_SHIM)
    (d / "common.cuh").write_text(_COMMON)
    (d / "k.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-include",
                    str(d / "shim.h"), "-I", str(d), str(d / "k.cpp"), "-o",
                    str(d / "k.so")], check=True)
    lib = ctypes.CDLL(str(d / "k.so"))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.zk_msm_digits.argtypes = [p, p, p, ll, ll, i, i, i, p]
    lib.zk_msm_digits_unpack.argtypes = [p] * 4 + [ll, i, p]
    return lib


@pytest.mark.parametrize("c,sets,n", [(8, 2, 300), (10, 3, 1000),
                                      (11, 2, 999), (12, 1, 513),
                                      (13, 2, 700), (6, 1, 512)])
def test_host_build_of_the_source_equals_the_plain_version(host_kernel, c,
                                                           sets, n):
    """Pack mode's keys and unpack mode's triple from the kernel's own
    source, bit for bit against the plain version; key counts that leave
    unpack mode a tail of one to three keys (N = 999, 513)."""
    limbs, pinf = limbs_of(scalars(c, sets, n, c * n)), infinity(n, c)
    w_count = kernels.digit_windows(c)
    keys = torch.empty((sets * w_count, n), dtype=torch.int32)
    ib = kernels.key_index_bits(n)
    assert host_kernel.zk_msm_digits(limbs.data_ptr(), pinf.data_ptr(),
                                     keys.data_ptr(), sets, n, c, w_count,
                                     ib, None) == 0
    assert torch.equal(keys, kernels.msm_digits_plain(limbs, pinf, c))
    srt = torch.sort(keys, dim=-1).values
    sid = torch.empty_like(srt)
    neg = torch.empty(srt.shape, dtype=torch.bool)
    perm = torch.empty(srt.shape, dtype=torch.int64)
    assert host_kernel.zk_msm_digits_unpack(
        srt.data_ptr(), sid.data_ptr(), neg.data_ptr(), perm.data_ptr(),
        srt.numel(), ib, None) == 0
    want = kernels.msm_digits_plain(srt, unpack=True)
    assert all(torch.equal(g, w) for g, w in zip((sid, neg, perm), want))


def test_host_build_gives_the_stable_key(host_kernel):
    """Where the packed key overflows (idx_bits 0), the source writes
    (bucket << 1) | sign, as the plain version does."""
    c, n = 13, (1 << 17) + 1024
    rng = np.random.default_rng(5)
    limbs = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (1, 8, n), dtype=np.int64)
        .astype(np.int32))
    pinf = infinity(n, 5)
    w_count = kernels.digit_windows(c)
    keys = torch.empty((w_count, n), dtype=torch.int32)
    assert host_kernel.zk_msm_digits(limbs.data_ptr(), pinf.data_ptr(),
                                     keys.data_ptr(), 1, n, c, w_count, 0,
                                     None) == 0
    assert torch.equal(keys, kernels.msm_digits_plain(limbs, pinf, c))
