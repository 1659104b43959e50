"""The port's tools (`zkvm_tpu_torch/tools/`: the MSM window sweep, the MSM
and NTT probes, the addition kernels' probe and the three generators) on
the CPU, against `zkvm_tpu` or the host.

Small sizes on a CPU device, where every kernel wrapper takes its plain
version (the window sweep is `tests/test_torch_msm_cwidth.py`): the NTT
probe's transforms at 2^6 and 2^9 against
`zkvm_tpu`'s `Domain` (its staged route, `ZKVM_NTT_IMPL=butterfly`); the
MSM probe at 2^4 against `zkvm_tpu`'s host MSM; the generators' output
against the committed files and the reference's own tool.  Exact
comparisons throughout.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.curves.g1 import G1Projective as RG1Projective
from zkvm_tpu.curves.msm import msm_variable_base as ref_msm_variable_base
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import ntt as rntt
from zkvm_tpu_torch.hashes import poseidon_constants
from zkvm_tpu_torch.ops import kernels
from zkvm_tpu_torch.ops import limb_field as lf
from zkvm_tpu_torch.ops.limb_field import FR
from zkvm_tpu_torch.plonk.proof import Proof
from zkvm_tpu_torch.tools import (bench_msm_cwidth, bench_msm_r3,
                                  bench_ntt_r3, bench_padd,
                                  gen_dryrun_fixture, gen_native_frob,
                                  gen_poseidon_constants)
from zkvm_tpu_torch.utils import dryrun

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _ref_points(points):
    return [RG1Affine.identity() if p.infinity
            else RG1Affine(RFp(p.x.value), RFp(p.y.value)) for p in points]


def _bytes(point) -> bytes:
    return point.to_affine().to_bytes()


def test_chain_points_are_the_reference_tool_s():
    """`tools/bench_msm_r3.py`'s chain (G, doubled and advanced by G in
    turns), built with `zkvm_tpu`'s classes."""
    base = RG1Affine.generator().to_projective()
    acc, want = base, []
    for _ in range(16):
        want.append(acc)
        acc = acc + acc if len(want) % 2 else acc + base
    want = RG1Projective.batch_normalize(want)
    assert ([p.to_bytes() for p in bench_msm_r3.chain_points(16)]
            == [p.to_bytes() for p in want])


def test_msm_r3_runs_and_its_sample_is_the_host_msm(capsys):
    out = bench_msm_r3.run((4,), "cpu")
    assert [r["log_n"] for r in out["rows"]] == [4]
    assert all(r["ms"] > 0 and r["points_per_s"] > 0 for r in out["rows"])
    points = bench_msm_r3.chain_points(16)
    import random

    rng = random.Random(42)
    scalars = [RFr(rng.randrange(RFr.MODULUS)) for _ in range(16)]
    assert _bytes(out["sample"]) == _bytes(
        ref_msm_variable_base(_ref_points(points), scalars))
    assert "equals the host MSM" in capsys.readouterr().out


def test_ntt_r3_transforms_equal_the_reference_domain(monkeypatch):
    monkeypatch.setenv("ZKVM_NTT_IMPL", "butterfly")
    shapes = ((6, ("fft", "ifft")), (9, ("coset_fft", "coset_ifft")))
    rows = bench_ntt_r3.run(shapes, "cpu")
    assert [(r["log_n"], r["kind"]) for r in rows] == [
        (6, "fft"), (6, "ifft"), (9, "coset_fft"), (9, "coset_ifft")]
    for r in rows:
        x = r["x"]
        assert x.shape == (8, 1 << r["log_n"])
        ref = getattr(rntt.Domain(1 << r["log_n"]), r["kind"] + "_device")(
            lf.to_reference(x, FR))
        assert (lf.to_reference(r["out"], FR) == np.asarray(ref)).all()
        assert r["ms"] > 0 and r["melems_per_s"] > 0


def test_padd_probe_kernels_equal_each_other_and_plain(capsys):
    p, q = bench_padd.batch(2, 256, "cpu")
    assert all(t.shape == (2, 12, 256) for t in (*p, *q))
    plain = kernels.padd_plain(p, q)
    for fn in (kernels.padd, kernels.padd_ilp, kernels.padd_ilp_plain):
        assert all(torch.equal(a, b) for a, b in zip(fn(p, q), plain))
    rows = bench_padd.run(2, 256, "cpu")
    assert [r["name"] for r in rows] == ["padd", "padd_ilp"]
    assert all(r["ns_per_add"] > 0 for r in rows)


def test_padd_probe_batch_is_a_gather_of_256_points():
    """Q is P's points rolled by one lane; every lane is one of the 256."""
    p, q = bench_padd.batch(3, 40, "cpu")
    assert all(torch.equal(b, a.roll(1, dims=-1)) for a, b in zip(p, q))
    lanes = {tuple(torch.cat([t[r, :, i] for t in p]).tolist())
             for r in range(3) for i in range(40)}
    assert len(lanes) <= 256


def test_native_frob_lines_stand_in_bls_c_and_match_the_reference():
    lines = gen_native_frob.lines()
    assert len(lines) == 9
    source = (ROOT / "zkvm_tpu_torch" / "native" / "bls.c").read_text()
    assert "\n".join(lines) in source
    ref = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "gen_native_frob.py")],
                         capture_output=True, text=True, check=True)
    assert ref.stdout.splitlines() == lines
    port = subprocess.run([sys.executable, "-m",
                           "zkvm_tpu_torch.tools.gen_native_frob"],
                          cwd=ROOT, capture_output=True, text=True,
                          check=True)
    assert port.stdout.splitlines() == lines


def test_poseidon_constants_rebuilt_from_blobs(tmp_path):
    arc = [v for row in poseidon_constants.ROUND_CONSTANTS for v in row]
    mds = [v for row in poseidon_constants.MDS_MATRIX for v in row]
    (tmp_path / "arc.bin").write_bytes(
        b"".join(v.to_bytes(32, "little") for v in arc))
    (tmp_path / "mds.bin").write_bytes(
        b"".join(v.to_bytes(32, "little") for v in mds))
    out = tmp_path / "poseidon_constants.py"
    assert gen_poseidon_constants.main([str(tmp_path), "--out",
                                        str(out)]) == 0
    ns = {}
    exec(out.read_text(), ns)
    assert ns["ROUND_CONSTANTS"] == poseidon_constants.ROUND_CONSTANTS
    assert ns["MDS_MATRIX"] == poseidon_constants.MDS_MATRIX
    assert out.read_text() == Path(poseidon_constants.__file__).read_text()
    (tmp_path / "mds.bin").write_bytes(b"\0" * 33)
    with pytest.raises(ValueError):
        gen_poseidon_constants.main([str(tmp_path), "--out", str(out)])


def test_gen_dryrun_fixture_writes_the_fixture_s_layout(tmp_path,
                                                        monkeypatch):
    """The tool's steps (prove, verify, write to `--out`) with the prove
    replaced by the committed proof: the file is the fixture, byte for
    byte, and the committed file is not written.  The real prove on the
    CPU is `tests/test_torch_dryrun.py` (slow)."""
    committed = Path(dryrun.fixture_path())
    before = committed.stat().st_mtime_ns
    proof_bytes, pis = dryrun.load_fixture()
    calls = []

    class Prover:
        pass

    class Verifier:
        def verify(self, proof, inputs):
            calls.append(("verify", proof.to_bytes(), inputs))

    monkeypatch.setattr(dryrun, "dryrun_prover",
                        lambda device: calls.append(("setup", device))
                        or (Prover(), Verifier()))
    monkeypatch.setattr(dryrun, "prove_dryrun",
                        lambda prover: (Proof.from_bytes(proof_bytes), pis))
    out = tmp_path / "fixture.bin"
    assert gen_dryrun_fixture.main(["--out", str(out), "--device",
                                    "cpu"]) == 0
    assert out.read_bytes() == committed.read_bytes()
    assert calls == [("setup", "cpu"), ("verify", proof_bytes, pis)]
    assert committed.stat().st_mtime_ns == before


def test_tools_without_a_card_raise(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: bench_msm_cwidth.sweep(),
                 lambda: bench_msm_r3.run(),
                 lambda: bench_ntt_r3.run(),
                 lambda: bench_padd.run(),
                 lambda: gen_dryrun_fixture.main(
                     ["--out", str(tmp_path / "f.bin")])):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    assert not list(tmp_path.iterdir())
