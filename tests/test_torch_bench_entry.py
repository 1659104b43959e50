"""The port's benchmark entry (`zkvm_tpu_torch/bench.py`), `msm_device`,
`trace_to` and `write_fixture` on the CPU.

The headline runs at 2^8 points on a CPU device (the kernels' plain
versions): its JSON row has the root `bench.py`'s keys and metric name, and
its MSM equals the port's host `msm_variable_base` and `zkvm_tpu`'s
`MSMContext.msm_many_mont` (JAX on its CPU backend) on the same points and
Montgomery coefficients.  Points cross between the packages as canonical
integers; results are compared as compressed bytes, exactly.  Asked for
the card where there is none, every entry raises and prints nothing.
"""

import json
import math
import re
from pathlib import Path

import jax
import pytest
import torch

from zkvm_tpu.curves.g1 import G1Affine as RG1Affine
from zkvm_tpu.fields import Fp as RFp
from zkvm_tpu.fields import Fr as RFr
from zkvm_tpu.ops import msm as rmsm
from zkvm_tpu.ops.limb_field import FR as RFR
from zkvm_tpu_torch import bench
from zkvm_tpu_torch.curves.g1 import G1Affine
from zkvm_tpu_torch.curves.msm import msm_variable_base
from zkvm_tpu_torch.fields import Fr
from zkvm_tpu_torch.ops import msm
from zkvm_tpu_torch.plonk.proof import Proof
from zkvm_tpu_torch.utils import benches, dryrun, trace_to

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LOG_N = 8


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _ref_points(points):
    return [RG1Affine.identity() if p.infinity
            else RG1Affine(RFp(p.x.value), RFp(p.y.value)) for p in points]


def _bytes(point) -> bytes:
    return point.to_affine().to_bytes()


@pytest.fixture(scope="module")
def head():
    return bench.headline(LOG_N, "cpu")


def test_headline_row_has_bench_py_s_keys_and_names(head):
    """The row's keys, metric and unit are those of the root `bench.py`'s
    printed object, and its values are finite and positive."""
    text = (ROOT / "bench.py").read_text()
    block = text[text.index("print(json.dumps({"):]
    block = block[:block.index("}))")]
    ref_keys = re.findall(r'"(\w+)":', block)
    row = head["row"]
    assert list(row) == ref_keys == ["metric", "value", "unit",
                                     "vs_baseline"]
    assert f'"metric": "{row["metric"]}"' in block
    assert f'"unit": "{row["unit"]}"' in block
    assert row["metric"] == "msm_g1_points_per_sec_2^16"
    assert all(math.isfinite(row[k]) and row[k] > 0
               for k in ("value", "vs_baseline"))
    assert json.loads(json.dumps(row)) == row


def test_headline_msm_equals_host_and_jax(head):
    points, scalars = head["points"], head["scalars"]
    assert len(points) == len(scalars) == 1 << LOG_N
    want = _bytes(msm_variable_base(points, scalars))
    assert _bytes(head["result"]) == want
    coeffs = jax.device_put(RFR.to_mont_array([s.value for s in scalars]))
    ref = rmsm.MSMContext(_ref_points(points)).msm_many_mont([coeffs])[0]
    assert _bytes(ref) == want


def test_msm_device_equals_the_reference_s(head):
    """The one-shot MSM over the first len(scalars) of more points."""
    points, scalars = head["points"], head["scalars"][:200]
    got = msm.msm_device(points, scalars, "cpu")
    ref = rmsm.msm_device(_ref_points(points),
                          [RFr(s.value) for s in scalars])
    assert _bytes(got) == _bytes(ref)
    assert _bytes(got) == _bytes(msm_variable_base(points[:200], scalars))
    with pytest.raises(ValueError, match="scalars for"):
        msm.msm_device(points[:3], scalars[:4], "cpu")


def test_headline_without_a_card_raises(capsys):
    _no_card()
    with pytest.raises((RuntimeError, AssertionError)):
        bench.headline()
    with pytest.raises((RuntimeError, AssertionError)):
        bench.main([])
    with pytest.raises((RuntimeError, AssertionError)):
        bench.main(["--device", "cuda"])
    with pytest.raises((RuntimeError, AssertionError)):
        msm.msm_device([G1Affine.generator()], [Fr(3)], "cuda")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv,want", [
    (["--all"], (None, "cuda")),
    (["--only", "msm,ntt"], (["msm", "ntt"], "cuda")),
    (["--only", "msm", "--device", "cpu"], (["msm"], "cpu")),
    (["--all", "--device", "cpu"], (None, "cpu")),
])
def test_all_and_only_forward_to_run_all(argv, want, monkeypatch):
    seen = []
    monkeypatch.setattr(benches, "run_all",
                        lambda only, device: seen.append((only, device)))
    assert bench.main(argv) == 0
    assert seen == [want]


def test_write_fixture_is_load_fixture_s_inverse(tmp_path):
    committed = Path(dryrun.fixture_path()).read_bytes()
    out = tmp_path / "fixture.bin"
    assert dryrun.write_fixture(*dryrun.load_fixture(), str(out)) == len(
        committed)
    assert out.read_bytes() == committed
    proof_bytes, pis = dryrun.load_fixture()
    out2 = tmp_path / "from_proof.bin"
    dryrun.write_fixture(Proof.from_bytes(proof_bytes), pis, str(out2))
    assert out2.read_bytes() == committed
    assert dryrun.load_fixture(str(out2)) == (proof_bytes, pis)


def test_trace_to_writes_a_trace_naming_the_op(tmp_path):
    a = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with trace_to(str(tmp_path), device="cpu"):
        torch.mm(a, a)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert any(e.get("name") == "aten::mm"
               for e in trace["traceEvents"])


def test_trace_to_without_a_card_raises(tmp_path):
    _no_card()
    with pytest.raises((RuntimeError, AssertionError)):
        with trace_to(str(tmp_path)):
            pass
    assert not list(tmp_path.iterdir())
