"""The port's benches (`zkvm_tpu_torch/utils/benches.py`) on the CPU.

The device rows' code runs at tiny sizes on a CPU device (the plain
versions of the kernels) and gives finite, positive values; on a machine
without a card, `run_all` with its default device raises and prints no row:
no error is swallowed and nothing falls back to the CPU.
"""

import numpy as np
import pytest
import torch

from zkvm_tpu_torch.utils import benches

torch.set_num_threads(1)


@pytest.mark.parametrize("row", sorted(benches.DEVICE_ROWS))
def test_benches_device_rows_raise_without_a_card(row, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        benches.run_all(only=[row])
    assert capsys.readouterr().out == ""


def test_run_flagship_raises_without_a_card():
    """The flagship's timed steps (`tools/bench_flagship.py`,
    `chip_smoke.py`) run on the device they are given: "cuda" without a
    card raises rather than proving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        benches.run_flagship("cuda", count=1, capacity_log2=8, reps=1)


def test_benches_rows_on_the_cpu(capsys):
    """The device rows' code at tiny sizes on a CPU device (the plain
    versions of the kernels); every value finite and positive."""
    rows = (benches.bench_poseidon_device("cpu", batch=4)
            + benches.bench_ntt_device("cpu", sizes=(1 << 4,))
            + benches.bench_msm_device("cpu", sizes=(1 << 3,)))
    assert [r["metric"] for r in rows] == [
        "device/poseidon/permutation", "device/ntt/2^4", "device/msm/2^3"]
    assert all(np.isfinite(r["value"]) and r["value"] > 0 for r in rows)
    assert capsys.readouterr().out.count("\n") == len(rows)
    with pytest.raises(ValueError, match="unknown"):
        benches.run_all(only=["nope"], device="cpu")
