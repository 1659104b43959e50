"""The benchmark of zkvm_tpu_torch: `run.py` runs one cell of BENCHMARK.json."""
