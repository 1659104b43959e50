"""proof_rate: proofs finished in the measured window over the window's
length, on the harness's clock: the batch service's throughput, paced by
the host (witness synthesis, the rounds' host work, the service steps)."""


def read(w):
    if not w.records or w.window_s <= 0:
        return None
    return sum(r["error"] is None for r in w.records) / w.window_s
