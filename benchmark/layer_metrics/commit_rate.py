"""commit_rate: coefficients committed in the measured window over the
window's length, on the harness's clock: the commit loop's throughput,
paced by the host's launches and its blocking copies."""


def read(w):
    if not w.records or w.window_s <= 0:
        return None
    return sum(r["points"] for r in w.records) / w.window_s
