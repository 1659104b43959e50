"""proof_wall_p90_s: the 90th percentile of every proof's wall time in the
measured window, from taking its input bytes to having its proof file
written, on the harness's clock (all items of the window, none left out)."""

import statistics


def read(w):
    walls = [r["wall"] for r in w.records]
    if not walls:
        return None
    if len(walls) == 1:
        return walls[0]
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
