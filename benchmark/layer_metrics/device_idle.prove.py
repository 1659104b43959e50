"""device_idle.prove: the share of the traced window of proofs in which no
operation ran on the device, in percent (1 - busy / window, both from the
same trace)."""


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
