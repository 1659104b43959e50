"""msm_device_ms: device-busy milliseconds per `commit_many_mont` call, from
the traced window, which holds the commit calls alone."""


def read(w):
    if w.trace is None or not w.trace.items or w.trace.busy_s <= 0:
        return None
    return 1e3 * w.trace.busy_s / w.trace.items
