"""padd_roofline: the `padd` kernel's share of its roofline in the traced
window, in percent: the bound of every launch (its lanes counted by the
harness's wrapper, `harness.roofline.padd_bound_s`) summed, over the
kernel's time in the trace.  Against the published peaks of one H100."""

from benchmark.harness.roofline import padd_bound_s


def read(w):
    if w.trace is None:
        return None
    t = w.trace.kernel_s.get("padd_kernel", 0.0)
    lanes = w.trace.lanes.get("padd", [])
    if t <= 0 or not lanes:
        return None
    return 100.0 * sum(padd_bound_s(n) for n in lanes) / t
