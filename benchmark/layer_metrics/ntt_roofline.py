"""ntt_roofline: the staged NTT's (`ntt_pass_kernel`) share of its roofline
in the traced window, in percent: the bound of every transform (rows and
size counted by the harness's wrapper of `kernels.ntt_stages`,
`harness.roofline.ntt_bound_s`) summed, over the kernel's time in the
trace.  Against the published peaks of one H100."""

from benchmark.harness.roofline import ntt_bound_s


def read(w):
    if w.trace is None:
        return None
    t = w.trace.kernel_s.get("ntt_pass_kernel", 0.0)
    calls = w.trace.lanes.get("ntt_stages", [])
    if t <= 0 or not calls:
        return None
    return 100.0 * sum(ntt_bound_s(rows, log_n) for rows, log_n in calls) / t
