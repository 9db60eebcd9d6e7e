"""The port's kernels' share of their roofline in the profiled stage: the
sum over their wrappers' calls of the least time their bytes need at the
card's HBM bandwidth, over the sum of their kernels' device time."""

from benchmark import roofline, trace as tracing


def read(run):
    if run.trace is None or not run.window.kernel_calls:
        return None
    lo, hi = tracing.stage(run.trace)
    device_s = sum(e - s for s, e, n in
                   tracing.within(run.trace["activities"], lo, hi)
                   if roofline.is_port_kernel(n)) / 1e6
    if not device_s:
        return None
    least = sum(t for _, t in run.window.kernel_calls)
    return 100.0 * least / device_s
