"""Device activities (kernels, memsets, copies) per step-3 iteration: those
that start inside the profiled stage's step-3 block, over its
iterations."""

from benchmark import trace as tracing


def read(run):
    if run.trace is None:
        return None
    spans = tracing.blocks(run.trace, "step3")
    n = sum(b["n"] for b in run.window.blocks
            if b["profiled"] and b["step"] == "step3")
    if not spans or not n:
        return None
    count = sum(len(tracing.within(run.trace["activities"], s, e))
                for s, e in spans)
    return count / n if count else None
