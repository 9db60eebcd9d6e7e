"""Reading the program's own spans (`g2s.<step>.<phase>`, `g2s.render.*`:
gan2shape_torch's `diagnostics.span`) from the profiled stage's trace,
inside the harness's step-3 blocks.  A trace of a program without such
spans reads None."""

from benchmark import trace as tracing


def step3_blocks(run):
    """(block intervals, iterations) of the profiled stage's step-3
    blocks, or None."""
    if run.trace is None:
        return None
    spans = tracing.blocks(run.trace, "step3")
    n = sum(b["n"] for b in run.window.blocks
            if b["profiled"] and b["step"] == "step3")
    return (spans, n) if spans and n else None


def named(trace, match, lo, hi):
    """The merged intervals of the annotations inside [lo, hi] whose name
    (without the prefix) `match` accepts."""
    p = len(tracing.PREFIX)
    return tracing.merged(tracing.within(
        [a for a in trace["annotations"] if match(a[2][p:])], lo, hi))


def overlap_us(a, b):
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(run, name):
    """Milliseconds an iteration, over the profiled step-3 blocks, in which
    no device activity ran while the span `name` was open on the host."""
    got = step3_blocks(run)
    if got is None:
        return None
    spans, n = got
    total, found = 0.0, False
    for lo, hi in spans:
        open_ = named(run.trace, lambda s: s == name, lo, hi)
        found = found or bool(open_)
        gaps = tracing.idle_gaps(
            tracing.within(run.trace["activities"], lo, hi), lo, hi)
        total += overlap_us(gaps, open_)
    return total / 1e3 / n if found else None


def host_ms(run, prefix):
    """Host milliseconds an iteration inside the union of the spans whose
    name starts with `prefix`, over the profiled step-3 blocks."""
    got = step3_blocks(run)
    if got is None:
        return None
    spans, n = got
    open_ = [iv for lo, hi in spans
             for iv in named(run.trace, lambda s: s.startswith(prefix),
                             lo, hi)]
    return sum(e - s for s, e in open_) / 1e3 / n if open_ else None
