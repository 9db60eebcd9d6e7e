"""Reading the program's own spans (`g2s.<step>.<phase>`, `g2s.render.*`:
gan2shape_torch's `diagnostics.span`) from the profiled stage's trace,
inside the harness's blocks of one step: the device's idle time while a
span was open (`idle_ms`), the host's time inside spans (`host_ms`), and
the device time of the work launched while a span was open (`device_ms`,
`cover_pct`), by the launch's host time, from whichever thread (autograd
launches a backward's kernels from its own thread while the main
thread's `g2s.<step>.backward` is open).  A trace of a program without
such spans reads None."""

from bisect import bisect_left, bisect_right

from benchmark import trace as tracing


def step_blocks(run, step):
    """(block intervals, iterations) of the profiled stage's blocks of
    `step`, or None."""
    if run.trace is None:
        return None
    spans = tracing.blocks(run.trace, step)
    n = sum(b["n"] for b in run.window.blocks
            if b["profiled"] and b["step"] == step)
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
    got = step_blocks(run, "step3")
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
    got = step_blocks(run, "step3")
    if got is None:
        return None
    spans, n = got
    open_ = [iv for lo, hi in spans
             for iv in named(run.trace, lambda s: s.startswith(prefix),
                             lo, hi)]
    return sum(e - s for s, e in open_) / 1e3 / n if open_ else None


def launched_in(launched, intervals):
    """The (start, end) on the device of the activities of `launched`
    ((launch time, start, end, name), sorted) whose launch falls inside
    one of the sorted disjoint host `intervals`."""
    times = [a[0] for a in launched]
    out = []
    for lo, hi in intervals:
        for a in launched[bisect_left(times, lo):bisect_right(times, hi)]:
            out.append((a[1], a[2]))
    return out


def device_ms(run, step, match):
    """Device milliseconds an iteration, over the profiled stage's blocks
    of `step`, of the activities launched while a span whose name
    (without the prefix) `match` accepts was open on the host: the union
    of their intervals, so that kernels overlapping on side streams count
    once.  None where no such span, or no launch, is in the trace."""
    got = step_blocks(run, step)
    if got is None or not run.trace.get("launched"):
        return None
    spans, n = got
    total, found = 0.0, False
    for lo, hi in spans:
        open_ = named(run.trace, match, lo, hi)
        found = found or bool(open_)
        total += tracing.busy_us(launched_in(run.trace["launched"], open_))
    return total / 1e3 / n if found else None


def cover_pct(run, step):
    """The share of the device's busy time in the profiled stage's blocks
    of `step` that the program's `g2s.<step>.*` spans account for:
    activities launched while one was open, over those launched inside
    the blocks or starting inside them (so a launch the trace lost still
    counts against the share).  Each side is the union of whole device
    intervals: the device's clock is not the host's to the microsecond,
    so neither side is clipped to the host's block."""
    got = step_blocks(run, step)
    if got is None or not run.trace.get("launched"):
        return None
    spans, _ = got
    busy = covered = 0.0
    found = False
    for lo, hi in spans:
        busy += tracing.busy_us(
            [(s, e) for s, e, _ in run.trace["activities"] if lo <= s <= hi]
            + launched_in(run.trace["launched"], [(lo, hi)]))
        open_ = named(run.trace, lambda s: s.startswith(step + "."), lo, hi)
        found = found or bool(open_)
        covered += tracing.busy_us(launched_in(run.trace["launched"], open_))
    return 100.0 * covered / busy if found and busy else None
