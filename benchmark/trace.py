"""Reading a torch.profiler trace (its Chrome-trace JSON export): the
device activities (kernels, memsets, copies), the host annotations the
harness puts around its blocks (`g2s.<term>`), the host time at which
each activity was launched (its `correlation` with the CUDA runtime or
driver call that launched it), busy time as the union of overlapping
intervals (cuDNN runs kernels on side streams), and the idle gaps
labelled with the harness term that was open on the host."""

import json

DEVICE = ("kernel", "gpu_memset", "gpu_memcpy")
LAUNCH = ("cuda_runtime", "cuda_driver")
ANNOTATION = "user_annotation"
PREFIX = "g2s."
STAGE = PREFIX + "stage"


def load(path):
    """{"activities": [(start, end, name)], "annotations": [(start, end,
    name)], "launched": [(host time of the launch, start, end, name)]} in
    microseconds, sorted; "launched" holds the activities whose launch the
    trace records, from whichever host thread it came."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return parse(events)


def _correlation(e):
    args = e.get("args")
    return args.get("correlation") if isinstance(args, dict) else None


def parse(events):
    acts, notes, calls, corr = [], [], {}, []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        start = float(e["ts"])
        span = (start, start + float(e.get("dur", 0.0)), e.get("name", ""))
        cat = e.get("cat", "")
        if cat in DEVICE:
            acts.append(span)
            corr.append((_correlation(e), span))
        elif cat in LAUNCH and _correlation(e) is not None:
            calls[_correlation(e)] = start
        elif cat == ANNOTATION and span[2].startswith(PREFIX):
            notes.append(span)
    launched = [(calls[c], *span) for c, span in corr if c in calls]
    return {"activities": sorted(acts), "annotations": sorted(notes),
            "launched": sorted(launched)}


def within(spans, lo, hi):
    """The spans that start inside [lo, hi], clipped to it."""
    return [(max(s, lo), min(e, hi), n) for s, e, n in spans
            if lo <= s <= hi]


def merged(spans):
    """The union of the spans as disjoint sorted (start, end) intervals."""
    out = []
    for s, e, *_ in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_us(spans):
    return sum(e - s for s, e in merged(spans))


def idle_gaps(spans, lo, hi):
    """(start, end) of each stretch of [lo, hi] with no activity."""
    gaps, at = [], lo
    for s, e in merged(spans):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def term_at(t, annotations):
    """The innermost harness term open on the host at time t."""
    best = None
    for s, e, n in annotations:
        if n != STAGE and s <= t <= e and (best is None or s >= best[0]):
            best = (s, n)
    return best[1][len(PREFIX):] if best else "none"


def stage(trace):
    """(start, end) of the profiled stage's annotation."""
    for s, e, n in trace["annotations"]:
        if n == STAGE:
            return s, e
    raise ValueError("the trace holds no profiled stage")


def blocks(trace, term):
    """(start, end) of each block of `term` inside the profiled stage."""
    lo, hi = stage(trace)
    return [(s, e) for s, e, n in trace["annotations"]
            if n == PREFIX + term and lo <= s <= hi]


def breakdown(trace, top=10):
    """The profiled stage's top device operations by time, and its longest
    idle gaps by the harness term open on the host, in seconds."""
    lo, hi = stage(trace)
    acts = within(trace["activities"], lo, hi)
    by_name = {}
    for s, e, n in acts:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(acts, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[term_at((s + e) / 2, trace["annotations"]),
                           (e - s) / 1e6]
                          for s, e in gaps]}
