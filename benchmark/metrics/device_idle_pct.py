"""The share of the profiled stage's time in which no device activity ran:
100 (1 - union of the activities' intervals / the stage's time).  The
profiler's own host cost stretches the profiled stage, so its time is
taken from its unprofiled twin, the next stage of the same instance,
which runs the same counts (`Window.unprofiled_twin`); the traced line's `busy_s` / `window_s` keep
the share over the profiled stage itself."""

from benchmark import trace as tracing


def read(run):
    if run.trace is None:
        return None
    wall = run.window.unprofiled_twin()
    lo, hi = tracing.stage(run.trace)
    acts = tracing.within(run.trace["activities"], lo, hi)
    if not acts or hi <= lo or not wall:
        return None
    return 100.0 * (1.0 - tracing.busy_us(acts) / 1e6 / wall)
