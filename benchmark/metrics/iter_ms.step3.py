"""Milliseconds per step-3 iteration: the seconds of the step-3 blocks
outside the profiled stage over their iterations (host clock around
synchronised blocks)."""


def read(run):
    n = run.window.iterations("step3", profiled=False)
    return 1e3 * run.window.seconds("step3", profiled=False) / n if n else None
