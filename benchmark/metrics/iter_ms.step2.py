"""Milliseconds per step-2 iteration: the seconds of the step-2 blocks
outside the profiled stage over their iterations (host clock around
synchronised blocks)."""


def read(run):
    n = run.window.iterations("step2", profiled=False)
    return 1e3 * run.window.seconds("step2", profiled=False) / n if n else None
