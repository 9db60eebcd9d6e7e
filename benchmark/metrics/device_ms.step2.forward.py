"""Device milliseconds an iteration, over the profiled stage's step-2
blocks, of the work launched while the program's `g2s.step2.forward` span
was open on the host (by the launch's host time, from any thread; the
union of the activities' device intervals)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "step2", lambda s: s == "step2.forward")
