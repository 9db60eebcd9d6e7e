"""Milliseconds an iteration, over the profiled stage's step-3 blocks, in
which no device activity ran while the program's `g2s.step3.backward` span
was open on the host (the idle gaps intersected with that span).  Read
under the profiler, which stretches host time: a comparison of two
commits, not an absolute cost."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, "step3.backward")
