"""Host milliseconds an iteration, over the profiled stage's step-3
blocks, inside the union of the program's `g2s.render.*` spans (the
renderer's warp, inverse grid and view calls).  Read under the profiler,
which stretches host time: a comparison of two commits, not an absolute
cost."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, "render.")
