"""The share of the device's busy time in the profiled stage's step-2
blocks that the program's `g2s.step2.*` spans account for (the work
launched while one was open): how much of step 2 the span metrics
(`device_ms.step2.*`) see."""

from benchmark import spans


def read(run):
    return spans.cover_pct(run, "step2")
