"""The port's raster and window kernels' share of their roofline in the
profiled stage: the sum over their calls of the least time their bytes
need at the card's HBM bandwidth, over the sum of their kernels' device
time (the roofline registry's entries of this metric, `kernels/`)."""

from benchmark import roofline


def read(run):
    return roofline.roofline_pct(run, "kernels_roofline")
