"""StyleGAN2's conv epilogue kernels' share of their roofline in the
profiled stage: the least time the bytes of their calls (`_forward`,
`_grad`: `kernels/bias_act.py`) need at the card's HBM bandwidth, over
the device time of `bias_act_kernel`, `bias_act_grad_kernel` and
`bias_sum_kernel`."""

from benchmark import roofline


def read(run):
    return roofline.roofline_pct(run, "bias_act_roofline")
