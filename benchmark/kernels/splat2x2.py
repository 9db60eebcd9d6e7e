"""The deterministic window splat: memset + `splat_amax_kernel` +
`splat2x2_kernel` + `splat_convert_kernel` (csrc/window.cu)."""

import math

MODULE = "gan2shape_torch.ops.gather_window"
KERNELS = ("splat_amax_kernel", "splat2x2_kernel", "splat_convert_kernel")
METRIC = "kernels_roofline"


def splat2x2_bytes(g, iy, ix, shape):
    """The (B, 4C, P) f32 addends and the starts read, the (B, C, H, W) f32
    sums written."""
    return g.numel() * 4 + 2 * iy.numel() * 4 + math.prod(shape) * 4


CALLS = {"splat2x2": splat2x2_bytes}
