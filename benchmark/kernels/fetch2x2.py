"""The window gather: `fetch2x2_kernel` (csrc/window.cu)."""

MODULE = "gan2shape_torch.ops.gather_window"
KERNELS = ("fetch2x2_kernel",)
METRIC = "kernels_roofline"


def fetch2x2_bytes(src, iy, ix):
    """The source's taps read (at most the whole source), the int32 window
    starts read, the (B, 4C, P) f32 windows written."""
    b, c, h, w = src.shape
    p = iy.shape[1]
    return (min(h * w, 4 * p) * b * c * 4 + 2 * b * p * 4
            + b * 4 * c * p * 4)


CALLS = {"fetch2x2": fetch2x2_bytes}
