"""The rasterizer's depth tests: `tests_kernel` (csrc/raster.cu)."""

MODULE = "gan2shape_torch.ops.rasterize"
KERNELS = ("tests_kernel",)
METRIC = "kernels_roofline"


def raster_tests_bytes(bufs, h, w, window, near, far):
    """The int16 payloads read; the (B, H, W) int32 keys written."""
    return bufs.numel() * 2 + bufs.shape[1] * h * w * 4


CALLS = {"raster_tests": raster_tests_bytes}
