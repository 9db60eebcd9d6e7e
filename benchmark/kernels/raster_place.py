"""The rasterizer's placement: memset + `place_collide_kernel` +
`place_write_kernel` (csrc/raster.cu)."""

MODULE = "gan2shape_torch.ops.rasterize"
KERNELS = ("place_collide_kernel", "place_write_kernel")
METRIC = "kernels_roofline"


def _padded(h, w, window):
    pad = window + 1
    return (h + 2 * pad) * (w + 2 * pad)


def raster_place_bytes(vx, vy, vz, window, near, far):
    """Three (B, H, W) f32 vertex planes read; the (2, B, 2, 2, 10, HP, WP)
    int16 payloads written."""
    b, h, w = vx.shape
    return 3 * 4 * b * h * w + 2 * b * 4 * 10 * _padded(h, w, window) * 2


CALLS = {"raster_place": raster_place_bytes}
