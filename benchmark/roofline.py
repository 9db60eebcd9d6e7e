"""The yardstick's arithmetic: the H100's published peaks, the least bytes
each of the port's kernels must move, the shapes of their calls (recorded
by wrapping the port's kernel wrappers), and the FLOPs of one iteration of
each step (torch.utils.flop_counter)."""

import math
import re
from contextlib import contextmanager

import torch

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and the float32
# (outside the tensor cores), TF32 and bfloat16 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def peak_flops(act_dtype):
    """The dense peak the run's precision allows, read from the torch flags
    (and the configured activation dtype) when the window starts."""
    if str(act_dtype) in ("bfloat16", "torch.bfloat16"):
        return PEAK_FLOPS["bfloat16"]
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        return PEAK_FLOPS["tf32"]
    return PEAK_FLOPS["float32"]


def _padded(h, w, window):
    pad = window + 1
    return (h + 2 * pad) * (w + 2 * pad)


def raster_place_bytes(vx, vy, vz, window, near, far):
    """Three (B, H, W) f32 vertex planes read; the (2, B, 2, 2, 10, HP, WP)
    int16 payloads written."""
    b, h, w = vx.shape
    return 3 * 4 * b * h * w + 2 * b * 4 * 10 * _padded(h, w, window) * 2


def raster_tests_bytes(bufs, h, w, window, near, far):
    """The int16 payloads read; the (B, H, W) int32 keys written."""
    return bufs.numel() * 2 + bufs.shape[1] * h * w * 4


def fetch2x2_bytes(src, iy, ix):
    """The source's taps read (at most the whole source), the int32 window
    starts read, the (B, 4C, P) f32 windows written."""
    b, c, h, w = src.shape
    p = iy.shape[1]
    return (min(h * w, 4 * p) * b * c * 4 + 2 * b * p * 4
            + b * 4 * c * p * 4)


def splat2x2_bytes(g, iy, ix, shape):
    """The (B, 4C, P) f32 addends and the starts read, the (B, C, H, W) f32
    sums written."""
    return g.numel() * 4 + 2 * iy.numel() * 4 + math.prod(shape) * 4


# wrapper -> (the module attribute the port calls it through, its bytes,
# the kernels one call launches)
KERNELS = {
    "raster_place": ("gan2shape_torch.ops.rasterize", raster_place_bytes,
                     ("place_collide_kernel", "place_write_kernel")),
    "raster_tests": ("gan2shape_torch.ops.rasterize", raster_tests_bytes,
                     ("tests_kernel",)),
    "fetch2x2": ("gan2shape_torch.ops.gather_window", fetch2x2_bytes,
                 ("fetch2x2_kernel",)),
    "splat2x2": ("gan2shape_torch.ops.gather_window", splat2x2_bytes,
                 ("splat_amax_kernel", "splat2x2_kernel",
                  "splat_convert_kernel")),
}
KERNEL_NAME = re.compile(r"\b(" + "|".join(
    k for _, _, ks in KERNELS.values() for k in ks) + r")\b")


def is_port_kernel(name):
    return KERNEL_NAME.search(name) is not None


@contextmanager
def recording_calls(calls):
    """Inside the block each call of a port kernel wrapper on CUDA tensors
    appends (wrapper, least seconds at HBM_BYTES_PER_S) to `calls`."""
    import importlib

    saved = []

    def wrap(name, real, nbytes):
        def call(*args):
            if args[0].is_cuda:
                calls.append((name, nbytes(*args) / HBM_BYTES_PER_S))
            return real(*args)
        return call

    for name, (module, nbytes, _) in KERNELS.items():
        mod = importlib.import_module(module)
        real = getattr(mod, name)
        saved.append((mod, name, real))
        setattr(mod, name, wrap(name, real, nbytes))
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **_):
    """A convolution's backward: the input gradient as torch counts it,
    and the weight gradient as many FLOPs as the forward, whose weight
    shape carries the groups.  torch's own count of the weight gradient
    ignores the groups, so it counts the instance-stacked nets' grouped
    convolutions once per group too many."""
    from torch.utils.flop_counter import conv_flop_count
    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0],
                                 not transposed)
    if output_mask[1]:
        flops += conv_flop_count(x_shape, w_shape, grad_out_shape,
                                 transposed)
    return flops


def flop_counter():
    """torch.utils.flop_counter's mode, with the grouped-convolution
    backward counted right."""
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})


def count_flops(system, steps, synchronize):
    """{step: (FLOPs of one iteration, FLOPs of a block's once-only part)}
    from blocks of one and two iterations under torch.utils.flop_counter.
    Runs three iterations of each step on the system's state."""
    out = {}
    for step in steps:
        counts = []
        for n in (1, 2):
            counter = flop_counter()
            with counter:
                system.run(step, n)
            synchronize()
            counts.append(counter.get_total_flops())
        per = counts[1] - counts[0]
        out[step] = (per, counts[0] - per)
    return out
