"""The yardstick's arithmetic: the H100's published peaks, the port's
kernels' calls (recorded by wrapping what the port calls them through, as
the roofline registry `kernels/` lists it, each with the least bytes it
must move), their share of the byte roofline, and the FLOPs of one
iteration of each step (torch.utils.flop_counter)."""

import importlib
import importlib.util
import re
from contextlib import contextmanager
from pathlib import Path

import torch

from benchmark import trace as tracing

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


KERNEL_DIR = Path(__file__).resolve().parent / "kernels"
_entries = {}


def kernel_entries(here=KERNEL_DIR):
    """{entry: module} of the roofline registry (`kernels/<entry>.py`:
    MODULE, CALLS, KERNELS, METRIC), found by listing the folder."""
    key = str(here)
    if key not in _entries:
        found = {}
        for path in sorted(Path(here).glob("*.py")):
            if path.stem.startswith("_"):
                continue
            spec = importlib.util.spec_from_file_location(
                "benchmark_kernel_" + path.stem.replace(".", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            found[path.stem] = module
        _entries[key] = found
    return _entries[key]


def is_port_kernel(name, metric=None, here=KERNEL_DIR):
    """Whether a device activity is one of the registry's kernels (of the
    entries of `metric`, where given)."""
    names = [k for e in kernel_entries(here).values()
             if metric is None or e.METRIC == metric for k in e.KERNELS]
    return bool(names) and re.search(r"\b(" + "|".join(names) + r")\b",
                                     name) is not None


@contextmanager
def recording_calls(calls, here=KERNEL_DIR):
    """Inside the block each call, on CUDA tensors, of what a registry
    entry records appends (entry, least seconds at HBM_BYTES_PER_S) to
    `calls`."""
    saved = []

    def wrap(entry, real, nbytes):
        def call(*args, **kwargs):
            if args[0].is_cuda:
                calls.append((entry, nbytes(*args, **kwargs)
                              / HBM_BYTES_PER_S))
            return real(*args, **kwargs)
        return call

    try:
        for entry, e in kernel_entries(here).items():
            mod = importlib.import_module(e.MODULE)
            for attr, nbytes in e.CALLS.items():
                real = getattr(mod, attr)
                saved.append((mod, attr, real))
                setattr(mod, attr, wrap(entry, real, nbytes))
        yield calls
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)


def roofline_pct(run, metric, here=KERNEL_DIR):
    """The share of their byte roofline of the registry's kernels of
    `metric` in the profiled stage: the least seconds of their recorded
    calls over their kernels' device time.  None where nothing was
    called or launched."""
    if run.trace is None:
        return None
    entries = kernel_entries(here)
    least = sum(t for entry, t in run.window.kernel_calls
                if entries[entry].METRIC == metric)
    if not least:
        return None
    lo, hi = tracing.stage(run.trace)
    device_s = sum(e - s for s, e, n in
                   tracing.within(run.trace["activities"], lo, hi)
                   if is_port_kernel(n, metric, here)) / 1e6
    return 100.0 * least / device_s if device_s else None


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
