"""upfirdn2d — zero-stuff by `up`, pad (negative pads crop), FIR filter,
keep every `down`-th sample; as direct FIR convolution in plain torch, the
form of StyleGAN2's native upfirdn2d.

Output size per axis: (in * up + pad0 + pad1 - k) // down + 1.

The filter is a pair of autograd Functions, a valid convolution of
single-channel planes and its adjoint, each the other's backward, so every
order of derivative is again an FIR filter.  Through `F.conv2d` alone, the
second derivative (R1's, in the StyleGAN2 trainer) also computes the
constant kernel's gradient: a convolution with the whole image as its
kernel, which took 97% of an R1 step's 20.5 s on an H100 (measured, PERF.md).
Both run with TF32 off under every precision policy (`exact_f32`), as the
JAX package pins its generic path to HIGHEST; under the bf16 activation
policy they run in their input's bf16.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .precision import exact_f32


def setup_filter(k, gain=1.0):
    """StyleGAN2's `make_kernel`: a 1-D input is outer-producted with itself;
    the kernel is normalised to sum 1 and multiplied by `gain`.  Returns a
    float32 numpy array."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = k / k.sum()
        return (np.outer(k, k) * gain).astype(np.float32)
    return (k / k.sum() * gain).astype(np.float32)


class _FIR(torch.autograd.Function):
    """conv2d of (N, 1, H, W) planes with a constant (1, 1, kh, kw) kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        with exact_f32():
            return F.conv2d(x, w)

    @staticmethod
    def backward(ctx, grad):
        w, = ctx.saved_tensors
        return _FIRAdjoint.apply(grad, w), None


class _FIRAdjoint(torch.autograd.Function):
    """The adjoint of `_FIR`: a full transposed convolution."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        with exact_f32():
            return F.conv_transpose2d(x, w)

    @staticmethod
    def backward(ctx, grad):
        w, = ctx.saved_tensors
        return _FIR.apply(grad, w), None


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """x (N, C, H, W); kernel (kh, kw) tensor; `up`/`down` ints or (y, x)
    pairs; `pad` (pad0, pad1) for both axes or (y0, y1, x0, x1)."""
    up_y, up_x = (up, up) if isinstance(up, int) else up
    down_y, down_x = (down, down) if isinstance(down, int) else down
    if len(pad) == 2:
        pad = (pad[0], pad[1], pad[0], pad[1])
    pad_y0, pad_y1, pad_x0, pad_x1 = pad
    n, c, h, w = x.shape
    kh, kw = kernel.shape

    out = x.reshape(n * c, 1, h, 1, w, 1)
    out = F.pad(out, [0, up_x - 1, 0, 0, 0, up_y - 1])
    out = out.reshape(n * c, 1, h * up_y, w * up_x)
    out = F.pad(out, [max(pad_x0, 0), max(pad_x1, 0),
                      max(pad_y0, 0), max(pad_y1, 0)])
    out = out[:, :, max(-pad_y0, 0):out.shape[2] - max(-pad_y1, 0),
              max(-pad_x0, 0):out.shape[3] - max(-pad_x1, 0)]
    wgt = torch.flip(kernel, (0, 1)).reshape(1, 1, kh, kw).to(out)
    out = _FIR.apply(out, wgt.detach())
    out = out[:, :, ::down_y, ::down_x]
    return out.reshape(n, c, out.shape[2], out.shape[3])


def upsample2d(x, kernel, factor=2):
    """FIR upsample; the caller bakes gain=factor**2 into `kernel`."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x, kernel, factor=2):
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur2d(x, kernel, pad):
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)
