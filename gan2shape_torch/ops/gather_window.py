"""2x2-window gathers with the splat as their backward.

`gather_window2x2_planes` (pixel-grid, plane layout) and `gather_window2x2`
(any number of points, patch layout) are one autograd.Function whose forward
is the fetch kernel and whose backward is the splat kernel
(ops/splat_window.py), for any channel count.
"""

import torch

from gan2shape_torch.ops.splat_window import fetch2x2, splat2x2


class _Window2x2(torch.autograd.Function):
    """src (B, C, H, W), iy/ix (B, P) int32 clipped starts -> (B, 4C, P)."""

    @staticmethod
    def forward(ctx, src, iy, ix):
        ctx.save_for_backward(iy, ix)
        ctx.src_shape = tuple(src.shape)
        ctx.src_dtype = src.dtype
        return fetch2x2(src, iy, ix)

    @staticmethod
    def backward(ctx, g):
        iy, ix = ctx.saved_tensors
        dsrc = splat2x2(g.float().contiguous(), iy, ix, ctx.src_shape)
        return dsrc.to(ctx.src_dtype), None, None


def _starts(iy, ix, b, h, w):
    iy = iy.to(torch.int32).clamp(0, h - 2).reshape(b, -1).contiguous()
    ix = ix.to(torch.int32).clamp(0, w - 2).reshape(b, -1).contiguous()
    return iy, ix


def gather_window2x2_planes(src, iy, ix):
    """src (B, C, H, W); iy/ix (B, H, W) window starts (clipped to
    [0, H-2] x [0, W-2]).  Returns (B, 2, 2, C, H, W) with
    out[b, a, s, c, y, x] = src[b, c, iy[y, x]+a, ix[y, x]+s]."""
    b, c, h, w = src.shape
    iy, ix = _starts(iy, ix, b, h, w)
    out = _Window2x2.apply(src.contiguous(), iy, ix)
    return out.reshape(b, 2, 2, c, h, w)


def gather_window2x2(op, starts):
    """op (B, H, W, C); starts (B, P, 2) window starts (clipped).  Returns
    (B, P, 2, 2, C) with out[b, p, a, s] = op[b, y+a, x+s]."""
    b, h, w, c = op.shape
    p = starts.shape[1]
    iy, ix = _starts(starts[..., 0], starts[..., 1], b, h, w)
    out = _Window2x2.apply(op.permute(0, 3, 1, 2).contiguous(), iy, ix)
    return out.reshape(b, 2, 2, c, p).permute(0, 4, 1, 2, 3)
