"""2x2-window gathers with the splat as their backward, in plain torch: a
gather forward and an f32 `scatter_add_` backward, on every device."""

import torch


def _clip_starts(iy, ix, h, w):
    return iy.clamp(0, h - 2), ix.clamp(0, w - 2)


def _tap_index(iy, ix, w):
    """(4, B, P) flat source index of each tap, order a*2+s."""
    return torch.stack([(iy + a) * w + (ix + s)
                        for a in (0, 1) for s in (0, 1)])


def fetch2x2_plain(src, iy, ix):
    b, c, h, w = src.shape
    iy, ix = _clip_starts(iy.long(), ix.long(), h, w)
    idx = _tap_index(iy, ix, w)  # (4, B, P)
    flat = src.reshape(b, c, h * w)
    taps = [torch.gather(flat, 2, idx[t][:, None, :].expand(b, c, -1))
            for t in range(4)]
    return torch.cat(taps, 1)  # (B, 4C, P)


def splat2x2_plain(g, iy, ix, shape):
    b, c, h, w = shape
    iy, ix = _clip_starts(iy.long(), ix.long(), h, w)
    idx = _tap_index(iy, ix, w)
    dsrc = torch.zeros((b, c, h * w), dtype=torch.float32, device=g.device)
    for t in range(4):
        dsrc.scatter_add_(2, idx[t][:, None, :].expand(b, c, -1),
                          g[:, t * c:(t + 1) * c].float())
    return dsrc.reshape(b, c, h, w)


class _Window2x2(torch.autograd.Function):
    """src (B, C, H, W), iy/ix (B, P) int32 clipped starts -> (B, 4C, P)."""

    @staticmethod
    def forward(ctx, src, iy, ix):
        ctx.save_for_backward(iy, ix)
        ctx.src_shape = tuple(src.shape)
        ctx.src_dtype = src.dtype
        return fetch2x2_plain(src, iy, ix)

    @staticmethod
    def backward(ctx, g):
        iy, ix = ctx.saved_tensors
        dsrc = splat2x2_plain(g.float().contiguous(), iy, ix, ctx.src_shape)
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
