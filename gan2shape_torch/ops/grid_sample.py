"""Differentiable bilinear / nearest grid sampling with torch-1.2
`F.grid_sample` semantics (align_corners=True, zero padding), the convention
the reference's warp grids are built for.

A bilinear sample reads the 2x2 window at floor(g), clipped into the image;
taps that fall outside are re-selected inside the clipped window and masked
to zero.  Pixel-aligned grids (grid size == image size, every warp of the
method) fetch the windows in plane layout through `gather_window2x2_planes`
(the fetch kernel forward, the splat kernel backward).
"""

import torch

from gan2shape_torch.ops.gather_window import (
    gather_window2x2, gather_window2x2_planes,
)


def _coords(grid, h, w):
    b, hg, wg, _ = grid.shape
    gx = ((grid[..., 0] + 1.0) * 0.5 * (w - 1)).reshape(b, hg * wg)
    gy = ((grid[..., 1] + 1.0) * 0.5 * (h - 1)).reshape(b, hg * wg)
    return gx, gy


def _bilinear_terms(gx, gy, h, w):
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    ix0 = x0.to(torch.int32)
    iy0 = y0.to(torch.int32)
    wx1 = gx - x0
    wy1 = gy - y0
    x0c = ix0.clamp(0, w - 2)
    y0c = iy0.clamp(0, h - 2)
    return ix0, iy0, 1.0 - wx1, wx1, 1.0 - wy1, wy1, x0c, y0c


def _accumulate(select, ix0, iy0, wx0, wx1, wy0, wy1, h, w, dtype, shape):
    """sum over the four taps of select(a, bb) * bilinear weight * valid."""
    out = None
    for a, wy in ((0, wy0), (1, wy1)):
        for bb, wx in ((0, wx0), (1, wx1)):
            jj = ix0 + bb
            ii = iy0 + a
            valid = (jj >= 0) & (jj <= w - 1) & (ii >= 0) & (ii <= h - 1)
            wgt = ((wy * wx) * valid.to(dtype)).reshape(shape)
            term = select(a, bb) * wgt
            out = term if out is None else out + term
    return out


def _plane_select(planes, dyg, dxg):
    def tap(a, bb):
        ra = (dyg + a).clamp(0, 1) == 1
        rb = (dxg + bb).clamp(0, 1) == 1
        p0 = torch.where(rb, planes[:, 0, 1], planes[:, 0, 0])
        p1 = torch.where(rb, planes[:, 1, 1], planes[:, 1, 0])
        return torch.where(ra, p1, p0)
    return tap


def grid_sample_im_mask(x, mask, grid):
    """Bilinear image + nearest mask sampling at one pixel-aligned grid, from
    ONE fetch of the channel-concatenated (image | mask) windows: round(g) is
    always a corner of the window at floor(g).  Equal to
    (grid_sample(x, grid), grid_sample(mask, grid, 'nearest'))."""
    b, c, h, w = x.shape
    _, hg, wg, _ = grid.shape
    if (hg, wg) != (h, w) or mask.dtype != x.dtype:
        return (grid_sample(x, grid, mode="bilinear"),
                grid_sample(mask, grid, mode="nearest"))
    gx, gy = _coords(grid, h, w)
    ix0, iy0, wx0, wx1, wy0, wy1, x0c, y0c = _bilinear_terms(gx, gy, h, w)
    planes = gather_window2x2_planes(torch.cat([x, mask], 1),
                                     y0c.reshape(b, h, w),
                                     x0c.reshape(b, h, w))
    imp = planes[:, :, :, :c]
    mkp = planes[:, :, :, c:]
    dyg = (iy0 - y0c).reshape(b, 1, h, w)
    dxg = (ix0 - x0c).reshape(b, 1, h, w)
    out = _accumulate(_plane_select(imp, dyg, dxg), ix0, iy0, wx0, wx1, wy0,
                      wy1, h, w, x.dtype, (b, 1, h, w))

    ixr = torch.round(gx).to(torch.int32)
    iyr = torch.round(gy).to(torch.int32)
    mvalid = (ixr >= 0) & (ixr <= w - 1) & (iyr >= 0) & (iyr <= h - 1)
    a = (iyr.clamp(0, h - 1) - y0c).clamp(0, 1).reshape(b, 1, h, w)
    s = (ixr.clamp(0, w - 1) - x0c).clamp(0, 1).reshape(b, 1, h, w)
    m0 = torch.where(s == 1, mkp[:, 0, 1], mkp[:, 0, 0])
    m1 = torch.where(s == 1, mkp[:, 1, 1], mkp[:, 1, 0])
    mout = torch.where(a == 1, m1, m0)
    return out, mout * mvalid.reshape(b, 1, h, w).to(x.dtype)


def grid_sample(x, grid, mode="bilinear"):
    """Sample x (B, C, H, W) at grid (B, Hg, Wg, 2) (x then y, in [-1, 1],
    align_corners=True); out-of-bounds samples read zero.
    Returns (B, C, Hg, Wg)."""
    b, c, h, w = x.shape
    _, hg, wg, _ = grid.shape
    gx, gy = _coords(grid, h, w)

    if mode == "nearest":
        ix = torch.round(gx).long()
        iy = torch.round(gy).long()
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        out = torch.gather(x.reshape(b, c, h * w), 2,
                           idx[:, None, :].expand(b, c, -1))
        out = out * valid[:, None, :].to(x.dtype)
        return out.reshape(b, c, hg, wg)
    if mode != "bilinear":
        raise ValueError(f"unsupported mode: {mode}")

    ix0, iy0, wx0, wx1, wy0, wy1, x0c, y0c = _bilinear_terms(gx, gy, h, w)
    dy = iy0 - y0c  # 0 inside; +-1 at the edges (taps re-selected)
    dx = ix0 - x0c

    if (hg, wg) == (h, w):
        planes = gather_window2x2_planes(x, y0c.reshape(b, h, w),
                                         x0c.reshape(b, h, w))
        return _accumulate(
            _plane_select(planes, dy.reshape(b, 1, h, w),
                          dx.reshape(b, 1, h, w)),
            ix0, iy0, wx0, wx1, wy0, wy1, h, w, x.dtype, (b, 1, h, w))

    patch = gather_window2x2(x.permute(0, 2, 3, 1),
                             torch.stack([y0c, x0c], -1))  # (B, P, 2, 2, C)

    def tap(a, bb):
        ra = ((dy + a).clamp(0, 1) == 1)[..., None]
        rb = ((dx + bb).clamp(0, 1) == 1)[..., None]
        p0 = torch.where(rb, patch[:, :, 0, 1], patch[:, :, 0, 0])
        p1 = torch.where(rb, patch[:, :, 1, 1], patch[:, :, 1, 0])
        return torch.where(ra, p1, p0)

    out = _accumulate(tap, ix0, iy0, wx0, wx1, wy0, wy1, h, w, x.dtype,
                      (b, hg * wg, 1))
    return out.permute(0, 2, 1).reshape(b, c, hg, wg)
