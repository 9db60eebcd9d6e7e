"""2x2-window fetch and its transpose (the splat): wrappers of the CUDA
kernels in csrc/window.cu, with their plain torch versions.

  fetch2x2(src, iy, ix) -> out:  out[b, (a*2+s)*C + ch, p]
                                   = src[b, ch, iy[b,p]+a, ix[b,p]+s]
  splat2x2(g, iy, ix, shape) -> dsrc:  dsrc[b, ch, iy+a, ix+s]
                                   += g[b, (a*2+s)*C + ch, p]

src (B, C, H, W) f32; iy/ix (B, P) int32 window starts, clipped to
[0, H-2] x [0, W-2]; out and g (B, 4C, P).  P is any number of points; the
rasterizer and pixel-aligned grid_sample use P = H*W (one window per pixel).

The CUDA kernels replace gan2shape_tpu/ops/splat_window.py:_fetch_pallas and
:_splat_pallas; a CUDA tensor always goes to the kernel (or raises), a CPU
tensor to the plain version.  The fetch is bit-exact; the splat's atomics
make its summation order, and so its last bits, vary from run to run.
"""

import torch

from gan2shape_torch.ops import _cuda


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


def _check_starts(src_b, iy, ix):
    _cuda.check_cuda_tensor(iy, "iy", torch.int32, 2)
    _cuda.check_cuda_tensor(ix, "ix", torch.int32, 2)
    if iy.shape != ix.shape or iy.shape[0] != src_b:
        raise ValueError(f"starts {tuple(iy.shape)}/{tuple(ix.shape)} do not "
                         f"match batch {src_b}")


def fetch2x2(src, iy, ix):
    """See module docstring.  Returns (B, 4C, P) f32."""
    if src.device.type == "cpu":
        return fetch2x2_plain(src, iy, ix)
    _cuda.check_cuda_tensor(src, "src", torch.float32, 4)
    b, c, h, w = src.shape
    if h < 2 or w < 2:
        raise ValueError("fetch2x2 needs H, W >= 2")
    _check_starts(b, iy, ix)
    p = iy.shape[1]
    out = torch.empty((b, 4 * c, p), dtype=torch.float32, device=src.device)
    lib = _cuda.load("window")
    err = lib.g2s_fetch2x2(src.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                           out.data_ptr(), b, c, h, w, p,
                           _cuda.stream_of(src))
    _cuda.check(err, "fetch2x2")
    _cuda.LAUNCHES["fetch2x2"] += 1
    return out


def splat2x2(g, iy, ix, shape):
    """See module docstring.  `shape` = (B, C, H, W) of the source; returns
    dsrc of that shape, f32."""
    if g.device.type == "cpu":
        return splat2x2_plain(g, iy, ix, shape)
    b, c, h, w = shape
    _cuda.check_cuda_tensor(g, "g", torch.float32, 3)
    _check_starts(b, iy, ix)
    p = iy.shape[1]
    if tuple(g.shape) != (b, 4 * c, p):
        raise ValueError(f"g {tuple(g.shape)} != {(b, 4 * c, p)}")
    dsrc = torch.zeros((b, c, h, w), dtype=torch.float32, device=g.device)
    lib = _cuda.load("window")
    err = lib.g2s_splat2x2(g.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                           dsrc.data_ptr(), b, c, h, w, p, _cuda.stream_of(g))
    _cuda.check(err, "splat2x2")
    _cuda.LAUNCHES["splat2x2"] += 1
    return dsrc
