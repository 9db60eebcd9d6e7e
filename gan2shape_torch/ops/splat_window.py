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
tensor to the plain version.  The fetch is bit-exact.  The splat kernel sums
in fixed point (int64, a power-of-two scale per (batch, channel) plane; see
csrc/window.cu), so it gives the same bits on every call: it equals
`splat2x2_fixed_plain` bit for bit and `splat2x2_plain`, the f32 sum, within
a few ulps of the largest value.  A plane of g that holds an inf or a NaN
comes out all NaN on the card.
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


NON_FINITE_BITS = 0x7F800000  # |g| as float bits at or above: inf or NaN


def ceil_log2(n):
    return max(int(n) - 1, 0).bit_length()


def _pow2(k):
    """2.0 ** k as float64, exactly, built from its bits."""
    return ((k + 1023) << 52).view(torch.float64)


def fixed_scale(g, c):
    """The splat kernel's scale of each (batch, channel) plane of g (B, 4C,
    P): (k (B, C) int64, non-finite (B, C) bool).  Addends become
    round(g * 2^k); with the plane's largest |g| < 2^e, k = 53 -
    ceil(log2 P) - e keeps every sum of at most P of them within 2^53."""
    b, _, p = g.shape
    bits = (g.reshape(b, 4, c, p).abs().amax((1, 3))
            .view(torch.int32).long() & 0x7FFFFFFF)
    e = (bits >> 23).clamp(min=1) - 126
    return 53 - ceil_log2(p) - e, bits >= NON_FINITE_BITS


def splat2x2_fixed_plain(g, iy, ix, shape):
    """The splat kernel's arithmetic in torch: the same scale, an int64
    `scatter_add_` of round(g * 2^k), and sum * 2^-k rounded once to f32.
    Equal to the card's kernel bit for bit; for tests and chip_smoke."""
    b, c, h, w = shape
    p = iy.shape[1]
    if p == 0:
        return torch.zeros(shape, dtype=torch.float32, device=g.device)
    k, bad = fixed_scale(g.float(), c)
    scaled = g.double().reshape(b, 4, c, p) * _pow2(k)[:, None, :, None]
    q = torch.round(torch.where(bad[:, None, :, None], 0.0, scaled)).long()
    iy, ix = _clip_starts(iy.long(), ix.long(), h, w)
    idx = _tap_index(iy, ix, w)
    acc = torch.zeros((b, c, h * w), dtype=torch.int64, device=g.device)
    for t in range(4):
        acc.scatter_add_(2, idx[t][:, None, :].expand(b, c, -1), q[:, t])
    out = (acc.double() * _pow2(-k)[..., None]).float()
    out = torch.where(bad[..., None], float("nan"), out)
    return out.reshape(b, c, h, w)


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
    dsrc of that shape, f32.  On the card the same inputs give the same bits
    on every call."""
    if g.device.type == "cpu":
        return splat2x2_plain(g, iy, ix, shape)
    b, c, h, w = shape
    _cuda.check_cuda_tensor(g, "g", torch.float32, 3)
    _check_starts(b, iy, ix)
    p = iy.shape[1]
    if tuple(g.shape) != (b, 4 * c, p):
        raise ValueError(f"g {tuple(g.shape)} != {(b, 4 * c, p)}")
    dsrc = torch.empty((b, c, h, w), dtype=torch.float32, device=g.device)
    if dsrc.numel() == 0:
        return dsrc
    # the int64 sums, then the B*C plane maxima (uint32, two an int64 slot)
    scratch = torch.empty(dsrc.numel() + (b * c + 1) // 2,
                          dtype=torch.int64, device=g.device)
    lib = _cuda.load("window")
    err = lib.g2s_splat2x2(g.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                           dsrc.data_ptr(), scratch.data_ptr(), b, c, h, w,
                           p, _cuda.stream_of(g))
    _cuda.check(err, "splat2x2")
    _cuda.LAUNCHES["splat2x2"] += 1
    return dsrc
