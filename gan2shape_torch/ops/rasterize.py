"""Differentiable depth rasterization of a warped grid mesh ('grid' mode).

The mesh is the fixed regular-grid triangulation of a depth map:
2*(h-1)*(w-1) small triangles.  Three stages:

  1. [no grad] placement: each face's compact int16 payload goes to its
     half-pixel bbox-start slot; on a slot collision the nearest face wins
     (`raster_place`);
  2. [no grad] candidate tests: every output pixel tests the payloads of the
     2 parities x 4 half-pixel phases x window^2 slots that can cover it and
     keeps the min packed (quantized depth << 17 | face id) key
     (`raster_tests`);
  3. [differentiable] the winning face's three vertices are fetched from the
     live vertex fields (`gather_window2x2_planes`) and re-interpolated with
     exact barycentric, perspective-correct 1/z, so gradients reach the
     vertices.

Stages 1 and 2 are the CUDA kernels of csrc/raster.cu on CUDA tensors and the
plain torch versions below (the JAX package's `_build_winner_buffers` +
`_dense_winner_xla`, bit for bit) on CPU tensors.
"""

import numpy as np
import torch

from gan2shape_torch.ops import _cuda
from gan2shape_torch.ops.gather_window import gather_window2x2_planes

DEPTH_BITS = 14
FACE_BITS = 17  # 2*(h-1)*(w-1) faces: up to 256x256 grids
SENTINEL = 2 ** 31 - 1
N_CHANNELS = 10


def _f32(x):
    """A Python float holding exactly the float32 nearest to `x`, so torch
    and the kernels see the same constant."""
    return float(np.float32(x))


def grid_faces(h, w):
    """Regular-grid triangulation: per cell, faces (tl, bl, tr) and
    (tr, bl, br) over row-major vertex ids."""
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
    f1 = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], -1)
    f2 = np.stack([idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]], -1)
    return np.concatenate([f1.reshape(-1, 3), f2.reshape(-1, 3)], 0)


def _barycentric(px, py, x0, y0, x1, y1, x2, y2):
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    degenerate = torch.abs(denom) <= 1e-12
    safe = torch.where(degenerate, torch.ones_like(denom), denom)
    l0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / safe
    l1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / safe
    l2 = 1.0 - l0 - l1
    return l0, l1, l2, degenerate


def _inv_z_quant(near, far):
    """Per-vertex 1/z payload quantization: 15 bits over [1/far, 1/near].
    Returns float32-exact (r_lo, r_step)."""
    r_lo = 1.0 / max(far, 1e-6)
    r_step = max(1.0 / max(near, 1e-6) - r_lo, 1e-9) / 32767.0
    return _f32(r_lo), _f32(r_step)


def _depth_scale(near, far):
    return _f32((2 ** DEPTH_BITS - 1) / (far - near))


def _cand_key_int(dx0, dy0, dx1, dy1, dx2, dy2, r0q, r1q, r2q, cell,
                  ox, oy, parity, n_faces, near, far):
    """One candidate test on f32 payload planes: barycentric inside test in
    slot-relative 1/256-px fixed point, then the packed ranking key
    (quantized depth << FACE_BITS) | face id; SENTINEL where not covered."""
    px2 = 256.0 * ox - dx2
    py2 = 256.0 * oy - dy2
    denom = (dy1 - dy2) * (dx0 - dx2) + (dx2 - dx1) * (dy0 - dy2)
    ok_den = torch.abs(denom) > 0.5
    safe = torch.where(ok_den, denom, torch.ones_like(denom))
    l0 = ((dy1 - dy2) * px2 + (dx2 - dx1) * py2) / safe
    l1 = ((dy2 - dy0) * px2 + (dx0 - dx2) * py2) / safe
    l2 = 1.0 - l0 - l1
    eps = _f32(-1e-5)
    inside = (l0 >= eps) & (l1 >= eps) & (l2 >= eps) & ok_den & (cell >= 0)
    r_lo, r_step = _inv_z_quant(near, far)
    inv_z = (l0 * (r_lo + r0q * r_step) + l1 * (r_lo + r1q * r_step)
             + l2 * (r_lo + r2q * r_step))
    z = 1.0 / torch.clamp_min(inv_z, _f32(1e-12))
    zq = torch.clamp((z - _f32(near)) * _depth_scale(near, far), 0,
                     2 ** DEPTH_BITS - 1)
    key = ((zq.to(torch.int32) << FACE_BITS)
           | (cell.to(torch.int32) + parity * n_faces))
    return torch.where(inside, key, torch.full_like(key, SENTINEL))


def decode_key(key, n_faces):
    """Winner key -> (cell int64, lower-triangle bool, covered bool)."""
    covered = key != SENTINEL
    fid = (key & (2 ** FACE_BITS - 1)).long()
    par = (fid >= n_faces) & covered
    cell = torch.where(covered, fid - par.long() * n_faces,
                       torch.full_like(fid, -1))
    return cell, par, covered


# ---------------- stage 1: placement ----------------

def build_winner_buffers_plain(vx, vy, vz, window, near, far):
    """Plain version of the placement kernel.  vx/vy/vz (B, H, W) f32.
    Returns (2, B, 2, 2, 10, HP, WP) int16 payloads (parity, batch, y-phase,
    x-phase, channel, padded row, padded column), -1 where empty."""
    b, h, w = vx.shape
    dev = vx.device
    pad = window + 1
    hp, wp = h + 2 * pad, w + 2 * pad
    plane = hp * wp
    per_batch = 4 * N_CHANNELS * plane
    n_faces = (h - 1) * (w - 1)
    r_lo, r_step = _inv_z_quant(near, far)

    def corners(v):
        return (v[:, :-1, :-1], v[:, 1:, :-1], v[:, :-1, 1:], v[:, 1:, 1:])

    xtl, xbl, xtr, xbr = corners(vx)
    ytl, ybl, ytr, ybr = corners(vy)
    ztl, zbl, ztr, zbr = corners(vz)
    cell_id = torch.arange(n_faces, dtype=torch.int32, device=dev).reshape(
        1, h - 1, w - 1).expand(b, -1, -1)
    batch_off = (torch.arange(b, device=dev) * per_batch).reshape(b, 1, 1)

    def half_pixel_floor(a, bb, c):
        m = torch.floor(2.0 * torch.minimum(torch.minimum(a, bb), c))
        return m.clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)

    def fx16(v, anchor):
        q = torch.round((v - anchor) * 256.0).clamp(-32767, 32767)
        return q.to(torch.int16)

    # a tensor divisor: on CUDA, torch turns division by a Python scalar
    # into multiplication by its reciprocal, which is not the IEEE quotient
    r_step_t = torch.tensor(r_step, dtype=torch.float32, device=dev)

    def rq16(z):
        q = torch.round((1.0 / torch.clamp_min(z, _f32(1e-6)) - r_lo)
                        / r_step_t)
        return q.clamp(0, 32767).to(torch.int16)

    bufs = []
    for tri in (((xtl, ytl, ztl), (xbl, ybl, zbl), (xtr, ytr, ztr)),
                ((xtr, ytr, ztr), (xbl, ybl, zbl), (xbr, ybr, zbr))):
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = tri
        bx2 = half_pixel_floor(x0, x1, x2)
        by2 = half_pixel_floor(y0, y1, y2)
        inb = ((bx2 >= -2 * pad) & (bx2 < 2 * (wp - pad))
               & (by2 >= -2 * pad) & (by2 < 2 * (hp - pad)))
        s_x = (bx2 + 2 * pad).clamp(0, 2 * wp - 1)
        s_y = (by2 + 2 * pad).clamp(0, 2 * hp - 1)
        qy, sy = s_y // 2, s_y % 2
        qx, sx = s_x // 2, s_x % 2
        ax = (qx - pad).to(vx.dtype)
        ay = (qy - pad).to(vx.dtype)
        r0q = rq16(z0)
        channels = (fx16(x0, ax), fx16(y0, ay), fx16(x1, ax), fx16(y1, ay),
                    fx16(x2, ax), fx16(y2, ay), r0q, rq16(z1), rq16(z2),
                    cell_id.to(torch.int16))
        slot = (batch_off + (sy * 2 + sx) * N_CHANNELS * plane
                + qy * wp + qx)[inb]
        # nearest-wins collision merge: min of (32767 - r0q) << 16 | cell
        zkey = (((32767 - r0q.to(torch.int32)) << 16) | cell_id)[inb]
        kbuf = torch.full((b * per_batch,), SENTINEL, dtype=torch.int32,
                          device=dev)
        kbuf.scatter_reduce_(0, slot, zkey, reduce="amin")
        won = kbuf[slot] == zkey
        slot = slot[won]
        vals = torch.stack([c[inb][won] for c in channels], -1)  # (n, 10)
        idx = slot[:, None] + torch.arange(N_CHANNELS, device=dev) * plane
        buf = torch.full((b * per_batch,), -1, dtype=torch.int16, device=dev)
        buf[idx.reshape(-1)] = vals.reshape(-1)
        bufs.append(buf.reshape(b, 2, 2, N_CHANNELS, hp, wp))
    return torch.stack(bufs)


def raster_place(vx, vy, vz, window, near, far):
    """Placement: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  See `build_winner_buffers_plain` for the result."""
    if vx.device.type == "cpu":
        return build_winner_buffers_plain(vx, vy, vz, window, near, far)
    for name, t in (("vx", vx), ("vy", vy), ("vz", vz)):
        _cuda.check_cuda_tensor(t, name, torch.float32, 3)
    if not vx.shape == vy.shape == vz.shape:
        raise ValueError("vx, vy, vz must have one shape")
    b, h, w = vx.shape
    pad = window + 1
    hp, wp = h + 2 * pad, w + 2 * pad
    kbuf = torch.full((2, b, 4, hp, wp), SENTINEL, dtype=torch.int32,
                      device=vx.device)
    buf = torch.full((2, b, 2, 2, N_CHANNELS, hp, wp), -1, dtype=torch.int16,
                     device=vx.device)
    r_lo, r_step = _inv_z_quant(near, far)
    lib = _cuda.load("raster")
    for pass_ in (0, 1):  # 0: nearest-wins atomicMin, 1: the winner writes
        err = lib.g2s_raster_place(vx.data_ptr(), vy.data_ptr(),
                                   vz.data_ptr(), kbuf.data_ptr(),
                                   buf.data_ptr(), b, h, w, pad, r_lo, r_step,
                                   pass_, _cuda.stream_of(vx))
        _cuda.check(err, "raster_place")
        _cuda.LAUNCHES["raster_place"] += 1
    return buf


# ---------------- stage 2: candidate tests ----------------

def dense_winner_plain(bufs, h, w, window, near, far):
    """Plain version of the candidate-test kernel: min key over all
    2 x 4 x window^2 candidates.  Returns (B, H, W) int32 keys."""
    b = bufs.shape[1]
    pad = window + 1
    n_faces = (h - 1) * (w - 1)
    best = torch.full((b, h, w), SENTINEL, dtype=torch.int32,
                      device=bufs.device)
    for parity in range(2):
        for oy in range(window):
            for sy in range(2):
                for ox in range(window):
                    for sx in range(2):
                        sl = bufs[parity, :, sy, sx, :, pad - oy:pad - oy + h,
                                  pad - ox:pad - ox + w].float()
                        key = _cand_key_int(*sl.unbind(1), ox, oy, parity,
                                            n_faces, near, far)
                        best = torch.minimum(best, key)
    return best


def raster_tests(bufs, h, w, window, near, far):
    """Candidate tests: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns (B, H, W) int32 winner keys."""
    if bufs.device.type == "cpu":
        return dense_winner_plain(bufs, h, w, window, near, far)
    _cuda.check_cuda_tensor(bufs, "bufs", torch.int16, 7)
    pad = window + 1
    b = bufs.shape[1]
    expect = (2, b, 2, 2, N_CHANNELS, h + 2 * pad, w + 2 * pad)
    if tuple(bufs.shape) != expect:
        raise ValueError(f"bufs {tuple(bufs.shape)} != {expect}")
    key = torch.empty((b, h, w), dtype=torch.int32, device=bufs.device)
    r_lo, r_step = _inv_z_quant(near, far)
    lib = _cuda.load("raster")
    err = lib.g2s_raster_tests(bufs.data_ptr(), key.data_ptr(), b, h, w, pad,
                               window, r_lo, r_step, _f32(near),
                               _depth_scale(near, far),
                               _cuda.stream_of(bufs))
    _cuda.check(err, "raster_tests")
    _cuda.LAUNCHES["raster_tests"] += 1
    return key


def winner_keys(vx, vy, vz, window, near, far):
    """Stages 1 + 2 on detached vertex fields: (B, H, W) int32 keys."""
    h, w = vx.shape[1:]
    bufs = raster_place(vx, vy, vz, window, near, far)
    return raster_tests(bufs, h, w, window, near, far)


# ---------------- stage 3 and entry points ----------------

def rasterize_depth_grid(vx, vy, vz, window=3, near=0.3, far=1.3):
    """vx, vy (B, H, W) screen coords of the warped grid, vz (B, H, W)
    camera depth.  Returns the (B, H, W) depth map, `far` where uncovered;
    differentiable in vx, vy, vz through the winner's re-interpolation."""
    b, h, w = vx.shape
    n_faces = (h - 1) * (w - 1)
    with torch.no_grad():
        key = winner_keys(vx.detach().contiguous(), vy.detach().contiguous(),
                          vz.detach().contiguous(), window, near, far)
        cell, par, covered = decode_key(key, n_faces)
        ci = torch.div(cell, w - 1, rounding_mode="floor").clamp(0, h - 2)
        cj = (cell - ci * (w - 1)).clamp(0, w - 2)
        # uncovered pixels get zero cotangent through the select below;
        # anchor their window at the pixel itself
        py = torch.arange(h, device=vx.device).reshape(1, h, 1)
        px = torch.arange(w, device=vx.device).reshape(1, 1, w)
        ci = torch.where(covered, ci, py.clamp(max=h - 2))
        cj = torch.where(covered, cj, px.clamp(max=w - 2))

    planes = gather_window2x2_planes(torch.stack([vx, vy, vz], 1), ci, cj)
    p_tl, p_tr = planes[:, 0, 0], planes[:, 0, 1]
    p_bl, p_br = planes[:, 1, 0], planes[:, 1, 1]  # each (B, 3, H, W)
    # upper tri = (tl, bl, tr), lower = (tr, bl, br) (grid_faces order)
    is_up = (~par)[:, None]
    pv0 = torch.where(is_up, p_tl, p_tr)
    pv1 = p_bl
    pv2 = torch.where(is_up, p_tr, p_br)
    gx = torch.arange(w, dtype=vx.dtype, device=vx.device).reshape(1, 1, w)
    gy = torch.arange(h, dtype=vx.dtype, device=vx.device).reshape(1, h, 1)
    l0, l1, l2, _ = _barycentric(gx, gy, pv0[:, 0], pv0[:, 1], pv1[:, 0],
                                 pv1[:, 1], pv2[:, 0], pv2[:, 1])
    inv_z = l0 / pv0[:, 2] + l1 / pv1[:, 2] + l2 / pv2[:, 2]
    z = 1.0 / torch.maximum(inv_z, inv_z.new_tensor(1e-12))
    return torch.where(covered, z, z.new_tensor(far))


def rasterize_depth(xs, ys, zs, h, w, window=5, near=0.3, far=1.3):
    """Depth map of the projected grid mesh (the JAX function's 'grid' mode,
    the only one ported; its triangulation is `grid_faces(h, w)`).  xs, ys
    (B, N) pixel coordinates, zs (B, N) camera depth, N == h*w row-major;
    the window is capped at 5."""
    if xs.shape[1] != h * w:
        raise ValueError(f"{xs.shape[1]} vertices do not form a {h}x{w} grid")
    b = xs.shape[0]
    return rasterize_depth_grid(
        xs.reshape(b, h, w), ys.reshape(b, h, w), zs.reshape(b, h, w),
        window=min(window, 5), near=float(near), far=float(far))
