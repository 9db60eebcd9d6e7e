"""Differentiable depth rasterization of a warped grid mesh.

The mesh is the fixed regular-grid triangulation of a depth map:
2*(h-1)*(w-1) small triangles.  Three winner passes, selected by `mode`:

  * 'grid' (the training path, `rasterize_depth_grid`): the CUDA kernels
    below;
  * 'scatter' (`_winner_pass`): the exact z-buffer, exact-f32 nearest face
    with lowest-id ties over every face's window^2 bbox-offset pixels; used
    by the mesh-RGB renders and as the exactness oracle;
  * 'invwarp' (`_winner_pass_invwarp`): fixed-point inversion of the vertex
    displacement field, then exact tests of the faces around the estimate.

'scatter' and 'invwarp' are plain torch (the JAX package's are XLA, not
Pallas); both re-interpolate the winner differentiably by a gather.

'grid' mode has three stages:

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
`_dense_winner_xla`, bit for bit) on CPU tensors.  `raster_mega` runs the
same two stages under the contract of the JAX package's `_raster_mega_pallas`
(cell, parity, covered); `dense_winner` is the buffers path in that form.
"""

import numpy as np
import torch

from gan2shape_torch.ops import _cuda
from gan2shape_torch.ops.gather_window import gather_window2x2_planes

DEPTH_BITS = 14
FACE_BITS = 17  # 2*(h-1)*(w-1) faces: up to 256x256 grids
SENTINEL = 2 ** 31 - 1
N_CHANNELS = 10
# the write pass's grid has 2 * 4 * B rows of blocks, at most 65535
MAX_PLACE_BATCH = 8191
MODES = ("grid", "scatter", "invwarp")


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


def _fma(a, b, c):
    """a * b + c of f32 tensors as a fused multiply-add: the product of two
    f32 is exact in f64, and the f64 sum is rounded to f32.  That is two
    roundings, so it is one ulp off a true FMA where the f64 sum lands
    exactly on an f32 halfway point that the exact sum misses (the low 29
    bits of the f64 sum must equal one pattern: about 2^-29 of calls on
    data without such structure).  An exact version (a round-to-odd f64
    sum) made 'scatter' 1.4x and 'invwarp' 1.5-1.9x slower on an H100."""
    return (a.double() * b.double() + c.double()).float()


def _barycentric_jit(px, py, x0, y0, x1, y1, x2, y2, z0, z1, z2):
    """`_barycentric` and the interpolated 1/z as the JAX package's jitted
    winner passes compute them: XLA rewrites (n / d) / z as n / (d * z), and
    XLA:CPU contracts a*b + c*d into fma(a, b, c*d).  The exact z-buffer
    breaks depth ties on these bits, so the port does the same."""
    denom = _fma(y1 - y2, x0 - x2, (x2 - x1) * (y0 - y2))
    degenerate = torch.abs(denom) <= 1e-12
    safe = torch.where(degenerate, torch.ones_like(denom), denom)
    n0 = _fma(y1 - y2, px - x2, (x2 - x1) * (py - y2))
    n1 = _fma(y2 - y0, px - x2, (x0 - x2) * (py - y2))
    l0 = n0 / safe
    l1 = n1 / safe
    l2 = 1.0 - l0 - l1
    inv_z = n0 / (safe * z0) + n1 / (safe * z1) + l2 / z2
    return l0, l1, l2, degenerate, inv_z


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
    """Plain version of the placement kernels.  vx/vy/vz (B, H, W) f32.
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
    """Placement: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors.  See `build_winner_buffers_plain` for the result.  Grids of
    1 to 2^16 cells on either device: a cell id fills the 16 low bits of
    the collision key."""
    b, h, w = vx.shape
    if not (h > 1 and w > 1 and (h - 1) * (w - 1) <= 2 ** 16):
        raise ValueError(f"placement takes 1 to 2^16 cells, got "
                         f"{h - 1} x {w - 1}")
    if vx.device.type == "cpu":
        return build_winner_buffers_plain(vx, vy, vz, window, near, far)
    for name, t in (("vx", vx), ("vy", vy), ("vz", vz)):
        _cuda.check_cuda_tensor(t, name, torch.float32, 3)
    if not vx.shape == vy.shape == vz.shape:
        raise ValueError("vx, vy, vz must have one shape")
    if b > MAX_PLACE_BATCH:
        raise ValueError(f"placement takes at most {MAX_PLACE_BATCH} grids, "
                         f"got {b}")
    pad = window + 1
    hp, wp = h + 2 * pad, w + 2 * pad
    # the payloads, which the write pass fills whole
    buf = torch.empty((2, b, 2, 2, N_CHANNELS, hp, wp), dtype=torch.int16,
                      device=vx.device)
    if b == 0:
        return buf
    kbuf = torch.empty((2, b, 4, hp, wp), dtype=torch.int32, device=vx.device)
    r_lo, r_step = _inv_z_quant(near, far)
    err = _cuda.load("raster").g2s_raster_place(
        vx.data_ptr(), vy.data_ptr(), vz.data_ptr(), kbuf.data_ptr(),
        buf.data_ptr(), b, h, w, pad, r_lo, r_step, _cuda.stream_of(vx))
    _cuda.check(err, "raster_place")
    # place_collide_kernel and place_write_kernel
    _cuda.LAUNCHES["raster_place"] += 2
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
    for CPU tensors.  Window 1 to 5 (the grid mode's cap) on either device;
    a ValueError beyond.  Returns (B, H, W) int32 winner keys."""
    if not 1 <= window <= 5:
        raise ValueError(f"the candidate tests take window 1 to 5, got "
                         f"{window}")
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
    """Stages 1 + 2 on detached vertex fields: (B, H, W) int32 keys.
    Window 1 to 5 on either device (see `raster_tests`)."""
    h, w = vx.shape[1:]
    bufs = raster_place(vx, vy, vz, window, near, far)
    return raster_tests(bufs, h, w, window, near, far)


def _winner_cells(key):
    """(B, H, W) winner keys -> the JAX kernels' (cell f32, parity f32,
    covered bool) planes."""
    h, w = key.shape[1:]
    cell, par, covered = decode_key(key, (h - 1) * (w - 1))
    return cell.float(), par.float(), covered


def raster_mega(vx, vy, vz, window, near, far):
    """Counterpart of the JAX package's `_raster_mega_pallas`: placement and
    candidate tests on (B, H, W) vertex fields, returning (cell f32,
    parity f32, covered bool).  That kernel's serial placement overwrites a
    slot only with a strictly smaller (32767 - r0q) << 16 | cell key and
    drops no displaced face, which is the nearest-wins min-merge of
    `raster_place`; so on CUDA tensors this runs the placement and test
    kernels of csrc/raster.cu, on CPU tensors their plain versions; window
    1 to 5 on either device.  It launches no kernel of its own: its
    launches are counted as `raster_place` (two) and `raster_tests`
    (one)."""
    key = winner_keys(*(t.detach().contiguous() for t in (vx, vy, vz)),
                      window, near, far)
    return _winner_cells(key)


def dense_winner(vx, vy, vz, window, near, far):
    """The buffers path (`_build_winner_buffers` + `_dense_winner_xla`) in
    its (cell f32, parity f32, covered bool) form, by the plain versions on
    any device: the oracle `raster_mega` is held to."""
    h, w = vx.shape[1:]
    bufs = build_winner_buffers_plain(vx, vy, vz, window, near, far)
    return _winner_cells(dense_winner_plain(bufs, h, w, window, near, far))


# ---------------- 'scatter' and 'invwarp' winner passes ----------------

@torch.no_grad()
def _winner_pass(xs, ys, zs, faces, h, w, window):
    """Exact z-buffer (no gradient): winner face id per pixel (B, H, W)
    int64, -1 where uncovered.  xs/ys/zs (B, N) screen coords and camera
    depth, faces (F, 3) int64.  Each face tests the window^2 pixels at offsets (dy, dx) from its
    integer bbox start.  Ranking is exact-f32 nearest with lowest-face-id
    ties: positive floats order as their int32 bit patterns, so two
    scatter-min passes (min depth bits per pixel, then min face id among the
    candidates at that depth) give the lexicographic (depth, id) order."""
    b = xs.shape[0]
    n_faces = faces.shape[0]
    dev = xs.device
    fx, fy, fz = xs[:, faces], ys[:, faces], zs[:, faces]  # (B, F, 3)
    x0, x1, x2 = fx.unbind(-1)
    y0, y1, y2 = fy.unbind(-1)

    def floor_int(v):
        return torch.floor(v).clamp(-2.0 ** 30, 2.0 ** 30).long()

    bx = floor_int(torch.minimum(torch.minimum(x0, x1), x2))
    by = floor_int(torch.minimum(torch.minimum(y0, y1), y2))
    offs = torch.arange(window, device=dev)
    dy = offs.repeat_interleave(window).reshape(-1, 1, 1)  # (K, 1, 1)
    dx = offs.repeat(window).reshape(-1, 1, 1)
    px_i = bx + dx  # (K, B, F)
    py_i = by + dy
    l0, l1, l2, degen, inv_z = _barycentric_jit(
        px_i.to(xs.dtype), py_i.to(xs.dtype), x0, y0, x1, y1, x2, y2,
        *fz.unbind(-1))
    z = 1.0 / torch.clamp_min(inv_z, _f32(1e-12))
    eps = _f32(-1e-5)
    ok = ((l0 >= eps) & (l1 >= eps) & (l2 >= eps) & ~degen
          & (px_i >= 0) & (px_i < w) & (py_i >= 0) & (py_i < h) & (z > 0))
    zbits = torch.where(ok, z.view(torch.int32), SENTINEL).reshape(-1)
    pix = py_i.clamp(0, h - 1) * w + px_i.clamp(0, w - 1)
    seg = (pix + torch.arange(b, device=dev).reshape(b, 1) * (h * w)
           ).reshape(-1)

    def segment_min(vals):
        out = torch.full((b * h * w,), SENTINEL, dtype=torch.int32,
                         device=dev)
        return out.scatter_reduce_(0, seg, vals, reduce="amin")

    buf_z = segment_min(zbits)
    fid = torch.arange(n_faces, dtype=torch.int32, device=dev).expand(
        px_i.shape).reshape(-1)
    buf_f = segment_min(torch.where((zbits == buf_z[seg]) & ok.reshape(-1),
                                    fid, SENTINEL))
    return torch.where(buf_z == SENTINEL, -1, buf_f.long()).reshape(b, h, w)


@torch.no_grad()
def _winner_pass_invwarp(xs, ys, zs, h, w, search=1, fp_iters=8):
    """Gather-only winner search for grid meshes (no gradient): winner face
    ids (B, H, W) int64 in `grid_faces` order, -1 where uncovered.  Each
    pixel's source cell is found by fixed-point inversion of the vertex displacement field
    (c <- p - D(c), bilinear gathers), started from the nearest screen
    vertex of a stride-4 subgrid; then the 2 * (2*search+1)^2 faces around
    that cell are tested exactly and the nearest hit wins.  Exact where the
    warp's folds stay inside the search neighbourhood."""
    b = xs.shape[0]
    dt, dev = xs.dtype, xs.device
    fx, fy, fz = (v.reshape(b, h, w) for v in (xs, ys, zs))
    gy = torch.arange(h, dtype=dt, device=dev).reshape(h, 1).expand(h, w)
    gx = torch.arange(w, dtype=dt, device=dev).reshape(1, w).expand(h, w)
    dx_f = fx - gx
    dy_f = fy - gy
    px = gx.expand(b, h, w)
    py = gy.expand(b, h, w)

    def bilerp(field, cy, cx):
        x0 = torch.clamp(torch.floor(cx), 0, w - 2)
        y0 = torch.clamp(torch.floor(cy), 0, h - 2)
        tx = torch.clamp(cx - x0, 0.0, 1.0)
        ty = torch.clamp(cy - y0, 0.0, 1.0)
        idx = (y0.long() * w + x0.long()).reshape(b, -1)
        f = field.reshape(b, h * w)

        def take(off):
            return f.gather(1, idx + off).reshape(b, h, w)
        return ((1 - ty) * ((1 - tx) * take(0) + tx * take(1))
                + ty * ((1 - tx) * take(w) + tx * take(w + 1)))

    # nearest screen vertex of a stride-4 subgrid, over candidate chunks of
    # 64; argmin keeps the first minimum, so ties break as in JAX
    stride = 4
    sub_x = fx[:, ::stride, ::stride].reshape(b, -1)
    sub_y = fy[:, ::stride, ::stride].reshape(b, -1)
    gy_s = gy[::stride, ::stride].reshape(-1)
    gx_s = gx[::stride, ::stride].reshape(-1)
    pxf = px.reshape(b, h * w, 1)
    pyf = py.reshape(b, h * w, 1)
    m = sub_x.shape[1]
    ch = min(64, m)
    n_chunks = -(-m // ch)
    pad = n_chunks * ch - m
    sub_x = torch.nn.functional.pad(sub_x, (0, pad), value=1e9)
    sub_y = torch.nn.functional.pad(sub_y, (0, pad), value=1e9)
    best_d2 = torch.full((b, h * w), float("inf"), dtype=dt, device=dev)
    nearest = torch.zeros((b, h * w), dtype=torch.long, device=dev)
    for k in range(n_chunks):
        ddx = sub_x[:, None, k * ch:(k + 1) * ch] - pxf
        ddy = sub_y[:, None, k * ch:(k + 1) * ch] - pyf
        d2 = ddx * ddx + ddy * ddy
        upd = torch.amin(d2, 2) < best_d2
        best_d2 = torch.where(upd, torch.amin(d2, 2), best_d2)
        nearest = torch.where(upd, torch.argmin(d2, 2) + k * ch, nearest)
    cy = gy_s[nearest].reshape(b, h, w)
    cx = gx_s[nearest].reshape(b, h, w)

    for _ in range(fp_iters):
        ny = py - bilerp(dy_f, cy, cx)
        nx = px - bilerp(dx_f, cy, cx)
        cy = torch.clamp(cy + 0.7 * (ny - cy), 0, h - 1)
        cx = torch.clamp(cx + 0.7 * (nx - cx), 0, w - 1)

    i0 = torch.floor(cy).long().clamp(0, h - 2)
    j0 = torch.floor(cx).long().clamp(0, w - 2)
    flat = [v.reshape(b, h * w) for v in (fx, fy, fz)]

    def corner(ii, jj):
        idx = (ii * w + jj).reshape(b, -1)
        return [v.gather(1, idx).reshape(b, h, w) for v in flat]

    best_z = torch.full((b, h, w), float("inf"), dtype=dt, device=dev)
    best_id = torch.full((b, h, w), -1, dtype=torch.long, device=dev)
    n_faces = (h - 1) * (w - 1)
    eps = _f32(-1e-5)
    for di in range(-search, search + 1):
        for dj in range(-search, search + 1):
            ci = (i0 + di).clamp(0, h - 2)
            cj = (j0 + dj).clamp(0, w - 2)
            tl, tr = corner(ci, cj), corner(ci, cj + 1)
            bl, br = corner(ci + 1, cj), corner(ci + 1, cj + 1)
            cell = ci * (w - 1) + cj
            for (v0, v1, v2), fid in (((tl, bl, tr), cell),
                                      ((tr, bl, br), cell + n_faces)):
                l0, l1, l2, degen, inv_z = _barycentric_jit(
                    px, py, v0[0], v0[1], v1[0], v1[1], v2[0], v2[1],
                    v0[2], v1[2], v2[2])
                z = 1.0 / torch.clamp_min(inv_z, _f32(1e-12))
                better = ((l0 >= eps) & (l1 >= eps) & (l2 >= eps) & ~degen
                          & (z > 0) & (z < best_z))
                best_z = torch.where(better, z, best_z)
                best_id = torch.where(better, fid, best_id)
    return best_id


def _winner_weights(xs, ys, zs, faces, winner):
    """The winner's vertex ids (B, P, 3) and its perspective weights
    (l_i / z_i) at the pixel centres, differentiable in xs, ys, zs."""
    b, h, w = winner.shape
    wf = torch.where(winner >= 0, winner, 0).reshape(b, -1)
    tri = faces[wf]  # (B, P, 3)

    def gather(v):
        return v.gather(1, tri.reshape(b, -1)).reshape(b, h * w, 3)

    tx, ty, tz = gather(xs), gather(ys), gather(zs)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=xs.dtype, device=xs.device),
                            torch.arange(w, dtype=xs.dtype, device=xs.device),
                            indexing="ij")
    l0, l1, l2, _ = _barycentric(gx.reshape(1, -1), gy.reshape(1, -1),
                                 tx[..., 0], ty[..., 0], tx[..., 1],
                                 ty[..., 1], tx[..., 2], ty[..., 2])
    return tri, (l0 / tz[..., 0], l1 / tz[..., 1], l2 / tz[..., 2])


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


def rasterize_depth(xs, ys, zs, faces, h, w, window=5, near=0.3, far=1.3,
                    mode="grid", search=1):
    """Depth map (B, H, W) of projected mesh vertices, `far` where uncovered.
    xs, ys (B, N) pixel coordinates (x right, y down, centres at integers),
    zs (B, N) camera depth, faces (F, 3) int64.  Gradients reach xs, ys, zs
    through the barycentric re-interpolation of each pixel's winner.

    mode 'grid' (N == h*w row-major grid vertices, window capped at 5; faces
    unused), 'invwarp' (grid vertices, `search` cells around the estimate)
    or 'scatter' (any mesh: the exact z-buffer)."""
    if mode not in MODES:
        raise ValueError(f"raster mode {mode!r} is not one of {MODES}")
    b = xs.shape[0]
    if mode == "grid" and xs.shape[1] == h * w:
        return rasterize_depth_grid(
            xs.reshape(b, h, w), ys.reshape(b, h, w), zs.reshape(b, h, w),
            window=min(window, 5), near=float(near), far=float(far))
    faces = torch.as_tensor(faces, device=xs.device).long()
    if mode == "invwarp":
        winner = _winner_pass_invwarp(xs, ys, zs, h, w, search=search)
    else:
        winner = _winner_pass(xs, ys, zs, faces, h, w, window)
    _, (w0, w1, w2) = _winner_weights(xs, ys, zs, faces, winner)
    z = 1.0 / torch.clamp_min(w0 + w1 + w2, _f32(1e-12))
    return torch.where(winner >= 0, z.reshape(b, h, w), z.new_tensor(far))


def rasterize_attributes(xs, ys, zs, attrs, faces, h, w, window=5,
                         near=0.3, far=1.3, background=1.0):
    """Per-vertex attributes `attrs` (B, N, C) rendered through the exact
    z-buffer with perspective-correct interpolation (vertex colours of the
    grid mesh, the reference's mesh-texture renders).  Returns the
    (B, C, H, W) image, `background` where uncovered, and the (B, 1, H, W)
    coverage mask."""
    b, _, c = attrs.shape
    faces = torch.as_tensor(faces, device=xs.device).long()
    winner = _winner_pass(xs, ys, zs, faces, h, w, window)
    tri, (w0, w1, w2) = _winner_weights(xs, ys, zs, faces, winner)
    ta = attrs.gather(1, tri.reshape(b, -1, 1).expand(-1, -1, c)).reshape(
        b, h * w, 3, c)
    wsum = torch.clamp_min(w0 + w1 + w2, _f32(1e-12))
    attr = (ta[..., 0, :] * w0[..., None] + ta[..., 1, :] * w1[..., None]
            + ta[..., 2, :] * w2[..., None]) / wsum[..., None]
    covered = (winner >= 0).reshape(b, 1, h, w)
    img = torch.where(covered, attr.reshape(b, h, w, c).permute(0, 3, 1, 2),
                      attr.new_tensor(background))
    return img, covered.to(xs.dtype)
