"""The port's grid-mode rasterizer and renderer against the JAX package on
training-scale warps at 64 px:

  * placement buffers and winner keys bit-equal to `_build_winner_buffers` +
    `_dense_winner_xla` (window 3 and 5; agreement >= 0.999 asserted,
    exact expected), and so the (cell, parity, covered) of `raster_mega`;
  * placement buffers bit-equal on a folded warp, where faces collide in
    their slots and some leave the padded viewport;
  * covered pixels agree with the exact `_winner_pass` z-buffer (>= 0.998);
  * depth within 1e-5, vertex gradients within 5e-5 relative;
  * renderer geometry, normals, warps, `warp_canon_depth` in each raster
    mode and render_given_view.

The raster kernels are held against the plain versions in
test_torch_kernels.py."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gan2shape_tpu.rendering import renderer as j_render

from gan2shape_torch.ops import _cuda
from gan2shape_torch.ops.rasterize import (
    build_winner_buffers_plain, decode_key, dense_winner_plain, raster_mega,
    rasterize_depth,
)
from gan2shape_torch.rendering import renderer as t_render

j_rast = importlib.import_module("gan2shape_tpu.ops.rasterize")

S = 64
CFG = {"rot_center_depth": 1.0, "fov": 10}
VIEWS = [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
         [0.12, -0.2, 0.05, 0.02, -0.02, 0.03],
         [-0.25, 0.3, -0.1, -0.05, 0.04, -0.06],
         [0.3, 0.15, -0.2, 0.05, 0.05, -0.05]]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy()


def _smooth_depth(rng, s, amplitude=0.08):
    base = rng.standard_normal((s // 8, s // 8)).astype(np.float32)
    up = gaussian_filter(np.kron(base, np.ones((8, 8), np.float32)), 4.0)
    return (1.0 + amplitude * np.tanh(up)).astype(np.float32)


def _warped_vertices(s, n_views=len(VIEWS), seed=0):
    """(depth, views, vx, vy, vz) of training-scale warps, via the JAX
    renderer (so both sides rasterize identical vertices)."""
    rng = np.random.default_rng(seed)
    depth = np.stack([_smooth_depth(rng, s) for _ in range(n_views)])
    views = np.asarray((VIEWS * 4)[:n_views], np.float32)
    r = j_render.Renderer(CFG, s, 0.9, 1.1)
    rot, trans = j_render.get_transform_matrices(jnp.asarray(views))
    pts = r.get_warped_3d_grid(jnp.asarray(depth), rot, trans)
    xs, ys, zs = r._project_screen(pts.reshape(n_views, -1, 3))
    v = [np.asarray(a).reshape(n_views, s, s) for a in (xs, ys, zs)]
    return depth, views, v[0], v[1], v[2]


@pytest.fixture(scope="module")
def warps():
    return _warped_vertices(S)


# large yaws and shifts: the step's far sheet folds over the near one, and
# part of each grid leaves the padded viewport
FOLD_VIEWS = [[0.1, 0.5, 0.0, 0.04, 0.0, 0.0],
              [-0.2, -0.6, 0.1, -0.03, 0.02, 0.0],
              [0.0, 0.7, -0.2, 0.0, -0.04, 0.05],
              [0.3, -0.4, 0.0, 0.03, 0.03, 0.0]]


def _folded_vertices(s):
    """(vx, vy, vz) of a depth map with a steep step under FOLD_VIEWS, via
    the JAX renderer."""
    ys, xs = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    step = np.where(xs + 0.5 * ys < 0.6 * s, 0.95, 1.1).astype(np.float32)
    b = len(FOLD_VIEWS)
    r = j_render.Renderer(CFG, s, 0.9, 1.1)
    rot, trans = j_render.get_transform_matrices(
        jnp.asarray(FOLD_VIEWS, jnp.float32))
    pts = r.get_warped_3d_grid(jnp.asarray(np.stack([step] * b)), rot, trans)
    xs, ys, zs = r._project_screen(pts.reshape(b, -1, 3))
    return [np.asarray(a).reshape(b, s, s) for a in (xs, ys, zs)]


def _faces_in_viewport(vx, vy, pad):
    """Faces whose half-pixel bbox start lies in the padded viewport: the
    faces placement puts into a slot."""
    h, w = vx.shape[1:]
    n = 0
    for tri in (((0, 0), (1, 0), (0, 1)), ((0, 1), (1, 0), (1, 1))):
        bx2, by2 = (np.floor(2 * np.minimum.reduce(
            [v[:, di:di + h - 1, dj:dj + w - 1] for di, dj in tri]))
            for v in (vx, vy))
        n += int(((bx2 >= -2 * pad) & (bx2 < 2 * (w + pad))
                  & (by2 >= -2 * pad) & (by2 < 2 * (h + pad))).sum())
    return n


NEAR, FAR = 0.8, 1.2


@pytest.mark.parametrize("window", [3, 5])
def test_winner_buffers_and_keys_match_jax(warps, window):
    _, _, vx, vy, vz = warps
    jb = j_rast._build_winner_buffers(jnp.asarray(vx), jnp.asarray(vy),
                                      jnp.asarray(vz), S, S, window, NEAR,
                                      FAR)
    tb = build_winner_buffers_plain(T(vx), T(vy), T(vz), window, NEAR, FAR)
    wp = S + 2 * (window + 1)
    for parity in (0, 1):
        np.testing.assert_array_equal(_np(tb[parity]),
                                      np.asarray(jb[parity])[..., :wp])
    j_cell, j_par, j_cov = j_rast._dense_winner_xla(
        jb[0], jb[1], S, S, window, NEAR, FAR)
    key = dense_winner_plain(tb, S, S, window, NEAR, FAR)
    cell, par, cov = decode_key(key, (S - 1) ** 2)
    agree = ((_np(cell) == np.asarray(j_cell))
             & (_np(par) == (np.asarray(j_par) > 0.5))
             & (_np(cov) == np.asarray(j_cov)))
    assert agree.mean() >= 0.999, agree.mean()
    assert agree.all()  # the expected result: bit-exact
    # the B3 entry (`_raster_mega_pallas`'s contract), its plain version
    _cuda.reset_launches()
    got = [_np(a) for a in raster_mega(T(vx), T(vy), T(vz), window, NEAR,
                                       FAR)]
    assert all(v == 0 for v in _cuda.LAUNCHES.values())
    assert [a.dtype for a in got] == [np.float32, np.float32, np.bool_]
    for g, j in zip(got, (j_cell, j_par, j_cov)):
        np.testing.assert_array_equal(g, np.asarray(j))


@pytest.mark.parametrize("window", [3, 5])
def test_winner_buffers_match_jax_on_folded_warp(window):
    """Placement bit-equal to `_build_winner_buffers` where faces collide in
    their slots (a fold) and where some leave the padded viewport."""
    vx, vy, vz = _folded_vertices(S)
    jb = j_rast._build_winner_buffers(jnp.asarray(vx), jnp.asarray(vy),
                                      jnp.asarray(vz), S, S, window, NEAR,
                                      FAR)
    tb = build_winner_buffers_plain(T(vx), T(vy), T(vz), window, NEAR, FAR)
    wp = S + 2 * (window + 1)
    for parity in (0, 1):
        np.testing.assert_array_equal(_np(tb[parity]),
                                      np.asarray(jb[parity])[..., :wp])
    placed = _faces_in_viewport(vx, vy, window + 1)
    won = int((tb[:, :, :, :, 9] >= 0).sum())
    assert won < placed < 2 * vx.shape[0] * (S - 1) ** 2, (won, placed)


def test_covered_pixels_agree_with_exact_zbuffer(warps):
    """Where the port's grid rasterizer claims coverage, its depth matches
    the JAX exact z-buffer ('scatter' mode) within 2e-3 (RASTER_CHECK's
    covered agreement)."""
    depth, views, *_ = warps
    jr = j_render.Renderer(CFG, S, 0.9, 1.1)
    tr = t_render.Renderer(CFG, S, 0.9, 1.1, device="cpu")
    far = jr.max_depth + jr.margin
    rot, trans = j_render.get_transform_matrices(jnp.asarray(views))
    d_exact = np.asarray(jr.warp_canon_depth(jnp.asarray(depth), rot, trans,
                                             raster_mode="scatter"))
    trot, ttrans = t_render.get_transform_matrices(T(views))
    d_grid = _np(tr.warp_canon_depth(T(depth), trot, ttrans))
    covered = ~np.isclose(d_grid, far)
    close = np.isclose(d_grid, d_exact, atol=2e-3)
    assert close[covered].mean() >= 0.998, close[covered].mean()


def test_rasterize_depth_and_vertex_grads_match_jax(warps, rng):
    _, _, vx, vy, vz = warps
    b = vx.shape[0]
    g = rng.standard_normal((b, S, S)).astype(np.float32)

    def j_fn(x, y, z):
        return j_rast.rasterize_depth(x, y, z, None, S, S, window=3,
                                      near=NEAR, far=FAR, mode="grid")

    want, vjp = jax.vjp(j_fn, *(jnp.asarray(a.reshape(b, -1))
                                for a in (vx, vy, vz)))
    jg = vjp(jnp.asarray(g))
    ts = [T(a.reshape(b, -1)).requires_grad_(True) for a in (vx, vy, vz)]
    got = rasterize_depth(*ts, None, S, S, window=3, near=NEAR, far=FAR)
    (got * T(g)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    for t, j in zip(ts, jg):
        j = np.asarray(j)
        err = np.abs(_np(t.grad) - j).max() / np.abs(j).max()
        assert err <= 5e-5, err


@pytest.mark.parametrize("mode", ["grid", "scatter", "invwarp"])
def test_renderer_raster_modes_match_jax(warps, mode):
    """Each configured raster mode's `warp_canon_depth` against JAX's."""
    # three views: the shapes test_renderer_geometry_matches_jax compiles
    depth, views = warps[0][1:], warps[1][1:]
    jr = j_render.Renderer(dict(CFG, raster_mode=mode), S, 0.9, 1.1)
    tr = t_render.Renderer(dict(CFG, raster_mode=mode), S, 0.9, 1.1,
                           device="cpu")
    assert tr.raster_mode == mode
    rot, trans = j_render.get_transform_matrices(jnp.asarray(views))
    want = np.asarray(jr.warp_canon_depth(jnp.asarray(depth), rot, trans))
    trot, ttrans = t_render.get_transform_matrices(T(views))
    np.testing.assert_allclose(
        _np(tr.warp_canon_depth(T(depth), trot, ttrans)), want, atol=1e-5)


def test_renderer_geometry_matches_jax(rng):
    jr = j_render.Renderer(CFG, S, 0.9, 1.1)
    tr = t_render.Renderer(CFG, S, 0.9, 1.1, device="cpu")
    views = np.asarray(VIEWS[1:], np.float32)
    depth = np.stack([_smooth_depth(rng, S) for _ in range(len(views))])
    jrot, jtrans = j_render.get_transform_matrices(jnp.asarray(views))
    trot, ttrans = t_render.get_transform_matrices(T(views))
    np.testing.assert_allclose(_np(trot), np.asarray(jrot), atol=1e-6)
    np.testing.assert_allclose(_np(ttrans), np.asarray(jtrans), atol=0)
    jd, td = jnp.asarray(depth), T(depth)
    for name in ("depth_to_3d_grid", "get_normal_from_depth"):
        np.testing.assert_allclose(_np(getattr(tr, name)(td)),
                                   np.asarray(getattr(jr, name)(jd)),
                                   atol=1e-6)
    for name in ("get_warped_2d_grid", "get_inv_warped_2d_grid"):
        np.testing.assert_allclose(
            _np(getattr(tr, name)(td, trot, ttrans)),
            np.asarray(getattr(jr, name)(jd, jrot, jtrans)), atol=1e-5)
    np.testing.assert_allclose(
        _np(tr.warp_canon_depth(td, trot, ttrans)),
        np.asarray(jr.warp_canon_depth(jd, jrot, jtrans)), atol=1e-5)


def test_render_given_view_matches_jax(rng):
    jr = j_render.Renderer(CFG, S, 0.9, 1.1)
    tr = t_render.Renderer(CFG, S, 0.9, 1.1, device="cpu")
    n = 3
    views = (np.asarray(VIEWS[1:], np.float32)
             * np.asarray([1, 1, 1, 0.1, 0.1, 0.1], np.float32))
    depth = np.broadcast_to(_smooth_depth(rng, S), (n, S, S)).copy()
    im = rng.uniform(-1, 1, (n, 3, S, S)).astype(np.float32)
    mask = np.ones((n, 3, S, S), np.float32)
    j_im, j_mask = jr.render_given_view(jnp.asarray(im), jnp.asarray(depth),
                                        jnp.asarray(views),
                                        mask=jnp.asarray(mask))
    t_im, t_mask = tr.render_given_view(T(im), T(depth), T(views),
                                        mask=T(mask))
    np.testing.assert_allclose(_np(t_im), np.asarray(j_im), atol=1e-4)
    assert (_np(t_mask) == np.asarray(j_mask)).mean() >= 0.999
