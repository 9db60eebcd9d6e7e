"""The port's ops (gan2shape_torch.ops) against the JAX package's on the same
numpy inputs: fused_act, upfirdn2d, resize (1e-6), the 2x2-window fetch and
splat and their autograd wrappers (forward bit-exact, backward 1e-6), and
grid_sample / grid_sample_im_mask (forward and VJP, 1e-6).  The CUDA
kernels are held against these plain versions in test_torch_kernels.py."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.ops.gather_window import (
    _gather_fwd_impl, gather_window2x2 as j_gw, gather_window2x2_planes as j_gwp,
)
from gan2shape_tpu.ops.splat_window import _splat_flat4

j_act = importlib.import_module("gan2shape_tpu.ops.fused_act")
j_gs = importlib.import_module("gan2shape_tpu.ops.grid_sample")
j_resize = importlib.import_module("gan2shape_tpu.ops.resize")
j_fir = importlib.import_module("gan2shape_tpu.ops.upfirdn2d")
fused_act = importlib.import_module("gan2shape_torch.ops.fused_act")
t_gs = importlib.import_module("gan2shape_torch.ops.grid_sample")
resize = importlib.import_module("gan2shape_torch.ops.resize")
upfirdn2d = importlib.import_module("gan2shape_torch.ops.upfirdn2d")
from gan2shape_torch.ops.gather_window import (
    gather_window2x2, gather_window2x2_planes,
)
from gan2shape_torch.ops.splat_window import fetch2x2_plain, splat2x2_plain



def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy()


def test_fused_leaky_relu_matches_jax(rng):
    x = rng.standard_normal((2, 5, 4, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        _np(fused_act.fused_leaky_relu(T(x), T(b))),
        np.asarray(j_act.fused_leaky_relu(x, b)), atol=1e-6)
    y = np.asarray(j_act.fused_leaky_relu(x, b))
    np.testing.assert_allclose(
        _np(fused_act.inverse_fused_leaky_relu(T(y), T(b))),
        np.asarray(j_act.inverse_fused_leaky_relu(y, b)), atol=1e-6)
    x2 = rng.standard_normal((3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        _np(fused_act.fused_leaky_relu(T(x2), T(b))),
        np.asarray(j_act.fused_leaky_relu(x2, b)), atol=1e-6)


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)),
    (1, 1, (-1, 2, 0, -1)), (2, 2, (2, 2, 2, 2))])
def test_upfirdn2d_matches_jax(rng, up, down, pad):
    x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32)
    k = upfirdn2d.setup_filter([1, 3, 3, 1], gain=up * up)
    jk, _ = j_fir.setup_filter([1, 3, 3, 1], gain=up * up)
    np.testing.assert_array_equal(k, np.asarray(jk))
    got = upfirdn2d.upfirdn2d(T(x), T(k), up=up, down=down, pad=pad)
    want = j_fir.upfirdn2d(jnp.asarray(x), jk, up=up, down=down, pad=pad)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


def test_up_down_sample_and_blur_match_jax(rng):
    x = rng.standard_normal((1, 2, 8, 8)).astype(np.float32)
    ku = upfirdn2d.setup_filter([1, 3, 3, 1], gain=4)
    kd = upfirdn2d.setup_filter([1, 3, 3, 1])
    np.testing.assert_allclose(
        _np(upfirdn2d.upsample2d(T(x), T(ku))),
        np.asarray(j_fir.upsample2d(jnp.asarray(x), ku)), atol=1e-6)
    np.testing.assert_allclose(
        _np(upfirdn2d.downsample2d(T(x), T(kd))),
        np.asarray(j_fir.downsample2d(jnp.asarray(x), kd)), atol=1e-6)
    np.testing.assert_allclose(
        _np(upfirdn2d.blur2d(T(x), T(kd), (2, 1))),
        np.asarray(j_fir.blur2d(jnp.asarray(x), kd, (2, 1))), atol=1e-6)


@pytest.mark.parametrize("size", [(32, 32), (64, 64), (16, 16), (24, 40)])
def test_resize_matches_jax(rng, size):
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(
        _np(resize.resize(T(x), size)),
        np.asarray(j_resize.resize(jnp.asarray(x), size)), atol=1e-6)
    np.testing.assert_allclose(
        _np(resize.resize_bilinear_align_corners(T(x), size)),
        np.asarray(j_resize.resize_bilinear_align_corners(
            jnp.asarray(x), size)), atol=1e-6)
    np.testing.assert_array_equal(_np(resize.crop(T(x), 20)),
                                  np.asarray(j_resize.crop(x, 20)))


def _starts(rng, b, h, w, spread=3):
    """Window starts = pixel + small displacement, clipped (the pixel-grid
    regime), plus a few wild ones."""
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    iy = py[None] + rng.integers(-spread, spread + 1, (b, h, w))
    ix = px[None] + rng.integers(-spread, spread + 1, (b, h, w))
    iy[:, 0, 0] = h + 5
    ix[:, -1, -1] = -4
    return (np.clip(iy, 0, h - 2).astype(np.int32),
            np.clip(ix, 0, w - 2).astype(np.int32))


@pytest.mark.parametrize("c", [3, 4])
def test_fetch_and_splat_plain_match_jax(rng, c):
    b, h, w = 2, 12, 10
    src = rng.standard_normal((b, c, h, w)).astype(np.float32)
    iy, ix = _starts(rng, b, h, w)
    starts = np.stack([iy.reshape(b, -1), ix.reshape(b, -1)], -1)
    got = fetch2x2_plain(T(src), T(iy.reshape(b, -1)), T(ix.reshape(b, -1)))
    patch = np.asarray(_gather_fwd_impl(
        jnp.asarray(src.transpose(0, 2, 3, 1)), jnp.asarray(starts)))
    want = patch.transpose(0, 2, 3, 4, 1).reshape(b, 4 * c, h * w)
    np.testing.assert_array_equal(_np(got), want)

    g = rng.standard_normal((b, 4 * c, h * w)).astype(np.float32)
    got = splat2x2_plain(T(g), T(iy.reshape(b, -1)), T(ix.reshape(b, -1)),
                         (b, c, h, w))
    gp = g.reshape(b, 2, 2, c, h * w).transpose(0, 4, 1, 2, 3)
    want = np.asarray(_splat_flat4(jnp.asarray(gp), jnp.asarray(starts),
                                   (b, h, w, c))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(_np(got), want, atol=1e-6)


@pytest.mark.parametrize("c", [3, 4])
def test_gather_window2x2_planes_matches_jax(rng, c):
    b, h, w = 2, 16, 12
    src = rng.standard_normal((b, c, h, w)).astype(np.float32)
    iy, ix = _starts(rng, b, h, w)
    g = rng.standard_normal((b, 2, 2, c, h, w)).astype(np.float32)

    src_t = T(src).requires_grad_(True)
    out = gather_window2x2_planes(src_t, T(iy), T(ix))
    (out * T(g)).sum().backward()
    want, vjp = jax.vjp(lambda s: j_gwp(s, jnp.asarray(iy), jnp.asarray(ix)),
                        jnp.asarray(src))
    np.testing.assert_array_equal(_np(out), np.asarray(want))
    np.testing.assert_allclose(_np(src_t.grad),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6)


def test_gather_window2x2_patch_layout_matches_jax(rng):
    b, h, w, c, p = 2, 9, 11, 3, 40
    op = rng.standard_normal((b, h, w, c)).astype(np.float32)
    starts = np.stack([rng.integers(0, h - 1, (b, p)),
                       rng.integers(0, w - 1, (b, p))], -1).astype(np.int32)
    g = rng.standard_normal((b, p, 2, 2, c)).astype(np.float32)
    op_t = T(op).requires_grad_(True)
    out = gather_window2x2(op_t, T(starts))
    (out * T(g)).sum().backward()
    want, vjp = jax.vjp(lambda o: j_gw(o, jnp.asarray(starts)),
                        jnp.asarray(op))
    np.testing.assert_array_equal(_np(out), np.asarray(want))
    np.testing.assert_allclose(_np(op_t.grad),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6)


def _grid(rng, b, hg, wg, spread=0.15):
    ys, xs = np.meshgrid(np.linspace(-1.1, 1.1, hg), np.linspace(-1.1, 1.1, wg),
                         indexing="ij")
    base = np.stack([xs, ys], -1)[None]
    return (base + rng.uniform(-spread, spread, (b, hg, wg, 2))
            ).astype(np.float32)


@pytest.mark.parametrize("mode,hg,wg", [
    ("bilinear", 16, 16), ("bilinear", 10, 7), ("nearest", 16, 16)])
def test_grid_sample_and_vjp_match_jax(rng, mode, hg, wg):
    b, c, h, w = 2, 3, 16, 16
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    grid = _grid(rng, b, hg, wg)
    g = rng.standard_normal((b, c, hg, wg)).astype(np.float32)
    x_t = T(x).requires_grad_(True)
    grid_t = T(grid).requires_grad_(True)
    out = t_gs.grid_sample(x_t, grid_t, mode=mode)
    (out * T(g)).sum().backward()
    want, vjp = jax.vjp(lambda a, gr: j_gs.grid_sample(a, gr, mode=mode),
                        jnp.asarray(x), jnp.asarray(grid))
    dx, dgrid = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(_np(x_t.grad), np.asarray(dx), atol=1e-6)
    if mode == "bilinear":
        np.testing.assert_allclose(_np(grid_t.grad), np.asarray(dgrid),
                                   atol=1e-5, rtol=1e-6)


def test_grid_sample_im_mask_and_vjp_match_jax(rng):
    b, c, h, w = 2, 3, 16, 16
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, 3, h, w)) > 0.3).astype(np.float32)
    grid = _grid(rng, b, h, w)
    g = rng.standard_normal((b, c, h, w)).astype(np.float32)
    x_t = T(x).requires_grad_(True)
    im, mk = t_gs.grid_sample_im_mask(x_t, T(mask), T(grid))
    (im * T(g)).sum().backward()
    (want_im, want_mk), vjp = jax.vjp(
        lambda a: j_gs.grid_sample_im_mask(a, jnp.asarray(mask),
                                           jnp.asarray(grid)),
        jnp.asarray(x))
    np.testing.assert_allclose(_np(im), np.asarray(want_im), atol=1e-6)
    np.testing.assert_array_equal(_np(mk), np.asarray(want_mk))
    dx = vjp((jnp.asarray(g), jnp.zeros_like(want_mk)))[0]
    np.testing.assert_allclose(_np(x_t.grad), np.asarray(dx), atol=1e-6)
