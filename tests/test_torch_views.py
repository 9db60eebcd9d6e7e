"""The port's mesh-RGB and sweep renders against the JAX package on the CPU
at 32 px: `render_given_view` without grid sampling, `render_yaw` in both
branches and with `crop_mesh`, and `render_view`.  Images are held to 1e-4.
A rendered mask is an interpolated vertex attribute, fractional along mask
edges, so it is held like the image and, thresholded at 0.5, >= 0.999
equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gan2shape_tpu.rendering import renderer as j_render

from gan2shape_torch.rendering import renderer as t_render

CFG = {"rot_center_depth": 1.0, "fov": 10,
       "renderer_min_depth": 0.5, "renderer_max_depth": 2.0}
VIEWS = [[0.12, -0.2, 0.05, 0.02, -0.02, 0.03],
         [-0.25, 0.3, -0.1, -0.05, 0.04, -0.06]]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy()


def _smooth_depth(rng, s, amplitude):
    base = rng.standard_normal((s // 8, s // 8)).astype(np.float32)
    up = gaussian_filter(np.kron(base, np.ones((8, 8), np.float32)), 4.0)
    return (1.0 + amplitude * np.tanh(up)).astype(np.float32)


R = 32


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    depth = np.stack([_smooth_depth(rng, R, 0.05) for _ in range(2)])
    im = rng.uniform(-0.9, 0.9, (2, 3, R, R)).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 1, R, R)) > 0.3).astype(np.float32)
    views = np.asarray(VIEWS, np.float32) * np.asarray(
        [1, 1, 1, 0.1, 0.1, 0.1], np.float32)
    return (depth, im, mask, views, j_render.Renderer(CFG, R, 0.9, 1.1),
            t_render.Renderer(CFG, R, 0.9, 1.1, device="cpu"))


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=atol)


def test_render_given_view_mesh_rgb_matches_jax(scene):
    depth, im, mask, views, jr, tr = scene
    j_im, j_mask = jr.render_given_view(
        jnp.asarray(im), jnp.asarray(depth), jnp.asarray(views),
        mask=jnp.asarray(mask), grid_sample_mode=False)
    t_im, t_mask = tr.render_given_view(T(im), T(depth), T(views),
                                        mask=T(mask), grid_sample_mode=False)
    _close(t_im, j_im)
    _close(t_mask, j_mask)
    assert ((_np(t_mask) > 0.5) == (np.asarray(j_mask) > 0.5)).mean() >= 0.999
    assert float((t_im != 1.0).float().mean()) > 0.5  # covered


@pytest.mark.parametrize("kind", ["mesh", "grid_sample", "crop_mesh"])
def test_render_yaw_matches_jax(scene, kind):
    depth, im, _, views, jr, tr = scene
    v_before = views * 0.5
    v_after = views[::-1].copy() if kind == "crop_mesh" else None
    kw = {"nsample": 3, "grid_sample_mode": kind == "grid_sample",
          "crop_mesh": (2, 3, 1, 2) if kind == "crop_mesh" else None}
    j_out = jr.render_yaw(
        jnp.asarray(im), jnp.asarray(depth), v_before=jnp.asarray(v_before),
        v_after=None if v_after is None else jnp.asarray(v_after), **kw)
    t_out = tr.render_yaw(
        T(im), T(depth), v_before=T(v_before),
        v_after=None if v_after is None else T(v_after), **kw)
    assert t_out.shape == (2, 3, 3, R, R)
    _close(t_out, j_out)


def test_render_view_matches_jax(scene):
    depth, im, *_, jr, tr = scene
    j_out = jr.render_view(jnp.asarray(im), jnp.asarray(depth),
                           maxr=(20, 60), nsample=(2, 3))
    t_out = tr.render_view(T(im), T(depth), maxr=(20, 60), nsample=(2, 3))
    assert t_out.shape == (2, 5, 3, R, R)
    _close(t_out, j_out)
