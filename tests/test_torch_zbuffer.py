"""The port's 'scatter' and 'invwarp' rasterizer modes, vertex-colour
rasterization and the raster-check entry point, against the JAX package on
the CPU at 64 px (the renders built on them are in test_torch_views.py,
`raster_mega` in test_torch_rasterize.py).

Winner ids of the exact z-buffer match `_winner_pass`: agreement >= 0.999
asserted, bit-equal expected, since the port evaluates the barycentric 1/z
as the jitted JAX function does (XLA's n / (d * z) rewrite and XLA:CPU's
fused multiply-adds; without them ~6% of the ids differ at 128 px on
near-identity views, where faces tie at their shared edges).  Depth is held
to 1e-5, vertex gradients to 5e-5 of the largest, attribute images to 1e-5
with equal coverage."""

import importlib
import math
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import jax
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gan2shape_tpu.rendering import renderer as j_render

from gan2shape_torch.ops.rasterize import (
    _fma, _winner_pass, rasterize_attributes, rasterize_depth,
)
from gan2shape_torch.rendering import renderer as t_render
from gan2shape_torch.tools import check_raster

j_rast = importlib.import_module("gan2shape_tpu.ops.rasterize")

S = 64
CFG = {"rot_center_depth": 1.0, "fov": 10}
VIEWS = [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
         [0.12, -0.2, 0.05, 0.02, -0.02, 0.03],
         [-0.25, 0.3, -0.1, -0.05, 0.04, -0.06],
         [0.3, 0.15, -0.2, 0.05, 0.05, -0.05]]
# the +-45 degree yaw frames of a render_yaw sweep
YAW = [[0.0, math.pi / 4, 0.0, 0.0, 0.0, 0.0],
       [0.0, -math.pi / 4, 0.0, 0.0, 0.0, 0.0]]
NEAR, FAR = 0.8, 1.2


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy()


def _smooth_depth(rng, s, amplitude=0.08):
    base = rng.standard_normal((s // 8, s // 8)).astype(np.float32)
    up = gaussian_filter(np.kron(base, np.ones((8, 8), np.float32)), 4.0)
    return (1.0 + amplitude * np.tanh(up)).astype(np.float32)


def _vertices(views, s, seed):
    """(xs, ys, zs) each (B, s*s) of smooth depth maps under `views`, as the
    JAX renderer projects them."""
    rng = np.random.default_rng(seed)
    n = len(views)
    depth = np.stack([_smooth_depth(rng, s) for _ in range(n)])
    r = j_render.Renderer(CFG, s, 0.9, 1.1)
    rot, trans = j_render.get_transform_matrices(
        jnp.asarray(np.asarray(views, np.float32)))
    pts = r.get_warped_3d_grid(jnp.asarray(depth), rot, trans)
    return [np.asarray(a) for a in r._project_screen(pts.reshape(n, -1, 3))]


@pytest.fixture(scope="module")
def cases():
    return {"training": _vertices(VIEWS, S, 0), "yaw45": _vertices(YAW, S, 1)}


FACES = j_rast.grid_faces(S, S)


@pytest.mark.parametrize("case", ["training", "yaw45"])
def test_scatter_winner_matches_jax(cases, case):
    xs, ys, zs = cases[case]
    want = np.asarray(j_rast._winner_pass(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs),
        jnp.asarray(FACES), S, S, 5, NEAR, FAR))
    got = _np(_winner_pass(T(xs), T(ys), T(zs), T(FACES).long(), S, S, 5))
    assert (want >= 0).mean() > 0.5
    agree = (got == want).mean()
    assert agree >= 0.999, agree
    assert agree == 1.0  # the expected result: bit-exact


def _nearest_f32(x):
    """The f32 nearest to the Fraction `x`, ties to even."""
    g = np.float32(float(x))
    cands = [np.nextafter(g, np.float32(-np.inf)), g,
             np.nextafter(g, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.int32)) & 1))


def test_fma_against_exact_rounding(rng):
    """`_fma` equals the exactly rounded a * b + c on random inputs.  It
    rounds twice, so it is one ulp off where its f64 sum lands on an f32
    halfway point that the exact sum misses, as its docstring says:
    (2^-24 (1 + 2^-23)) (1 - 2^-23) + (1 + 2^-23) lies just under one."""
    a = rng.standard_normal(2000) * 2.0 ** rng.integers(-30, 30, 2000)
    b = rng.standard_normal(2000) * 2.0 ** rng.integers(-30, 30, 2000)
    c = rng.standard_normal(2000) * 2.0 ** rng.integers(-60, 60, 2000)
    u = 2.0 ** -23
    # the case and its mirror image
    a, b, c = (np.concatenate([v, w]).astype(np.float32) for v, w in (
        (a, [2.0 ** -24 * (1 + u), -2.0 ** -24 * (1 + u)]),
        (b, [1 - u, 1 - u]), (c, [1 + u, -1 - u])))
    got = _np(_fma(T(a), T(b), T(c)))
    want = np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got[:-2], want[:-2])
    assert want[-2] == np.float32(1 + u) and want[-1] == -np.float32(1 + u)
    # the documented double-rounding case: one ulp up in magnitude
    np.testing.assert_array_equal(got[-2:], [1 + 2 * u, -(1 + 2 * u)])


@pytest.mark.parametrize("mode", ["scatter", "invwarp"])
def test_rasterize_depth_and_vertex_grads_match_jax(cases, mode, rng):
    xs, ys, zs = cases["training"]
    b = xs.shape[0]
    g = rng.standard_normal((b, S, S)).astype(np.float32)

    def j_fn(x, y, z):
        return j_rast.rasterize_depth(x, y, z, jnp.asarray(FACES), S, S,
                                      window=5, near=NEAR, far=FAR,
                                      mode=mode, search=2)

    want, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (xs, ys, zs)))
    jg = vjp(jnp.asarray(g))
    ts = [T(a).requires_grad_(True) for a in (xs, ys, zs)]
    got = rasterize_depth(*ts, T(FACES), S, S, window=5, near=NEAR, far=FAR,
                          mode=mode, search=2)
    (got * T(g)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    for t, j in zip(ts, jg):
        j = np.asarray(j)
        err = np.abs(_np(t.grad) - j).max() / np.abs(j).max()
        assert err <= 5e-5, err


def test_invwarp_matches_port_scatter():
    """The limits of tests/test_rasterize_invwarp.py, on the port alone."""
    rng = np.random.default_rng(0)
    r = t_render.Renderer(CFG, S, 0.9, 1.1, device="cpu")
    depth = T(_smooth_depth(rng, S)[None])
    for view, least in zip(VIEWS[:3], (1.0, 0.995, 0.985)):
        rot, trans = t_render.get_transform_matrices(T([view]).float())
        d_sc = r.warp_canon_depth(depth, rot, trans, raster_mode="scatter")
        d_inv = r.warp_canon_depth(depth, rot, trans, raster_mode="invwarp")
        frac = np.isclose(_np(d_sc), _np(d_inv), atol=2e-3).mean()
        assert frac >= least, (view, frac)


def test_invwarp_128px_on_check_inputs_matches_jax():
    """check_raster's 128-px invwarp inputs (its default seed, sizes and
    batch), projected by the JAX renderer: the port's invwarp depth equals
    JAX's within 1e-5 on the same vertices, and JAX's own invwarp meets the
    check's 128-px limits against its exact z-buffer, which is what those
    limits rest on.  (Through each side's own renderer the projections
    differ by an ulp, 3e-5 px, which flips the coverage of 5 border pixels
    of the identity view, whose mesh edge lies on the last pixel centre.)"""
    s, depth, _ = list(check_raster.scenes((64, 128), 4, 0))[-1]
    assert s == 128
    views = np.asarray(check_raster.INVWARP_VIEWS, np.float32)
    n = len(views)
    jr = j_render.Renderer(dict(check_raster.CFG, raster_window=5), s, 0.9,
                           1.1)
    rot, trans = j_render.get_transform_matrices(jnp.asarray(views))
    pts = jr.get_warped_3d_grid(
        jnp.asarray(np.broadcast_to(depth, (n, s, s))), rot, trans)
    verts = [np.asarray(a) for a in jr._project_screen(pts.reshape(n, -1, 3))]
    faces = j_rast.grid_faces(s, s)
    kw = dict(window=5, near=jr.min_depth - jr.margin,
              far=jr.max_depth + jr.margin, search=2)
    j_sc, j_inv = (np.asarray(j_rast.rasterize_depth(
        *(jnp.asarray(a) for a in verts), jnp.asarray(faces), s, s, mode=m,
        **kw)) for m in ("scatter", "invwarp"))
    t_inv = rasterize_depth(*(T(a) for a in verts), T(faces), s, s,
                            mode="invwarp", **kw)
    np.testing.assert_allclose(_np(t_inv), j_inv, atol=1e-5)
    for i, least in enumerate(check_raster.INVWARP_MIN[128]):
        frac = np.isclose(j_inv[i], j_sc[i],
                          atol=check_raster.DEPTH_ATOL).mean()
        assert frac >= least, (i, frac)


def test_rasterize_attributes_matches_jax(cases, rng):
    xs, ys, zs = (np.concatenate([a, b]) for a, b in zip(
        cases["training"], cases["yaw45"]))
    attrs = rng.uniform(-1, 1, xs.shape + (3,)).astype(np.float32)
    j_img, j_mask = j_rast.rasterize_attributes(
        *(jnp.asarray(a) for a in (xs, ys, zs, attrs)), jnp.asarray(FACES),
        S, S, window=5, near=0.1, far=10.0, background=1.0)
    t_img, t_mask = rasterize_attributes(
        *(T(a) for a in (xs, ys, zs, attrs)), T(FACES), S, S, window=5,
        near=0.1, far=10.0, background=1.0)
    assert t_img.shape == (6, 3, S, S) and t_mask.shape == (6, 1, S, S)
    np.testing.assert_allclose(_np(t_img), np.asarray(j_img), atol=1e-5)
    np.testing.assert_array_equal(_np(t_mask), np.asarray(j_mask))


# ---------------- the check entry point ----------------

def test_check_raster_entry_point_on_cpu():
    res = check_raster.run_checks(sizes=(64,), batch=2, device="cpu")
    names = [c["check"] for c in res["checks"]]
    assert names == ["raster_mega_vs_buffers_s64", "grid_depth_vs_scatter_s64",
                     "grid_depth_vs_scatter_s64_w3",
                     "invwarp_vs_scatter_s64_view0",
                     "invwarp_vs_scatter_s64_view1",
                     "invwarp_vs_scatter_s64_view2"]
    assert res["ok"] and res["device"] == "cpu", res


def test_check_raster_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_raster.run_checks(sizes=(16,), batch=1)
