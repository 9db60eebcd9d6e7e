"""The splat's arithmetic on the CPU (gan2shape_torch.ops.splat_window):
the f32 plain version and the fixed-point emulation of the card's kernel
(`splat2x2_fixed_plain`) against the JAX package's `_splat_flat4` at 64²,
the emulation's independence of the points' order, and its scale choice
(an all-zero plane, one large value, P != H*W, every point on one window,
a NaN).  The card's kernel equals the emulation bit for bit
(tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.ops.splat_window import _splat_flat4

from gan2shape_torch.ops.splat_window import (
    ceil_log2, fixed_scale, splat2x2_fixed_plain, splat2x2_plain,
)

S = 64
SPLATS = {"plain": splat2x2_plain, "fixed": splat2x2_fixed_plain}


def _inputs(rng, b, c, h, w, p=None, spread=3):
    """g (B, 4C, P) and clipped starts: a smooth warp's (pixel plus a few
    px) when P = H*W, anywhere in the image otherwise."""
    if p is None:
        p = h * w
        py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        iy = py.reshape(1, -1) + rng.integers(-spread, spread + 1, (b, p))
        ix = px.reshape(1, -1) + rng.integers(-spread, spread + 1, (b, p))
    else:
        iy = rng.integers(-1, h, (b, p))
        ix = rng.integers(-1, w, (b, p))
    g = rng.standard_normal((b, 4 * c, p)).astype(np.float32)
    return (torch.from_numpy(g),
            torch.from_numpy(np.clip(iy, 0, h - 2)).int(),
            torch.from_numpy(np.clip(ix, 0, w - 2)).int())


@pytest.mark.parametrize("c", [3, 6])
@pytest.mark.parametrize("name", sorted(SPLATS))
def test_splat_matches_jax(rng, name, c):
    b = 2
    g, iy, ix = _inputs(rng, b, c, S, S)
    got = SPLATS[name](g, iy, ix, (b, c, S, S))
    # JAX's layout: g (B, P, 2, 2, C), starts (B, P, 2), out (B, H, W, C)
    gp = g.numpy().reshape(b, 2, 2, c, S * S).transpose(0, 4, 1, 2, 3)
    starts = np.stack([iy.numpy(), ix.numpy()], -1)
    want = np.asarray(_splat_flat4(jnp.asarray(gp), jnp.asarray(starts),
                                   (b, S, S, c)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)


@pytest.mark.parametrize("c", [3, 6])
def test_fixed_splat_does_not_depend_on_the_points_order(rng, c):
    b = 2
    g, iy, ix = _inputs(rng, b, c, S, S, spread=6)
    want = splat2x2_fixed_plain(g, iy, ix, (b, c, S, S))
    perm = torch.from_numpy(rng.permutation(S * S))
    got = splat2x2_fixed_plain(g[:, :, perm], iy[:, perm], ix[:, perm],
                               (b, c, S, S))
    assert torch.equal(got, want)
    # the f32 sum's does, within rounding
    plain = splat2x2_plain(g[:, :, perm], iy[:, perm], ix[:, perm],
                           (b, c, S, S))
    np.testing.assert_allclose(plain.numpy(), want.numpy(), atol=1e-6)


def test_fixed_scale_of_an_all_zero_plane(rng):
    b, c = 2, 3
    g, iy, ix = _inputs(rng, b, c, S, S)
    g[1].zero_()
    k, bad = fixed_scale(g, c)
    # largest |g| of 0 counts as below 2^-125: the scale is finite
    assert k[1].tolist() == [53 - ceil_log2(S * S) + 125] * c
    assert not bool(bad.any())
    out = splat2x2_fixed_plain(g, iy, ix, (b, c, S, S))
    assert bool((out[1] == 0).all())
    want = splat2x2_plain(g, iy, ix, (b, c, S, S))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)


def test_fixed_scale_of_one_large_value(rng):
    b, c = 1, 3
    g, iy, ix = _inputs(rng, b, c, S, S)
    big, p = 3.0e38, 1000  # < 2^128: e = 128
    g[0, 4, p] = big       # tap (0, 1), channel 1
    k, bad = fixed_scale(g, c)
    assert int(k[0, 1]) == 53 - ceil_log2(S * S) - 128 and not bad.any()
    out = splat2x2_fixed_plain(g, iy, ix, (b, c, S, S))
    # the large value comes back exactly; the plane's others are below its
    # quantum (2^87) and vanish, within 4 ulps of the largest value
    y, x = int(iy[0, p]), int(ix[0, p]) + 1
    assert float(out[0, 1, y, x]) == float(np.float32(big))
    want = splat2x2_plain(g, iy, ix, (b, c, S, S))
    tol = 4 * torch.finfo(torch.float32).eps * big
    assert float((out - want).abs().max()) <= tol
    # the other channels keep their own, finer scale
    np.testing.assert_allclose(out[0, ::2].numpy(), want[0, ::2].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("p", [1, 1000, S * S + 7])
def test_fixed_scale_when_p_is_not_h_times_w(rng, p):
    b, c = 2, 3
    g, iy, ix = _inputs(rng, b, c, S, S, p=p)
    k, bad = fixed_scale(g, c)
    amax = g.reshape(b, 4, c, p).abs().amax((1, 3))
    e = torch.frexp(amax).exponent.long()  # amax = m * 2^e, m in [0.5, 1)
    assert torch.equal(k, 53 - ceil_log2(p) - e)
    assert ceil_log2(p) == int(np.ceil(np.log2(p)))
    got = splat2x2_fixed_plain(g, iy, ix, (b, c, S, S))
    want = splat2x2_plain(g, iy, ix, (b, c, S, S))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_fixed_splat_of_every_point_on_one_window(rng):
    # each pixel of the window sums all P taps of a plane: the sums reach
    # the 2^53 headroom and stay exact, rounded once to f32
    b, c, p = 1, 3, S * S
    vals = 1.0 + rng.integers(0, 2 ** 10, (b, 4 * c, p)) / 2.0 ** 10
    g = torch.from_numpy((vals * rng.choice([-1, 1], vals.shape)).astype(
        np.float32))
    iy = torch.full((b, p), 9, dtype=torch.int32)
    ix = torch.full((b, p), 20, dtype=torch.int32)
    got = splat2x2_fixed_plain(g, iy, ix, (b, c, S, S))
    exact = g.double().reshape(b, 2, 2, c, p).sum(-1)  # (B, a, s, C)
    for a in (0, 1):
        for s in (0, 1):
            assert torch.equal(got[:, :, 9 + a, 20 + s],
                               exact[:, a, s].float())
    got[:, :, 9:11, 20:22] = 0.0
    assert bool((got == 0).all())


def test_fixed_splat_of_a_nan_is_a_nan_plane(rng):
    b, c = 2, 3
    g, iy, ix = _inputs(rng, b, c, S, S)
    g[1, 3 * c + 2, 50] = float("nan")  # tap (1, 1), channel 2 of item 1
    k, bad = fixed_scale(g, c)
    assert bad.tolist() == [[False] * 3, [False, False, True]]
    out = splat2x2_fixed_plain(g, iy, ix, (b, c, S, S))
    assert bool(out[1, 2].isnan().all())
    out[1, 2] = 0.0
    assert bool(torch.isfinite(out).all())
