"""The port's CUDA kernels against their plain PyTorch versions, on the card
(marked `cuda`; they skip without a GPU), and the wrappers' refusals on
either device.  This file imports no JAX, so it
also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

The fetch is bit-exact; the splat sums in fixed point, so it is held to a
few ulps of the f32 sum, bit-equal to its fixed-point emulation and to
itself on a repeated call; the raster payload buffers and winner keys, and
the `raster_mega` triple, are bit-exact."""

import numpy as np
import pytest
import torch

from gan2shape_torch.ops import _cuda, fused_act
from gan2shape_torch.ops.rasterize import (
    SENTINEL, build_winner_buffers_plain, dense_winner, dense_winner_plain,
    raster_mega, raster_place, raster_tests,
)
from gan2shape_torch.ops.splat_window import (
    fetch2x2, fetch2x2_plain, splat2x2, splat2x2_fixed_plain,
    splat2x2_plain,
)
from gan2shape_torch.rendering.renderer import (
    Renderer, get_transform_matrices,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _starts(rng, b, h, w, spread=3):
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    iy = py[None] + rng.integers(-spread, spread + 1, (b, h, w))
    ix = px[None] + rng.integers(-spread, spread + 1, (b, h, w))
    return (torch.from_numpy(np.clip(iy, 0, h - 2).reshape(b, -1)).int(),
            torch.from_numpy(np.clip(ix, 0, w - 2).reshape(b, -1)).int())


def _splat_tol(want):
    return 4 * torch.finfo(torch.float32).eps * max(float(want.abs().max()),
                                                    1)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 4, 6])
def test_fetch_and_splat_kernels_match_plain(rng, cuda, c):
    b, h, w = 16, 128, 128
    src = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((b, 4 * c, h * w)).astype(
        np.float32))
    iy, ix = _starts(rng, b, h, w)
    got = fetch2x2(src.to(cuda), iy.to(cuda), ix.to(cuda)).cpu()
    assert torch.equal(got, fetch2x2_plain(src, iy, ix))
    got = splat2x2(g.to(cuda), iy.to(cuda), ix.to(cuda), (b, c, h, w)).cpu()
    want = splat2x2_plain(g, iy, ix, (b, c, h, w))
    assert float((got - want).abs().max()) <= _splat_tol(want)
    _assert_repeats_and_matches_fixed(g, iy, ix, (b, c, h, w), got, cuda)


def _assert_repeats_and_matches_fixed(g, iy, ix, shape, got, cuda):
    """The splat kernel gives the same bits on a second call and equals its
    fixed-point emulation bit for bit (on the card's tensors; compared as
    int32, where a NaN equals itself)."""
    args = (g.to(cuda), iy.to(cuda), ix.to(cuda), shape)
    bits = got.view(torch.int32)
    assert torch.equal(splat2x2(*args).cpu().view(torch.int32), bits)
    assert torch.equal(splat2x2_fixed_plain(*args).cpu().view(torch.int32),
                       bits)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,p", [
    (1, 3, 128, 128, 128 * 128), (4, 3, 64, 64, 64 * 64),
    (3, 5, 37, 45, 37 * 45),
    # the patch layout of gather_window2x2: any number of points, none too
    (2, 3, 64, 64, 1000), (1, 6, 32, 48, 32 * 48 + 7), (2, 3, 16, 16, 0)])
def test_splat_kernel_shapes(rng, cuda, b, c, h, w, p):
    g = torch.from_numpy(rng.standard_normal((b, 4 * c, p)).astype(
        np.float32))
    if p == h * w:
        iy, ix = _starts(rng, b, h, w)
    else:
        iy = torch.from_numpy(rng.integers(-1, h, (b, p))).int()
        ix = torch.from_numpy(rng.integers(-1, w, (b, p))).int()
    _cuda.reset_launches()
    got = splat2x2(g.to(cuda), iy.to(cuda), ix.to(cuda), (b, c, h, w)).cpu()
    assert _cuda.LAUNCHES["splat2x2"] == 1
    want = splat2x2_plain(g, iy, ix, (b, c, h, w))
    assert float((got - want).abs().max()) <= _splat_tol(want)
    _assert_repeats_and_matches_fixed(g, iy, ix, (b, c, h, w), got, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_window", "zeros", "single_large",
                                  "nan_plane"])
def test_splat_kernel_extremes(rng, cuda, case):
    # every point on one window: each of its pixels sums all P taps of a
    # plane, the most the fixed-point headroom allows for
    b, c, h, w, p = 2, 3, 32, 32, 32 * 32
    g = torch.from_numpy(rng.standard_normal((b, 4 * c, p)).astype(
        np.float32))
    iy, ix = _starts(rng, b, h, w)
    if case == "one_window":
        iy.fill_(5)
        ix.fill_(7)
        g = g.sign() * 3.0e4
    elif case == "zeros":
        g.zero_()
    elif case == "single_large":
        g[1, 4, 100] = 3.0e38
    else:
        g[0, 2 * c + 1, 17] = float("nan")
    got = splat2x2(g.to(cuda), iy.to(cuda), ix.to(cuda), (b, c, h, w)).cpu()
    _assert_repeats_and_matches_fixed(g, iy, ix, (b, c, h, w), got, cuda)
    if case == "nan_plane":
        # the plane that holds a NaN comes out all NaN, the others finite
        assert bool(got[0, 1].isnan().all())
        got[0, 1] = 0.0
        assert bool(torch.isfinite(got).all())
        return
    want = splat2x2_plain(g, iy, ix, (b, c, h, w))
    assert float((got - want).abs().max()) <= _splat_tol(want)


def _warp(rng, b, s):
    """Vertices of a smooth depth map under small rotations."""
    ys, xs = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    c = (s - 1) / 2
    out = []
    for i in range(b):
        a = 0.05 * (i % 4 - 1.5)
        z = 1.0 + 0.05 * np.sin(xs / 9.0 + i) * np.cos(ys / 7.0)
        x = c + (xs - c) * np.cos(a) - (ys - c) * np.sin(a) + 2 * (z - 1) * s
        y = c + (xs - c) * np.sin(a) + (ys - c) * np.cos(a)
        out.append((x, y, z))
    return [torch.tensor(np.stack([o[k] for o in out]), dtype=torch.float32)
            for k in range(3)]


# large yaws and shifts over a depth step: the far sheet folds over the
# near one, and part of each grid leaves the padded viewport
FOLD_VIEWS = [[0.1, 0.5, 0.0, 0.04, 0.0, 0.0],
              [-0.2, -0.6, 0.1, -0.03, 0.02, 0.0],
              [0.0, 0.7, -0.2, 0.0, -0.04, 0.05],
              [0.3, -0.4, 0.0, 0.03, 0.03, 0.0]]


def _folded_warp(b, s):
    """Vertices (vx, vy, vz) of a depth map with a steep step under
    FOLD_VIEWS, projected by the port's renderer on the CPU."""
    ys, xs = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    step = np.where(xs + 0.5 * ys < 0.6 * s, 0.95, 1.1).astype(np.float32)
    r = Renderer({"rot_center_depth": 1.0, "fov": 10}, s, 0.9, 1.1,
                 device="cpu")
    rot, trans = get_transform_matrices(
        torch.tensor((FOLD_VIEWS * b)[:b], dtype=torch.float32))
    pts = r.get_warped_3d_grid(torch.from_numpy(np.stack([step] * b)), rot,
                               trans)
    return [t.reshape(b, s, s).contiguous()
            for t in r._project_screen(pts.reshape(b, -1, 3))]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("window", [3, 5])
def test_raster_place_matches_plain_on_folded_warp(cuda, b, window):
    near, far, s = 0.8, 1.2, 128
    vx, vy, vz = _folded_warp(b, s)
    ref = build_winner_buffers_plain(vx, vy, vz, window, near, far)
    # folds and faces off-screen: fewer slots are won than there are faces
    assert int((ref[:, :, :, :, 9] >= 0).sum()) < 2 * b * (s - 1) ** 2
    bufs = raster_place(vx.to(cuda), vy.to(cuda), vz.to(cuda), window, near,
                        far)
    assert torch.equal(bufs.cpu(), ref)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("h,w", [(258, 258), (1, 16), (16, 1)])
def test_raster_place_refuses_grids_without_1_to_2_16_cells(device, h, w):
    # the same refusal on both devices: a cell id fills 16 bits of the key
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v = torch.zeros((1, h, w), device=device)
    with pytest.raises(ValueError, match="1 to 2\\^16 cells"):
        raster_place(v, v, v, 3, 0.8, 1.2)


@pytest.mark.cuda
@pytest.mark.parametrize("s,b,window", [
    (64, 4, 3), (128, 16, 3), (64, 4, 5), (128, 1, 3), (128, 1, 5),
    (128, 16, 5), (40, 2, 3), (40, 2, 5), (100, 16, 5)])
def test_raster_kernels_match_plain(rng, cuda, s, b, window):
    near, far = 0.8, 1.2
    vx, vy, vz = _warp(rng, b, s)
    ref = build_winner_buffers_plain(vx, vy, vz, window, near, far)
    _cuda.reset_launches()
    bufs = raster_place(vx.to(cuda), vy.to(cuda), vz.to(cuda), window, near,
                        far)
    assert torch.equal(bufs.cpu(), ref)
    key = raster_tests(bufs, s, s, window, near, far).cpu()
    # placement is two launches: place_collide_kernel, place_write_kernel
    assert _cuda.LAUNCHES["raster_place"] == 2
    assert _cuda.LAUNCHES["raster_tests"] == 1
    assert torch.equal(key, dense_winner_plain(ref, s, s, window, near, far))
    assert float((key != SENTINEL).float().mean()) > 0.5


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_raster_tests_refuses_windows_above_5(rng, device):
    # the same refusal on both devices, by raster_tests and the entries
    # that reach it
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bufs = torch.full((2, 1, 2, 2, 10, 30, 30), -1, dtype=torch.int16,
                      device=device)
    with pytest.raises(ValueError, match="window 1 to 5"):
        raster_tests(bufs, 16, 16, 6, 0.8, 1.2)
    vx, vy, vz = (t.to(device) for t in _warp(rng, 1, 16))
    with pytest.raises(ValueError, match="window 1 to 5"):
        raster_mega(vx, vy, vz, 6, 0.8, 1.2)


@pytest.mark.cuda
@pytest.mark.parametrize("s,b", [(64, 4), (128, 4)])
def test_raster_mega_matches_buffers_path(rng, cuda, s, b):
    near, far, window = 0.8, 1.2, 5
    vx, vy, vz = _warp(rng, b, s)
    want = dense_winner(vx, vy, vz, window, near, far)
    _cuda.reset_launches()
    got = raster_mega(vx.to(cuda), vy.to(cuda), vz.to(cuda), window, near,
                      far)
    # the B3 entry is one placement (place_collide_kernel and
    # place_write_kernel) and one tests_kernel launch
    assert _cuda.LAUNCHES["raster_place"] == 2
    assert _cuda.LAUNCHES["raster_tests"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert float(want[2].float().mean()) > 0.5


# ---------------- the StyleGAN2 epilogue (csrc/bias_act.cu) ----------------

# car512's generator widths a plane size (channel multiplier 2) at 64
# images, a step-2 iteration of car512-n8; 0 is the mapping's and D's
# linear layers (H*W = 1)
CAR_WIDTHS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 512, 128: 256, 256: 128,
              512: 64, 0: 512}


def _epilogue_inputs(res, dtype, device, batch=64, per_sample=False,
                     seed=0):
    """x, demod, weighted noise, bias of a StyledConv at `res` (a linear
    layer's x and bias at res 0), with exact zeros in the pre-activation:
    x, the noise and the bias all 0 at some points."""
    g = torch.Generator().manual_seed(seed)
    c = CAR_WIDTHS[res]
    shape = (batch, c) + ((res, res) if res else ())
    x = torch.randn(shape, generator=g)
    bias = torch.randn(c, generator=g)
    bias[::4] = 0
    if not res:
        x[:, ::4][::3] = 0
        return x.to(device, dtype), None, None, bias.to(device)
    x[:, ::4, ::3, ::2] = 0
    demod = torch.rand(batch, c, generator=g) + 0.5
    noise = 0.3 * torch.randn((batch if per_sample else 1, 1, res, res),
                              generator=g)
    noise[..., ::3, :] = 0
    return (x.to(device, dtype), demod.to(device), noise.to(device, dtype),
            bias.to(device))


def _grads(fn, inputs, g):
    leaves = [t.detach().requires_grad_(True) if t is not None else None
              for t in inputs]
    y = fn(*leaves)
    want = [t for t in leaves if t is not None]
    return y.detach(), torch.autograd.grad(y, want, g)


def _sum_tol(terms, dims, dtype):
    """A fixed-order sum against another order: 16 f32 units of the sum of
    the terms' magnitudes, and in bf16 besides two units of the result's
    own rounding to bf16 (bounded by that sum too)."""
    mag = terms.abs().sum(dims)
    tol = 16 * torch.finfo(torch.float32).eps * mag
    if dtype == torch.bfloat16:
        tol = tol + 2 * torch.finfo(torch.bfloat16).eps * mag
    return tol


def _assert_sums_close(grads, want, inputs, g):
    """grad_demod, grad_noise and grad_bias (those present) within
    `_sum_tol` of the plain chain's."""
    x, demod, noise, _ = inputs
    # a bound on each sum's terms: |the gradient before the demodulation|
    # is at most gain |g|
    pre = fused_act.SQRT2 * g.float().abs()
    spatial = tuple(range(2, x.dim()))
    sums = [(-1, pre, (0,) + spatial)]
    if demod is not None:
        sums.append((1, x.float().abs() * pre, spatial))
    if noise is not None:
        dims = (1,) if noise.shape[0] > 1 else (0, 1)
        sums.append((1 + (demod is not None), pre, dims))
    for k, terms, dims in sums:
        got, exp = grads[k].float(), want[k].float()
        tol = _sum_tol(terms, dims, x.dtype).reshape(exp.shape)
        assert bool(((got - exp).abs() <= tol).all()), \
            (k, float((got - exp).abs().max()))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("res", sorted(CAR_WIDTHS))
def test_bias_act_kernels_match_plain(cuda, res, dtype):
    """Forward bit-equal to the plain chain; grad_x equal to its autograd;
    grad_demod, grad_noise and grad_bias within a reduction-order
    tolerance; a second call repeats every bit."""
    inputs = _epilogue_inputs(res, dtype, cuda)
    x, demod, noise, bias = inputs
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda, dtype)
    _cuda.reset_launches()
    y, grads = _grads(fused_act.bias_act, inputs, g)
    assert _cuda.LAUNCHES["bias_act"] == 1
    assert _cuda.LAUNCHES["bias_act_grad"] == 1
    want_y, want = _grads(fused_act.bias_act_plain, inputs, g)
    assert torch.equal(_bits(y), _bits(want_y))
    assert torch.equal(grads[0], want[0])
    _assert_sums_close(grads, want, inputs, g)
    y2, grads2 = _grads(fused_act.bias_act, inputs, g)
    assert torch.equal(_bits(y2), _bits(y))
    for a, b in zip(grads2, grads):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_bias_act_per_sample_noise_and_no_demod(cuda):
    """The GAN trainer's per-sample noise, and D's bias-only epilogue at a
    plane size that is not a multiple of 4 (the scalar path)."""
    inputs = _epilogue_inputs(16, torch.float32, cuda, batch=8,
                              per_sample=True)
    g = torch.randn(inputs[0].shape, device=cuda)
    y, grads = _grads(fused_act.bias_act, inputs, g)
    want_y, want = _grads(fused_act.bias_act_plain, inputs, g)
    assert torch.equal(y, want_y) and torch.equal(grads[0], want[0])
    _assert_sums_close(grads, want, inputs, g)
    x = torch.randn(3, 5, 7, 9, device=cuda)
    x[:, :, ::2] = 0
    bias = torch.randn(5, device=cuda)
    bias[1] = 0
    inputs = (x, None, None, bias)
    g = torch.randn(x.shape, device=cuda)
    y, grads = _grads(fused_act.bias_act, inputs, g)
    want_y, want = _grads(fused_act.bias_act_plain, inputs, g)
    assert torch.equal(y, want_y) and torch.equal(grads[0], want[0])
    _assert_sums_close(grads, want, inputs, g)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [0, 8, 32])
def test_bias_act_second_derivative_matches_plain(cuda, res):
    """R1's and the path penalty's double backward: the gradient of a
    function of the first gradients, through the kernels and through the
    plain chain."""
    inputs = _epilogue_inputs(res, torch.float64, "cpu", batch=4)
    inputs = [t.float().to(cuda) if t is not None else None for t in inputs]

    def second(fn):
        leaves = [t.clone().requires_grad_(True) if t is not None else None
                  for t in inputs]
        live = [t for t in leaves if t is not None]
        y = fn(*leaves)
        first = torch.autograd.grad((y * y).sum(), live, create_graph=True)
        penalty = sum((f ** 2).sum() for f in first)
        return torch.autograd.grad(penalty, live)

    got = second(fused_act.bias_act)
    want = second(fused_act.bias_act_plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_bias_act_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 3, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fused_act.bias_act(x.double())
    with pytest.raises(ValueError, match="demod"):
        fused_act.bias_act(x, demod=torch.ones(2, 4, device=cuda))
    with pytest.raises(ValueError, match="noise"):
        fused_act.bias_act(x, noise=torch.ones(1, 1, 4, 5, device=cuda))
    with pytest.raises(ValueError, match="bias"):
        fused_act.bias_act(x, bias=torch.ones(4, device=cuda))


@pytest.mark.cuda
def test_bias_act_launches_once_per_layer_in_a_face128_step2(cuda):
    """One step-2 iteration of the face-128 Trainer launches the forward
    kernel once for every StyledConv, activated ConvLayer and fused-lrelu
    EqualLinear call, and the backward kernel once for each such call whose
    output takes part in the gradient."""
    from gan2shape_torch.core.trainer import Trainer
    from gan2shape_torch.models import stylegan2 as S

    config = {"image_size": 128, "gan_size": 128, "z_dim": 512,
              "channel_multiplier": 1, "category": "face",
              "n_proj_samples": 16, "n_epochs_prior": 20,
              "learning_rate": 1e-4, "prior_name": "box",
              "rot_center_depth": 1.0, "fov": 10}
    trainer = Trainer(config, seed=0, device=cuda)
    gen = torch.Generator().manual_seed(0)
    image = (torch.rand(1, 3, 128, 128, generator=gen) * 2 - 1).to(cuda)
    latent = torch.randn(1, 512, generator=gen).to(cuda)
    collected, _ = trainer.run_step1(image, 0)
    calls = {"fwd": 0, "grad": 0}

    def hook(module, args, out):
        calls["fwd"] += 1
        calls["grad"] += int(out.requires_grad)

    epilogues = [m for m in trainer.model.modules()
                 if isinstance(m, S.StyledConv)
                 or (isinstance(m, S.ConvLayer) and isinstance(
                     m[-1], (S.FusedLeakyReLU, S._ScaledLeakyReLU)))
                 or (isinstance(m, S.EqualLinear)
                     and m.activation == "fused_lrelu")]
    handles = [m.register_forward_hook(hook) for m in epilogues]
    try:
        _cuda.reset_launches()
        trainer.run_step2(image, latent, collected, 1)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    assert calls["fwd"] > 0 and calls["grad"] > 0
    assert _cuda.LAUNCHES["bias_act"] == calls["fwd"], (_cuda.LAUNCHES, calls)
    assert _cuda.LAUNCHES["bias_act_grad"] == calls["grad"], \
        (_cuda.LAUNCHES, calls)
