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

from gan2shape_torch.ops import _cuda
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
