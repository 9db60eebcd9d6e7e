"""The rest of LPIPS against the JAX package's: the AlexNet and SqueezeNet
1.1 trunks and both LPIPS modes on weights converted from one JAX init
(within 1e-5 of the largest value), `rgb2lab`, the L2 and DSSIM distances
(1e-5), `perceptual_distance`, the reference-layout weight files, and the
main path's step-1 loss with `lpips_net: alex` (2e-6 relative, as
tests/test_torch_method.py holds the VGG one)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.models import lpips as JL

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.models import lpips as TL


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel_max(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed, size, b=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (b, 3, size, size)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def nets():
    """{backbone: (JAX LPIPS params, port LPIPS with heads)}."""
    out = {}
    a, b = _pair(0, 64)
    for i, backbone in enumerate(("alex", "squeeze", "vgg")):
        jm = JL.LPIPS(backbone=backbone)
        params = jax.jit(jm.init)(jax.random.PRNGKey(i), jnp.asarray(a),
                                  jnp.asarray(b))
        tm = TL.LPIPS(backbone=backbone)
        tm.load_state_dict(jax2torch.lpips_state_dict(params))
        out[backbone] = (params, tm)
    return out


@pytest.mark.parametrize("size", [64, 67])
@pytest.mark.parametrize("backbone", ["alex", "squeeze"])
def test_trunk_taps_match_jax(nets, backbone, size):
    params, tm = nets[backbone]
    x, _ = _pair(1, size)
    trunk = JL.AlexFeatures() if backbone == "alex" else \
        JL.SqueezeFeatures()
    want = jax.jit(trunk.apply)({"params": params["params"][backbone]},
                                jnp.asarray(x))
    with torch.no_grad():
        got = getattr(tm, backbone)(T(x))
    assert len(got) == len(want) == len(TL.BACKBONE_CHNS[backbone])
    for g, w in zip(got, want):
        assert _rel_max(g, w) <= 1e-5


@pytest.mark.parametrize("model", ["net-lin", "net"])
@pytest.mark.parametrize("backbone", ["alex", "squeeze", "vgg"])
def test_lpips_modes_match_jax(nets, backbone, model):
    params, tm = nets[backbone]
    a, b = _pair(2, 64)
    if model == "net":  # the same trunk, no heads
        bare = TL.LPIPS(backbone=backbone, lpips_heads=False)
        bare.load_state_dict({k: v for k, v in tm.state_dict().items()
                              if not k.startswith("lin")})
        tm = bare
    want = jax.jit(lambda x, y: JL.perceptual_distance(
        params["params"], x, y, model=model, net=backbone))(
            jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = TL.perceptual_distance(tm, T(a), T(b), model=model)
        same = TL.perceptual_distance(tm, T(a), T(a), model=model)
    # the JAX init's heads have either sign, so only `net` is positive
    assert got.shape == (2, 1, 1, 1) and (model == "net-lin" or
                                         (got > 0).all())
    assert _rel_max(got, want) <= 1e-5
    assert float(same.abs().max()) <= 1e-7


def test_distance_modes_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    # the Lab conversion on both sides of its branches
    lab_in = np.linspace(-1, 1, 3 * 256, dtype=np.float32).reshape(
        1, 3, 16, 16)
    assert _rel_max(TL.rgb2lab(T(lab_in)), JL.rgb2lab(lab_in)) <= 1e-5
    assert _rel_max(TL.rgb2lab(T(a)), JL.rgb2lab(a)) <= 1e-5
    for model in ("L2", "DSSIM"):
        for space in ("RGB", "Lab"):
            got = TL.perceptual_distance(None, T(a), T(b), model=model,
                                         colorspace=space)
            want = JL.perceptual_distance(None, jnp.asarray(a),
                                          jnp.asarray(b), model=model,
                                          colorspace=space)
            assert got.shape == (2,) and (got > 0).all()
            assert _rel_max(got, want) <= 1e-5, (model, space)
    got = TL.perceptual_distance(None, T((a + 1) / 2), T((b + 1) / 2),
                                 model="L2", normalize=True)
    assert _rel_max(got, JL.l2_distance(a, b)) <= 1e-5
    # Lab keeps a finite gradient where a channel is black
    x = T(lab_in).requires_grad_(True)
    TL.dssim_distance(x, T(a[:1, :, :16, :16]), "Lab").sum().backward()
    assert torch.isfinite(x.grad).all()
    with pytest.raises(ValueError):
        TL.perceptual_distance(None, T(a), T(b), model="lab")
    with pytest.raises(ValueError):
        TL.LPIPS(backbone="resnet")


@pytest.mark.parametrize("backbone", ["alex", "squeeze"])
def test_reference_files_load_into_lpips(nets, backbone, tmp_path):
    """torchvision-layout backbone files and lpips v0.1 heads, written from
    the converted weights, load back into an LPIPS of that backbone; a
    config with `lpips_net` finds them under its own keys."""
    from gan2shape_torch.convert.reference import (
        LPIPS_TRUNK_FILES, build_frozen_assets, load_lpips,
    )
    from gan2shape_torch.core.model import GAN2Shape

    params, tm = nets[backbone]
    p = params["params"]
    trunk = jax2torch.TRUNK_STATE_DICTS[backbone](p[backbone])
    heads = {k: v for k, v in tm.state_dict().items() if k.startswith("lin")}
    torch.save(trunk, tmp_path / "trunk.pth")
    torch.save(heads, tmp_path / "heads.pth")
    fresh = TL.LPIPS(backbone=backbone)
    load_lpips(fresh, str(tmp_path / "trunk.pth"), str(tmp_path / "heads.pth"))
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    config = {"image_size": 64, "gan_size": 32, "channel_multiplier": 1,
              "lpips_net": backbone,
              LPIPS_TRUNK_FILES[backbone][0]: str(tmp_path / "trunk.pth"),
              "lpips_ckpt_path": str(tmp_path / "heads.pth")}
    model = build_frozen_assets(GAN2Shape(config, device="cpu"), config)
    assert model.lpips.backbone == backbone
    for k, v in tm.state_dict().items():
        assert torch.equal(model.lpips.state_dict()[k], v), k


def test_step1_loss_with_lpips_alex_matches_jax():
    backbone = "alex"
    from gan2shape_tpu.core.model import GAN2Shape as JModel
    from gan2shape_torch.core.model import GAN2Shape

    cfg = {"image_size": 64, "gan_size": 32, "z_dim": 512,
           "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
           "rot_center_depth": 1.0, "fov": 10, "lpips_net": backbone}
    jm = JModel(cfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    frozen = jax.jit(jm.init_frozen)(jax.random.PRNGKey(1))
    tm = GAN2Shape(cfg, device="cpu")
    jax2torch.load_into(tm, params, frozen)
    assert tm.lpips.backbone == backbone
    image = np.random.default_rng(0).uniform(
        -1, 1, (1, 3, 64, 64)).astype(np.float32)
    jl, _ = jax.jit(jm.forward_step1)(params, frozen, jnp.asarray(image))
    with torch.no_grad():
        tl, _ = tm.forward_step1(T(image))
    assert abs(float(tl) - float(jl)) <= 2e-6 * abs(float(jl))
