"""The port's networks against the JAX package's, with the JAX init brought
over through the port's bridge (gan2shape_torch.convert.jax2torch): the five
trainable nets, the StyleGAN2 generator (mapping, synthesis, invert) and
discriminator taps, and LPIPS-VGG — each within 1e-5 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.models import networks as j_nets
from gan2shape_tpu.models.lpips import LPIPS as JLPIPS
from gan2shape_tpu.models.stylegan2 import (
    Discriminator as JDisc, Generator as JGen,
)

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.models import networks as t_nets
from gan2shape_torch.models.lpips import LPIPS
from gan2shape_torch.models.stylegan2 import Discriminator, Generator


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rtol, err


NETS = {
    "viewpoint": (j_nets.ViewpointNet, t_nets.ViewpointNet),
    "lighting": (j_nets.LightingNet, t_nets.LightingNet),
    "depth": (j_nets.DepthNet, t_nets.DepthNet),
    "albedo": (j_nets.AlbedoNet, t_nets.AlbedoNet),
    "offset_encoder": (j_nets.OffsetEncoder, t_nets.OffsetEncoder),
}


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("name", list(NETS))
def test_trainable_net_matches_jax(rng, name, size):
    jcls, tcls = NETS[name]
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    jm = jcls(size)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tcls(size)
    tm.load_state_dict(jax2torch.NET_STATE_DICTS[name](params))
    with torch.no_grad():
        _close(tm(T(x)), jm.apply(params, jnp.asarray(x)))


GS = 32  # generator / discriminator size of the CPU tests


@pytest.fixture(scope="module")
def gan():
    jg = JGen(size=GS, style_dim=512, n_mlp=8, channel_multiplier=1)
    noise = jg.make_noise(jax.random.PRNGKey(3))
    gp = jg.init(jax.random.PRNGKey(1), [jnp.zeros((1, 512))], noise)
    # non-zero noise strengths and biases so every term is exercised
    rng = np.random.default_rng(7)
    gp = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), gp)
    tg = Generator(GS, 512, 8, channel_multiplier=1)
    tg.load_state_dict(jax2torch.generator_state_dict(gp, noise))
    jd = JDisc(size=GS, channel_multiplier=1)
    dp = jd.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, GS, GS)))
    td = Discriminator(GS, channel_multiplier=1)
    td.load_state_dict(jax2torch.discriminator_state_dict(dp))
    return jg, gp, noise, tg, jd, dp, td


def test_generator_mapping_matches_jax(gan, rng):
    jg, gp, _, tg, *_ = gan
    z = rng.standard_normal((3, 512)).astype(np.float32)
    with torch.no_grad():
        for kw in ({}, {"skip": 6}, {"depth": 6}):
            _close(tg.style_forward(T(z), **kw),
                   jg.apply(gp, jnp.asarray(z), method="style_forward", **kw))
        # the inverse of the whole random MLP is ill-conditioned; invert the
        # last two layers
        w = np.asarray(jg.apply(gp, jnp.asarray(z), method="style_forward"))
        _close(tg.style_invert(T(w), skip=6),
               jg.apply(gp, jnp.asarray(w), skip=6, method="style_invert"),
               1e-4)


def test_generator_synthesis_and_invert_match_jax(gan, rng):
    jg, gp, noise, tg, *_ = gan
    w = rng.standard_normal((2, 512)).astype(np.float32)
    with torch.no_grad():
        img, feats = tg([T(w)], input_is_w=True, return_features=True)
    jimg, jfeats = jg.apply(gp, [jnp.asarray(w)], noise, input_is_w=True,
                            return_features=True)
    _close(img, jimg)
    for f, jf in zip(feats, jfeats):
        _close(f, jf)
    z = rng.standard_normal((2, 512)).astype(np.float32)
    with torch.no_grad():
        img, _ = tg([T(z)])
    _close(img, jg.apply(gp, [jnp.asarray(z)], noise)[0])
    off = rng.standard_normal((2, 512)).astype(np.float32) * 0.1
    with torch.no_grad():
        inv, o = tg.invert((T(off), T(w)))
    jinv, _ = jg.apply(gp, (jnp.asarray(off), jnp.asarray(w)), noise=noise,
                       method="invert")
    _close(inv, jinv)


@pytest.mark.parametrize("size,ftr_num", [(64, 3), (GS, 100)])
def test_discriminator_taps_match_jax(gan, rng, size, ftr_num):
    *_, jd, dp, td = gan
    x = rng.uniform(-1, 1, (4, 3, size, size)).astype(np.float32)
    with torch.no_grad():
        out, feats = td(T(x), ftr_num)
    jout, jfeats = jd.apply(dp, jnp.asarray(x), ftr_num=ftr_num)
    assert len(feats) == len(jfeats) == min(ftr_num, 4)
    for f, jf in zip(feats, jfeats):
        _close(f, jf)
    _close(out, jout)


def test_lpips_vgg_matches_jax(rng):
    s = 64
    a = rng.uniform(-1, 1, (2, 3, s, s)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 3, s, s)).astype(np.float32)
    jm = JLPIPS()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))
    tm = LPIPS()
    tm.load_state_dict(jax2torch.lpips_state_dict(params))
    with torch.no_grad():
        _close(tm(T(a), T(b)), jm.apply(params, jnp.asarray(a),
                                        jnp.asarray(b)))
