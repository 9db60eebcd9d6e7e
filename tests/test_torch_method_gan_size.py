"""The port's method against the JAX package's where the GAN synthesises
at a larger size than the image it trains at (`gan_size > image_size`, as
the cat, church and car configs do), at image 64 and `disc_ftr_num` 3, in
three cases of the categories' shapes cut to size:

  cat     GAN 128, channel multiplier 1 (2:1, configs/cat.yml's width);
  church  GAN 128, channel multiplier 2 (2:1, configs/church.yml's width);
  car     GAN 256, channel multiplier 2 (4:1, configs/car.yml's ratio and
          width).

Step 2 then shrinks the synthesis and the inversion by area resize, and
feeds image-size inputs to a discriminator built at the GAN size through
the `ftr_num` early exit.  The five nets and LPIPS are one JAX init; the
GAN is a seeded port init with its parameters moved off their init values
(non-zero noise strengths and biases); both go through the bridge, so the
two packages hold the same weights.  The bounds are
test_torch_method.py's: iteration-0 step 1 and step 3 within 2e-6
relative, step 2 with one injected pseudo-sample pool and its projected
image within 1e-4 absolute.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.convert import torch2jax
from gan2shape_tpu.core.model import GAN2Shape as JModel

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.core.model import GAN2Shape
from gan2shape_torch.models.layers import reset_parameters

S = 64
BASE = {"image_size": S, "z_dim": 512, "disc_ftr_num": 3,
        "rot_center_depth": 1.0, "fov": 10}
# category: (gan_size, channel_multiplier, pseudo samples in step 2)
CASES = {"cat": (128, 1, 3), "church": (128, 2, 2), "car": (256, 2, 2)}


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: six test processes share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared(_two_torch_threads):
    """The JAX init of what does not depend on the GAN: the five nets and
    LPIPS (image 64 in every case)."""
    jm = JModel(dict(BASE, gan_size=S, channel_multiplier=1))
    params = jm.init_params(jax.random.PRNGKey(0))
    lpips = jm.lpips.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, S, S)),
                          jnp.zeros((1, 3, S, S)))
    return params, lpips


@pytest.fixture(scope="module", params=list(CASES))
def env(request, shared):
    category = request.param
    gan_size, cm, n_proj = CASES[category]
    cfg = dict(BASE, gan_size=gan_size, channel_multiplier=cm,
               category=category)
    params, lpips = shared
    tm = GAN2Shape(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    reset_parameters(tm.generator, g)
    reset_parameters(tm.discriminator, g)
    with torch.no_grad():
        for buf, n in zip(tm.generator.noise_list(),
                          tm.generator.make_noise(g)):
            buf.copy_(n)
        for p in tm.generator.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    gen, noise = torch2jax.convert_generator(tm.generator.state_dict())
    frozen = {"generator": gen, "noise": noise, "lpips": lpips,
              "discriminator": torch2jax.convert_discriminator(
                  tm.discriminator.state_dict())}
    jax2torch.load_into(tm, params, frozen)
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (1, 3, S, S)).astype(np.float32)
    latent = rng.standard_normal((1, 512)).astype(np.float32)
    return JModel(cfg), params, frozen, tm, image, latent, n_proj


def _pool(n, seed):
    rng = np.random.default_rng(seed)
    pseudo = rng.uniform(-1, 1, (n, 3, S, S)).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, 1, S, S)) > 0.2).astype(np.float32)
    return pseudo, mask


def test_gan_larger_than_image_builds_at_gan_size(env):
    jm, _, _, tm, _, _, _ = env
    assert tm.gan_size == jm.gan_size > tm.image_size == S
    assert tm.generator.size == tm.gan_size
    assert tm.generator.n_latent == 2 * int(np.log2(tm.gan_size)) - 2
    assert len(tm.generator.noise_list()) == tm.generator.num_layers


def test_step1_loss_matches_jax_gan_larger_than_image(env):
    jm, params, frozen, tm, image, _, _ = env
    jl, _ = jm.forward_step1(params, frozen, jnp.asarray(image))
    with torch.no_grad():
        tl, _ = tm.forward_step1(T(image))
    assert _rel(tl, jl) <= 2e-6, (float(tl), float(jl))


def test_step2_loss_and_projection_match_jax_gan_larger_than_image(env):
    jm, params, frozen, tm, _, latent, n_proj = env
    pseudo, mask = _pool(n_proj, 1)
    jinv = jm.step2_invariants(frozen, jnp.asarray(latent))
    jl, (jproj, _) = jm.step2_loss(params, frozen, jnp.asarray(latent),
                                   jnp.asarray(pseudo), jnp.asarray(mask),
                                   jinv)
    with torch.no_grad():
        tinv = tm.step2_invariants(T(latent))
        tl, (tproj, _) = tm.step2_loss(T(latent), T(pseudo), T(mask), tinv)
    # the synthesis is resized from the GAN's size to the image's 64
    assert tuple(tinv["gan_im"].shape) == (1, 3, S, S)
    assert tuple(tproj.shape) == (n_proj, 3, S, S)
    np.testing.assert_allclose(tinv["gan_im"].numpy(),
                               np.asarray(jinv["gan_im"]), atol=1e-4)
    assert abs(float(tl) - float(jl)) <= 1e-4, (float(tl), float(jl))
    np.testing.assert_allclose(tproj.numpy(), np.asarray(jproj), atol=1e-4)


def test_step3_loss_matches_jax_gan_larger_than_image(env):
    jm, params, frozen, tm, image, latent, n_proj = env
    proj, mask = _pool(n_proj, 2)
    jl, _ = jm.forward_step3(params, frozen, jnp.asarray(image),
                             jnp.asarray(latent),
                             (jnp.asarray(proj), jnp.asarray(mask)))
    with torch.no_grad():
        tl, _ = tm.forward_step3(T(image), T(latent), (T(proj), T(mask)))
    assert _rel(tl, jl) <= 2e-6, (float(tl), float(jl))
