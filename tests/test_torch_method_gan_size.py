"""The port's method against the JAX package's where the GAN synthesises
at a larger size than the image it trains at (`gan_size > image_size`, as
the cat, church and car configs do): image 64, GAN 128, category `cat`,
`disc_ftr_num` 3, on one JAX init brought over through the bridge.

Step 2 then shrinks the synthesis and the inversion by area resize, and
feeds image-size inputs to a discriminator built at the GAN size through
the `ftr_num` early exit.  The bounds are test_torch_method.py's:
iteration-0 step 1 and step 3 within 2e-6 relative, step 2 with one
injected pseudo-sample pool and its projected image within 1e-4 absolute.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.core.model import GAN2Shape as JModel

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.core.model import GAN2Shape

S = 64
CFG = {
    "image_size": S, "gan_size": 128, "z_dim": 512,
    "channel_multiplier": 1, "category": "cat", "disc_ftr_num": 3,
    "rot_center_depth": 1.0, "fov": 10,
}
N_PROJ = 3


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
def env(_two_torch_threads):
    jm = JModel(CFG)
    params = jm.init_params(jax.random.PRNGKey(0))
    frozen = jm.init_frozen(jax.random.PRNGKey(1))
    tm = GAN2Shape(CFG, device="cpu")
    jax2torch.load_into(tm, params, frozen)
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (1, 3, S, S)).astype(np.float32)
    latent = rng.standard_normal((1, 512)).astype(np.float32)
    return jm, params, frozen, tm, image, latent


def _pool(n, seed):
    rng = np.random.default_rng(seed)
    pseudo = rng.uniform(-1, 1, (n, 3, S, S)).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, 1, S, S)) > 0.2).astype(np.float32)
    return pseudo, mask


def test_gan_larger_than_image_builds_at_gan_size(env):
    _, _, _, tm, _, _ = env
    assert tm.gan_size == 128 and tm.image_size == S
    assert tm.generator.size == 128


def test_step1_loss_matches_jax_gan_larger_than_image(env):
    jm, params, frozen, tm, image, _ = env
    jl, _ = jm.forward_step1(params, frozen, jnp.asarray(image))
    with torch.no_grad():
        tl, _ = tm.forward_step1(T(image))
    assert _rel(tl, jl) <= 2e-6, (float(tl), float(jl))


def test_step2_loss_and_projection_match_jax_gan_larger_than_image(env):
    jm, params, frozen, tm, _, latent = env
    pseudo, mask = _pool(N_PROJ, 1)
    jinv = jm.step2_invariants(frozen, jnp.asarray(latent))
    jl, (jproj, _) = jm.step2_loss(params, frozen, jnp.asarray(latent),
                                   jnp.asarray(pseudo), jnp.asarray(mask),
                                   jinv)
    with torch.no_grad():
        tinv = tm.step2_invariants(T(latent))
        tl, (tproj, _) = tm.step2_loss(T(latent), T(pseudo), T(mask), tinv)
    # the synthesis is resized from the GAN's 128 to the image's 64
    assert tuple(tinv["gan_im"].shape) == (1, 3, S, S)
    assert tuple(tproj.shape) == (N_PROJ, 3, S, S)
    np.testing.assert_allclose(tinv["gan_im"].numpy(),
                               np.asarray(jinv["gan_im"]), atol=1e-4)
    assert abs(float(tl) - float(jl)) <= 1e-4, (float(tl), float(jl))
    np.testing.assert_allclose(tproj.numpy(), np.asarray(jproj), atol=1e-4)


def test_step3_loss_matches_jax_gan_larger_than_image(env):
    jm, params, frozen, tm, image, latent = env
    proj, mask = _pool(N_PROJ, 2)
    jl, _ = jm.forward_step3(params, frozen, jnp.asarray(image),
                             jnp.asarray(latent),
                             (jnp.asarray(proj), jnp.asarray(mask)))
    with torch.no_grad():
        tl, _ = tm.forward_step3(T(image), T(latent), (T(proj), T(mask)))
    assert _rel(tl, jl) <= 2e-6, (float(tl), float(jl))
