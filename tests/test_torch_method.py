"""The port's method (gan2shape_torch.core.model.GAN2Shape) against the JAX
package's on one JAX init brought over through the bridge, at 64 px with a
32-px GAN: iteration-0 losses of the depth-prior objective (2e-7 relative),
step 1 and step 3 (2e-6 relative), step 2 with one injected pseudo-sample
pool (1e-4 absolute), and the hoisted step-1 split equal to the whole
forward.

Steps 1 and 3 sit at 2e-6, not 2e-7: XLA's and oneDNN's convolutions sum in
different orders, so the nets' outputs already differ by ~3e-6 relative
(held to 1e-5 in test_torch_nets.py), and the losses inherit ~1e-6 of it
(measured 6.8e-7 and 7.8e-7 on this init)."""

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
    "image_size": S, "gan_size": 32, "z_dim": 512,
    "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
    "rot_center_depth": 1.0, "fov": 10,
}
N_PROJ = 3


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.fixture(scope="module")
def env():
    jm = JModel(CFG)
    params = jm.init_params(jax.random.PRNGKey(0))
    frozen = jm.init_frozen(jax.random.PRNGKey(1))
    tm = GAN2Shape(CFG, device="cpu")
    jax2torch.load_into(tm, params, frozen)
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (1, 3, S, S)).astype(np.float32)
    latent = rng.standard_normal((1, 512)).astype(np.float32)
    return jm, params, frozen, tm, image, latent


def test_depth_prior_loss_matches_jax(env):
    jm, params, _, tm, image, _ = env
    prior = np.full((S, S), 1.0, np.float32)
    prior[16:48, 20:44] = 0.95
    jl, jd = jm.depth_net_forward(params, jnp.asarray(image),
                                  jnp.asarray(prior))
    with torch.no_grad():
        tl, td = tm.depth_net_forward(T(image), T(prior))
    assert _rel(tl, jl) <= 2e-7
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


def test_step1_loss_and_collected_match_jax(env):
    jm, params, frozen, tm, image, _ = env
    jl, jc = jm.forward_step1(params, frozen, jnp.asarray(image))
    with torch.no_grad():
        tl, tc = tm.forward_step1(T(image))
        inv = tm.step1_invariants(T(image))
        tl2, _ = tm.step1_iter(T(image), inv)
    assert _rel(tl, jl) <= 2e-6, (float(tl), float(jl))
    assert _rel(tl2, tl) <= 2e-7
    # normals difference the depth, amplifying its ~3e-7 gap
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def _pool(n, seed):
    rng = np.random.default_rng(seed)
    pseudo = rng.uniform(-1, 1, (n, 3, S, S)).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, 1, S, S)) > 0.2).astype(np.float32)
    return pseudo, mask


def test_step2_loss_with_injected_pool_matches_jax(env):
    jm, params, frozen, tm, image, latent = env
    pseudo, mask = _pool(N_PROJ, 1)
    jinv = jm.step2_invariants(frozen, jnp.asarray(latent))
    jl, (jproj, _) = jm.step2_loss(params, frozen, jnp.asarray(latent),
                                   jnp.asarray(pseudo), jnp.asarray(mask),
                                   jinv)
    with torch.no_grad():
        tinv = tm.step2_invariants(T(latent))
        tl, (tproj, _) = tm.step2_loss(T(latent), T(pseudo), T(mask), tinv)
    assert abs(float(tl) - float(jl)) <= 1e-4
    np.testing.assert_allclose(tproj.numpy(), np.asarray(jproj), atol=1e-4)


def test_step3_loss_matches_jax(env):
    jm, params, frozen, tm, image, latent = env
    proj, mask = _pool(N_PROJ, 2)
    jl, _ = jm.forward_step3(params, frozen, jnp.asarray(image),
                             jnp.asarray(latent),
                             (jnp.asarray(proj), jnp.asarray(mask)))
    with torch.no_grad():
        tl, _ = tm.forward_step3(T(image), T(latent), (T(proj), T(mask)))
    assert _rel(tl, jl) <= 2e-6, (float(tl), float(jl))


def test_pseudo_samples_and_evaluation(env):
    jm, params, frozen, tm, image, _ = env
    with torch.no_grad():
        _, coll = tm.forward_step1(T(image))
        g = torch.Generator().manual_seed(0)
        pseudo, mask = tm.step2_sample(g, coll, N_PROJ)
        recon_im, recon_depth = tm.evaluate_results(T(image))
    assert pseudo.shape == (N_PROJ, 3, S, S) and mask.shape == (N_PROJ, 1,
                                                                S, S)
    assert torch.isfinite(pseudo).all() and pseudo.abs().max() <= 1.0
    assert set(np.unique(mask.numpy())) <= {0.0, 1.0}
    j_im, j_depth = jm.evaluate_results(params, frozen, jnp.asarray(image))
    np.testing.assert_allclose(recon_im.numpy(), np.asarray(j_im), atol=1e-4)
    np.testing.assert_allclose(recon_depth.numpy(), np.asarray(j_depth),
                               atol=1e-6)
