"""A miniature instance-mode `fit` in both packages from one JAX init
(brought over through the bridge), at 64 px with a 32-px GAN: a short
depth-prior pretrain and two stages of a few iterations of each step.  The
step-2 pseudo-sample sampling is replaced on both sides by one fixed numpy
pool (its random streams cannot be matched across frameworks).

What the comparison can ask for.  Adam's first updates move every weight by
about lr * sign(grad), so gradient differences far below f32 precision flip
the steps of near-zero-gradient weights, and the trajectories drift apart
from the first prior iteration on.  The port alone shows it: run again with
its gradients scaled by 1 + 1e-7 * N(0, 1), its final depth moves by a mean
6.0e-3 (the floor below).  Against JAX the loss trajectories sit up to
3.6e-3 relative apart and the final depth maps a mean 1.72e-2 apart.  So
the trajectories are held to rtol 3e-3 with atol 3e-3, as the JAX
package's own trajectory test (tests/test_method_parity.py) does, and the
depth MAD to 2e-2 and to 4x the floor.  A step 3 that takes no optimizer
step breaks both limits (2.5e-2 relative, MAD 2.15e-2); a wrong parameter
subset or a missing step-2 update breaks the trajectories.  Decoupled
weight decay (AdamW) keeps the trajectories within theirs and puts the MAD
at 2.02e-2, just over its limit, so the optimizer and the per-step
parameter subsets are also held exactly, by the first two tests.

The JAX side rasterizes in its exact 'scatter' mode, once: its grid mode
unrolls 8*window^2 candidate tests into one XLA graph whose CPU compile
inside the step gradients costs minutes.  The port runs in each of 'grid'
(its training path, whose winner is held bit-equal to the JAX grid path in
test_torch_rasterize.py) and 'scatter' (like for like).  The scatter case
measures a depth MAD of 1.713e-2 against a floor of 4.50e-3 and a largest
relative loss gap of 3.83e-3, no closer than grid mode's, so both are held
to the same limits: the gap comes from Adam's sign noise, not the
rasterizer."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gan2shape_tpu.core import trainer as j_trainer

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.core.trainer import (
    STEP_SUBSETS, Trainer, default_optimizer,
)
from gan2shape_torch.ops import _cuda

S = 64
CFG = {
    "image_size": S, "gan_size": 32, "z_dim": 512,
    "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
    "rot_center_depth": 1.0, "fov": 10, "n_proj_samples": 2,
    "n_epochs_prior": 2, "learning_rate": 1e-4, "prior_name": "box",
}
STAGES = [{"step1": 2, "step2": 2, "step3": 1}] * 2


def test_default_optimizer_matches_jax():
    """Adam with the weight decay added to the gradient (not AdamW), step
    for step against the JAX package's optax chain on one gradient
    sequence.  The decay term 5e-4 * p is the size of these gradients, so
    decoupled or missing decay, or another beta, moves the parameters off
    JAX's by 1.4e-6 to 8.7e-4; the port stays within 1 ulp (1.2e-7)."""
    rng = np.random.default_rng(0)
    p0 = rng.uniform(-1, 1, 4096).astype(np.float32)
    grads = (1e-3 * rng.standard_normal((5, 4096))).astype(np.float32)
    opt = j_trainer.default_optimizer()
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    for g in grads:
        update, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, update)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = default_optimizer([tp])
    for g in grads:
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
    assert np.abs(np.asarray(jp) - p0).max() > 1e-4  # the steps moved it
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0,
                               atol=5e-7)


def test_step_subsets_match_jax():
    """Each step's optimizer holds exactly the parameters of the JAX
    package's subset for that step."""
    assert STEP_SUBSETS == j_trainer.STEP_SUBSETS
    tt = Trainer(CFG, seed=0, device="cpu")
    assert set(tt.optimizers) == set(j_trainer.STEP_SUBSETS)
    for step, names in j_trainer.STEP_SUBSETS.items():
        held = [p for g in tt.optimizers[step].param_groups
                for p in g["params"]]
        want = [p for n in names for p in tt.model.nets[n].parameters()]
        assert len(held) == len(want) > 0
        assert {id(p) for p in held} == {id(p) for p in want}, step


def _torch_fit(mode, params, frozen, image, latent, pool, grad_noise=None):
    """The port's fit from the JAX init in raster mode `mode`; with
    `grad_noise` (a seed) every gradient is scaled by 1 + 1e-7 * N(0, 1)
    before its Adam step."""
    tt = Trainer(dict(CFG, raster_mode=mode), seed=0, device="cpu")
    jax2torch.load_into(tt.model, params, frozen)
    tt.model.step2_sample = lambda g, collected, n: tuple(
        torch.from_numpy(a.copy()) for a in pool)
    if grad_noise is not None:
        gen = torch.Generator().manual_seed(grad_noise)

        def noisy_step(loss, optimizer):
            tt.model.zero_grad(set_to_none=True)
            loss.backward()
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.mul_(1 + 1e-7 * torch.randn(p.grad.shape,
                                                           generator=gen))
            optimizer.step()

        tt._step = noisy_step
    history = tt.fit([(image, latent, 0)], stages=STAGES)
    _, depth = tt.evaluate(torch.from_numpy(image[None].copy()))
    return history, depth.numpy()


@pytest.fixture(scope="module")
def jax_fitted():
    """The JAX fit, once, in 'scatter' mode."""
    rng = np.random.default_rng(0)
    image = rng.uniform(-1, 1, (3, S, S)).astype(np.float32)
    latent = rng.standard_normal(512).astype(np.float32)
    pool_im = rng.uniform(-1, 1, (2, 3, S, S)).astype(np.float32)
    pool_mask = (rng.uniform(0, 1, (2, 1, S, S)) > 0.2).astype(np.float32)

    jt = j_trainer.Trainer(dict(CFG, raster_mode="scatter"), seed=0)
    params = jax.tree.map(np.asarray, jt.params)
    frozen = jax.tree.map(np.asarray, jt.frozen)

    def jax_pool(key, collected, n):
        # tie the pool to a traced value so XLA does not constant-fold the
        # discriminator pass over it at compile time
        z = 0.0 * jax.numpy.sum(collected[3])
        return (jax.numpy.asarray(pool_im) + z,
                jax.numpy.asarray(pool_mask) + z)

    jt.model.step2_sample = jax_pool
    real_scan = jax.lax.scan

    def unrolled_scan(*args, **kwargs):
        # the same iterations, unrolled: XLA:CPU runs the step-2
        # discriminator convolutions inside a while loop ~100x slower than
        # outside one (~50 s against ~0.5 s per iteration here)
        return real_scan(*args, **dict(kwargs, unroll=True))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", unrolled_scan)
        jh = jt.fit([(image, latent, 0)], stages=STAGES)
    _, jdepth = jt.evaluate(jax.numpy.asarray(image[None]))
    return (params, frozen, image, latent, (pool_im, pool_mask)), jh, \
        np.asarray(jdepth)


@pytest.fixture(scope="module", params=["grid", "scatter"])
def fitted(request, jax_fitted):
    """The port's fit in each raster mode, with its sign-noise twin, against
    the one JAX fit."""
    inputs, jh, jdepth = jax_fitted
    _cuda.reset_launches()
    th, tdepth = _torch_fit(request.param, *inputs)
    launches = dict(_cuda.LAUNCHES)
    _, tdepth_noisy = _torch_fit(request.param, *inputs, grad_noise=1)
    return jh, th, jdepth, tdepth, tdepth_noisy, launches


def test_fit_loss_trajectories_match_jax(fitted):
    jh, th = fitted[:2]
    assert len(jh) == len(th) == len(STAGES)
    for jr, tr in zip(jh, th):
        for k in ("losses_step1", "losses_step2", "losses_step3"):
            assert len(tr[k]) == len(jr[k]) == STAGES[0][k[7:]]
            assert np.all(np.isfinite(tr[k]))
            np.testing.assert_allclose(tr[k], jr[k], rtol=3e-3, atol=3e-3)


def test_fit_final_depth_within_sign_noise_floor(fitted):
    jdepth, tdepth, tdepth_noisy = fitted[2:5]
    assert tdepth.shape == jdepth.shape == (1, S, S)
    mad = np.abs(tdepth - jdepth).mean()
    floor = np.abs(tdepth - tdepth_noisy).mean()
    # measured: grid MAD 1.72e-2, floor 6.0e-3; scatter MAD 1.71e-2,
    # floor 4.5e-3
    assert mad <= 2e-2, (mad, floor)
    assert mad <= 4 * floor, (mad, floor)


def test_cpu_fit_launches_no_kernel(fitted):
    """On the CPU every wrapper takes its plain version."""
    launches = fitted[5]
    assert all(v == 0 for v in launches.values()), launches
