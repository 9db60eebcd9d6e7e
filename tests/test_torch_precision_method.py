"""The method's iteration 0 under the bf16 activation policy: the step-1
and step-3 losses of the port's GAN2Shape at 64² (a 32-px GAN) with
`act_dtype: bfloat16` in its config, against the JAX package's under its
own 'bfloat16', on one JAX init brought over through the bridge.

At f32 the two agree to 2e-6 relative (test_torch_method.py).  Under bf16
the frozen G, D and LPIPS trunk round at other places in the two packages
(see test_torch_precision.py), and the losses, means over many pixels and
taps, inherit a small part of it: measured 2.8e-5 (step 1) and 2.2e-5
(step 3) relative on this init, held to ITER0_TOL."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.core.model import GAN2Shape as JModel
from gan2shape_tpu.utils import precision as jprec

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.core.model import GAN2Shape
from gan2shape_torch.utils import precision as prec

S = 64
CFG = {"image_size": S, "gan_size": 32, "z_dim": 512,
       "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
       "rot_center_depth": 1.0, "fov": 10}
ITER0_TOL = 5e-4


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    """One JAX init in both packages, the port's model built with
    `act_dtype: bfloat16` in its config; the policies are restored after
    the module's tests."""
    with prec.policy():
        jm = JModel(CFG)
        params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
        frozen = jax.jit(jm.init_frozen)(jax.random.PRNGKey(1))
        tm = GAN2Shape({**CFG, "act_dtype": "bfloat16"}, device="cpu")
        jax2torch.load_into(tm, params, frozen)
        assert prec.act_dtype() == torch.bfloat16
        jprec.set_act_dtype("bfloat16")
        rng = np.random.default_rng(0)
        inputs = {
            "image": rng.uniform(-1, 1, (1, 3, S, S)).astype(np.float32),
            "latent": rng.standard_normal((1, 512)).astype(np.float32),
            "proj": rng.uniform(-1, 1, (3, 3, S, S)).astype(np.float32),
            "mask": (rng.uniform(0, 1, (3, 1, S, S)) > 0.2).astype(
                np.float32)}
        try:
            yield jm, params, frozen, tm, inputs
        finally:
            jprec.set_act_dtype(None)


def _step(env, step):
    jm, params, frozen, tm, x = env
    image = x["image"]
    if step == "step1":
        j, _ = jax.jit(jm.forward_step1)(params, frozen, jnp.asarray(image))
        with torch.no_grad():
            t, _ = tm.forward_step1(T(image))
        return t, j
    pool = (x["proj"], x["mask"])
    j, _ = jax.jit(jm.forward_step3)(params, frozen, jnp.asarray(image),
                                     jnp.asarray(x["latent"]),
                                     tuple(map(jnp.asarray, pool)))
    with torch.no_grad():
        t, _ = tm.forward_step3(T(image), T(x["latent"]),
                                tuple(map(T, pool)))
    return t, j


@pytest.mark.parametrize("step", ["step1", "step3"])
def test_bf16_iteration0_loss_matches_jax(env, step):
    t, j = _step(env, step)
    assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert abs(float(t) - float(j)) <= ITER0_TOL * abs(float(j)), (
        float(t), float(j))
