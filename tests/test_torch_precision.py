"""The port's precision policy (gan2shape_torch.utils.precision) on the CPU:

  * the policy's state: names validated before they are assigned, the
    environment read at import, 'auto' as f32, both config keys applied by
    `GAN2Shape`, `resolve_device` keeping the policy, the torch flags as
    each name maps them, `exact_matmul` equal to `torch.matmul`, the
    `deterministic()` context's flags set and restored;
  * the frozen stacks under 'bfloat16' against the JAX package's under its
    own 'bfloat16', on one JAX init brought over through the bridge: the
    generator (32 px, style_dim 32, n_mlp 2) with the discriminator's taps,
    and LPIPS-VGG at 64²; each also against its own f32 run within JAX's
    bounds (tests/test_stylegan2.py: image 0.1, loss 5%, gradient cosine
    0.95);

bf16 keeps 8 bits of mantissa (a rounding step of 2^-8 = 3.9e-3 relative)
and the two packages round at other places (JAX's FIR filter is two
separable bf16 passes, the port's one 2-D pass; XLA's and oneDNN's bf16
convolutions accumulate differently), so the port is held to JAX's bf16
result at a few rounding steps of the largest value, with each bound
stated beside the value measured on this init.  The method's iteration 0
under 'bfloat16' is tested in test_torch_precision_method.py, the gate
(tools/check_precision.py) in test_torch_precision_gate.py: three files,
so that the JAX compiles of each run in parallel.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.models.lpips import LPIPS as JLPIPS
from gan2shape_tpu.models.stylegan2 import (
    Discriminator as JDisc, Generator as JGen,
)
from gan2shape_tpu.utils import precision as jprec

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.core.model import GAN2Shape
from gan2shape_torch.device import resolve_device
from gan2shape_torch.models.lpips import LPIPS
from gan2shape_torch.models.stylegan2 import Discriminator, Generator
from gan2shape_torch.rendering.renderer import Renderer
from gan2shape_torch.utils import precision as prec

ROOT = Path(__file__).resolve().parents[1]
GS, STYLE, N_MLP = 32, 32, 2


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel_max(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_policies():
    with prec.policy():
        yield
    jprec.set_act_dtype(None)


# ---------------- the policy's state ----------------

def test_bad_names_leave_the_policy_unchanged():
    prec.set_matmul_precision("high")
    prec.set_act_dtype("bfloat16")
    with pytest.raises(ValueError, match="act_dtype"):
        prec.set_act_dtype("bf16")  # a typo for bfloat16
    with pytest.raises(ValueError, match="matmul_precision"):
        prec.set_matmul_precision("medium")
    with pytest.raises(ValueError, match="matmul_precision"):
        with prec.policy("fast"):
            pass
    assert prec.act_dtype() == torch.bfloat16
    assert prec.matmul_precision() == "high"
    assert _flags() == (True, True)


@pytest.mark.parametrize("env,expect", [
    ({"G2S_MATMUL_PRECISION": "high", "G2S_ACT_DTYPE": "bfloat16"},
     "high torch.bfloat16 True True"),
    ({}, "highest torch.float32 False False"),
    ({"G2S_ACT_DTYPE": "bf16"}, "act_dtype must be one of"),
])
def test_env_vars_are_read_at_import(env, expect):
    code = ("from gan2shape_torch.utils import precision as p; "
            "import torch; p.apply_matmul_precision(); "
            "print(p.matmul_precision(), p.act_dtype(), "
            "torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32)")
    base = {k: v for k, v in os.environ.items()
            if k not in ("G2S_MATMUL_PRECISION", "G2S_ACT_DTYPE")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**base, **env}, capture_output=True,
                         text=True, timeout=120)
    assert expect in out.stdout + out.stderr
    assert (out.returncode == 0) == ("must be" not in expect)


def test_auto_and_none_resolve_to_f32():
    for name in ("auto", None, "float32"):
        prec.set_act_dtype(name)
        assert prec.act_dtype() == torch.float32
    prec.set_act_dtype("bfloat16")
    assert prec.act_dtype() == torch.bfloat16


@pytest.mark.parametrize("name,tf32", [("highest", False), ("high", True),
                                       ("default", True)])
def test_flags_read_back_as_each_name_maps(name, tf32):
    prec.set_matmul_precision(name)
    assert prec.matmul_precision() == name
    assert _flags() == (tf32, tf32)
    with prec.exact_f32():
        assert _flags() == (False, False)
    assert _flags() == (tf32, tf32)
    # the legacy flags and the newer attributes agree
    assert torch.get_float32_matmul_precision() == (
        "high" if tf32 else "highest")


def test_policy_context_restores_on_error():
    prec.set_matmul_precision("highest")
    prec.set_act_dtype("float32")
    with pytest.raises(RuntimeError):
        with prec.policy("default", "bfloat16"):
            assert _flags() == (True, True)
            assert prec.act_dtype() == torch.bfloat16
            raise RuntimeError("inside")
    assert prec.matmul_precision() == "highest"
    assert prec.act_dtype() == torch.float32 and _flags() == (False, False)


def _det_flags():
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())


@pytest.mark.parametrize("preset", [None, ":16:8"])
def test_deterministic_context_sets_and_restores_flags(monkeypatch, preset):
    # cuBLAS's workspace is set when unset, and a value already in the
    # environment is kept
    if preset is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", preset)
    before = _det_flags()
    with pytest.raises(RuntimeError):
        with prec.deterministic():
            assert _det_flags() == (True, False, True, False)
            assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == (
                preset or prec.CUBLAS_WORKSPACE_CONFIG)
            raise RuntimeError("inside")
    assert _det_flags() == before


def test_gan2shape_applies_both_config_keys_and_resolve_device_keeps_them():
    cfg = {"image_size": 64, "gan_size": 32, "z_dim": 512,
           "channel_multiplier": 1, "matmul_precision": "high",
           "act_dtype": "bfloat16"}
    GAN2Shape(cfg, device="cpu")
    assert prec.matmul_precision() == "high"
    assert prec.act_dtype() == torch.bfloat16
    assert _flags() == (True, True)
    # modules built after the model, and resolve_device itself, keep it
    Renderer({}, 64, 0.9, 1.1, device="cpu")
    resolve_device("cpu")
    assert prec.matmul_precision() == "high" and _flags() == (True, True)
    # a config without the keys leaves the policy as it is
    GAN2Shape({k: v for k, v in cfg.items()
               if k not in ("matmul_precision", "act_dtype")}, device="cpu")
    assert prec.matmul_precision() == "high"
    assert prec.act_dtype() == torch.bfloat16


@pytest.mark.parametrize("shape_a,shape_b", [
    ((3, 4, 3), (3, 3)),        # points by a 3x3 (grid_3d_to_2d)
    ((2, 10, 3), (2, 3, 3)),    # points by a batch of rotations
    ((2, 3, 3), (2, 3, 3)),     # rotation products
    ((6, 5), (2, 3, 5, 7)),     # the resize's row matrix by an image
])
def test_exact_matmul_matches_torch_matmul(shape_a, shape_b):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(shape_a, generator=g).requires_grad_(True)
    b = torch.randn(shape_b, generator=g).requires_grad_(True)
    out = prec.exact_matmul(a, b)
    want = torch.matmul(a, b)
    assert torch.equal(out, want)
    cot = torch.randn(want.shape, generator=g)
    ga, gb = torch.autograd.grad(out, (a, b), cot)
    wa, wb = torch.autograd.grad(want, (a, b), cot)
    torch.testing.assert_close(ga, wa, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gb, wb, rtol=1e-6, atol=1e-6)


# ---------------- the frozen stacks under bf16, against JAX ----------------

# port bf16 against JAX bf16, of the largest value (measured on this init):
# image 8.9e-3 and G taps up to 1.4e-2, D score 3.1e-2 and taps up to
# 1.2e-2, the tap loss 5.4e-5 relative, gradient cosine 0.9959
STACK_TOL = {"image": 3e-2, "taps": 3e-2, "score": 6e-2, "loss": 1e-3,
             "grad_cos": 0.99}
LPIPS_TOL = 1e-2  # relative; measured 4.1e-3
# JAX's own bf16 bounds (tests/test_stylegan2.py::test_bf16_activation_
# policy), for each package's bf16 run against its f32 run
IMAGE_ABS, LOSS_REL, GRAD_COS = 0.1, 0.05, 0.95


@pytest.fixture(scope="module")
def gan():
    jg = JGen(size=GS, style_dim=STYLE, n_mlp=N_MLP, channel_multiplier=1)
    noise = jg.make_noise(jax.random.PRNGKey(3))
    gp = jax.jit(lambda k: jg.init(k, [jnp.zeros((1, STYLE))], noise))(
        jax.random.PRNGKey(1))
    # non-zero noise strengths and biases so every term is exercised
    rng = np.random.default_rng(7)
    gp = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), gp)
    tg = Generator(GS, STYLE, N_MLP, channel_multiplier=1)
    tg.load_state_dict(jax2torch.generator_state_dict(gp, noise, N_MLP))
    jd = JDisc(size=GS, channel_multiplier=1)
    dp = jax.jit(lambda k: jd.init(k, jnp.zeros((1, 3, GS, GS))))(
        jax.random.PRNGKey(2))
    td = Discriminator(GS, channel_multiplier=1)
    td.load_state_dict(jax2torch.discriminator_state_dict(dp))
    return jg, gp, noise, tg, jd, dp, td


def _jax_stack(jg, gp, noise, jd, dp, w):
    """JAX's G + D under its current act_dtype: (image, G taps, score,
    D taps, tap loss, its gradient in w)."""
    def run(wv):
        img, feats = jg.apply(gp, [wv], noise, input_is_w=True,
                              return_features=True)
        score, dfeats = jd.apply(dp, img)
        loss = sum(jnp.mean(jnp.abs(f)) for f in dfeats[:3])
        return loss, (img, feats, score, dfeats)

    (loss, aux), grad = jax.jit(jax.value_and_grad(run, has_aux=True))(
        jnp.asarray(w))
    return (*aux, loss, grad)


def _port_stack(tg, td, w):
    wv = T(w).requires_grad_(True)
    img, feats = tg([wv], input_is_w=True, return_features=True)
    score, dfeats = td(img)
    loss = sum(torch.mean(torch.abs(f)) for f in dfeats[:3])
    grad, = torch.autograd.grad(loss, wv)
    return (img.detach(), [f.detach() for f in feats], score.detach(),
            [f.detach() for f in dfeats], float(loss.detach()), grad)


def test_bf16_generator_and_discriminator_match_jax(gan, rng):
    jg, gp, noise, tg, jd, dp, td = gan
    w = rng.standard_normal((2, STYLE)).astype(np.float32)
    ref = _port_stack(tg, td, w)
    prec.set_act_dtype("bfloat16")
    jprec.set_act_dtype("bfloat16")
    got = _port_stack(tg, td, w)
    want = _jax_stack(jg, gp, noise, jd, dp, w)

    img, feats, score, dfeats, loss, grad = got
    for t in (img, score, grad, *feats, *dfeats):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    # against JAX's bf16 stack
    assert _rel_max(img, want[0]) <= STACK_TOL["image"]
    for f, jf in zip(feats, want[1]):
        assert _rel_max(f, jf) <= STACK_TOL["taps"]
    assert _rel_max(score, want[2]) <= STACK_TOL["score"]
    assert len(dfeats) == len(want[3]) == 4
    for f, jf in zip(dfeats, want[3]):
        assert _rel_max(f, jf) <= STACK_TOL["taps"]
    assert abs(loss - float(want[4])) <= STACK_TOL["loss"] * abs(
        float(want[4]))
    assert _cos(grad.numpy(), np.asarray(want[5])) >= STACK_TOL["grad_cos"]
    # against its own f32 run, within JAX's bounds
    assert float((img - ref[0]).abs().max()) < IMAGE_ABS
    assert abs(loss - ref[4]) / abs(ref[4]) < LOSS_REL
    assert _cos(grad.numpy(), ref[5].numpy()) > GRAD_COS


def test_bf16_lpips_vgg_matches_jax(rng):
    s = 64
    a = rng.uniform(-1, 1, (2, 3, s, s)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 3, s, s)).astype(np.float32)
    jm = JLPIPS()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(a),
                              jnp.asarray(b))
    tm = LPIPS()
    tm.load_state_dict(jax2torch.lpips_state_dict(params))
    with torch.no_grad():
        d32 = tm(T(a), T(b))
        prec.set_act_dtype("bfloat16")
        jprec.set_act_dtype("bfloat16")
        d16 = tm(T(a), T(b))
    want = jax.jit(jm.apply)(params, jnp.asarray(a), jnp.asarray(b))
    assert d16.dtype == torch.float32 and torch.isfinite(d16).all()
    np.testing.assert_allclose(d16.numpy(), np.asarray(want), rtol=LPIPS_TOL)
    # JAX's own bound for its bf16 distance against its f32 one
    np.testing.assert_allclose(d16.numpy(), d32.numpy(), rtol=0.05,
                               atol=1e-4)
