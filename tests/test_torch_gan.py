"""The port's GAN side against the JAX package's, at 16 px (style_dim 32,
n_mlp 2, channel_multiplier 1), on one JAX init brought over through
`convert.jax2torch.gan_state_dicts`:

  * ADA: the matrix builders, `apply_affine` / `apply_color` / `augment`
    with a fixed (G, C), within 1e-5 of the largest value; the samplers'
    entry statistics against JAX's; `AdaptiveAugment` exactly;
  * StyleGAN2Trainer: with the same latents, noise, transforms and
    path-length image injected into both trainers, the iteration-0 D and G
    losses, R1 and the path penalty within 1e-5 relative, the gradients of
    each step (Adam's first moment after a b1 = 0 step is the gradient,
    exactly, on both sides) within 1e-4 of the largest (the G half of the
    main step within 2e-3: see STEP_TOL), and the parameters after each step
    within the b1 = 0 Adam bound (PARAM_TOL) with few of them apart; the
    EMA; save and load bit-equal;
  * the native mmap cache, `MultiResolutionDataset` and `prepare_data`
    against the JAX package's;
  * `python -m gan2shape_torch.tools.train_gan` for 3 iterations on the
    CPU, with a checkpoint that `convert.reference.load_gan_checkpoint`
    loads.

Randomness cannot be matched across the packages: the tests replace the
trainers' draws (`_mixed_latent`, `_fresh_noise`, `_maybe_augment`, and on
the port `_path_noise`) on the two instances."""

import copy
import json
import os
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu.models import augment as JA
from gan2shape_tpu.models.stylegan2_train import \
    StyleGAN2Trainer as JTrainer
from gan2shape_tpu.utils import precision as jprec

from gan2shape_torch.convert import jax2torch
from gan2shape_torch.models import augment as TA
from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer
from gan2shape_torch.utils import precision as prec

ROOT = Path(__file__).resolve().parents[1]
SIZE, STYLE, N_MLP, B = 16, 32, 2, 2
ADA_P = 0.6
# b1 = 0 Adam moves each parameter by lr * g / (|g| + eps) on its first
# step, at most lr (2e-3 * 16/17 for D, * 4/5 for G): a gradient at rounding
# level can take the other sign, so two first steps differ by up to 2 lr
PARAM_TOL = 2 * 2e-3 * 16 / 17
# per step: (largest gradient gap over the largest gradient, share of the
# parameters more than 1e-5 apart after the step).  Measured on this init:
# train (D half) 8.1e-7 / 3.2e-5, d_reg 2.6e-6 / 2.7e-5, g_reg 8.2e-7 /
# 2.2e-5, and the G half 8.2e-4 / 1.4e-3: there 11 of 11.9M gradient
# entries pass 1e-4, where a pre-activation within ~1e-5 of a leaky-ReLU
# kink takes the other slope in one package.  The G-half gradient is only
# that well defined in f32: the port's own f32 gradient lies 4.8e-3 of the
# largest from its f64 one, with 574 entries past 1e-4.
STEP_TOL = {"train": (1e-4, 1e-4), "d_reg": (1e-4, 1e-4),
            "g_reg": (1e-4, 1e-4), "train_g": (2e-3, 5e-3)}


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel_max(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------- augmentation ----------------

def _transforms(seed, b, size, p=0.8):
    g = torch.Generator().manual_seed(seed)
    G = torch.linalg.inv(TA.sample_affine(g, p, b, size, size))
    C = TA.sample_color(g, p, b)
    return G.numpy(), C.numpy()


def test_matrix_builders_match_jax(rng):
    v = [rng.uniform(-2, 2, 5).astype(np.float32) for _ in range(3)]
    i = (rng.uniform(0, 1, 5) > 0.5).astype(np.float32)
    axis = (0.6, 0.0, 0.8)
    pairs = [
        (TA.translate_mat(T(v[0]), T(v[1])), JA.translate_mat(v[0], v[1])),
        (TA.rotate_mat(T(v[0])), JA.rotate_mat(v[0])),
        (TA.scale_mat(T(v[0]), T(v[1])), JA.scale_mat(v[0], v[1])),
        (TA.translate3d_mat(*map(T, v)), JA.translate3d_mat(*v)),
        (TA.scale3d_mat(*map(T, v)), JA.scale3d_mat(*v)),
        (TA.rotate3d_mat(axis, T(v[0])), JA.rotate3d_mat(axis, v[0])),
        (TA.luma_flip_mat(axis, T(i)), JA.luma_flip_mat(axis, i)),
        (TA.saturation_mat(axis, T(v[2])), JA.saturation_mat(axis, v[2])),
    ]
    for got, want in pairs:
        assert _rel_max(got, want) <= 1e-6


@pytest.mark.parametrize("size", [16, 32])
def test_augment_with_fixed_transforms_matches_jax(rng, size):
    img = rng.uniform(-1, 1, (3, 3, size, size)).astype(np.float32)
    G, C = _transforms(size, 3, size)
    want_a, want_c, want = jax.jit(lambda x, g, c: (
        JA.apply_affine(x, g), JA.apply_color(x, c),
        JA.augment(jax.random.PRNGKey(0), x, 0.8, transforms=(g, c))[0]))(
            jnp.asarray(img), jnp.asarray(G), jnp.asarray(C))
    assert _rel_max(TA.apply_affine(T(img), T(G)), want_a) <= 1e-5
    assert _rel_max(TA.apply_color(T(img), T(C)), want_c) <= 1e-5
    got, (tg, tc) = TA.augment(None, T(img), 0.8, transforms=(T(G), T(C)))
    assert _rel_max(got, want) <= 1e-5
    assert torch.equal(tg, T(G)) and torch.equal(tc, T(C))
    # the augmentation is differentiable twice (R1 runs through it)
    x = T(img).requires_grad_(True)
    y, _ = TA.augment(None, x, 0.8, transforms=(T(G), T(C)))
    gx, = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
    assert gx.requires_grad and torch.isfinite(gx).all()


@jax.jit
def _jax_samplers(p):
    return (JA.sample_affine(jax.random.PRNGKey(4), p, 4096, 32, 32),
            JA.sample_color(jax.random.PRNGKey(5), p, 4096))


@pytest.mark.parametrize("kw", [{"up": 2, "pad": (2, 1)},
                                {"down": 2, "pad": (1, 1)},
                                {"pad": (2, 1)},
                                {"up": (1, 2), "pad": (0, 0, 6, 5)}])
def test_fir_filter_is_differentiable_twice(kw):
    """upfirdn2d's filter is a pair of autograd Functions, each the other's
    backward: first and second derivatives against finite differences (in
    f64), and no gradient of the constant kernel is ever computed."""
    from torch.profiler import ProfilerActivity, profile

    from gan2shape_torch.ops.upfirdn2d import setup_filter, upfirdn2d

    kernel = (torch.tensor(setup_filter([1, 3, 3, 1], 4),
                           dtype=torch.float64) if "up" not in kw
              or kw["up"] == 2 else torch.tensor(JA.SYM6[None],
                                                  dtype=torch.float64))
    x = torch.randn(2, 3, 7, 7, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)

    def f(a):
        return upfirdn2d(a, kernel, **kw)

    assert torch.autograd.gradcheck(f, (x,))
    assert torch.autograd.gradgradcheck(f, (x,))
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        g, = torch.autograd.grad((f(x) ** 2).sum(), x, create_graph=True)
        (g ** 2).sum().backward()
    outs = [e.input_shapes for e in prof.events()
            if e.name == "aten::convolution"]
    # every convolution filters planes with the (1, 1, kh, kw) kernel
    assert outs and all(shape[1] == [1, 1, *kernel.shape]
                        for shape in outs), outs


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_sampler_statistics_match_jax(p):
    n = 4096
    g = torch.Generator().manual_seed(3)
    tg = TA.sample_affine(g, p, n, 32, 32).numpy()
    tc = TA.sample_color(g, p, n).numpy()
    jg, jc = map(np.asarray, _jax_samplers(jnp.float32(p)))
    if p == 0.0:
        assert (tg == np.eye(3)).all() and (tc == np.eye(4)).all()
    for t, j in ((tg, jg), (tc, jc)):
        # each entry's mean within 5 standard errors of JAX's, and the
        # share of samples left untouched by a transform alike
        se = np.sqrt((t.var(0) + j.var(0)) / n) + 1e-6
        assert (np.abs(t.mean(0) - j.mean(0)) <= 5 * se).all()
        sd_t, sd_j = t.std(0), j.std(0)
        assert (np.abs(sd_t - sd_j) <= 0.1 * sd_j + 1e-6).all()
    # integer translations are whole pixels before the fractional one
    assert np.isfinite(tg).all() and np.isfinite(tc).all()


def test_adaptive_augment_matches_jax(rng):
    jada = JA.AdaptiveAugment(ada_aug_target=0.6, ada_aug_len=40,
                              update_every=2)
    tada = TA.AdaptiveAugment(ada_aug_target=0.6, ada_aug_len=40,
                              update_every=2)
    for s in rng.integers(1, 5, 40):
        assert tada.tune(float(s), 4) == jada.tune(float(s), 4)
    assert tada.ada_aug_p > 0 and tada.r_t_stat == jada.r_t_stat


# ---------------- the trainer ----------------

def _inputs(seed, n_latent, num_layers):
    """Latents (z1, z2, take2), per-layer noise, (G, C) transforms and the
    path-length image, for one call of each step."""
    rng = np.random.default_rng(seed)

    def latent(b, mix):
        take2 = np.arange(n_latent) >= rng.integers(1, n_latent)
        return (rng.standard_normal((b, STYLE)).astype(np.float32),
                rng.standard_normal((b, STYLE)).astype(np.float32),
                take2 & mix)

    def noise(b):
        return [rng.standard_normal(
            (b, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2))).astype(
                np.float32) for i in range(num_layers)]

    return {"train": {"latents": [latent(B, True), latent(B, False)],
                      "noise": [noise(B), noise(B)],
                      "aug": [_transforms(10 + k, B, SIZE, ADA_P)
                              for k in range(3)]},
            "d_reg": {"aug": [_transforms(20, B, SIZE, ADA_P)]},
            "g_reg": {"latents": [latent(1, True)], "noise": [noise(1)]}}


def _patch_jax(t, inj):
    gen = t.generator

    def mixed(g_params, key, batch):
        z1, z2, take2 = inj["latents"].pop(0)
        w1 = gen.apply(g_params, jnp.asarray(z1), method="style_forward")
        w2 = gen.apply(g_params, jnp.asarray(z2), method="style_forward")
        return jnp.where(jnp.asarray(take2)[None, :, None], w2[:, None],
                         w1[:, None])

    t._mixed_latent = mixed
    t._fresh_noise = lambda key, batch: [jnp.asarray(n)
                                         for n in inj["noise"].pop(0)]
    t._maybe_augment = lambda key, img, p: JA.augment(
        key, img, p, transforms=tuple(map(jnp.asarray,
                                          inj["aug"].pop(0))))[0]


def _patch_port(t, inj):
    def mixed(g, batch):
        z1, z2, take2 = inj["latents"].pop(0)
        w1, w2 = g.style_forward(T(z1)), g.style_forward(T(z2))
        return torch.where(torch.as_tensor(take2)[None, :, None],
                           w2[:, None], w1[:, None])

    t._mixed_latent = mixed
    t._fresh_noise = lambda batch: [T(n) for n in inj["noise"].pop(0)]
    t._maybe_augment = lambda img, p: TA.augment(
        None, img, p, transforms=tuple(map(T, inj["aug"].pop(0))))[0]
    t._path_noise = lambda shape: T(inj["path"])


def _port_trainer(state):
    t = StyleGAN2Trainer(SIZE, STYLE, N_MLP, channel_multiplier=1,
                         use_augment=True, device="cpu")
    sds = jax2torch.gan_state_dicts(state)
    t.generator.load_state_dict(sds["g"])
    t.discriminator.load_state_dict(sds["d"])
    t.g_ema.load_state_dict(sds["g_ema"])
    return t


def _copy(state):
    return jax.tree_util.tree_map(jnp.array, state)


@pytest.fixture(scope="module")
def runs():
    """Each step once from the same JAX init, on both packages, with the
    same injected inputs.  Returns {step: (jax state after, jax metrics,
    port trainer after, port metrics)} and the init."""
    jt = JTrainer(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                  channel_multiplier=1, use_augment=True)
    state0 = jax.jit(lambda k: jt.init(k, B))(jax.random.PRNGKey(0))
    real = np.random.default_rng(1).uniform(
        -1, 1, (B, 3, SIZE, SIZE)).astype(np.float32)
    gen = jt.generator
    inputs = _inputs(2, gen.n_latent, gen.num_layers)
    jinj, tinj = {}, {}
    _patch_jax(jt, jinj)
    out = {}

    jinj.update(copy.deepcopy(inputs["train"]))
    js, jm = jt.train_step(_copy(state0), jnp.asarray(real),
                           jax.random.PRNGKey(1), jnp.float32(ADA_P))
    tt = _port_trainer(state0)
    _patch_port(tt, tinj)
    tinj.update(copy.deepcopy(inputs["train"]))
    tm = tt.train_step(T(real), ADA_P)
    out["train"] = (js, jm, tt, tm)
    # the G half alone, against JAX's updated D: b1 = 0 Adam leaves the two
    # updated Ds up to 2 lr apart where a D gradient is at rounding level
    tg = _port_trainer(state0)
    tg.discriminator.load_state_dict(
        jax2torch.discriminator_state_dict(js.d_params))
    _patch_port(tg, tinj)
    tinj.update({k: v[-1:] for k, v in
                 copy.deepcopy(inputs["train"]).items()})
    tg.g_step(B, ADA_P)
    out["train_g"] = (js, jm, tg, None)

    jinj.update(copy.deepcopy(inputs["d_reg"]))
    js, jr1 = jt.d_reg_step(_copy(state0), jnp.asarray(real),
                            jax.random.PRNGKey(2), jnp.float32(ADA_P))
    tt = _port_trainer(state0)
    _patch_port(tt, tinj)
    tinj.update(copy.deepcopy(inputs["d_reg"]))
    tr1 = tt.d_reg_step(T(real), ADA_P)
    out["d_reg"] = (js, {"r1": jr1}, tt, {"r1": tr1})

    key = jax.random.PRNGKey(3)
    jinj.update(copy.deepcopy(inputs["g_reg"]))
    js, jpm = jt.g_reg_step(_copy(state0), key)
    tt = _port_trainer(state0)
    _patch_port(tt, tinj)
    tinj.update(copy.deepcopy(inputs["g_reg"]))
    tinj["path"] = np.asarray(jax.random.normal(
        jax.random.split(key, 3)[2], (1, 3, SIZE, SIZE)))
    tpm = tt.g_reg_step()
    out["g_reg"] = (js, jpm, tt, tpm)
    return out, state0, jt


def test_iteration0_losses_match_jax(runs):
    out, _, _ = runs
    _, jm, _, tm = out["train"]
    for k in ("d_loss", "g_loss", "real_score", "fake_score"):
        assert _rel_max(tm[k], jm[k]) <= 1e-5, k
    assert float(tm["real_sign_sum"]) == float(jm["real_sign_sum"])
    _, jr, _, tr = out["d_reg"]
    assert float(tr["r1"]) > 0 and _rel_max(tr["r1"], jr["r1"]) <= 1e-5
    _, jp, _, tp = out["g_reg"]
    for k in ("path_loss", "path_length", "mean_path_length"):
        assert float(tp[k]) > 0 and _rel_max(tp[k], jp[k]) <= 1e-5, k


# under the bf16 activation policy, port against JAX from the same init
# and injected inputs, relative (measured: d_loss 1.5e-4, the G half's
# g_loss 5.7e-3, the mean scores 5.0e-3 and 7.9e-3: the scores leave D's
# last layer in bf16, a rounding step of 3.9e-3, and the losses are means
# of two softplus of them)
BF16_TOL = {"d_loss": 2e-3, "g_loss": 2e-2, "real_score": 3e-2,
            "fake_score": 3e-2}


def test_iteration0_losses_under_bf16_match_jax(runs):
    """The main step under the bf16 activation policy on both sides, from
    the same init and injected inputs: the D half's loss and scores against
    JAX's bf16 step and within JAX's 5% loss bound of the port's own f32
    step; the G half's loss against JAX's (on JAX's updated D, as
    `runs` does at f32); the parameters and Adam's moments stay f32."""
    out, state0, _ = runs
    tm32 = out["train"][3]
    jt = JTrainer(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                  channel_multiplier=1, use_augment=True)
    gen = jt.generator
    inputs = _inputs(2, gen.n_latent, gen.num_layers)
    real = np.random.default_rng(1).uniform(
        -1, 1, (B, 3, SIZE, SIZE)).astype(np.float32)
    jinj, tinj = {}, {}
    # a new JAX trainer traces its jitted step under the policy set now
    _patch_jax(jt, jinj)
    with prec.policy(act="bfloat16"):
        jprec.set_act_dtype("bfloat16")
        try:
            jinj.update(copy.deepcopy(inputs["train"]))
            js, jm = jt.train_step(_copy(state0), jnp.asarray(real),
                                   jax.random.PRNGKey(1), jnp.float32(ADA_P))
        finally:
            jprec.set_act_dtype(None)
        tt = _port_trainer(state0)
        _patch_port(tt, tinj)
        tinj.update(copy.deepcopy(inputs["train"]))
        tm = tt.d_step(T(real), ADA_P)
        tg = _port_trainer(state0)
        tg.discriminator.load_state_dict(
            jax2torch.discriminator_state_dict(js.d_params))
        _patch_port(tg, tinj)
        tinj.update({k: v[-1:] for k, v in
                     copy.deepcopy(inputs["train"]).items()})
        tm["g_loss"] = tg.g_step(B, ADA_P)
    for k, tol in BF16_TOL.items():
        assert _rel_max(tm[k], jm[k]) <= tol, (k, float(tm[k]), float(jm[k]))
    for k in ("d_loss", "real_score", "fake_score"):
        assert _rel_max(tm[k], tm32[k]) < 0.05, k
    for t in (tt, tg):
        for net in (t.generator, t.discriminator):
            assert all(p.dtype == torch.float32 for p in net.parameters())
    for opt in (tt.d_optim, tg.g_optim):
        assert opt.state
        for st in opt.state.values():
            assert st["exp_avg"].dtype == torch.float32
            assert st["exp_avg_sq"].dtype == torch.float32


def _named(module, params_tree, which):
    """{port parameter name: JAX leaf} for a generator or discriminator
    tree (of params or of Adam's first moments)."""
    sd = (jax2torch.generator_state_dict(params_tree, [], N_MLP)
          if which == "g" else jax2torch.discriminator_state_dict(
              params_tree))
    return {k: sd[k] for k, _ in module.named_parameters()}


def _grads_and_params(js, tt, which):
    module = tt.generator if which == "g" else tt.discriminator
    optim = tt.g_optim if which == "g" else tt.d_optim
    jstate = js.g_opt if which == "g" else js.d_opt
    jgrads = _named(module, jstate[0].mu, which)
    jparams = _named(module, js.g_params if which == "g" else js.d_params,
                     which)
    tgrads = {k: optim.state[p]["exp_avg"] for k, p in
              module.named_parameters()}
    tparams = dict(module.named_parameters())
    return jgrads, tgrads, jparams, tparams


@pytest.mark.parametrize("step,which", [("train", "d"), ("train_g", "g"),
                                        ("d_reg", "d"), ("g_reg", "g")])
def test_step_gradients_and_parameters_match_jax(runs, step, which):
    out, _, _ = runs
    js, _, tt, _ = out[step]
    jg, tg, jp, tp = _grads_and_params(js, tt, which)
    scale = max(float(v.abs().max()) for v in jg.values())
    assert scale > 0
    err = max(float((tg[k] - jg[k]).abs().max()) for k in jg)
    grad_tol, share_tol = STEP_TOL[step]
    assert err <= grad_tol * scale, (err, scale)
    gaps = [(tp[k].detach() - jp[k]).abs() for k in jp]
    assert max(float(x.max()) for x in gaps) <= PARAM_TOL
    share = sum(int((x > 1e-5).sum()) for x in gaps) / sum(
        x.numel() for x in gaps)
    assert share <= share_tol, share
    # the untouched network of each step kept its parameters exactly
    other = tt.discriminator if which == "g" else tt.generator
    init = _port_trainer(runs[1])
    other0 = init.discriminator if which == "g" else init.generator
    if step in ("d_reg", "g_reg"):
        for a, b in zip(other.parameters(), other0.parameters()):
            assert torch.equal(a, b)


def test_ema_after_train_step(runs):
    out, state0, _ = runs
    js, _, tt, _ = out["train"]
    d = tt.ema_decay
    init = _port_trainer(state0)
    for e, e0, p in zip(tt.g_ema.parameters(), init.g_ema.parameters(),
                        tt.generator.parameters()):
        assert torch.equal(e, e0 * d + p.detach() * (1 - d))
    # the parameters' gap scaled by 1 - d, plus a rounding of e * d and
    # p * (1 - d) at the mapping weights' magnitude (1 / lr_mlp = 100)
    jema = _named(tt.g_ema, js.g_ema, "g")
    for k, e in tt.g_ema.named_parameters():
        bound = PARAM_TOL * (1 - d) + 4 * 2 ** -23 * jema[k].abs()
        assert ((e - jema[k]).abs() <= bound).all(), k


def test_save_load_bit_equal(runs, tmp_path):
    out, state0, _ = runs
    _, _, tt, _ = out["g_reg"]
    path = tmp_path / "ckpt" / "000004.pt"
    tt.save_checkpoint(str(path), iteration=4, ada_p=0.125)
    fresh = _port_trainer(state0)
    it, p = fresh.load_checkpoint(str(path))
    assert (it, p) == (4, 0.125)
    saved, loaded = tt.state_dict(), fresh.state_dict()
    for k in ("g", "d", "g_ema"):
        assert saved[k].keys() == loaded[k].keys()
        for name in saved[k]:
            assert torch.equal(saved[k][name], loaded[k][name]), name
    for k in ("g_optim", "d_optim"):
        for idx, st in saved[k]["state"].items():
            for name, v in st.items():
                assert torch.equal(v, loaded[k]["state"][idx][name])
    assert torch.equal(saved["mean_path_length"], loaded["mean_path_length"])
    assert saved["rng"]["device"] == loaded["rng"]["device"] == "cpu"
    assert torch.equal(saved["rng"]["state"], loaded["rng"]["state"])
    ckpt = torch.load(path, weights_only=False)
    assert {"g", "d", "g_ema", "g_optim", "d_optim", "ada_aug_p",
            "iteration", "mean_path_length", "rng"} <= set(ckpt)


def test_sample_ema_zero_noise_matches_jax(runs):
    _, state0, jt = runs
    z = np.random.default_rng(4).standard_normal((2, STYLE)).astype(
        np.float32)
    want = jax.jit(jt.sample_ema)(state0, jnp.asarray(z))
    got = _port_trainer(state0).sample_ema(T(z))
    assert _rel_max(got, want) <= 1e-5


# ---------------- data ----------------

def test_native_cache_round_trip(tmp_path, rng):
    from gan2shape_torch import native

    n, shape = 7, (3, 16, 16)
    data = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
    path = tmp_path / "cache.bin"
    path.write_bytes(data.tobytes())
    cache = native.TensorCache(str(path), n, shape, "uint8")
    idx = [3, 0, 6, 3]
    got = cache.get_batch(idx)
    np.testing.assert_array_equal(
        got, native.read_records_plain(str(path), n, shape, idx))
    np.testing.assert_allclose(
        got, data[idx].astype(np.float32) * (2 / 255) - 1, atol=1e-6)
    cache.prefetch([0, 1])
    with pytest.raises(IndexError):
        cache.get_batch([n])
    cache.close()
    f32 = rng.standard_normal((4, 2, 8, 8)).astype(np.float32)
    (tmp_path / "f.bin").write_bytes(f32.tobytes())
    c32 = native.TensorCache(str(tmp_path / "f.bin"), 4, (2, 8, 8),
                             "float32")
    np.testing.assert_array_equal(c32.get_batch([1, 2]), f32[[1, 2]])
    # a missing or short file raises: there is no fallback reader
    with pytest.raises(OSError):
        native.TensorCache(str(tmp_path / "none.bin"), 1, shape)
    with pytest.raises(OSError):
        native.TensorCache(str(path), n + 1, shape)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from gan2shape_torch import native

    bad = tmp_path / "cache.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    assert not list((tmp_path / "build").iterdir())


def _write_pngs(folder, n, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(folder / "sub")
    for i in range(n):
        w, h = (40, 30) if i % 2 else (24, 36)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            folder / ("sub" if i % 3 == 0 else "") / f"{i:03d}.png")


def test_prepare_data_and_dataset_match_jax(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    from tools import prepare_data as j_prep
    from gan2shape_tpu.core.dataset import \
        MultiResolutionDataset as JDataset

    from gan2shape_torch.core.dataset import MultiResolutionDataset
    from gan2shape_torch.tools import prepare_data

    _write_pngs(tmp_path / "img", 6, 0)
    # the CLI with its worker pool, called in this process after torch has
    # run on its intra-op threads: the pool must spawn, not fork
    torch.ones(256, 256) @ torch.ones(256, 256)
    methods = []
    get_context = prepare_data.multiprocessing.get_context
    monkeypatch.setattr(prepare_data.multiprocessing, "get_context",
                        lambda method=None: methods.append(method)
                        or get_context(method))
    prepare_data.main(["--out", str(tmp_path / "port"), "--size", "8,16",
                       "--n_worker", "2", str(tmp_path / "img")])
    assert methods == ["spawn"]
    files = j_prep.find_images(str(tmp_path / "img"))
    assert files == prepare_data.find_images(str(tmp_path / "img"))
    from PIL import Image
    j_prep.prepare(str(tmp_path / "jax"), files, 1, [8, 16], Image.LANCZOS)
    for name in ("8.bin", "16.bin", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == {
        "length": 6, "sizes": [8, 16], "layout": "chw_uint8"}

    ds = MultiResolutionDataset(str(tmp_path / "port"), resolution=16)
    jds = JDataset(str(tmp_path / "jax"), resolution=16)
    idx = np.array([5, 0, 3, 3])
    flip = np.array([True, False, True, False])
    got = ds.get_batch(idx, flip)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jds.get_batch(idx, flip))
    assert torch.equal(got[1], ds[0]) and len(ds) == 6
    assert torch.equal(got[0], ds[5].flip(-1))
    with pytest.raises(ValueError):
        MultiResolutionDataset(str(tmp_path / "port"), resolution=32)


def test_train_gan_cli_on_cpu(tmp_path):
    from gan2shape_torch.convert.reference import load_gan_checkpoint
    from gan2shape_torch.core.model import GAN2Shape
    from gan2shape_torch.tools import prepare_data, train_gan

    _write_pngs(tmp_path / "img", 4, 1)
    prepare_data.main(["--out", str(tmp_path / "data"), "--size", "16",
                       "--n_worker", "1", str(tmp_path / "img")])
    flags = [str(tmp_path / "data"), "--size", "16", "--batch", "2",
             "--iter", "4", "--channel_multiplier", "1", "--augment",
             "--d_reg_every", "2", "--g_reg_every", "2", "--n_sample", "4",
             "--sample_every", "2", "--device", "cpu"]
    trainer, log = train_gan.run(train_gan.parse_args(
        flags + ["--ckpt_every", "2", "--out_dir", str(tmp_path / "run")]))
    assert [r["iter"] for r in log] == [0, 1, 2, 3]
    assert all(np.isfinite([r["d"], r["g"], r["r1"], r["path"]]).all()
               for r in log)
    assert log[0]["r1"] > 0 and log[2]["path"] > 0 and log[1]["r1"] == 0
    assert sorted(os.listdir(tmp_path / "run" / "checkpoint")) == [
        "000000.pt", "000002.pt"]
    assert sorted(os.listdir(tmp_path / "run" / "sample")) == [
        "000000.png", "000002.png"]
    # the trained g_ema loads straight into the GAN2Shape model
    model = GAN2Shape({"image_size": 64, "gan_size": 16, "z_dim": 512,
                       "channel_multiplier": 1}, device="cpu")
    ckpt = tmp_path / "run" / "checkpoint" / "000002.pt"
    load_gan_checkpoint(model, str(ckpt))
    saved = torch.load(ckpt, weights_only=False)["g_ema"]
    for name, v in model.generator.state_dict().items():
        assert torch.equal(v, saved[name]), name
    # resume runs the iterations after the saved one, with the draws that
    # the uninterrupted run made there
    resumed, log2 = train_gan.run(train_gan.parse_args(
        flags + ["--ckpt", str(ckpt), "--out_dir", str(tmp_path / "run2")]))
    assert log2 == log[3:]
    for a, b in zip(resumed.g_ema.parameters(), trainer.g_ema.parameters()):
        assert torch.equal(a, b)
