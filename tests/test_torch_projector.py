"""The port's projector and GAN sampling tools against the JAX package's:
`noise_regularize`, `noise_normalize` and `get_lr`; one `Projector` step
from the same latent, noise maps and latent perturbation (a 16-px
generator, LPIPS-VGG), its losses within 1e-5 relative, its gradients (Adam's
first moment after one step is 0.1 g on both sides) within 1e-4 of the
largest, and the variables after the step; then `tools.generate` and
`tools.project` on the CPU, whose latents `core.dataset.load_latent` reads
back."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gan2shape_tpu import projector as JP
from gan2shape_tpu.models.lpips import LPIPS as JLPIPS
from gan2shape_tpu.models.stylegan2 import Generator as JGen

from gan2shape_torch import projector as TP
from gan2shape_torch.convert import jax2torch
from gan2shape_torch.models.lpips import LPIPS
from gan2shape_torch.models.stylegan2 import Generator

SIZE, STYLE, N_MLP = 16, 32, 2


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


def _noises(seed, batch, num_layers):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, 1, 2 ** ((i + 5) // 2),
                                 2 ** ((i + 5) // 2))).astype(np.float32)
            for i in range(num_layers)]


def test_noise_helpers_and_lr_match_jax():
    noises = _noises(0, 2, 7)
    noises[3] = noises[3] * 2 + 0.5  # off N(0, 1) so normalising moves it
    got = TP.noise_regularize([T(n) for n in noises])
    want = JP.noise_regularize([jnp.asarray(n) for n in noises])
    assert _rel_max(got, want) <= 1e-5
    tn = [T(n) for n in noises]
    TP.noise_normalize(tn)
    for g, w in zip(tn, JP.noise_normalize([jnp.asarray(n)
                                            for n in noises])):
        assert _rel_max(g, w) <= 1e-5
    for t in (0.0, 0.01, 0.05, 0.3, 0.74, 0.8, 0.99):
        assert TP.get_lr(t, 0.1) == JP.get_lr(t, 0.1)


@pytest.mark.parametrize("w_plus", [False, True])
def test_projector_step_matches_jax(w_plus):
    jg = JGen(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, channel_multiplier=1)
    gp = jax.jit(lambda k: jg.init(k, [jnp.zeros((1, STYLE))],
                                   jg.make_noise(k)))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    gp = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), gp)  # non-zero noise strengths
    target = rng.uniform(-1, 1, (2, 3, SIZE, SIZE)).astype(np.float32)
    jl = JLPIPS()
    lp = jax.jit(jl.init)(jax.random.PRNGKey(2), jnp.asarray(target),
                          jnp.asarray(target))
    jproj = JP.Projector(jg, gp, jl, lp, w_plus=w_plus, mse_weight=0.5)

    gen = Generator(SIZE, STYLE, N_MLP, channel_multiplier=1)
    gen.load_state_dict(jax2torch.generator_state_dict(
        gp, _noises(9, 1, gen.num_layers), N_MLP))
    lpips = LPIPS()
    lpips.load_state_dict(jax2torch.lpips_state_dict(lp))
    tproj = TP.Projector(gen, lpips, w_plus=w_plus, mse_weight=0.5)

    shape = (2, gen.n_latent, STYLE) if w_plus else (2, STYLE)
    latent = rng.standard_normal(shape).astype(np.float32) * 0.5
    noises = _noises(3, 2, gen.num_layers)
    key = jax.random.PRNGKey(4)
    perturb = np.asarray(jax.random.normal(key, shape))
    lr, strength = 0.05, 0.02
    jn = [jnp.asarray(n) for n in noises]
    opt = jproj._adam.init((jnp.asarray(latent), jn))
    opt, jlat, jnz, jp, jnl, jmse = jproj._step(
        opt, jnp.asarray(latent), jn, jnp.asarray(target), key,
        jnp.float32(lr), strength)
    tproj.set_variables(T(latent), [T(n) for n in noises])
    tp, tnl, tmse = tproj.step(T(target), lr, strength, T(perturb))
    for got, want in ((tp, jp), (tnl, jnl), (tmse, jmse)):
        assert float(want) > 0 and _rel_max(got, want) <= 1e-5
    # Adam's first moment after one step is (1 - b1) g, on both sides
    mu_lat, mu_noise = opt.mu
    tmu = [tproj.optim.state[p]["exp_avg"]
           for p in [tproj.latent] + tproj.noises]
    scale = max(float(np.abs(np.asarray(m)).max())
                for m in [mu_lat] + list(mu_noise))
    err = max(float((t - T(m)).abs().max())
              for t, m in zip(tmu, [mu_lat] + list(mu_noise)))
    assert err <= 1e-4 * scale, (err, scale)
    # a first Adam step moves each variable by lr * g / (|g| + eps): two
    # differ by up to 2 lr where a gradient sits at rounding level.
    # Measured: the latent 3.6e-7 (w) and 9.5e-6 (W+) apart, the
    # renormalised noise maps 2.2e-7 of their largest value
    assert float((tproj.latent.detach() - T(jlat)).abs().max()) <= 2 * lr
    for t, j in zip(tproj.noises, jnz):
        assert _rel_max(t, j) <= 1e-5


def test_generate_and_project_tools_on_cpu(tmp_path, monkeypatch):
    from PIL import Image

    from gan2shape_torch.core.dataset import load_latent
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer
    from gan2shape_torch.tools import generate, project

    ckpt = tmp_path / "gan.pt"
    StyleGAN2Trainer(SIZE, channel_multiplier=1, device="cpu",
                     seed=3).save_checkpoint(str(ckpt), iteration=0)
    out = tmp_path / "samples"
    args = generate.parse_args([
        "--ckpt", str(ckpt), "--size", str(SIZE), "--channel_multiplier",
        "1", "--sample", "2", "--pics", "2", "--truncation", "0.7",
        "--truncation_mean", "64", "--save_path", str(out), "--device",
        "cpu"])
    assert generate.run(args) == 4
    names = sorted(os.listdir(out))
    assert names == ["000000.png", "000001.png", "000002.png", "000003.png",
                     "latents"]
    lat = load_latent(str(out / "latents" / "000003.pt"))
    assert lat.shape == (512,) and np.isfinite(lat).all()
    assert Image.open(out / "000000.png").size == (SIZE, SIZE)

    monkeypatch.chdir(tmp_path)
    files = [str(out / "000000.png"), str(out / "000001.png")]
    args = project.parse_args([
        "--ckpt", str(ckpt), "--size", str(SIZE), "--channel_multiplier",
        "1", "--step", "3", "--vgg_ckpt", "none.pth", "--lpips_ckpt",
        "none.pth", "--device", "cpu", *files])
    result = project.run(args)
    assert [r["step"] for r in result["losses"]] == [0, 2]
    assert os.path.exists(tmp_path / "000000-project.png")
    saved = np.load(out / "latents" / "000000.png.npz")
    assert saved["000001_latent"].shape == (512,)
    assert len([k for k in saved if k.startswith("noise_")]) == 5
    for i, f in enumerate(files):
        got = load_latent(str(out / "latents" / (os.path.basename(f)
                                                 + ".npy")))
        np.testing.assert_array_equal(got, result["latent"][i].numpy())
