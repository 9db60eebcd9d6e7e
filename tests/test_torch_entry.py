"""The port's entry-point surface against the JAX package's: the config
merge, the dataset, checkpoint selection, loading the reference assets, the
refusals (segmentation checkpoints, multi-instance and multi-host flags,
JAX msgpack checkpoints), and `cli.train` followed by `cli.evaluate` on the
CPU at 64 px with a 32-px GAN."""

import ast
import functools
import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gan2shape_tpu.convert import torch2jax
from gan2shape_tpu.core import checkpoint as j_ckpt
from gan2shape_tpu.core import dataset as j_dataset
from gan2shape_tpu.core.model import ViewLightSampler as JSampler
from gan2shape_tpu.models.lpips import LPIPS as JLPIPS
from gan2shape_tpu.models.stylegan2 import (
    Discriminator as JDisc, Generator as JGen,
)
from gan2shape_tpu.utils import config as j_config

from gan2shape_torch.cli import evaluate as t_evaluate
from gan2shape_torch.cli import train as t_train
from gan2shape_torch.convert import reference
from gan2shape_torch.core import checkpoint as t_ckpt
from gan2shape_torch.core import dataset as t_dataset
from gan2shape_torch.core.model import GAN2Shape
from gan2shape_torch.models.stylegan2 import Blur
from gan2shape_torch.utils import config as t_config

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"image_size": 64, "gan_size": 32, "z_dim": 512,
         "channel_multiplier": 1, "disc_ftr_num": 3, "n_proj_samples": 2,
         "n_epochs_prior": 2}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores, and torch's default of one thread per core then
    oversubscribes it (these CPU tests ran 10-30x slower in the suite than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------- config ----------------

@pytest.mark.parametrize("category", ["face", "car", "cat", "church", None])
def test_load_config_matches_jax(category):
    kw = dict(category=category,
              config_file=None if category else str(ROOT / "config.yml"),
              config_dir=str(ROOT / "configs"),
              minimal_config=str(ROOT / "minimal_config.yml"),
              overrides={"prior_name": "box", "image_size": None})
    got = t_config.load_config(**kw)
    assert got == j_config.load_config(**kw)
    assert got["prior_name"] == "box"
    assert got["image_size"] == 128
    if category is not None:
        assert got["category"] == category


def test_load_config_defaults_match_jax():
    assert t_config.DEFAULTS == j_config.DEFAULTS


# ---------------- dataset ----------------

@pytest.fixture
def dataset_dir(tmp_path):
    """Four images (RGB 80 px, RGBA 64 px, grey 50 x 70, RGB 64 px) with a
    latent each, one per form; the .npy latent has a .pt sibling that it
    must win over."""
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "latents")
    images = [("a.png", "RGB", (80, 80, 3)), ("b.png", "RGBA", (64, 64, 4)),
              ("c.png", "L", (70, 50)), ("d.png", "RGB", (64, 64, 3))]
    for name, mode, shape in images:
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                        mode).save(tmp_path / name)
    lat = [torch.from_numpy(rng.standard_normal((1, 512)).astype(np.float32))
           for _ in range(5)]
    torch.save(lat[0], tmp_path / "latents" / "a.pt")
    torch.save({"latent": lat[1]}, tmp_path / "latents" / "b.pt")
    torch.save({"c.png": {"latent": lat[2][0]}}, tmp_path / "latents" /
               "c.pt")
    np.save(tmp_path / "latents" / "d.npy", lat[3].numpy())
    torch.save(lat[4], tmp_path / "latents" / "d.pt")
    (tmp_path / "list.txt").write_text(
        "".join(f"{n},label\n" for n, _, _ in images))
    return tmp_path, [t.numpy().reshape(512) for t in lat[:4]]


@pytest.mark.parametrize("subset", [None, [3, 1]])
def test_dataset_matches_jax(dataset_dir, subset):
    root, latents = dataset_dir
    got = t_dataset.ImageLatentDataset(str(root), image_size=64,
                                       subset=subset)
    want = j_dataset.ImageLatentDataset(str(root), image_size=64,
                                        subset=subset)
    assert len(got) == len(want) == (4 if subset is None else 2)
    for i in range(len(got)):
        (gi, gl, gx), (wi, wl, wx) = got[i], want[i]
        assert gi.shape == (3, 64, 64) and gi.dtype == np.float32
        assert gi.min() >= -1 and gi.max() <= 1
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gx == wx == i
        form = (subset or range(4))[i]
        np.testing.assert_array_equal(gl, latents[form])


def test_dataset_without_list_names_download_data(tmp_path):
    with pytest.raises(FileNotFoundError, match="download_data.py"):
        t_dataset.ImageDataset(str(tmp_path))


# ---------------- checkpoint selection ----------------

def _write_manifests(base):
    """Manifests of images 0, 1, 2 and 10 and of general runs (image ""),
    stages 0-12, several saved in the same second or minute (ties go to
    (stage, total_it)), and older ones with no "time" field (stamp from the
    file name, minute granularity)."""
    d = base / "face"
    os.makedirs(d)
    rows = [("0", 0, 100, "2026_01_02_10_00_05"),
            ("0", 11, 900, "2026_01_02_10_00_05"),
            ("0", 2, 300, "2026_01_02_10_00_05"),
            ("1", 12, 50, "2026_01_02_09_59_59"),
            ("1", 3, 70, "2026_01_03_00_00_00"),
            ("10", 10, 5, "2026_01_02_10_00_05"),
            ("2", 1, 10, "2026_01_01_08_00_00"),
            ("", 0, 40, "2026_01_02_10_00_05"),
            ("", 20, 800, "2026_01_02_10_00_05"),
            ("", 100, 90, "2026_01_02_09_00_00")]
    for n, (img, stage, it, stamp) in enumerate(rows):
        m = {"total_it": it, "dataset": "face", "image": img,
             "stage": stage, "time": stamp,
             "nets": {net: f"{img}_{n}_{net}.pth" for net in t_ckpt.NETS}}
        (d / f"manifest_image_{img}_stage_{stage}_{it}_it_{stamp}.json"
         ).write_text(json.dumps(m))
    for n, (img, stage, it, stamp) in enumerate(
            [("0", 10, 990, "2026_01_02_10_00"),
             ("0", 9, 999, "2026_01_02_10_00"),
             ("", 10, 1, "2026_01_02_10_00")]):
        m = {"total_it": it, "dataset": "face", "image": img,
             "stage": stage,
             "nets": {net: f"old_{img}_{n}_{net}.pth" for net in t_ckpt.NETS}}
        (d / f"manifest_image_{img}_stage_{stage}_{it}_it_{stamp}.json"
         ).write_text(json.dumps(m))


SELECTORS = [{}, {"stage": "1*"}, {"stage": "10"}, {"iteration": "9*"},
             {"time": "2026_01_02_10_00*"}, {"stage": "1?", "iteration": "*"},
             {"time": "2026_01_03*"}]


@pytest.mark.parametrize("sel", SELECTORS, ids=str)
def test_checkpoint_selection_matches_jax(tmp_path, monkeypatch, sel):
    _write_manifests(tmp_path)
    jm = j_ckpt.CheckpointManager(str(tmp_path))
    tm = t_ckpt.CheckpointManager(str(tmp_path))
    # the selection alone: each manager's loader returns the manifest
    monkeypatch.setattr(jm, "load_manifest", lambda m, template: m)
    monkeypatch.setattr(tm, "load_manifest", lambda m: m)
    assert tm.manifests("face") == jm.manifests("face")
    for img in ("*", "0", "1?", ""):
        assert (tm.select("face", img_idx=img, **sel)
                == jm.select("face", img_idx=img, **sel))
    assert (list(tm.load_per_image("face", **sel))
            == list(jm.load_per_image("face", None, **sel)))
    try:
        want = jm.load_latest_general("face", None, **sel)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            tm.load_latest_general("face", **sel)
    else:
        assert tm.load_latest_general("face", **sel) == want


def test_checkpoint_latest_is_by_time_then_stage(tmp_path):
    _write_manifests(tmp_path)
    tm = t_ckpt.CheckpointManager(str(tmp_path))
    tm.load_manifest = lambda m: m
    # newest time; same-second ties go to the larger (stage, total_it)
    assert tm.load_latest_general("face")["image"] == "1"
    latest = tm.load_latest_general("face", time="2026_01_02_10_00_05")
    assert (latest["image"], latest["stage"]) == ("", 20)
    per = dict(tm.load_per_image("face"))
    assert list(per) == ["", "0", "1", "2", "10"]
    assert per["0"]["stage"] == 11


def test_msgpack_checkpoint_is_refused_before_loading(tmp_path,
                                                      monkeypatch):
    """A manifest of the JAX package's flax msgpack files is refused with
    an error that names the file, before any net is read."""
    d = tmp_path / "face"
    os.makedirs(d)
    nets = {net: str(d / f"{net}_image_0_stage_0_1_it_x.pth")
            for net in t_ckpt.NETS}
    nets["depth"] = nets["depth"][:-4] + ".msgpack"
    (d / "manifest_image_0_stage_0_1_it_2026_01_01_00_00_00.json").write_text(
        json.dumps({"total_it": 1, "dataset": "face", "image": "0",
                    "stage": 0, "time": "2026_01_01_00_00_00",
                    "nets": nets}))
    loads = []
    monkeypatch.setattr(torch, "load", lambda *a, **k: loads.append(a))
    tm = t_ckpt.CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match=r"depth_image_0.*\.msgpack"):
        tm.load_latest_general("face")
    with pytest.raises(ValueError, match="msgpack"):
        list(tm.load_per_image("face"))
    assert loads == []


def test_checkpoint_save_is_failure_tolerant(tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("")
    tm = t_ckpt.CheckpointManager(str(blocker))  # a file, not a folder
    model_nets = {net: torch.nn.Linear(2, 2) for net in t_ckpt.NETS}
    tm.save(model_nets, 0, 0, 1, "face")
    assert "saving failed" in caplog.text


# ---------------- reference assets ----------------

def _reference_layout(model, tmp_path, rng):
    """The port's random frozen weights, saved as the reference's files
    are: the GAN checkpoint {"g_ema", "d"} with the FIR kernels the
    reference keeps as state, torchvision's vgg16.pth, the lpips heads and
    the view / light MVN."""
    def with_fir(module):
        sd = dict(module.state_dict())
        for name, m in module.named_modules():
            if isinstance(m, Blur):
                sd[f"{name}.kernel"] = m.kernel.clone()
        return sd

    paths = {k: str(tmp_path / f) for k, f in (
        ("gan_ckpt_path", "gan.pt"), ("vgg_ckpt_path", "vgg16.pth"),
        ("lpips_ckpt_path", "vgg.pth"), ("view_mvn_path", "view_mvn.pth"),
        ("light_mvn_path", "light_mvn.pth"))}
    torch.save({"g_ema": with_fir(model.generator),
                "d": with_fir(model.discriminator)}, paths["gan_ckpt_path"])
    lp = model.lpips.state_dict()
    vgg = {k[4:]: v for k, v in lp.items() if k.startswith("vgg.")}
    vgg["classifier.0.weight"] = torch.zeros(4, 4)
    torch.save(vgg, paths["vgg_ckpt_path"])
    torch.save({k: v for k, v in lp.items() if k.startswith("lin")},
               paths["lpips_ckpt_path"])
    for key, n in (("view_mvn_path", 6), ("light_mvn_path", 4)):
        a = rng.standard_normal((n, n)).astype(np.float32)
        torch.save({"mean": torch.from_numpy(
                        rng.standard_normal(n).astype(np.float32)),
                    "cov": torch.from_numpy(a @ a.T / n + 0.1 * np.eye(
                        n, dtype=np.float32))}, paths[key])
    return paths


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("assets")
    rng = np.random.default_rng(0)
    src = GAN2Shape(SMALL, device="cpu")
    src.init_frozen(torch.Generator().manual_seed(3))
    with torch.no_grad():  # non-zero noise strengths and biases
        for p in src.generator.parameters():
            p.add_(0.1 * torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32)))
    paths = _reference_layout(src, tmp_path, rng)
    cfg = dict(SMALL, **paths)
    port = GAN2Shape(cfg, device="cpu")
    reference.build_frozen_assets(port, cfg)
    # build_frozen converts over the model's random init; an empty init
    # keeps exactly what it read from the files (and skips JAX's init)
    frozen = torch2jax.build_frozen(
        SimpleNamespace(init_frozen=lambda key: {}, truncation=1),
        gan_ckpt_path=paths["gan_ckpt_path"],
        vgg_path=paths["vgg_ckpt_path"], lpips_path=paths["lpips_ckpt_path"],
        key=jax.random.PRNGKey(7))
    view, light = (torch2jax.convert_mvn(paths[k])
                   for k in ("view_mvn_path", "light_mvn_path"))
    jmodel = SimpleNamespace(
        generator=JGen(size=32, style_dim=512, n_mlp=8,
                       channel_multiplier=1),
        discriminator=JDisc(size=32, channel_multiplier=1), lpips=JLPIPS(),
        view_light_sampler=JSampler(view["mean"], view["cov"],
                                    light["mean"], light["cov"]))
    return src, port, jmodel, frozen, rng


def _rel_err(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def test_assets_load_bit_exact(assets):
    src, port = assets[:2]
    for name in ("generator", "discriminator", "lpips"):
        a = getattr(src, name).state_dict()
        b = getattr(port, name).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


def test_assets_generator_and_discriminator_match_jax(assets):
    """Within 1e-5 relative, the bound of test_torch_nets.py."""
    _, port, jmodel, frozen, rng = assets
    w = rng.standard_normal((2, 512)).astype(np.float32)
    with torch.no_grad():
        img, _ = port.generator([torch.from_numpy(w)], input_is_w=True)
    jimg = jmodel.generator.apply(frozen["generator"], [jnp.asarray(w)],
                                  frozen["noise"], input_is_w=True)[0]
    assert _rel_err(img, jimg) <= 1e-5
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        _, feats = port.discriminator(torch.from_numpy(x), ftr_num=3)
    _, jfeats = jmodel.discriminator.apply(frozen["discriminator"],
                                           jnp.asarray(x), ftr_num=3)
    assert len(feats) == len(jfeats) == 3
    for f, jf in zip(feats, jfeats):
        assert _rel_err(f, jf) <= 1e-5


def test_assets_lpips_matches_jax(assets):
    _, port, jmodel, frozen, rng = assets
    a, b = (rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
            for _ in range(2))
    with torch.no_grad():
        d = port.lpips(torch.from_numpy(a), torch.from_numpy(b))
    jd = jmodel.lpips.apply(frozen["lpips"], jnp.asarray(a), jnp.asarray(b))
    assert _rel_err(d, np.asarray(jd).reshape(d.shape)) <= 1e-5


def test_assets_samplers_match_jax(assets):
    _, port, jmodel = assets[:3]
    ts, js = port.view_light_sampler, jmodel.view_light_sampler
    for t, j in ((ts.view_mean, js.view_mean), (ts.light_mean, js.light_mean),
                 (ts._view_chol, js._view_chol),
                 (ts._light_chol, js._light_chol)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-7)
    assert float(ts.view_mean.abs().max()) > 0.1  # not the neutral stats


def test_assets_missing_keep_seeded_random_init(tmp_path, caplog):
    """Without asset files both entry points build the same seeded random
    frozen nets (so a checkpoint evaluates as it trained), with warnings."""
    cfg = dict(SMALL, gan_ckpt_path=str(tmp_path / "none.pt"),
               view_mvn_path=str(tmp_path / "none.pth"))
    models = [GAN2Shape(cfg, device="cpu") for _ in range(2)]
    models[1].init_frozen(torch.Generator().manual_seed(99))
    for m in models:
        reference.build_frozen_assets(m, cfg)
    for name in ("generator", "discriminator", "lpips"):
        other = getattr(models[1], name).state_dict()
        for k, v in getattr(models[0], name).state_dict().items():
            assert torch.equal(v, other[k]), (name, k)
    assert "GAN checkpoint not found" in caplog.text
    assert "MVN stats not found" in caplog.text


def test_assets_recompute_mean_latent_after_loading(assets, tmp_path):
    """With truncation < 1, mean_latent comes from the loaded generator,
    not from the random one it replaced."""
    src, rng = assets[0], assets[4]
    paths = _reference_layout(src, tmp_path, rng)
    cfg = dict(SMALL, truncation=0.7, **paths)
    model = GAN2Shape(cfg, device="cpu")
    model.init_frozen(torch.Generator().manual_seed(11))
    before = model.mean_latent.clone()
    reference.build_frozen_assets(model, cfg)
    gen = torch.Generator().manual_seed(42)
    with torch.no_grad():
        want = src.generator.mean_latent(4096, gen)
    assert torch.equal(model.mean_latent, want)
    assert not torch.equal(before, want)


def test_assets_reject_unknown_entries(assets, tmp_path):
    src = assets[0]
    sd = dict(src.generator.state_dict())
    sd["style.1.extra"] = torch.zeros(1)
    torch.save({"g_ema": sd, "d": src.discriminator.state_dict()},
               tmp_path / "gan.pt")
    with pytest.raises(KeyError, match="style.1.extra"):
        reference.load_gan_checkpoint(GAN2Shape(SMALL, device="cpu"),
                                      str(tmp_path / "gan.pt"))


# ---------------- refusals ----------------

@pytest.mark.parametrize("argv, env, exc, match", [
    (["--distributed"], {}, NotImplementedError, "sequential"),
    ([], {"G2S_COORDINATOR": "localhost:1234"}, RuntimeError,
     "partial multi-host"),
    ([], {"G2S_MULTIHOST": "1"}, RuntimeError, "without coordinates")])
def test_train_refuses_multi_instance_and_multi_host(tmp_path, monkeypatch,
                                                     argv, env, exc, match):
    """Multi-process runs the port cannot honour are refused before any
    work: `--distributed` on the sequential branch (every rank would train
    every image), a partial G2S_* environment (JAX's error), and
    G2S_MULTIHOST=1 without coordinates (no pod autodetection in torch).
    The multi-process branches themselves: tests/test_torch_distributed.py."""
    monkeypatch.chdir(tmp_path)
    for k in ("G2S_COORDINATOR", "G2S_NUM_PROCESSES", "G2S_PROCESS_ID",
              "G2S_MULTIHOST", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
              "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = t_train.parse_args(["--category", "face", "--device", "cpu"]
                              + argv)
    with pytest.raises(exc, match=match):
        t_train.run(dict(SMALL, category="face"), args)
    assert not (tmp_path / "results").exists()  # refused before any work


def _add_arguments(script):
    """The option strings of every add_argument call in a script."""
    tree = ast.parse((ROOT / script).read_text())
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"
            for a in node.args if isinstance(a, ast.Constant)}


def _stage_literals(script):
    tree = ast.parse((ROOT / script).read_text())
    return [ast.literal_eval(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.List)
            and any(getattr(t, "id", "") == "stages" for t in node.targets)]


@pytest.mark.parametrize("script, port", [
    ("main.py", "gan2shape_torch/cli/train.py"),
    ("evaluate_results.py", "gan2shape_torch/cli/evaluate.py")])
def test_cli_keeps_the_jax_flags(script, port):
    want = _add_arguments(script)
    got = _add_arguments(port)
    assert want and want <= got
    assert got - want == {"--device"}


def test_train_keeps_the_jax_schedules():
    generalizing, instance = _stage_literals("main.py")
    assert t_train.GENERALIZING_STAGES == generalizing
    assert t_train.INSTANCE_STAGES == instance


# ---------------- the CLI on the CPU ----------------

def _write_face_set(root, n, size, rng):
    d = root / "data" / "face"
    os.makedirs(d / "latents")
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     dtype=np.uint8)).save(d / f"{i:03d}.png")
        torch.save(torch.from_numpy(rng.standard_normal(
            (1, 512)).astype(np.float32)), d / "latents" / f"{i:03d}.pt")
    (d / "list.txt").write_text("".join(f"{i:03d}.png\n" for i in range(n)))


@pytest.fixture
def face_set(tmp_path, monkeypatch):
    from gan2shape_torch.utils import plotting

    # 2 frames of the rotating GIF instead of 18: the same code, less time
    monkeypatch.setattr(plotting, "plot_3d_depth", functools.partial(
        plotting.plot_3d_depth, n_frames=2))
    _write_face_set(tmp_path, 2, 64, np.random.default_rng(0))
    config = t_config.load_config(
        category="face", config_dir=str(ROOT / "configs"),
        minimal_config=str(ROOT / "minimal_config.yml"),
        overrides=dict(SMALL, root_path=str(tmp_path / "data"),
                       our_nets_ckpts={"VLADE_nets": str(tmp_path / "ck")},
                       n_epochs_generalized=1, batch_size=2))
    monkeypatch.chdir(tmp_path)
    return tmp_path, config


def test_cli_train_then_evaluate_on_cpu(face_set, monkeypatch):
    """Instance training saves one manifest and five .pth files per image;
    the evaluation reloads them bit-equal, and each image's step-1 loss
    from its checkpoint equals the trainer's in-memory model's within 1e-6
    relative."""
    tmp_path, config = face_set
    snapshots = {}
    real_save = t_ckpt.CheckpointManager.save

    def save(self, nets, img_idx, *rest):
        snapshots[img_idx] = {n: {k: v.clone() for k, v in
                                  nets[n].state_dict().items()}
                              for n in t_ckpt.NETS}
        return real_save(self, nets, img_idx, *rest)

    monkeypatch.setattr(t_ckpt.CheckpointManager, "save", save)
    args = t_train.parse_args(["--category", "face", "--save-ckpts",
                               "--device", "cpu"])
    trainer, history = t_train.run(config, args,
                                   stages=[{"step1": 1, "step2": 1,
                                            "step3": 1}])
    assert [h["image"] for h in history] == [0, 1]
    for h in history:
        assert all(np.isfinite(h[k]).all() and len(h[k]) == 1 for k in
                   ("losses_step1", "losses_step2", "losses_step3"))
    files = sorted(os.listdir(tmp_path / "ck" / "face"))
    for img in (0, 1):
        mine = [f for f in files if f"_image_{img}_" in f]
        assert len([f for f in mine if f.endswith(".json")]) == 1
        assert len([f for f in mine if f.endswith(".pth")]) == 5

    mgr = t_ckpt.CheckpointManager(str(tmp_path / "ck"))
    for img, nets in mgr.load_per_image("face"):
        for n in t_ckpt.NETS:
            for k, v in snapshots[int(img)][n].items():
                assert torch.equal(nets[n][k], v), (img, n, k)

    eargs = t_evaluate.parse_args(["--category", "face", "--record-loss",
                                   "--device", "cpu", "--gallery"])
    records = t_evaluate.run(config, eargs)
    assert [r["image"] for r in records] == [0, 1]
    data = t_dataset.ImageDataset(str(tmp_path / "data" / "face"),
                                  image_size=64)
    for r in records:
        assert r["recon"].shape == (3, 64, 64)
        assert r["depth"].shape == (64, 64)
        assert np.isfinite(r["recon"]).all() and np.isfinite(r["depth"]).all()
        t_ckpt.load_nets(trainer.model, snapshots[r["image"]])
        with torch.no_grad():
            want, _ = trainer.model.forward_step1(
                torch.from_numpy(data[r["image"]])[None])
        assert abs(r["loss"] - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_array_equal(np.load("results/step1_losses.npy"),
                                  [r["loss"] for r in records])
    assert os.path.exists("results/htmls/depth_1.html")
    assert os.path.exists("results/index.html")


@pytest.mark.parametrize("n", [1, 2, 5])
def test_originals_v_reconstructions_plot_any_count(tmp_path, monkeypatch,
                                                    n):
    """cli.evaluate's closing plot, for one image too (`--images 0`): the
    JAX package's version indexes a (1, 2) row of axes as (2, 1) there."""
    from gan2shape_torch.utils import plotting

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(n)
    images = [rng.uniform(-1, 1, (3, 16, 16)).astype(np.float32)
              for _ in range(n)]
    plotting.plot_originals_v_reconstructions(images, images[::-1])
    assert os.path.getsize("results/plots/originals_v_reconstructions.png")


def test_cli_generalize_resume_and_general_evaluation_on_cpu(face_set):
    tmp_path, config = face_set
    args = t_train.parse_args(["--category", "face", "--save-ckpts",
                               "--generalize", "--device", "cpu"])
    trainer, history = t_train.run(config, args,
                                   stages=[{"step1": 1, "step2": 1,
                                            "step3": 1}])
    assert [h["image_num"] for h in history] == [0, 1]
    (m,) = t_ckpt.CheckpointManager(str(tmp_path / "ck")).manifests("face")
    assert (m["image"], m["stage"], m["total_it"]) == ("", 0, 5)

    resumed = t_train.build_trainer(config, t_train.parse_args(
        ["--category", "face", "--generalize", "--load-pretrained",
         "--device", "cpu"]))
    assert resumed.load_dict["stage"] == "*"
    for n in t_ckpt.NETS:
        for k, v in trainer.model.nets[n].state_dict().items():
            assert torch.equal(resumed.model.nets[n].state_dict()[k], v)

    eargs = t_evaluate.parse_args(["--category", "face", "--general",
                                   "--record-loss", "--device", "cpu"])
    records = t_evaluate.run(config, eargs)
    assert [r["image"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)
    # per-image evaluation finds no per-image checkpoint
    eargs = t_evaluate.parse_args(["--category", "face", "--device", "cpu"])
    assert t_evaluate.run(config, eargs) == []


def test_debug_report_names_the_nets_each_step_trains(caplog):
    """--debug logs each net's gradient norm per step; a net outside the
    step's parameter subset gets a ZERO-gradient warning (step 3 also
    reaches no offset encoder)."""
    import logging

    from gan2shape_torch.core.trainer import STEP_SUBSETS, Trainer

    rng = np.random.default_rng(0)
    trainer = Trainer(dict(SMALL, prior_name="box"), debug=True,
                      device="cpu")
    image = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 64, 64)).astype(
        np.float32))
    latent = torch.from_numpy(rng.standard_normal((1, 512)).astype(
        np.float32))
    with caplog.at_level(logging.INFO):
        trainer.debug_report(image, latent)
    for step, trained in STEP_SUBSETS.items():
        for net in t_ckpt.NETS:
            zero = f"step{step}: net {net!r} received ZERO gradient"
            assert (zero in caplog.text) == (net not in trained), zero
