"""The port's measurement and study tools (gan2shape_torch/tools and
utils/tensor_utils.py) against the JAX package's root tools and utils, on
the CPU: depth-MAD and the tensor helpers on the same inputs, the
real-assets harness's asset list and blocked path, the raster benchmarks'
inputs and agreement, the pool-every study's verdicts on hand-made runs,
and every tool refusing to run without a GPU unless told to use the CPU.
The tools' training runs are in test_torch_tools_runs.py."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan2shape_tpu.rendering.renderer import Renderer as JRenderer
from gan2shape_tpu.rendering.renderer import \
    get_transform_matrices as j_transform
from gan2shape_tpu.utils import tensor_utils as J

from gan2shape_torch.rendering.renderer import Renderer
from gan2shape_torch.tools import (
    bench, bench_raster, chain_raster, check_pool_every, compare_depth,
    full_instance_run, run_real_assets,
)
from gan2shape_torch.utils import tensor_utils as T
from gan2shape_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
TRACKED = ("FULL_RUN.json", "POOL_EVERY_CHECK.json", "RUN_REAL.json")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_tool(name):
    """A root tools/<name>.py of the JAX package, loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tracked_bytes():
    return {name: (ROOT / name).read_bytes() for name in TRACKED}


# ---------------- depth-MAD ----------------

def _depth_case(kind, rng):
    a = rng.uniform(0.9, 1.1, (3, 16, 16))
    b = a + 0.01 * rng.standard_normal(a.shape)
    mask = None
    if kind == "2d":
        return a[0], b[0], None
    if kind == "nan":
        a[0, :4] = np.nan
        b[1, 3:9, 2] = np.nan
        b[2] = np.nan  # an image without a valid pixel
    if kind == "mask":
        mask = (rng.uniform(0, 1, a.shape) > 0.3).astype(np.float32)
        a[1, 0, 0] = np.nan
    return a.astype(np.float32), b.astype(np.float32), mask


@pytest.mark.parametrize("kind", ["2d", "3d", "nan", "mask"])
def test_depth_mad_matches_jax(kind):
    rng = np.random.default_rng(3)
    a, b, mask = _depth_case(kind, rng)
    got = compare_depth.depth_mad(a, b, mask)
    want = jax_tool("compare_depth").depth_mad(a, b, mask)
    assert set(got) == set(want)
    np.testing.assert_equal(got, want)  # NaN equal to NaN
    if kind == "nan":
        assert np.isnan(got["per_image_mad"][2])
    with pytest.raises(ValueError, match="differ in shape"):
        compare_depth.depth_mad(a, b[..., :-1])


def test_compare_depth_cli(tmp_path, capsys):
    rng = np.random.default_rng(4)
    a, b, mask = _depth_case("mask", rng)
    for name, x in (("a", a), ("b", b), ("m", mask)):
        np.save(tmp_path / f"{name}.npy", x)
    assert compare_depth.main([str(tmp_path / "a.npy"),
                               str(tmp_path / "b.npy"), "--mask",
                               str(tmp_path / "m.npy")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == json.loads(json.dumps(compare_depth.depth_mad(a, b, mask)))


# ---------------- tensor helpers ----------------

def test_tensor_utils_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    for lo, hi in ((0.0, 1.0), (-1.0, 2.5)):
        np.testing.assert_allclose(
            T.mm_normalize(torch.from_numpy(x), lo, hi).numpy(),
            np.asarray(J.mm_normalize(jnp.asarray(x), lo, hi)), rtol=0,
            atol=1e-7)
    # torch's and XLA's linspace round their steps differently: up to one
    # f32 epsilon (1.19e-7) apart at 7 points, equal at 5 and 33
    for h, w in ((5, 7), (33, 5)):
        for normalize in (True, False):
            got = T.get_grid(2, h, w, normalize=normalize)
            want = np.asarray(J.get_grid(2, h, w, normalize=normalize))
            assert got.shape == want.shape == (2, h, w, 2)
            assert got.dtype == torch.float32
            atol = np.finfo(np.float32).eps if normalize and w == 7 else 0
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=atol)
    masks = [rng.uniform(0, 1, (9, 11)) > 0.8, np.zeros((9, 11), bool)]
    masks[0][:, :2] = False
    for m in masks:
        got = [int(v) for v in T.get_mask_range(torch.from_numpy(m))]
        assert got == [int(v) for v in J.get_mask_range(jnp.asarray(m))]


def test_random_ranges():
    """Ranges and signs by their statistics: JAX's key streams cannot be
    matched, so the draws come from a torch generator."""
    n = 20000
    g = torch.Generator().manual_seed(0)
    u = T.rand_range(g, (n,), 0.2, 0.7)
    assert u.shape == (n,) and float(u.min()) >= 0.2 and float(u.max()) < 0.7
    assert abs(float(u.mean()) - 0.45) < 0.01
    s = T.rand_posneg_range(g, (n,), 0.2, 0.7)
    mag = s.abs()
    assert float(mag.min()) >= 0.2 and float(mag.max()) < 0.7
    assert abs(float((s > 0).float().mean()) - 0.5) < 0.02
    assert abs(float(mag.mean()) - 0.45) < 0.01
    again = T.rand_posneg_range(torch.Generator().manual_seed(1), (n,), 0.2,
                                0.7)
    assert torch.equal(again, T.rand_posneg_range(
        torch.Generator().manual_seed(1), (n,), 0.2, 0.7))
    assert not torch.equal(again, s)


# ---------------- the real-assets harness ----------------

CATEGORIES = ["face", "cat", "car", "church"]


@pytest.mark.parametrize("category", CATEGORIES)
def test_required_assets_match_jax(category):
    """The JAX tool's list, but for the StyleGAN2 file: the JAX tool names
    files that the cat, car and church configs do not (its GAN_CKPTS), the
    port the config's own; for face the two agree."""
    got = run_real_assets.required_assets(category)
    want = jax_tool("run_real_assets").required_assets(category)
    assert got[1:] == want[1:]
    assert got[0][1] == want[0][1]
    assert (got[0][0] == want[0][0]) == (category == "face")


@pytest.mark.parametrize("category", CATEGORIES)
def test_required_assets_name_the_configs_gan_checkpoint(category):
    """The StyleGAN2 file that the harness asks for is the one that
    configs/<category>.yml names, which the run then loads."""
    config = load_config(category=category, config_dir=str(ROOT / "configs"),
                         minimal_config=str(ROOT / "minimal_config.yml"))
    (gan, _), = [a for a in run_real_assets.required_assets(category)
                 if "stylegan2" in a[0]]
    assert gan == config["gan_ckpt_path"]
    assert gan == (ROOT / "configs" / f"{category}.yml").read_text().split(
        "gan_ckpt_path:")[1].split()[0]


def test_run_real_assets_blocked_path(tmp_path):
    """Without the files under --root the harness exits 2, lists every
    missing file and writes its summary under the root, never the JAX
    tool's RUN_REAL.json."""
    before = tracked_bytes()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "gan2shape_torch.tools.run_real_assets",
         "--category", "face", "--fast", "--root", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stdout + out.stderr
    wanted = [p for p, _ in run_real_assets.required_assets("face")]
    for p in wanted:
        assert p in out.stdout
    assert "download_data.py" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["build"]
    with open(tmp_path / "build" / "run_real_torch.json") as f:
        assert json.load(f) == {"ok": False, "skipped": True,
                                "category": "face", "missing": wanted}
    assert tracked_bytes() == before


# ---------------- the raster benchmarks ----------------

def test_bench_raster_inputs_match_jax():
    """The pseudo-sample scene: the Gaussian filter equal to scipy's, and
    the projected vertices of one depth and pose set equal to the JAX
    renderer's within 1e-5 px ..."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    np.testing.assert_array_equal(bench_raster.gaussian_filter(x, 6.0),
                                  gaussian_filter(x, 6.0))
    s, b = 64, 4
    depth, views = bench_raster.pseudo_sample_scene(rng, s, b)
    assert depth.shape == (b, s, s) and views.shape == (b, 6)
    assert 0.92 <= depth.min() and depth.max() <= 1.08
    got = bench_raster.screen_vertices(
        Renderer(bench_raster.CONFIG, s, 0.9, 1.1, device="cpu"), depth,
        views)
    jr = JRenderer(bench_raster.CONFIG, s, 0.9, 1.1)
    rot, trans = j_transform(jnp.asarray(views))
    pts = jr.get_warped_3d_grid(jnp.asarray(depth), rot, trans)
    want = jr._project_screen(pts.reshape(b, -1, 3))
    # and within two f32 ulps of the coordinate, where the renderer's
    # summation order puts the port an ulp from JAX (ROADMAP C: 1.14e-5 px
    # at two of these 16384 vertices)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(b, s, s),
                                   rtol=2.5e-7, atol=1e-5)


def test_bench_raster_on_cpu(capsys):
    assert bench_raster.main(["--device", "cpu", "--size", "32", "--batch",
                              "2", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert "raster_mega winner agreement vs dense_winner: 1.00000" in out
    for name in ("mega", "mega_v2", "bufwinner", "grid_e2e", "invwarp",
                 "scatter"):
        assert any(line.startswith(name + " ") for line in out.splitlines())


@pytest.mark.parametrize("impl", chain_raster.IMPLS)
def test_chain_raster_on_cpu(impl):
    r = chain_raster.per_call(impl, n=4, size=32, batch=2, device="cpu")
    assert (r["n_small"], r["n_big"]) == (2, 4)
    assert np.isfinite(r["ms_per_call"]) and r["device"] == "cpu"


def test_chain_cells_agree_across_impls():
    """The three chained functions return the same winner cells."""
    bench_ = bench_raster.Bench(32, 2, "cpu")
    ins = bench_.inputs()
    cells = [chain_raster.winner_cells(i, 32, bench_.near, bench_.far)(*ins)
             for i in chain_raster.IMPLS]
    assert (cells[0] >= 0).float().mean() > 0.5
    for c in cells[1:]:
        assert torch.equal(c, cells[0])


# ---------------- the pool-every study's verdicts ----------------

def _run(depth_shift=0.0, tails=(1.0, 1.0, 1.0), first=2.0, nan=False):
    """A hand-made run: curves falling from `first` to each step's tail."""
    depth = np.full((8, 8), 1.0) + depth_shift
    losses = {}
    for step, tail in zip(check_pool_every.STEPS, tails):
        curve = np.concatenate([np.linspace(first, tail, 30),
                                np.full(25, tail)])
        if nan and step == "step2":
            curve[10] = np.nan
        losses[step] = curve
    return {"wall_s": 1.0, "depth": depth, "losses": losses}


@pytest.mark.parametrize("fault", [None, "depth", "tail", "nan", "rising"])
def test_judge_criteria(fault):
    bound = check_pool_every.DEPTH_MAD_BOUND
    run = {None: _run(depth_shift=0.5 * bound),
           "depth": _run(depth_shift=1.5 * bound),
           "tail": _run(tails=(1.0, 1.0, 1.06)),
           "nan": _run(nan=True),
           "rising": _run(first=0.5)}[fault]
    results = check_pool_every.judge({1: _run(), 4: _run(tails=(
        1.0, 1.1, 1.0)), 2: run}, [1, 2, 4])
    assert results["ks"]["4"]["pass"]  # step 2's tail bound is 0.15
    entry = results["ks"]["2"]
    assert entry["pass"] is (fault is None)
    assert results["ok"] is (fault is None)
    assert results["recommended_default"] == 4
    mad = entry["depth_mad_vs_base"]
    assert abs(mad - {None: 0.5 * bound, "depth": 1.5 * bound}.get(
        fault, 0.0)) < 1e-12
    failed = {s for s in check_pool_every.STEPS if not entry[s]["pass"]}
    assert failed == {None: set(), "depth": set(), "tail": {"step3"},
                      "nan": {"step2"},
                      "rising": set(check_pool_every.STEPS)}[fault]
    only = check_pool_every.judge({1: _run(), 2: run}, [1, 2])
    assert only["recommended_default"] == (2 if fault is None else 1)


def test_spread_of_two_runs():
    """--floor's measures: judge's distances, without a verdict."""
    bound = check_pool_every.DEPTH_MAD_BOUND
    base, run = _run(), _run(depth_shift=2 * bound, tails=(1.0, 1.2, 0.9))
    got = check_pool_every.spread(run, base)
    assert abs(got["depth_mad_vs_base"] - 2 * bound) < 1e-12
    assert got["tail_rel_dev"] == {"step1": 0.0, "step2": 0.2, "step3": 0.1}
    entry = check_pool_every.judge({1: base, 2: run}, [1, 2])["ks"]["2"]
    assert got["depth_mad_vs_base"] == entry["depth_mad_vs_base"]
    assert got["depth_p95_vs_base"] == entry["depth_p95_vs_base"]
    assert got["tail_rel_dev"] == {s: entry[s]["tail_rel_dev"]
                                   for s in check_pool_every.STEPS}


def test_study_bounds_match_jax():
    jax_study = jax_tool("check_pool_every")
    assert check_pool_every.MAX_TAIL_DEV == jax_study.MAX_TAIL_DEV
    assert check_pool_every.DEPTH_MAD_BOUND == jax_study.DEPTH_MAD_BOUND


# ---------------- no GPU, no run ----------------

def test_tools_refuse_missing_cuda(monkeypatch, tmp_path):
    """Every tool asks for CUDA unless --device cpu is passed, and stops
    before any work without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    calls = [
        lambda: bench.main(),
        lambda: bench.bench_instances(2),
        lambda: full_instance_run.main([]),
        lambda: check_pool_every.main(["--fast"]),
        lambda: bench_raster.main([]),
        lambda: chain_raster.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for p, _ in run_real_assets.required_assets("face"):
        (tmp_path / p).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / p).touch()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_real_assets.main(["--root", str(tmp_path), "--fast"])
    assert sorted(os.listdir(tmp_path)) == ["checkpoints", "data"]
