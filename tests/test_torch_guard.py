"""Guards of the port's boundaries: gan2shape_torch and chip_smoke.py import
neither JAX, the JAX package nor the root `tools` scripts (which import JAX)
(an AST scan and a clean subprocess import);
the entry points refuse to fall back to the CPU; CPU tensors never reach a
kernel launch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gan2shape_tpu", "tools")


def _port_sources():
    return sorted((ROOT / "gan2shape_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    bad = set(_imported_roots(path)) & set(FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_port_import_loads_no_jax_module():
    code = (
        "import sys, runpy\n"
        "import gan2shape_torch, gan2shape_torch.core, "
        "gan2shape_torch.convert, gan2shape_torch.models, "
        "gan2shape_torch.ops, gan2shape_torch.rendering, "
        "gan2shape_torch.tools, gan2shape_torch.cli, gan2shape_torch.utils\n"
        "import gan2shape_torch.ops._cuda\n"
        "import gan2shape_torch.tools.check_raster\n"
        "import gan2shape_torch.cli.train, gan2shape_torch.cli.evaluate\n"
        "import gan2shape_torch.convert.reference\n"
        "import gan2shape_torch.core.checkpoint, "
        "gan2shape_torch.core.dataset, gan2shape_torch.core.diagnostics, "
        "gan2shape_torch.core.masking\n"
        "import gan2shape_torch.utils.config, gan2shape_torch.utils.plotting\n"
        "import gan2shape_torch.models.segmentation, "
        "gan2shape_torch.parallel, gan2shape_torch.parallel.sharding, "
        "gan2shape_torch.distributed\n"
        "import gan2shape_torch.native, gan2shape_torch.projector, "
        "gan2shape_torch.models.augment, "
        "gan2shape_torch.models.stylegan2_train\n"
        "import gan2shape_torch.tools.prepare_data, "
        "gan2shape_torch.tools.train_gan, gan2shape_torch.tools.generate, "
        "gan2shape_torch.tools.project\n"
        "import gan2shape_torch.tools.bench, "
        "gan2shape_torch.tools.full_instance_run, "
        "gan2shape_torch.tools.check_pool_every, "
        "gan2shape_torch.tools.bench_raster, "
        "gan2shape_torch.tools.chain_raster, "
        "gan2shape_torch.tools.run_real_assets, "
        "gan2shape_torch.tools.compare_depth, "
        "gan2shape_torch.utils.tensor_utils\n"
        "sys.argv = ['chip_smoke.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r)\n"
        "print('BAD', bad)\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_refuse_missing_cuda(monkeypatch):
    from gan2shape_torch.core.model import GAN2Shape, ViewLightSampler
    from gan2shape_torch.device import resolve_device
    from gan2shape_torch.rendering.renderer import Renderer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GAN2Shape({"image_size": 64, "gan_size": 32})
    # the public constructors default to the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer({}, 16, 0.9, 1.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViewLightSampler.default()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViewLightSampler(np.zeros(6), np.eye(6), np.zeros(4), np.eye(4))
    assert resolve_device("cpu").type == "cpu"
    assert Renderer({}, 16, 0.9, 1.1, device="cpu").K.device.type == "cpu"
    assert ViewLightSampler.default(device="cpu").view_mean.device.type == \
        "cpu"


@pytest.mark.parametrize("cli", ["train", "evaluate"])
def test_cli_entry_points_refuse_missing_cuda(monkeypatch, tmp_path, cli):
    """Without --device the entry points ask for CUDA and stop before any
    work when there is none; --device cpu is the only way onto the CPU."""
    import importlib

    module = importlib.import_module(f"gan2shape_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    args = module.parse_args(["--category", "face"])
    assert args.DEVICE is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run({"category": "face", "root_path": str(tmp_path)}, args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--category", "face"])
    assert not (tmp_path / "results").exists()


@pytest.mark.parametrize("tool,argv", [
    ("train_gan", ["data/none"]),
    ("generate", ["--ckpt", "none.pt"]),
    ("project", ["--ckpt", "none.pt", "none.png"]),
])
def test_gan_tools_refuse_missing_cuda(monkeypatch, tmp_path, tool, argv):
    """The GAN tools and the trainer ask for CUDA unless told otherwise, and
    stop before reading any file when there is none."""
    import importlib

    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer

    module = importlib.import_module(f"gan2shape_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    args = module.parse_args(argv)
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StyleGAN2Trainer(16, style_dim=32, n_mlp=1, channel_multiplier=1)
    assert not os.listdir(tmp_path)


@pytest.mark.cuda
def test_constructors_default_to_the_card():
    from gan2shape_torch.core.model import ViewLightSampler
    from gan2shape_torch.rendering.renderer import Renderer

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert Renderer({}, 16, 0.9, 1.1).K.device.type == "cuda"
    assert ViewLightSampler.default().view_mean.device.type == "cuda"


def test_cpu_tensors_take_plain_versions():
    from gan2shape_torch.ops import _cuda
    from gan2shape_torch.ops.gather_window import gather_window2x2_planes
    from gan2shape_torch.ops.rasterize import rasterize_depth_grid

    _cuda.reset_launches()
    rng = np.random.default_rng(0)
    s = 16
    ys, xs = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    vx = torch.tensor(xs[None] + rng.uniform(-0.2, 0.2, (2, s, s)),
                      dtype=torch.float32, requires_grad=True)
    vy = torch.tensor(ys[None] + 0.0, dtype=torch.float32).expand(2, s, s)
    vz = torch.full((2, s, s), 1.0)
    depth = rasterize_depth_grid(vx, vy, vz, window=3, near=0.8, far=1.2)
    depth.sum().backward()
    src = torch.randn(2, 4, s, s, requires_grad=True)
    iy = torch.zeros(2, s, s, dtype=torch.int32)
    gather_window2x2_planes(src, iy, iy).sum().backward()
    assert torch.isfinite(vx.grad).all() and torch.isfinite(src.grad).all()
    assert all(v == 0 for v in _cuda.LAUNCHES.values()), _cuda.LAUNCHES


def test_cuda_wrappers_reject_non_cuda_tensors():
    from gan2shape_torch.ops import _cuda

    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.check_cuda_tensor(torch.zeros(2, 2), "x", torch.float32, 2)
