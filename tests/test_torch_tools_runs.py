"""The port's bench (gan2shape_torch/tools/bench.py) on the CPU at 64 px
with a 32-px GAN, against the JAX package's root bench.py: the bench
block's step-1 iteration-0 loss against JAX `Trainer._run_step1` from one
init (2e-6 relative, as in test_torch_method.py: XLA's and oneDNN's
convolutions sum in different orders), and its JSON lines' keys, metric
names and constant against bench.py's.  The other training tools are in
test_torch_tools_study.py.

The init is the port's, brought into the JAX trainer by the JAX package's
own converters (convert/torch2jax.py), as test_torch_generalizing.py does:
the JAX package's own init of these nets compiles for about 30 s on the
CPU."""

import ast
import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan2shape_tpu.convert import torch2jax
from gan2shape_tpu.core import trainer as j_trainer
from gan2shape_tpu.core.model import GAN2Shape as JGAN2Shape

from gan2shape_torch.core.checkpoint import NETS
from gan2shape_torch.tools import bench

ROOT = Path(__file__).resolve().parents[1]
S = 64
# the face config cut to test size
SMALL = {"image_size": S, "gan_size": 32, "disc_ftr_num": 3,
         "n_proj_samples": 2}
# 'scatter' on both sides of the JAX comparison: the JAX grid mode's compile
# inside the step gradients takes minutes on the CPU
SCATTER = {**SMALL, "raster_mode": "scatter"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def dict_keys_with(path, key):
    """The key sets of the dict literals in a file that hold `key`."""
    tree = ast.parse(Path(path).read_text())
    return [{k.value for k in node.keys if isinstance(k, ast.Constant)}
            for node in ast.walk(tree) if isinstance(node, ast.Dict)
            and any(isinstance(k, ast.Constant) and k.value == key
                    for k in node.keys)]


def python_scan(f, init, xs=None, length=None, **_):
    """jax.lax.scan's semantics as a Python loop (XLA:CPU runs convolutions
    inside a while loop ~100x slower)."""
    n = length if xs is None else len(jax.tree.leaves(xs)[0])
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None
                     else jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def jax_init(model):
    """A port GAN2Shape's weights as the JAX package's init_params and
    init_frozen pytrees (test_torch_generalizing.py's bridge)."""
    params = {}
    for name in NETS:
        sd = model.nets[name].state_dict()
        if name in ("viewpoint", "lighting"):
            names = [f"conv{i}" for i in range(len(sd) - 2)] + ["conv5",
                                                                 "conv6"]
            params[name] = {"params": {"encoder": {
                n: {"weight": sd[f"network.{2 * i}.weight"].numpy()}
                for i, n in enumerate(names)}}}
        elif name == "offset_encoder":
            params[name] = torch2jax.convert_offset_encoder(sd, S)
        else:
            params[name] = torch2jax.convert_encoder_decoder_net(sd)
    gen, noise = torch2jax.convert_generator(model.generator.state_dict())
    lp = model.lpips.state_dict()
    frozen = {"generator": gen, "noise": [np.asarray(n) for n in noise],
              "discriminator": torch2jax.convert_discriminator(
                  model.discriminator.state_dict()),
              "lpips": torch2jax.convert_lpips(
                  {k[4:]: v for k, v in lp.items() if k.startswith("vgg.")},
                  lp)}
    # copies: on the CPU a JAX array may share the state_dict's memory,
    # which the port's optimizer steps then change in place
    return (jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, frozen))


# ---------------- bench ----------------

@pytest.fixture(scope="module")
def bench_run():
    """`bench.main` with one warm-up and one timed block of 1/1/1, and the
    JAX trainer's step 1 of one iteration on the same init and image:
    (stdout lines, result, the warm-up block's losses, JAX's losses)."""
    blocks = []
    real_build, real_block = bench.build, bench.run_block

    def build(*args, **kw):
        trainer, image, latent = real_build(*args, **kw)
        blocks.append((jax_init(trainer.model), image.numpy().copy()))
        return trainer, image, latent

    def run_block(*args):
        blocks.append(real_block(*args))
        return blocks[-1]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(bench, "build", build)
        mp.setattr(bench, "run_block", run_block)
        result = bench.main(config=SCATTER, n_blocks=1, n_iters=1,
                            device="cpu")
    ((params, frozen), image), warm_up = blocks[0], blocks[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JGAN2Shape, "init_params", lambda self, key: params)
        jt = j_trainer.Trainer({**bench.FACE128, **SCATTER}, frozen=frozen)
        mp.setattr(jax.lax, "scan", python_scan)
        *_, j_losses = jt._run_step1(jt.params, jt.opt_states[1], jt.frozen,
                                     jnp.asarray(image), n_iters=1)
    return out.getvalue().splitlines(), result, warm_up, np.asarray(j_losses)


def test_bench_block_step1_matches_jax(bench_run):
    _, _, (l1, l2, l3), j_losses = bench_run
    assert [len(l) for l in (l1, l2, l3)] == [1, 1, 1]
    assert all(np.isfinite(float(v)) for v in l1 + l2 + l3)
    got, want = float(l1[0]), float(j_losses[0])
    assert abs(got - want) / abs(want) <= 2e-6, (got, want)


def test_bench_json_line_matches_jax(bench_run):
    lines, result, _, _ = bench_run
    assert len(lines) == 1 and json.loads(lines[0]) == result
    src = (ROOT / "bench.py").read_text()
    jax_keys = dict_keys_with(ROOT / "bench.py", "metric")
    assert len(jax_keys) == 2 and all(k == set(result) for k in jax_keys)
    assert result["metric"] == bench.STEPS_METRIC
    assert f'"{bench.STEPS_METRIC}"' in src
    assert f'f"{bench.INSTANCES_METRIC}"' in src
    assert "NORTH_STAR_STEPS_PER_SEC = (1000 + 4900) / 300.0" in src
    assert bench.NORTH_STAR_STEPS_PER_SEC == (1000 + 4900) / 300.0
    assert result["value"] > 0 and result["vs_baseline"] == round(
        result["value"] / bench.NORTH_STAR_STEPS_PER_SEC, 3)


def test_bench_instances_json_line(capsys):
    result = bench.bench_instances(1, config={**SMALL, "n_epochs_prior": 1},
                                   n_iters=1, n_blocks=1, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["metric"] == \
        "gan2shape_face128_instance_batched_steps_per_sec_x1"
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["value"] > 0
