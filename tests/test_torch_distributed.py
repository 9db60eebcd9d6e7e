"""The port's multi-process training on the CPU: two ranks of a gloo group
(tests/torch_dist_worker.py, started as subprocesses through the G2S_*
variables, torch at 2 threads each) against one process of the port and
against the JAX package's mesh runs on conftest's virtual CPU devices, at
64 px with a 32-px GAN and, for StyleGAN2, 16 px, style_dim 32, n_mlp 2.
JAX runs in this process only; the StyleGAN2 weights come from a JAX init
through `convert/jax2torch.py`, written to a file the workers read.

  (i)   `initialize_from_env` on the G2S_* and torchrun variables;
  (ii)  the runtime's helpers on 2 ranks (tests/dist_worker.py in torch)
        and the split batch's masked mean;
  (iii) InstanceParallelTrainer N=2 over 2 ranks against one process:
        iteration-0 losses (step 2's samples drawn by both) within 2e-6
        relative, a prior and a {2, 1, 1} stage within rtol/atol 3e-3
        (ROADMAP C's instance tolerances);
  (iv)  data_parallel GeneralizingTrainer over 2 ranks against one process
        (the ranks' nets bit-equal) and, over its batched prior and step 1,
        against JAX's GeneralizingTrainer on a 2-device mesh, within the
        generalizing tolerances (rtol/atol 3e-3);
  (v)   StyleGAN2's steps at batch 8 over 2 ranks, with one set of draws
        injected: losses within 1e-5 relative of one process and of JAX's
        train_step on a batch sharded over 2 devices, the averaged
        gradients (Adam's first moments, b1 = 0) within 1e-4 of the
        largest, parameters within 2 lr; the D scores with the whole
        batch's minibatch standard deviation, a check that fails on
        per-rank statistics;
  (vi)  `cli.train --distributed --n-instances 2` on 2 ranks: each
        instance's checkpoint written once, and read by `cli.evaluate`;
  (vii) `StepTimer` and `profile_trace` on the CPU.

Measured on these inits: instance iteration-0 losses within 2.1e-7, curves
1.6e-3 relative apart and nets 6.0e-4; generalizing curves 1.2e-3, nets
8.0e-4, JAX's step-1 curve 5.7e-4; StyleGAN2 metrics within 1.1e-7 of one
process and 4.4e-7 of JAX, the gradients applied within 4.9e-7 of one
process's largest (3.3e-3 with a row gather whose backward pass does not
sum over the ranks), parameters 5.5e-5 from one process and 3.2e-3 from
JAX in G (the G half's kink sensitivity, tests/test_torch_gan.py).
"""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import torch_dist_worker as W
from gan2shape_torch.cli import evaluate as t_evaluate
from gan2shape_torch.convert import jax2torch
from gan2shape_torch.core import checkpoint as t_ckpt
from gan2shape_torch.core import diagnostics
from gan2shape_torch.core.trainer import GeneralizingTrainer
from gan2shape_torch import distributed
from gan2shape_torch.distributed import Mesh, make_mesh
from gan2shape_torch.parallel import InstanceParallelTrainer

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds for the two workers
# b1 = 0 Adam's first step moves a parameter by up to lr (2e-3 * 16/17 for
# D, * 4/5 for G) whatever the gradient: a sanity bound only (the gradients
# are held by GRAD_TOL)
PARAM_TOL = 2 * 2e-3 * 16 / 17
# the averaged gradients against one process's, of the largest
GRAD_TOL = 1e-4
ENV = ("G2S_COORDINATOR", "G2S_NUM_PROCESSES", "G2S_PROCESS_ID",
       "G2S_MULTIHOST", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
       "LOCAL_RANK", "LOCAL_WORLD_SIZE", "G2S_DIST_BACKEND")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes, and the two
    workers two threads each, on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


def _max_abs(a, b):
    return max(float((x - b[k]).abs().max()) for k, x in a.items())


# ---------------- (i) the environment ----------------

@pytest.mark.parametrize("env, required, want", [
    ({"G2S_COORDINATOR": "localhost:1234", "G2S_NUM_PROCESSES": "2",
      "G2S_PROCESS_ID": "1"}, False, ("localhost:1234", "2", "1")),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4",
      "RANK": "3"}, True, ("10.0.0.1:29500", "4", "3")),
    ({"G2S_COORDINATOR": "localhost:1234"}, False, "partial"),
    ({"G2S_COORDINATOR": "localhost:1234", "G2S_NUM_PROCESSES": "2"},
     False, "partial"),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}, False, "partial"),
    ({"G2S_COORDINATOR": "localhost:1234", "G2S_NUM_PROCESSES": "1",
      "G2S_PROCESS_ID": "0"}, False, False),
    ({}, False, False),
    ({}, True, "without coordinates"),
    ({"G2S_MULTIHOST": "1"}, False, "without coordinates"),
], ids=["g2s", "torchrun", "partial-g2s-1", "partial-g2s-2",
        "partial-torchrun", "one-process", "none", "required-alone",
        "multihost-alone"])
def test_initialize_from_env(monkeypatch, env, required, want):
    """The JAX package's rules on the G2S_* and torchrun variables: a full
    set joins (here: the call `initialize` gets), a partial set raises
    JAX's error, G2S_NUM_PROCESSES=1 stays single-process, and
    --distributed (`required`) or G2S_MULTIHOST=1 without coordinates
    raises (torch has no pod autodetection)."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(distributed, "initialize",
                        lambda *a, **kw: calls.append(a) or True)
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=want):
            distributed.initialize_from_env(required=required)
        assert not calls
    elif want is False:
        assert distributed.initialize_from_env(required=required) is False
        assert not calls
    else:
        assert distributed.initialize_from_env(required=required) is True
        assert calls == [want]


@pytest.mark.parametrize("backend, env, device, want", [
    (None, None, "cpu", "gloo"),
    (None, "gloo", "cuda", "gloo"),
    ("gloo", None, "cpu", "gloo"),
    ("nccl", None, "cpu", ValueError),
    ("mpi", None, "cpu", ValueError),
])
def test_backend_follows_the_device(monkeypatch, backend, env, device,
                                    want):
    """NCCL on CUDA, gloo on the CPU; gloo on CUDA only by name."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    if env is None:
        monkeypatch.delenv("G2S_DIST_BACKEND", raising=False)
    else:
        monkeypatch.setenv("G2S_DIST_BACKEND", env)
    if want is ValueError:
        with pytest.raises(ValueError):
            distributed._backend(backend, torch.device(device))
    else:
        assert distributed._backend(backend, torch.device(device)) == want


def test_torchrun_world_of_one_forms_a_group(monkeypatch):
    """torchrun's variables form a group even of one rank (gloo on the
    CPU), whose collectives are identities; `shutdown` leaves it."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
                 "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    try:
        assert distributed.initialize_from_env(device="cpu") is True
        assert distributed.initialize_from_env(device="cpu") is True
        mesh = make_mesh()
        assert mesh == Mesh(1, 0, torch.device("cpu"))
        assert distributed.group_mesh(mesh)
        assert distributed.local_slice(4) == slice(0, 4)
        x = torch.arange(3.0)
        assert torch.equal(distributed.all_reduce_mean_([x])[0],
                           torch.arange(3.0))
        assert torch.equal(distributed.gather_rows(x), torch.arange(3.0))
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()
    assert make_mesh() == Mesh(1, 0, None)
    assert not distributed.group_mesh(make_mesh())
    with pytest.raises(ValueError, match="without a process group"):
        distributed.group_mesh(Mesh(2, 0))


def test_a_mesh_that_is_not_the_group_s_is_refused(monkeypatch):
    """The data-parallel trainers run their collectives in the process
    group: a mesh of other ranks raises inside a group and, of several
    ranks, without one; the group's own mesh runs them."""
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="without a process group"):
        GeneralizingTrainer(W.CFG, mesh=Mesh(2, 1), device="cpu")
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
                 "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    try:
        assert distributed.initialize_from_env(device="cpu") is True
        assert distributed.group_mesh(make_mesh())
        with pytest.raises(ValueError, match="not the process group's"):
            distributed.group_mesh(Mesh(2, 0))
        with pytest.raises(ValueError, match="not the process group's"):
            StyleGAN2Trainer(**W.GAN, device="cpu", mesh=Mesh(2, 1))
    finally:
        distributed.shutdown()


# ---------------- the two workers and the one-process runs ----------------

def _write_face_set(root, n, size, rng):
    folder = root / "data" / "face"
    (folder / "latents").mkdir(parents=True)
    names = [f"{i:06d}.png" for i in range(n)]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                     dtype=np.uint8)).save(folder / name)
        torch.save(torch.from_numpy(rng.standard_normal(
            (1, 512)).astype(np.float32)), folder / "latents" /
            (name[:-4] + ".pt"))
    (folder / "list.txt").write_text("".join(x + "\n" for x in names))


def _gan_draws(rng, n_latent, num_layers):
    """The whole batch's latents (z1, z2, take2), per-layer noise and
    (G, C) transforms of train_step, d_reg_step and g_reg_step, in the
    order the port draws them."""
    from gan2shape_torch.models import augment as TA

    def latent(b, mix):
        take2 = np.arange(n_latent) >= rng.integers(1, n_latent)
        return (rng.standard_normal((b, W.GAN["style_dim"])).astype(
            np.float32), rng.standard_normal(
                (b, W.GAN["style_dim"])).astype(np.float32), take2 & mix)

    def noise(b):
        return [rng.standard_normal(
            (b, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2))).astype(
                np.float32) for i in range(num_layers)]

    b, size = W.GAN_BATCH, W.GAN["size"]
    gens = [torch.Generator().manual_seed(10 + k) for k in range(4)]
    return {"latents": [latent(b, True), latent(b, False), latent(1, True)],
            "noise": [noise(b), noise(b), noise(1)],
            "aug": [[torch.linalg.inv(TA.sample_affine(
                         g, W.ADA_P, b, size, size)).numpy() for g in gens],
                    [TA.sample_color(g, W.ADA_P, b).numpy() for g in gens]],
            "path": rng.standard_normal((1, 3, size, size)).astype(
                np.float32)}


def _jax_gan(jt, state0, real, draws):
    """JAX's train_step with the batch sharded over 2 devices and the same
    draws; returns (metrics, port state dicts after)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gan2shape_tpu.models import augment as JA
    from gan2shape_tpu.parallel.mesh import make_mesh as j_make_mesh

    gen = jt.generator
    inj = copy.deepcopy(draws)
    aug = list(zip(inj["aug"][0], inj["aug"][1]))

    def mixed(g_params, key, batch):
        z1, z2, take2 = inj["latents"].pop(0)
        w1 = gen.apply(g_params, jnp.asarray(z1), method="style_forward")
        w2 = gen.apply(g_params, jnp.asarray(z2), method="style_forward")
        return jnp.where(jnp.asarray(take2)[None, :, None], w2[:, None],
                         w1[:, None])

    jt._mixed_latent = mixed
    jt._fresh_noise = lambda key, batch: [jnp.asarray(n)
                                          for n in inj["noise"].pop(0)]
    jt._maybe_augment = lambda key, img, p: JA.augment(
        key, img, p, transforms=tuple(map(jnp.asarray, aug.pop(0))))[0]
    mesh = j_make_mesh(2)
    data = NamedSharding(mesh, P(mesh.axis_names[0]))
    state = jax.device_put(jax.tree_util.tree_map(jnp.array, state0),
                           NamedSharding(mesh, P()))
    real = jax.device_put(jnp.asarray(real), data)
    assert len(real.sharding.device_set) == 2
    state, metrics = jt.train_step(state, real, jax.random.PRNGKey(1),
                                   jnp.float32(W.ADA_P))
    return ({k: float(v) for k, v in metrics.items()},
            jax2torch.gan_state_dicts(state))


def _jax_generalizing(port_trainer, data):
    """JAX's GeneralizingTrainer on a 2-device mesh from the port trainer's
    init, over the batched prior and a step-1 block (the phases it shards:
    steps 2 and 3 run per image, replicated)."""
    from test_torch_generalizing import _jax_init, python_scan

    from gan2shape_tpu.core import trainer as j_trainer
    from gan2shape_tpu.core.model import GAN2Shape as JGAN2Shape
    from gan2shape_tpu.parallel.mesh import make_mesh as j_make_mesh

    params, frozen = _jax_init(port_trainer.model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JGAN2Shape, "init_params", lambda self, key: params)
        jt = j_trainer.GeneralizingTrainer(
            dict(W.CFG, raster_mode="scatter"), mesh=j_make_mesh(2),
            frozen=frozen)
        mp.setattr(jax.lax, "scan", python_scan)
        return jt.fit(data, stages=[dict(W.STAGE, step2=0, step3=0)],
                      batch_size=W.N)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The job written for the workers, the workers started, the
    one-process and JAX runs made meanwhile, the workers' results read."""
    from gan2shape_tpu.models.stylegan2_train import \
        StyleGAN2Trainer as JTrainer

    work = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (W.N, 3, W.S, W.S)).astype(np.float32)
    latents = rng.standard_normal((W.N, 512)).astype(np.float32)
    priors = np.full((W.N, W.S, W.S), 1.0, np.float32)
    priors[:, 16:48, 20:44] = 0.95
    priors[1, 24:40] = 0.93
    _write_face_set(work / "cli", W.N, W.S, rng)

    jt = JTrainer(size=W.GAN["size"], style_dim=W.GAN["style_dim"],
                  n_mlp=W.GAN["n_mlp"], channel_multiplier=1,
                  use_augment=True)
    state0 = jax.jit(lambda k: jt.init(k, W.GAN_BATCH))(
        jax.random.PRNGKey(0))
    sds = jax2torch.gan_state_dicts(state0)
    job = {"cases": list(W.CASES), "images": images, "latents": latents,
           "priors": priors, "cli_root": str(work / "cli"),
           "gan": {"generator": sds["g"], "discriminator": sds["d"],
                   "g_ema": sds["g_ema"]},
           "real": rng.uniform(-1, 1, (W.GAN_BATCH, 3, W.GAN["size"],
                                       W.GAN["size"])).astype(np.float32),
           "draws": _gan_draws(rng, jt.generator.n_latent,
                               jt.generator.num_layers)}
    torch.save(job, work / "job.pt")

    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(port), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT))
        for r in range(2)]
    try:
        out = {}
        ip = InstanceParallelTrainer(W.CFG, W.N, seed=0, device="cpu")
        out["iteration0"] = W.iteration0(
            ip.model, *(torch.from_numpy(a) for a in
                        (images, latents, priors)))
        out["instances"] = ip.fit(images, latents, priors,
                                  stages=[W.STAGE])
        out["instance_nets"] = [ip.model.nets.instance(j).state_dict()
                                for j in range(W.N)]
        data = [(images[i], latents[i], i) for i in range(W.N)]
        gt = GeneralizingTrainer(W.CFG, seed=0, device="cpu")
        out["jax_generalizing"] = _jax_generalizing(gt, data)
        out["generalizing"] = gt.fit(data, stages=[W.STAGE],
                                     batch_size=W.N)
        out["generalizing_nets"] = gt.model.nets.state_dict()
        out["gan"] = W.run_gan_steps(W.gan_trainer(job), job, job["real"])
        out["jax_gan"] = _jax_gan(jt, state0, job["real"], job["draws"])
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log}"
    out["logs"] = logs
    out["ranks"] = [torch.load(work / f"rank{r}.pt", weights_only=False)
                    for r in range(2)]
    out["work"] = work
    return out


def test_two_process_smoke(runs):
    """(ii): the owned rows, a broadcast, row gathers, a mean, the
    all-reduce total of tests/dist_worker.py, and a masked mean split over
    the ranks (mask sums 1 + 2 rows apart) against the whole batch's,
    value and gradient."""
    for r, log in enumerate(runs["logs"]):
        assert f"DIST_OK rank={r} total=28.0" in log, log


def test_instances_over_ranks_match_one_process(runs):
    """(iii): rank r holds instance r of the one-process N=2 run: its
    iteration-0 losses within 2e-6, its curves and nets within 3e-3."""
    for r, rank in enumerate(runs["ranks"]):
        got = rank["instances"]
        assert (got["first"], got["n"]) == (r, 1)
        for step, (a, b) in enumerate(zip(got["iteration0"][:, 0],
                                          runs["iteration0"][:, r])):
            assert _rel(a, b) <= 2e-6, (r, step, float(a), float(b))
        (rec,) = got["history"]
        want = runs["instances"][r]
        assert rec["image"] == want["image"] == r
        for k in ("losses_step1", "losses_step2", "losses_step3"):
            assert len(rec[k]) == W.STAGE[k[7:]]
            np.testing.assert_allclose(rec[k], want[k], rtol=3e-3,
                                       atol=3e-3)
        for k, v in runs["instance_nets"][r].items():
            np.testing.assert_allclose(got["nets"][0][k].numpy(), v.numpy(),
                                       rtol=3e-3, atol=3e-3, err_msg=k)


def test_data_parallel_generalizing_matches_one_process(runs):
    """(iv): the batch of 2 split 1 + 1 for the prior and step 1, steps 2
    and 3 per image on both ranks with averaged gradients: the ranks' nets
    bit-equal to each other, histories and nets within 3e-3 of one
    process."""
    a, b = (rank["generalizing"] for rank in runs["ranks"])
    assert a["world"] == b["world"] == 2
    assert a["hash"] == b["hash"]
    for got in (a["history"], b["history"]):
        assert len(got) == len(runs["generalizing"]) == W.N
        for rec, want in zip(got, runs["generalizing"]):
            assert (rec["image_num"], rec["total_it"]) == (
                want["image_num"], want["total_it"])
            for k in ("losses_step1", "losses_step2", "losses_step3"):
                if k in want:
                    np.testing.assert_allclose(rec[k], want[k], rtol=3e-3,
                                               atol=3e-3)
    for k, v in runs["generalizing_nets"].items():
        np.testing.assert_allclose(a["nets"][k].numpy(), v.numpy(),
                                   rtol=3e-3, atol=3e-3, err_msg=k)


def test_data_parallel_generalizing_matches_jax_mesh(runs):
    """(iv): the step-1 curve after the batched prior, on 2 ranks, against
    JAX's GeneralizingTrainer with the batch sharded over 2 devices."""
    jh = runs["jax_generalizing"]
    want = jh[-1]["losses_step1"]
    assert len(want) == W.STAGE["step1"]
    for rank in runs["ranks"]:
        got = rank["generalizing"]["history"][-1]["losses_step1"]
        np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)


def _stddev_is_global(scores_by_rank, whole):
    """Whether the ranks' D scores are those of the whole batch on one
    device (its minibatch standard deviation over strided groups), within
    1e-6 of the largest score.  Measured: equal; per-rank statistics move
    the scores of this init by 3.4e-5 of the largest."""
    got = torch.cat(scores_by_rank)
    return float((got - whole).abs().max()) <= 1e-6 * float(
        whole.abs().max())


def test_gan_minibatch_stddev_is_the_whole_batch(runs):
    """(v): at batch 8 the groups are {0, 2, 4, 6} and {1, 3, 5, 7}; a
    rank's 4 rows alone would form {0, 1, 2, 3}.  The check passes on the
    ranks' scores and fails on the per-rank statistic planted beside."""
    ranks = [rank["gan"] for rank in runs["ranks"]]
    whole = runs["gan"]["scores"]
    assert _stddev_is_global([g["scores"] for g in ranks], whole)
    assert not _stddev_is_global([g["scores_per_rank"] for g in ranks],
                                 whole)


def test_gan_steps_over_ranks_match_one_process_and_jax(runs):
    """(v): train_step, d_reg_step and g_reg_step at batch 8 split 4 + 4
    with the same draws: every metric within 1e-5 relative of one process
    (train_step's also of JAX's, its batch sharded over 2 devices), the
    gradients each step applied (Adam's first moments: the all-reduce
    through the gathered features, R1's double backward across ranks)
    within 1e-4 of one process's largest, the parameters after each
    within 2 lr, and equal on the two ranks."""
    one = runs["gan"]
    jm, jsd = runs["jax_gan"]
    a, b = (rank["gan"] for rank in runs["ranks"])
    for got in (a, b):
        for k, want in one["grads"].items():
            scale = max(float(v.abs().max()) for v in want)
            err = max(float((x - y).abs().max())
                      for x, y in zip(got["grads"][k], want))
            assert scale > 0 and err <= GRAD_TOL * scale, (k, err, scale)
        for k in ("d_loss", "g_loss", "real_score", "fake_score",
                  "real_sign_sum"):
            assert _rel(got["train"][k], one["train"][k]) <= 1e-5, k
            assert _rel(got["train"][k], jm[k]) <= 1e-5, (k, jm[k])
        assert _rel(got["r1"], one["r1"]) <= 1e-5
        for k, v in one["path"].items():
            assert _rel(got["path"][k], v) <= 1e-5, k
        for net in ("g", "d"):
            assert _max_abs(got["after_train"][net],
                            one["after_train"][net]) <= PARAM_TOL, net
            assert _max_abs(got["after"][net], one["after"][net]) \
                <= 2 * PARAM_TOL, net
        assert _max_abs(got["after_train"]["g"], jsd["g"]) <= PARAM_TOL
        assert _max_abs(got["after_train"]["d"], jsd["d"]) <= PARAM_TOL
    for net in ("g", "d"):
        assert all(torch.equal(v, b["after"][net][k])
                   for k, v in a["after"][net].items()), net


def test_cli_splits_instances_over_ranks(runs):
    """(vi): `cli.train --distributed --n-instances 2`: rank r trains image
    r, each image's manifest and five .pth files are written once, and
    `cli.evaluate` reads them as the ranks' in-memory nets."""
    work = runs["work"] / "cli"
    for r, rank in enumerate(runs["ranks"]):
        got = rank["cli"]
        assert got["images"] == [r]
        assert all(len(c) == W.CLI_STAGE["step1"] and np.isfinite(c).all()
                   for c in got["losses"])
    files = os.listdir(work / "ck" / "face")
    for img in range(W.N):
        mine = [f for f in files if f"_image_{img}_" in f]
        assert sum(f.endswith(".json") for f in mine) == 1, mine
        assert sum(f.endswith(".pth") for f in mine) == 5, mine
    mgr = t_ckpt.CheckpointManager(str(work / "ck"))
    for img, nets in mgr.load_per_image("face"):
        want = runs["ranks"][int(img)]["cli"]["nets"][int(img)]
        assert all(torch.equal(v, want[f"{n}.{k}"])
                   for n in t_ckpt.NETS for k, v in nets[n].items())
    here = os.getcwd()
    os.chdir(work)
    try:
        records = t_evaluate.run(W.cli_config(work), t_evaluate.parse_args(
            ["--category", "face", "--record-loss", "--device", "cpu"]))
    finally:
        os.chdir(here)
    assert [r["image"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)


# ---------------- (vii) diagnostics ----------------

def test_step_timer_and_profile_trace(tmp_path):
    timer = diagnostics.StepTimer()
    with timer.time("matmul", n_iters=3):
        for _ in range(3):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (rec,) = timer.summary()
    assert rec["name"] == "matmul" and rec["iters"] == 3
    assert rec["seconds"] > 0 and rec["iters_per_sec"] > 0
    with diagnostics.profile_trace(str(tmp_path), enabled=False) as prof:
        assert prof is None
    assert not list(tmp_path.iterdir())
    with diagnostics.profile_trace(str(tmp_path / "p")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    trace = tmp_path / "p" / "trace_rank0.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
