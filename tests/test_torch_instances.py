"""Instance-parallel training on one device
(gan2shape_torch.parallel.InstanceParallelTrainer) at 64 px with a 32-px
GAN and N=2: against a sequential port Trainer run from each instance's
init (with one injected step-2 pool), against the JAX package's
per-instance step functions on the same weights (converted by its own
torch2jax), and through its Adam state, checkpoints, history and CLI.

The batched nets run each layer of both instances as one grouped
convolution, which sums in another order than the sequential nets' own
convolutions.  Measured on this init: iteration-0 losses within 2.1e-7
relative of the sequential port's and 4.6e-7 of the JAX package's (held to
2e-6, as tests/test_torch_method.py holds the sequential port to JAX).
Over a few iterations Adam's sign-like first steps amplify such gaps, as
between the two packages (tests/test_torch_trainer.py): the loss curves
measured 6.8e-4 relative apart and the final nets 6.0e-4 absolute, held to
the miniature fit's rtol 3e-3 + atol 3e-3."""

import ast
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gan2shape_tpu.convert import torch2jax
from gan2shape_tpu.core.model import GAN2Shape as JModel

from gan2shape_torch.cli import evaluate as t_evaluate
from gan2shape_torch.cli import train as t_train
from gan2shape_torch.core import checkpoint as t_ckpt
from gan2shape_torch.core import masking as t_masking
from gan2shape_torch.core.trainer import Trainer
from gan2shape_torch.models.segmentation import BiSeNet
from gan2shape_torch.parallel import InstanceParallelTrainer
from gan2shape_torch.distributed import Mesh
from gan2shape_torch.utils import config as t_config

ROOT = Path(__file__).resolve().parents[1]
S = 64
N = 2
CFG = {
    "image_size": S, "gan_size": 32, "z_dim": 512,
    "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
    "rot_center_depth": 1.0, "fov": 10, "n_proj_samples": 2,
    "n_epochs_prior": 2, "learning_rate": 1e-4, "prior_name": "box",
}
STAGES = [{"step1": 2, "step2": 1, "step3": 1}]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads, as in test_torch_entry.py: six test processes
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


def _pools(seed):
    """One step-2 pool per instance: (pseudo images, masks)."""
    rng = np.random.default_rng(seed)
    n = CFG["n_proj_samples"]
    return [(rng.uniform(-1, 1, (n, 3, S, S)).astype(np.float32),
             (rng.uniform(0, 1, (n, 1, S, S)) > 0.2).astype(np.float32))
            for _ in range(N)]


def _stacked_pool(pools):
    return tuple(T(np.concatenate([p[i] for p in pools])) for i in (0, 1))


def _jax_weights(model, nets):
    """The JAX package's init_params pytree of port nets (the encoder
    nets' converter there is written for 128 px, whose nets have one more
    conv: conv0..conv{n-3}, conv5, conv6 in layer order), and its frozen
    pytree's LPIPS from the port model's."""
    params = {}
    for name in t_ckpt.NETS:
        sd = nets[name].state_dict()
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
    lp = model.lpips.state_dict()
    frozen = {"lpips": torch2jax.convert_lpips(
        {k[4:]: v for k, v in lp.items() if k.startswith("vgg.")}, lp)}
    return jax.tree.map(jnp.asarray, (params, frozen))


@pytest.fixture(scope="module")
def env():
    """The batched trainer (seed 0), a sequential port Trainer (seed 0,
    whose nets and frozen nets are the batched trainer's instance 0 and
    frozen nets), each instance's initial nets, images, latents, priors."""
    ip = InstanceParallelTrainer(CFG, N, seed=0, device="cpu")
    tt = Trainer(CFG, seed=0, device="cpu")
    inits = [{k: v.clone() for k, v in
              ip.model.nets.instance(j).state_dict().items()}
             for j in range(N)]
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (N, 3, S, S)).astype(np.float32)
    latents = rng.standard_normal((N, 512)).astype(np.float32)
    priors = np.full((N, S, S), 1.0, np.float32)
    priors[:, 16:48, 20:44] = 0.95
    priors[1, 24:40] = 0.93
    return ip, tt, inits, images, latents, priors


def test_instance_0_is_the_sequential_trainers_init(env):
    ip, tt, inits = env[:3]
    for k, v in tt.model.nets.state_dict().items():
        assert torch.equal(inits[0][k], v), k
    assert any(not torch.equal(inits[1][k], v)
               for k, v in inits[0].items())
    for name in ("generator", "discriminator", "lpips"):
        a = getattr(tt.model, name).state_dict()
        b = getattr(ip.model, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name


def test_iteration0_losses_match_sequential_and_jax(env):
    """Each step's loss from the init, per instance: the batched model
    against the sequential port model and, for the prior and step 1,
    against the JAX package's step functions on the same weights, within
    2e-6 relative."""
    ip, tt, inits, images, latents, priors = env
    jm = JModel(CFG)
    bm, m = ip.model, tt.model
    pools = _pools(1)
    proj = _pools(2)
    with torch.no_grad():
        prior_b, _ = bm.depth_net_forward(T(images), T(priors))
        step1_b, _ = bm.step1_iter(T(images), bm.step1_invariants(T(images)))
        step2_b, _ = bm.step2_loss(T(latents), *_stacked_pool(pools),
                                   bm.step2_invariants(T(latents)))
        step3_b, _ = bm.forward_step3(T(images), T(latents),
                                      _stacked_pool(proj))
    for b in (prior_b, step1_b, step2_b, step3_b):
        assert b.shape == (N,)
    for j in range(N):
        m.nets.load_state_dict(inits[j])
        im, lat = T(images[j:j + 1]), T(latents[j:j + 1])
        with torch.no_grad():
            prior_s, _ = m.depth_net_forward(im, T(priors[j]))
            step1_s, _ = m.step1_iter(im, m.step1_invariants(im))
            step2_s, _ = m.step2_loss(lat, T(pools[j][0]), T(pools[j][1]),
                                      m.step2_invariants(lat))
            step3_s, _ = m.forward_step3(im, lat, (T(proj[j][0]),
                                                   T(proj[j][1])))
        for b, s in ((prior_b, prior_s), (step1_b, step1_s),
                     (step2_b, step2_s), (step3_b, step3_s)):
            assert _rel(b[j], s) <= 2e-6, (j, float(b[j]), float(s))
        params, frozen = _jax_weights(m, m.nets)
        jl_prior, _ = jm.depth_net_forward(params,
                                           jnp.asarray(images[j:j + 1]),
                                           jnp.asarray(priors[j]))
        jl_step1, _ = jm.forward_step1(params, frozen,
                                       jnp.asarray(images[j:j + 1]))
        assert _rel(prior_b[j], jl_prior) <= 2e-6, (j, float(jl_prior))
        assert _rel(step1_b[j], jl_step1) <= 2e-6, (j, float(jl_step1))


def test_fit_matches_sequential_trainers(env):
    """A prior and a {2, 1, 1} stage: every instance's loss curves and
    final nets against its own sequential fit from the same init, with the
    same injected step-2 pool."""
    ip, tt, inits, images, latents, priors = env
    pools = _pools(3)
    ip.model.step2_sample = lambda g, collected, n: _stacked_pool(pools)
    history = ip.fit(images, latents, priors, stages=STAGES)
    assert [(h["image"], h["stage"]) for h in history] == [(0, 0), (1, 0)]
    for j in range(N):
        tt.model.nets.load_state_dict(inits[j])
        tt.optimizers = tt._optimizers()
        tt.prior_generator = lambda image, j=j: priors[j][None]
        tt.model.step2_sample = lambda g, collected, n, j=j: (
            T(pools[j][0]), T(pools[j][1]))
        (want,) = tt.fit([(images[j], latents[j], j)], stages=STAGES)
        for k in ("losses_step1", "losses_step2", "losses_step3"):
            assert len(history[j][k]) == STAGES[0][k[7:]]
            np.testing.assert_allclose(history[j][k], want[k], rtol=3e-3,
                                       atol=3e-3)
        got = ip.model.nets.instance(j).state_dict()
        for k, v in tt.model.nets.state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=3e-3,
                                       atol=3e-3, err_msg=k)


def test_adam_state_carries_across_fits_unless_reset():
    """Also: `frozen` lends the trainer its frozen nets."""
    from gan2shape_torch.core.model import GAN2Shape

    cfg = dict(CFG, n_epochs_prior=0)
    src = GAN2Shape(cfg, device="cpu")
    src.init_frozen(torch.Generator().manual_seed(5))
    ip = InstanceParallelTrainer(cfg, N, frozen=src, device="cpu")
    for name in ("generator", "discriminator", "lpips"):
        a = getattr(src, name).state_dict()
        b = getattr(ip.model, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (N, 3, S, S)).astype(np.float32)
    latents = rng.standard_normal((N, 512)).astype(np.float32)
    stage = [{"step1": 2, "step2": 0, "step3": 0}]

    def steps():
        p = next(iter(ip.optimizers[1].param_groups[0]["params"]))
        return int(ip.optimizers[1].state[p]["step"])

    ip.fit(images, latents, stages=stage)
    assert steps() == 2
    ip.fit(images, latents, stages=stage)
    assert steps() == 4
    ip.fit(images, latents, stages=stage, reset_opt=True)
    assert steps() == 2
    assert not ip.optimizers[2].state and not ip.optimizers[3].state


def test_one_adam_over_stacked_tensors_is_independent_adams():
    """The port's default optimizer (Adam, weight decay added to the
    gradient) is elementwise: one Adam over a stacked parameter moves each
    slice exactly as an Adam over that slice alone."""
    from gan2shape_torch.core.trainer import default_optimizer

    rng = np.random.default_rng(5)
    p0 = rng.uniform(-1, 1, (N, 64)).astype(np.float32)
    grads = (1e-3 * rng.standard_normal((4, N, 64))).astype(np.float32)
    stacked = torch.nn.Parameter(T(p0))
    alone = [torch.nn.Parameter(T(p0[j])) for j in range(N)]
    opt = default_optimizer([stacked])
    opts = [default_optimizer([p]) for p in alone]
    for g in grads:
        stacked.grad = T(g)
        opt.step()
        for j, (p, o) in enumerate(zip(alone, opts)):
            p.grad = T(g[j])
            o.step()
    for j in range(N):
        assert torch.equal(stacked.detach()[j], alone[j].detach())


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


def _jax_history_keys():
    """The keys of the record the JAX InstanceParallelTrainer appends."""
    tree = ast.parse((ROOT / "gan2shape_tpu" / "parallel" /
                      "sharding.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "append"
                and getattr(node.func.value, "id", "") == "history"):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no history record in the JAX trainer")


def test_cli_trains_instances_then_evaluates_their_checkpoints(
        tmp_path, monkeypatch):
    """`cli.train --n-instances 3` on a set of 2 trains both images at
    once (history keys those of the JAX trainer's records), saves one
    manifest and five .pth files per image that the sequential
    CheckpointManager reads back bit-equal, and `cli.evaluate` scores each
    checkpoint with the step-1 loss of the trained instance (masking its
    depth plot by the segmentation net once a parsing checkpoint
    exists)."""
    _write_face_set(tmp_path, N, S, np.random.default_rng(6))
    config = t_config.load_config(
        category="face", config_dir=str(ROOT / "configs"),
        minimal_config=str(ROOT / "minimal_config.yml"),
        overrides=dict(CFG, root_path=str(tmp_path / "data"),
                       our_nets_ckpts={"VLADE_nets": str(tmp_path / "ck")}))
    monkeypatch.chdir(tmp_path)
    args = t_train.parse_args(["--category", "face", "--n-instances", "3",
                               "--save-ckpts", "--device", "cpu"])
    trainer, history = t_train.run(
        config, args, stages=[{"step1": 2, "step2": 0, "step3": 0}])
    assert isinstance(trainer, InstanceParallelTrainer) and trainer.n == N
    assert [h["image"] for h in history] == [0, 1]
    assert all(set(h) == _jax_history_keys() for h in history)
    assert all(len(h["losses_step1"]) == 2
               and np.isfinite(h["losses_step1"]).all() for h in history)
    files = os.listdir(tmp_path / "ck" / "face")
    for img in range(N):
        mine = [f for f in files if f"_image_{img}_" in f]
        assert sum(f.endswith(".json") for f in mine) == 1
        assert sum(f.endswith(".pth") for f in mine) == 5

    mgr = t_ckpt.CheckpointManager(str(tmp_path / "ck"))
    for img, nets in mgr.load_per_image("face"):
        want = trainer.model.nets.instance(int(img)).state_dict()
        assert all(torch.equal(v, want[f"{n}.{k}"])
                   for n in t_ckpt.NETS for k, v in nets[n].items())
    # with a parsing checkpoint present the evaluation masks by the net
    (tmp_path / "checkpoints" / "parsing").mkdir(parents=True)
    torch.save(BiSeNet(n_classes=19).init_weights(
        torch.Generator().manual_seed(7)).state_dict(),
        tmp_path / "checkpoints" / "parsing" / "bisenet.pth")
    masked = []
    real_mask = t_masking.MaskingModel.image_mask
    monkeypatch.setattr(t_masking.MaskingModel, "image_mask",
                        lambda self, *a: masked.append(1) or real_mask(self,
                                                                      *a))
    eargs = t_evaluate.parse_args(["--category", "face", "--record-loss",
                                   "--device", "cpu"])
    records = t_evaluate.run(config, eargs)
    assert len(masked) == N
    assert [r["image"] for r in records] == [0, 1]
    images = np.stack([t_evaluate_image(tmp_path, i) for i in range(N)])
    with torch.no_grad():
        want, _ = trainer.model.forward_step1(T(images))
    for r in records:
        assert _rel(r["loss"], want[r["image"]]) <= 1e-5
    recon, depth = trainer.evaluate(images)
    assert recon.shape == (N, 3, S, S) and depth.shape == (N, S, S)


def t_evaluate_image(root, i):
    from gan2shape_torch.core.dataset import ImageDataset
    return ImageDataset(str(root / "data" / "face"), image_size=S)[i]


@pytest.mark.parametrize("n, kw, exc, match", [
    (3, {"mesh": Mesh(2, 0, torch.device("cpu"))}, ValueError,
     "do not divide over 2 ranks"),
    (N, {"device": ["cpu", "cpu"]}, NotImplementedError, "torchrun")])
def test_a_mesh_or_several_devices_are_refused(n, kw, exc, match):
    """Instances split over the ranks of a process group
    (tests/test_torch_distributed.py), so N must divide by their number;
    several devices in one process stay refused, pointing to torchrun."""
    with pytest.raises(exc, match=match):
        InstanceParallelTrainer(CFG, n, **kw)


def test_cli_refuses_a_resume_of_instances(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = t_train.parse_args(["--category", "face", "--n-instances", "2",
                               "--load-pretrained", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="n-instances"):
        t_train.run(dict(CFG), args)
    assert not (tmp_path / "results").exists()
