"""One rank of tests/test_torch_distributed.py's 2-process gloo group on
the CPU.  It joins the group through the G2S_* variables, runs the cases
named in the job file of its work folder, and saves what each returns to
rank{r}.pt there for the parent to hold against its one-process and JAX
runs.  It imports torch and the port only, never JAX:

    python tests/torch_dist_worker.py RANK PORT WORKDIR
"""

import hashlib
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
S = 64
N = 2
CFG = {
    "image_size": S, "gan_size": 32, "z_dim": 512,
    "channel_multiplier": 1, "category": "face", "disc_ftr_num": 3,
    "rot_center_depth": 1.0, "fov": 10, "n_proj_samples": 2,
    "n_epochs_prior": 2, "learning_rate": 1e-4, "prior_name": "box",
    "n_epochs_generalized": 1,
}
STAGE = {"step1": 2, "step2": 1, "step3": 1}
CLI_STAGE = {"step1": 2, "step2": 0, "step3": 0}
GAN = {"size": 16, "style_dim": 32, "n_mlp": 2, "channel_multiplier": 1}
GAN_BATCH = 8
ADA_P = 0.6


def T(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def digest(tensors):
    """A hash of the bytes of a state's tensors, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def iteration0(model, images, latents, priors):
    """The prior's and each step's loss from the init, without an update
    (step 2 from a seeded generator: its draws are under test)."""
    n_proj = CFG["n_proj_samples"]
    with torch.no_grad():
        prior, _ = model.depth_net_forward(images, priors)
        inv = model.step1_invariants(images)
        step1, albedo = model.step1_iter(images, inv)
        collected = (inv["normal"], inv["light_a"], inv["light_b"], albedo,
                     inv["depth"])
        pool = model.step2_sample(torch.Generator().manual_seed(1),
                                  collected, n_proj)
        step2, coll2 = model.step2_loss(latents, *pool,
                                        model.step2_invariants(latents))
        step3, _ = model.forward_step3(images, latents, coll2)
    return torch.stack([prior, step1, step2, step3])


def instance_case(job):
    """(iii): this rank's instances of the N of InstanceParallelTrainer."""
    from gan2shape_torch.parallel import InstanceParallelTrainer

    ip = InstanceParallelTrainer(CFG, N, seed=0, device="cpu")
    own = [ip._batch(job[k]) for k in ("images", "latents", "priors")]
    out = {"first": ip.first, "n": ip.n,
           "iteration0": iteration0(ip.model, *own)}
    out["history"] = ip.fit(job["images"], job["latents"], job["priors"],
                            stages=[STAGE])
    out["nets"] = [ip.model.nets.instance(j).state_dict()
                   for j in range(ip.n)]
    return out


def generalizing_case(job):
    """(iv): data_parallel GeneralizingTrainer over the two images."""
    from gan2shape_torch.core.trainer import GeneralizingTrainer

    gt = GeneralizingTrainer(dict(CFG, data_parallel=True), seed=0,
                             device="cpu")
    data = [(job["images"][i], job["latents"][i], i) for i in range(N)]
    history = gt.fit(data, stages=[STAGE], batch_size=N)
    nets = gt.model.nets.state_dict()
    return {"history": history, "nets": nets,
            "hash": digest(nets.values()), "world": gt.mesh.size}


def _inject(trainer, inj):
    """The parent's draws of the whole batch into the port trainer: the
    latents and noise through the draw methods, the augmentation through
    the module's transform samplers."""
    from gan2shape_torch.models import stylegan2_train

    def mixed(g, batch):
        z1, z2, take2 = inj["latents"].pop(0)
        assert batch == z1.shape[0], (batch, z1.shape)
        w1, w2 = g.style_forward(T(z1)), g.style_forward(T(z2))
        return torch.where(torch.as_tensor(take2)[None, :, None],
                           w2[:, None], w1[:, None])

    trainer._mixed_latent = mixed
    trainer._fresh_noise = lambda batch: [T(n) for n in
                                          inj["noise"].pop(0)]
    trainer._path_noise = lambda shape: T(inj["path"])
    stylegan2_train.sample_inverse_affine = \
        lambda gen, p, size, h, w: T(inj["aug"][0].pop(0))
    stylegan2_train.sample_color = lambda gen, p, size: T(
        inj["aug"][1].pop(0))


def gan_trainer(job, mesh=None):
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer

    t = StyleGAN2Trainer(**GAN, use_augment=True, device="cpu", mesh=mesh)
    for name in ("generator", "discriminator", "g_ema"):
        getattr(t, name).load_state_dict(job["gan"][name])
    return t


def first_moments(optim):
    """Adam's first moment of each parameter, in order: with b1 = 0 the
    last step's (averaged) gradient itself."""
    return [optim.state[p]["exp_avg"].clone()
            for g in optim.param_groups for p in g["params"]]


def run_gan_steps(t, job, real):
    """train_step, d_reg_step and g_reg_step from the init, with the
    parent's draws, and the gradients each applied (Adam's first moments);
    the D scores of the reals at the init with the whole batch's minibatch
    standard deviation (and, as a planted fault, the rank's own)."""
    import copy

    real = T(real)
    with torch.no_grad():
        scores = t.discriminator(real, split_batch=t.grouped)[0]
        per_rank = t.discriminator(real)[0]
    inj = copy.deepcopy(job["draws"])
    _inject(t, inj)
    out = {"scores": scores, "scores_per_rank": per_rank}
    out["train"] = {k: float(v) for k, v in
                    t.train_step(real, ADA_P).items()}
    out["after_train"] = {"g": copy.deepcopy(t.generator.state_dict()),
                          "d": copy.deepcopy(t.discriminator.state_dict())}
    out["grads"] = {"train g": first_moments(t.g_optim),
                    "train d": first_moments(t.d_optim)}
    out["r1"] = float(t.d_reg_step(real, ADA_P))
    out["grads"]["r1 d"] = first_moments(t.d_optim)
    out["path"] = {k: float(v) for k, v in t.g_reg_step().items()}
    out["grads"]["path g"] = first_moments(t.g_optim)
    out["after"] = {"g": t.generator.state_dict(),
                    "d": t.discriminator.state_dict()}
    return out


def gan_case(job):
    """(v): the StyleGAN2 steps at batch GAN_BATCH over the ranks."""
    from gan2shape_torch.models import stylegan2_train
    from gan2shape_torch import distributed

    saved = (stylegan2_train.sample_inverse_affine,
             stylegan2_train.sample_color)
    try:
        t = gan_trainer(job, distributed.make_mesh())
        return run_gan_steps(
            t, job, job["real"][distributed.local_slice(GAN_BATCH)])
    finally:
        (stylegan2_train.sample_inverse_affine,
         stylegan2_train.sample_color) = saved


def cli_config(root):
    from gan2shape_torch.utils.config import load_config

    return load_config(
        category="face", config_dir=str(ROOT / "configs"),
        minimal_config=str(ROOT / "minimal_config.yml"),
        overrides=dict(CFG, root_path=str(Path(root) / "data"),
                       our_nets_ckpts={
                           "VLADE_nets": str(Path(root) / "ck")}))


def cli_case(job):
    """(vi): cli.train --distributed --n-instances 2 in the parent's
    written data folder."""
    from gan2shape_torch.cli import train as t_train

    here = os.getcwd()
    os.chdir(job["cli_root"])
    try:
        args = t_train.parse_args(["--category", "face", "--distributed",
                                   "--n-instances", str(N), "--save-ckpts",
                                   "--device", "cpu"])
        trainer, history = t_train.run(cli_config(job["cli_root"]), args,
                                       stages=[CLI_STAGE])
    finally:
        os.chdir(here)
    return {"images": [h["image"] for h in history],
            "losses": [h["losses_step1"] for h in history],
            "nets": {h["image"]: trainer.model.nets.instance(j).state_dict()
                     for j, h in enumerate(history)}}


def smoke_case():
    """(ii): tests/dist_worker.py's checks in torch: the owned rows, a
    broadcast, row gathers, an all-reduce total of 28; and a split masked
    mean."""
    import torch.distributed as dist

    from gan2shape_torch import distributed

    r = distributed.rank()
    mesh = distributed.make_mesh()
    assert (mesh.size, mesh.rank) == (2, r), mesh
    glob = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    rows = distributed.local_slice(4)
    assert (rows.start, rows.stop) == (2 * r, 2 * r + 2), rows
    total = glob[rows].sum()
    dist.all_reduce(total)
    got = distributed.broadcast_([torch.full((3,), float(r)),
                                  torch.full((2, 2), 10.0 + r)])
    assert all(bool((t == v).all()) for t, v in zip(got, (0.0, 10.0)))
    gathered = distributed.gather_rows(glob[rows])
    assert torch.equal(gathered, glob), gathered
    a, b = distributed.gather_rows_of([glob[rows], glob[rows][:, :1] + 1])
    assert torch.equal(a, glob) and torch.equal(b, glob[:, :1] + 1)
    mean = distributed.all_reduce_mean_([torch.full((2,), float(r))])[0]
    assert torch.equal(mean, torch.full((2,), 0.5)), mean
    masked_mean_shares(rows)
    return float(total)


def masked_mean_shares(rows):
    """A split batch's masked mean: the ranks' shares average to the
    whole batch's value, and their gradients are its gradient, with mask
    sums that differ from rank to rank."""
    import torch.distributed as dist

    from gan2shape_torch.core.losses import masked_mean

    g = torch.Generator().manual_seed(0)
    x = torch.rand(4, 3, 5, 5, generator=g)
    keep = torch.tensor([0.1, 0.2, 0.7, 0.9]).reshape(4, 1, 1, 1)
    mask = (torch.rand(4, 1, 5, 5, generator=g) > keep).float()
    whole = x.clone().requires_grad_(True)
    masked_mean(whole, mask).sum().backward()
    mine = x[rows].clone().requires_grad_(True)
    share = masked_mean(mine, mask[rows], split=True)
    (share / 2).sum().backward()  # the mean of the two ranks' shares
    total = share.detach().clone()
    dist.all_reduce(total)
    assert torch.allclose(total / 2, masked_mean(x, mask), rtol=1e-6), total
    assert torch.allclose(mine.grad, whole.grad[rows], rtol=1e-6)


CASES = {"instances": instance_case, "generalizing": generalizing_case,
         "gan": gan_case, "cli": cli_case}


def main(rank, port, workdir):
    torch.set_num_threads(2)
    os.environ.update({"G2S_COORDINATOR": f"localhost:{port}",
                       "G2S_NUM_PROCESSES": "2",
                       "G2S_PROCESS_ID": str(rank)})
    from gan2shape_torch import distributed

    assert distributed.initialize_from_env(device="cpu")
    job = torch.load(Path(workdir) / "job.pt", weights_only=False)
    try:
        out = {"total": smoke_case()}
        for name in job["cases"]:
            out[name] = CASES[name](job)
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()
    print(f"DIST_OK rank={rank} total={out['total']}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
