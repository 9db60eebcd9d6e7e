"""Train a StyleGAN2 on a prepared image cache, on one device or
data-parallel over the ranks of a process group.

The JAX package's tools/train_gan.py with its flags and schedule: lazy R1
every --d_reg_every iterations, path-length regularisation every
--g_reg_every, the adaptive augmentation controller (--augment with
--augment_p 0), an EMA sample grid every --sample_every iterations and a
full-state checkpoint `checkpoint/{iter:06d}.pt` (the reference
stylegan2-pytorch layout) every --ckpt_every.  The path-length batch is the
JAX trainer's default, max(1, 2 // path_batch_shrink).  --ckpt resumes
after the checkpoint's iteration, with its augmentation probability and
its draws: the trainer's generator state is in the checkpoint, and the
data draws of the iterations before are replayed from --seed.

    python -m gan2shape_torch.tools.prepare_data --out data/gan_cache \\
        --size 256 images/
    python -m gan2shape_torch.tools.train_gan data/gan_cache --size 256 \\
        --batch 16 --augment

Over W ranks (`--distributed`, or the G2S_* / torchrun variables, see
`gan2shape_torch/distributed.py`), each rank loads and trains on batch / W
of the batch; the batch must divide by W (the JAX tool takes the largest
divisor of the batch among its devices instead).  Every rank draws the same data
indices and flips from --seed, rank 0 writes the samples and checkpoints,
and every rank resumes from --ckpt:

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m gan2shape_torch.tools.train_gan data/gan_cache --distributed
"""

import argparse
import os

import numpy as np
import torch


def save_grid(images, path, value_range=(-1, 1)):
    """A (N, 3, H, W) batch as one PNG grid of ceil(sqrt N) columns."""
    from PIL import Image

    lo, hi = value_range
    imgs = np.clip((np.asarray(images) - lo) / (hi - lo), 0, 1)
    n, c, h, w = imgs.shape
    ncol = max(1, int(np.sqrt(n)))
    nrow = (n + ncol - 1) // ncol
    grid = np.ones((nrow * h, ncol * w, 3), np.float32)
    for i in range(n):
        r, cc = divmod(i, ncol)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = \
            imgs[i].transpose(1, 2, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((grid * 255 + 0.5).astype(np.uint8)).save(path)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="StyleGAN2 trainer")
    parser.add_argument("path", type=str,
                        help="prepared dataset dir (tools.prepare_data)")
    parser.add_argument("--iter", type=int, default=800000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--n_sample", type=int, default=64)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--r1", type=float, default=10)
    parser.add_argument("--path_regularize", type=float, default=2)
    parser.add_argument("--path_batch_shrink", type=int, default=2)
    parser.add_argument("--d_reg_every", type=int, default=16)
    parser.add_argument("--g_reg_every", type=int, default=4)
    parser.add_argument("--mixing", type=float, default=0.9)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint to resume from")
    parser.add_argument("--lr", type=float, default=0.002)
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--augment_p", type=float, default=0,
                        help="fixed augment probability (0 = adaptive)")
    parser.add_argument("--ada_target", type=float, default=0.6)
    parser.add_argument("--ada_length", type=int, default=500 * 1000)
    parser.add_argument("--ada_every", type=int, default=256,
                        help="(reference flag; the controller updates every "
                             "8 D steps)")
    parser.add_argument("--sample_every", type=int, default=100)
    parser.add_argument("--ckpt_every", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", type=str, default=".")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be "
                             "present)")
    parser.add_argument("--distributed", action="store_true",
                        help="train data-parallel over the ranks of a "
                             "process group (coordinates from torchrun or "
                             "G2S_COORDINATOR / G2S_NUM_PROCESSES / "
                             "G2S_PROCESS_ID; the variables alone also "
                             "ask for it)")
    return parser.parse_args(argv)


def run(args):
    """Train; returns (trainer, one record per iteration)."""
    from gan2shape_torch.core.dataset import MultiResolutionDataset
    from gan2shape_torch.models.augment import AdaptiveAugment
    from gan2shape_torch.models.stylegan2_train import StyleGAN2Trainer
    from gan2shape_torch import distributed

    distributed.initialize_from_env(device=args.device,
                                    required=args.distributed)
    mesh = distributed.make_mesh()
    if args.batch % mesh.size:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{mesh.size} ranks")
    rows = distributed.local_slice(args.batch)
    lead = mesh.rank == 0

    wandb = None
    if args.wandb and lead:
        try:
            import wandb
            wandb.init(project="stylegan 2")
        except ImportError:
            print("wandb not installed; continuing without")
            wandb = None

    trainer = StyleGAN2Trainer(
        size=args.size, style_dim=512, n_mlp=8,
        channel_multiplier=args.channel_multiplier, lr=args.lr,
        r1_weight=args.r1, d_reg_every=args.d_reg_every,
        g_reg_every=args.g_reg_every, mixing=args.mixing,
        path_regularize=args.path_regularize,
        path_batch_shrink=args.path_batch_shrink,
        use_augment=args.augment, seed=args.seed, device=args.device,
        mesh=mesh)
    dataset = MultiResolutionDataset(args.path, resolution=args.size)
    if lead:
        print(f"dataset: {len(dataset)} images @ {args.size}px on "
              f"{trainer.device}; {mesh.size} rank(s), "
              f"{args.batch // mesh.size} samples each")

    start_iter = 0
    ada_p = args.augment_p
    ada = AdaptiveAugment(args.ada_target, args.ada_length, 8)
    if args.ckpt is not None:
        if lead:
            print("load model:", args.ckpt)
        last, saved_p = trainer.load_checkpoint(args.ckpt)
        start_iter = last + 1
        if args.augment_p == 0:
            ada_p = ada.ada_aug_p = saved_p

    rng = np.random.default_rng(args.seed)
    sample_z = torch.as_tensor(
        rng.standard_normal((args.n_sample, 512)).astype(np.float32),
        device=trainer.device)
    for _ in range(start_iter):  # the saved run's data draws
        rng.integers(0, len(dataset), args.batch)
        rng.random(args.batch)

    log = []
    mean_path = float(trainer.mean_path_length)
    for i in range(start_iter, args.iter):
        idx = rng.integers(0, len(dataset), args.batch)
        flip = rng.random(args.batch) < 0.5
        real = dataset.get_batch(idx[rows], flip[rows]).to(trainer.device)

        metrics = trainer.train_step(real, ada_p)
        if args.augment and args.augment_p == 0:
            ada_p = ada.tune(metrics["real_sign_sum"], args.batch)

        r1_val = path_val = 0.0
        if i % args.d_reg_every == 0:
            r1_val = float(trainer.d_reg_step(real, ada_p))
        if i % args.g_reg_every == 0:
            pmetrics = trainer.g_reg_step()
            path_val = float(pmetrics["path_loss"])
            mean_path = float(pmetrics["mean_path_length"])

        rec = {"iter": i, "d": float(metrics["d_loss"]),
               "g": float(metrics["g_loss"]), "r1": r1_val,
               "path": path_val, "mean_path": mean_path, "augment": ada_p}
        log.append(rec)
        if i % 10 == 0 and lead:
            print(f"iter {i}: d: {rec['d']:.4f}; g: {rec['g']:.4f}; "
                  f"r1: {r1_val:.4f}; path: {path_val:.4f}; mean path: "
                  f"{mean_path:.4f}; augment: {ada_p:.4f}", flush=True)
        if wandb is not None:
            wandb.log({"Generator": rec["g"], "Discriminator": rec["d"],
                       "Augment": ada_p, "Rt": ada.r_t_stat, "R1": r1_val,
                       "Path Length Regularization": path_val,
                       "Mean Path Length": mean_path,
                       "Real Score": float(metrics["real_score"]),
                       "Fake Score": float(metrics["fake_score"])})

        if i % args.sample_every == 0 and lead:
            sample = trainer.sample_ema(sample_z)
            save_grid(sample.cpu().numpy(),
                      os.path.join(args.out_dir, "sample",
                                   f"{str(i).zfill(6)}.png"))
        if i % args.ckpt_every == 0 and lead:
            trainer.save_checkpoint(
                os.path.join(args.out_dir, "checkpoint",
                             f"{str(i).zfill(6)}.pt"),
                iteration=i, ada_p=ada_p)
    return trainer, log


def main(argv=None):
    run(parse_args(argv))
    print("Done!")


if __name__ == "__main__":
    main()
