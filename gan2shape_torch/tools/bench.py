"""Benchmark of the port: face-128 optimization steps per second on one GPU,
the counterpart of the JAX package's root bench.py.

    python -m gan2shape_torch.tools.bench                  # one instance
    python -m gan2shape_torch.tools.bench --instances 8    # 8 at once
    python -m gan2shape_torch.tools.bench --device cpu     # on the CPU

`main` runs the three-step stage loop of instance training with the face
config (image 128², GAN 128, 16 pseudo samples a step-2 iteration, LPIPS-VGG,
`box` prior, seeded random weights) on one seeded random image and latent.
A block is 25 iterations each of step 1, 2 and 3 through the Trainer's
`run_step1` / `run_step2` / `run_step3`, each step's collected state passed
on as `fit` passes it.  One untimed warm-up block (it builds the kernels),
then 4 timed blocks by the host clock, synchronised before and after.

`bench_instances` (`--instances K`) trains K instances at once through
`InstanceParallelTrainer` on one device: one warm-up `fit` (with 10 prior
iterations), then 2 timed fits of 15 iterations a step; the value is the
aggregate steps/s (each iteration advances all K instances).

vs_baseline: steps/s over 19.67 = (1000 + 4900) / 300, the JAX bench's
north-star rate: the reference's instance schedule in 5 minutes, as
BASELINE.md counts it (it holds 1000 prior + 5300 step iterations).

Prints exactly one JSON line on stdout, {"metric", "value", "unit",
"vs_baseline"}; the logs go to stderr.
"""

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from gan2shape_torch.core.trainer import Trainer
from gan2shape_torch.device import synchronize
from gan2shape_torch.parallel.sharding import InstanceParallelTrainer

NORTH_STAR_STEPS_PER_SEC = (1000 + 4900) / 300.0  # 19.67

# configs/face.yml over minimal_config.yml, with the box prior
FACE128 = {
    "image_size": 128, "gan_size": 128, "z_dim": 512,
    "channel_multiplier": 1, "category": "face",
    "n_proj_samples": 16, "n_epochs_prior": 100,
    "learning_rate": 1e-4, "prior_name": "box",
    "rot_center_depth": 1.0, "fov": 10,
}
STEPS_METRIC = "gan2shape_face128_steps_per_sec_per_chip"
INSTANCES_METRIC = "gan2shape_face128_instance_batched_steps_per_sec_x{k}"


def _result(metric, value, unit):
    """The JSON line, printed alone on stdout and returned."""
    result = {"metric": metric, "value": round(value, 3), "unit": unit,
              "vs_baseline": round(value / NORTH_STAR_STEPS_PER_SEC, 3)}
    print(json.dumps(result), flush=True)
    return result


def build(config=None, raster_window=None, device=None):
    """(trainer, image (1, 3, S, S), latent (1, 512)) of `main`: the face
    config updated by `config`, the seed-0 image and latent on the
    trainer's device."""
    config = {**FACE128, **(config or {})}
    if raster_window is not None:  # an A/B knob; None keeps the default
        config["raster_window"] = raster_window
    trainer = Trainer(config, device=device)
    s = trainer.image_size
    rng = np.random.default_rng(0)
    image = torch.as_tensor(rng.uniform(-1, 1, (1, 3, s, s))
                            .astype(np.float32), device=trainer.device)
    latent = torch.as_tensor(rng.standard_normal((1, 512))
                             .astype(np.float32), device=trainer.device)
    return trainer, image, latent


def run_block(trainer, image, latent, n1, n2, n3):
    """n1, n2, n3 iterations of step 1, 2 and 3, as a stage of `fit` runs
    them.  Returns the three lists of per-iteration loss tensors (not
    synchronised)."""
    collected, l1 = trainer.run_step1(image, n1)
    collected2, l2 = trainer.run_step2(image, latent, collected, n2)
    l3 = trainer.run_step3(image, latent, collected2, n3)
    return l1, l2, l3


def main(raster_window=None, config=None, n_blocks=4, n_iters=25,
         device=None):
    """Steps/s of blocks of `n_iters` iterations of each step: one warm-up
    block, then `n_blocks` timed ones."""
    trainer, image, latent = build(config, raster_window, device)
    run_block(trainer, image, latent, n_iters, n_iters, n_iters)
    synchronize(trainer.device)
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        run_block(trainer, image, latent, n_iters, n_iters, n_iters)
    synchronize(trainer.device)
    dt = time.perf_counter() - t0
    return _result(STEPS_METRIC, n_blocks * 3 * n_iters / dt,
                   "optimization steps/sec (step1+2+3 mix, n_proj=16)")


def bench_instances(k, config=None, n_iters=15, n_blocks=2, device=None):
    """Aggregate steps/s of K instances trained at once on one device: a
    warm-up fit with 10 prior iterations, then `n_blocks` timed fits of
    `n_iters` iterations a step."""
    config = {**FACE128, "n_epochs_prior": 10, **(config or {})}
    trainer = InstanceParallelTrainer(config, n_instances=k, device=device)
    s = trainer.image_size
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (k, 3, s, s)).astype(np.float32)
    latents = rng.standard_normal((k, 512)).astype(np.float32)
    priors = np.full((k, s, s), 1.0, np.float32)
    stage = [{"step1": n_iters, "step2": n_iters, "step3": n_iters}]

    trainer.fit(images, latents, priors, stages=stage)
    synchronize(trainer.device)
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        trainer.fit(images, latents, priors=None, stages=stage)
    synchronize(trainer.device)
    dt = time.perf_counter() - t0
    return _result(INSTANCES_METRIC.format(k=k),
                   n_blocks * 3 * n_iters * k / dt,
                   f"aggregate optimization steps/sec ({k} instances, 1 "
                   f"chip)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--instances", type=int, default=0,
                        help="bench K instances trained at once on one "
                             "device")
    parser.add_argument("--raster-window", type=int, default=None,
                        help="override the grid rasterizer window (A/B)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = parse_args()
    if args.instances > 0:
        bench_instances(args.instances, device=args.device)
    else:
        main(raster_window=args.raster_window, device=args.device)
