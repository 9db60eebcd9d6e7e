"""Train GAN2Shape on a dataset folder, on CUDA.

    python -m gan2shape_torch.cli.train --category face --save-ckpts
    python -m gan2shape_torch.cli.train --category car --prior smoothed_box --generalize
    python -m gan2shape_torch.cli.train --category face --images 0 1 2

The flags and the stage schedules are those of the JAX package's `main.py`.
Instance mode trains each image in turn: a 1000-iteration prior, then stages
{700, 700, 600} and 3 x {200, 500, 400} of steps 1, 2 and 3.  `--generalize`
shares the nets over all images: per epoch, one {13, 22, 18} stage with step
1 batched over `batch_size` images.  Checkpoints are reference-style `.pth`
state_dicts under `our_nets_ckpts`; `--load-pretrained` resumes from the
latest one (the config's `stage` / `iteration` / `time` selectors).  The
reference assets (StyleGAN2 checkpoint, VGG16 and LPIPS heads, view / light
MVN) load from the config's paths; a missing file leaves seeded random
weights, with a warning.

`--n-instances K` trains the first min(K, len(data)) images at once
(`parallel.InstanceParallelTrainer`), with the instance schedule and priors
from the default prior generator.

Over several processes (`--distributed`, or the G2S_* / torchrun
variables: `gan2shape_torch/distributed.py`), `--n-instances K` splits the
K instances over the ranks (K must divide by their number) and
`--generalize` honours the config's `data_parallel`; the sequential
branch is refused, since every rank would train every image over the
others' checkpoints:

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m gan2shape_torch.cli.train --distributed --n-instances 8 ...

`--device` defaults to CUDA (a rank's own device under a process group) and
there is no CPU fallback: a missing GPU is an error (`--device cpu` runs on
the CPU on purpose, the ranks over gloo).
"""

import argparse
import logging
import sys
import time
from os import path

from gan2shape_torch.device import resolve_device
from gan2shape_torch import distributed
from gan2shape_torch.utils.config import create_results_folder, load_config

log = logging.getLogger(__name__)

INSTANCE_STAGES = [{"step1": 700, "step2": 700, "step3": 600},
                   {"step1": 200, "step2": 500, "step3": 400},
                   {"step1": 200, "step2": 500, "step3": 400},
                   {"step1": 200, "step2": 500, "step3": 400}]
GENERALIZING_STAGES = [{"step1": 13, "step2": 22, "step3": 18}]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run GAN 2D-to-3D shape recovery (PyTorch, CUDA)")
    parser.add_argument("--config-file", dest="CONFIG", default="config.yml")
    parser.add_argument("--category", dest="CATEGORY", default=None)
    parser.add_argument("--prior", dest="PRIOR", default=None)
    parser.add_argument("--wandb", dest="WANDB", action="store_true")
    parser.add_argument("--save-ckpts", dest="SAVE_CKPTS",
                        action="store_true")
    parser.add_argument("--debug", dest="DEBUG", action="store_true")
    parser.add_argument("--log-file", dest="LOG_FILE", default=None)
    parser.add_argument("--load-pretrained", dest="LOAD_PRETRAINED",
                        action="store_true")
    parser.add_argument("--generalize", dest="GENERALIZE",
                        action="store_true")
    parser.add_argument("--images", dest="IMAGES", action="append", type=int,
                        default=None, nargs="+")
    parser.add_argument("--n-instances", dest="N_INSTANCES", type=int,
                        default=0,
                        help="train this many images at once, split "
                             "over the ranks (0: one after another)")
    parser.add_argument("--distributed", dest="DISTRIBUTED",
                        action="store_true",
                        help="join a process group (coordinates from "
                             "torchrun or G2S_COORDINATOR/"
                             "G2S_NUM_PROCESSES/G2S_PROCESS_ID; the "
                             "variables alone also ask for it)")
    parser.add_argument("--device", dest="DEVICE", default=None,
                        help="torch device (default: cuda, which must be "
                             "present)")
    return parser.parse_args(argv)


def instance_parallel(args):
    return args.N_INSTANCES > 0 and not args.GENERALIZE


def sequential(args):
    return not args.GENERALIZE and not instance_parallel(args)


def refuse_unported(args):
    """Refused, never ignored: a resume of instances trained at once,
    which the JAX package ignores, and the sequential branch over several
    ranks, where the JAX package would train every image on every host."""
    if instance_parallel(args) and args.LOAD_PRETRAINED:
        raise NotImplementedError(
            "--load-pretrained resumes sequential or --generalize runs, not "
            "--n-instances ones")
    if sequential(args) and (args.DISTRIBUTED
                             or distributed.world_size() > 1):
        raise NotImplementedError(
            "the sequential trainer runs in one process: over several "
            "ranks use --n-instances or --generalize")


def join_group(args):
    """Join the process group the flags or the environment ask for, then
    apply the refusals; before any side effect."""
    refuse_unported(args)
    distributed.initialize_from_env(device=args.DEVICE,
                                    required=args.DISTRIBUTED)
    refuse_unported(args)


def config_from_args(args):
    return load_config(category=args.CATEGORY,
                       config_file=None if args.CATEGORY else args.CONFIG,
                       overrides={"prior_name": args.PRIOR})


def _flat(images):
    return None if images is None else [i for lst in images for i in lst]


def build_trainer(config, args):
    """The trainer `args` ask for, with the reference assets loaded (the
    nets restored first when resuming)."""
    from gan2shape_torch.convert.reference import build_frozen_assets
    from gan2shape_torch.core.trainer import GeneralizingTrainer2, Trainer

    join_group(args)
    load_dict = None
    if args.LOAD_PRETRAINED:
        load_dict = {"category": config.get("category"),
                     "base_path": config.get("our_nets_ckpts")["VLADE_nets"],
                     "stage": config.get("stage", "*"),
                     "iteration": config.get("iteration", "*"),
                     "time": config.get("time", "*")}
    trainer_cls = GeneralizingTrainer2 if args.GENERALIZE else Trainer
    trainer = trainer_cls(config, debug=args.DEBUG, plot_intermediate=True,
                          log_wandb=args.WANDB, save_ckpts=args.SAVE_CKPTS,
                          load_dict=load_dict, device=args.DEVICE)
    build_frozen_assets(trainer.model, config)
    return trainer


def run(config, args, stages=None):
    """Train as `args` ask on `config`'s dataset, with `stages` (default:
    the schedule of the mode).  Returns (trainer, history)."""
    from gan2shape_torch.core.dataset import ImageLatentDataset

    join_group(args)  # before any side effect
    resolve_device(args.DEVICE)
    category = config.get("category")
    if args.WANDB:
        try:
            import wandb
            wandb.init(project="gan-2d-to-3d-torch", config=config)
        except ImportError:
            log.warning("wandb not installed; continuing without")
    create_results_folder()
    images_latents = ImageLatentDataset(
        path.join(config.get("root_path"), category),
        image_size=config.get("image_size"), subset=_flat(args.IMAGES))
    if not args.SAVE_CKPTS:
        print(">>> Warning, not saving checkpoints. "
              "Rerun with --save-ckpts for a real run <<<")
        time.sleep(0.5)
    if instance_parallel(args):
        return run_instances(config, args, images_latents,
                             stages or INSTANCE_STAGES)
    trainer = build_trainer(config, args)
    if args.GENERALIZE:
        history = trainer.fit(images_latents,
                              stages=stages or GENERALIZING_STAGES,
                              batch_size=config.get("batch_size", 2))
    else:
        history = trainer.fit(images_latents,
                              stages=stages or INSTANCE_STAGES)
    return trainer, history


def run_instances(config, args, images_latents, stages):
    """main.py's --n-instances branch: the first min(K, len(data)) images,
    their priors from the trainer's default prior generator (the
    segmentation masker when a parsing checkpoint exists), trained at once,
    each rank's share on its device.  Returns (trainer, the history of
    this rank's instances)."""
    import numpy as np

    from gan2shape_torch.convert.reference import build_frozen_assets
    from gan2shape_torch.parallel import InstanceParallelTrainer

    n = min(args.N_INSTANCES, len(images_latents))
    trainer = InstanceParallelTrainer(config, n_instances=n,
                                      save_ckpts=args.SAVE_CKPTS,
                                      device=args.DEVICE)
    build_frozen_assets(trainer.model, config)
    images, latents, indices = zip(*(images_latents[i] for i in range(n)))
    priors = [trainer.prior_generator(im)[0] for im in images]
    history = trainer.fit(
        np.stack(images), np.stack([np.asarray(x).reshape(-1)
                                    for x in latents]),
        np.stack(priors), stages=stages,
        data_indices=[int(i) for i in indices])
    return trainer, history


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        filename=args.LOG_FILE,
        format="%(asctime)s %(levelname)-8s %(message)s", level=logging.INFO)
    join_group(args)
    resolve_device(args.DEVICE)  # before the config and the data
    run(config_from_args(args), args)


if __name__ == "__main__":
    sys.exit(main())
