"""Evaluate trained checkpoints, on CUDA.

    python -m gan2shape_torch.cli.evaluate --category face
    python -m gan2shape_torch.cli.evaluate --category face --record-loss
    python -m gan2shape_torch.cli.evaluate --category face --general

The flags are those of the JAX package's `evaluate_results.py`.  For each
image it loads the latest per-image checkpoint (or, with `--general`, the
latest general one for every image) matching the `--stage` / `--iteration`
/ `--time` selectors, reconstructs the image, and writes the reconstruction
and depth plots and a rotating 3D surface of the masked depth under
`results/`.  `--record-loss` records each image's step-1 loss to
`results/step1_losses.npy` and prints their mean and std; `--gallery`
assembles `results/index.html`.  Checkpoints are the port's `.pth` files:
the JAX package's msgpack checkpoints are refused.
"""

import argparse
import logging
import sys
from os import path

import numpy as np
import torch

from gan2shape_torch.device import resolve_device
from gan2shape_torch.utils.config import create_results_folder, load_config

log = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate GAN-2D-to-3D")
    parser.add_argument("--category", dest="CATEGORY", default="face")
    parser.add_argument("--config-file", dest="CONFIG", default=None)
    parser.add_argument("--general", dest="GENERAL", action="store_true",
                        help="use the latest general checkpoint for all "
                             "images instead of per-image checkpoints")
    parser.add_argument("--record-loss", dest="RECORD_LOSS",
                        action="store_true")
    parser.add_argument("--images", dest="IMAGES", action="append", type=int,
                        default=None, nargs="+")
    parser.add_argument("--stage", dest="STAGE", default="*",
                        help="glob selector on the checkpoint stage")
    parser.add_argument("--iteration", dest="ITERATION", default="*",
                        help="glob selector on the checkpoint iteration "
                             "count")
    parser.add_argument("--time", dest="TIME", default="*",
                        help="glob selector on the checkpoint timestamp")
    parser.add_argument("--gallery", dest="GALLERY", action="store_true",
                        help="assemble all per-image artifacts into "
                             "results/index.html")
    parser.add_argument("--device", dest="DEVICE", default=None,
                        help="torch device (default: cuda, which must be "
                             "present)")
    return parser.parse_args(argv)


def config_from_args(args):
    return load_config(category=args.CATEGORY, config_file=args.CONFIG)


def _checkpoints(mgr, args, n_images):
    """(image index, {net: state_dict}) pairs."""
    sel = dict(stage=args.STAGE, iteration=args.ITERATION, time=args.TIME)
    if args.GENERAL:
        nets = mgr.load_latest_general(args.CATEGORY, **sel)
        return ((i, nets) for i in range(n_images))
    # general checkpoints (image "") are not per-image ones
    return ((int(img), nets) for img, nets in
            mgr.load_per_image(args.CATEGORY, **sel) if img != "")


def run(config, args):
    """Evaluate as `args` ask.  Returns one record per image: {"image",
    "recon" (3, H, W), "depth" (H, W), "loss" (with --record-loss)}, arrays
    on the host."""
    from gan2shape_torch.convert.reference import build_frozen_assets
    from gan2shape_torch.core.checkpoint import CheckpointManager, load_nets
    from gan2shape_torch.core.dataset import ImageDataset
    from gan2shape_torch.core.masking import make_masking_model
    from gan2shape_torch.core.model import GAN2Shape
    from gan2shape_torch.utils import plotting

    device = resolve_device(args.DEVICE)
    create_results_folder()
    subset = args.IMAGES
    if subset is not None:
        subset = [i for lst in subset for i in lst]
    dataset = ImageDataset(path.join(config["root_path"], args.CATEGORY),
                           image_size=config["image_size"], subset=subset)
    model = GAN2Shape(config, device=device)
    build_frozen_assets(model, config)
    mgr = CheckpointManager(config["our_nets_ckpts"]["VLADE_nets"])
    masker = make_masking_model(args.CATEGORY, config["image_size"],
                                device=device)

    records = []
    for img_idx, nets in _checkpoints(mgr, args, len(dataset)):
        load_nets(model, nets)
        image_np = dataset[img_idx]
        image = torch.as_tensor(image_np, device=device)[None]
        recon_im, recon_depth = model.evaluate_results(image)
        recon = recon_im[0].cpu().numpy()
        depth = recon_depth[0].cpu().numpy()
        plotting.plot_reconstructions(recon[None], depth[None],
                                      im_idx=str(img_idx))
        # the background of the depth as NaN
        mask = np.asarray(masker.image_mask(image_np[None])).reshape(
            -1, depth.shape[0], depth.shape[1])[0]
        plotting.plot_3d_depth(np.where(mask > 0.5, depth, np.nan),
                               image=image_np, img_idx=img_idx)
        rec = {"image": img_idx, "recon": recon, "depth": depth}
        if args.RECORD_LOSS:
            with torch.no_grad():
                loss, _ = model.forward_step1(image)
            rec["loss"] = float(loss)
            log.info("image %d step-1 loss: %.5f", img_idx, rec["loss"])
        records.append(rec)

    if records:
        plotting.plot_originals_v_reconstructions(
            [dataset[r["image"]] for r in records],
            [r["recon"] for r in records])
    losses = [r["loss"] for r in records if "loss" in r]
    if args.RECORD_LOSS and losses:
        plotting.plot_loss_distribution(losses)
        np.save("results/step1_losses.npy", np.asarray(losses))
        print(f"step-1 loss mean={np.mean(losses):.5f} "
              f"std={np.std(losses):.5f} over {len(losses)} images")
    if args.GALLERY:
        out = plotting.make_gallery()
        if out:
            print(f"gallery written to {out}")
    return records


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resolve_device(args.DEVICE)  # before the config and the data
    run(config_from_args(args), args)


if __name__ == "__main__":
    sys.exit(main())
