"""One command from the GAN2Shape release assets to the method's deliverable
on the port, the counterpart of the JAX package's tools/run_real_assets.py.

Given the release files under --root (the pretrained StyleGAN2 of the
category, torchvision's VGG16, the LPIPS heads, the view / light MVNs and a
data/<category> folder of images and latents), this reconstructs one real
image with the category's config: `Trainer.fit` over the full instance
schedule (or, with --fast, prior 50 + {20, 20, 20}), then the evaluated
depth map, the reconstruction plot and the rotating 3-D depth view.  The
files load through `convert/reference.py`'s `build_frozen_assets`.

    python -m gan2shape_torch.tools.run_real_assets --category face
    python -m gan2shape_torch.tools.run_real_assets --category face --fast
    python -m gan2shape_torch.tools.run_real_assets --root /data/g2s --fast

Everything is read and written relative to --root (default: the repository
root): results/real_assets/<category>/ gets depth.npy and REAL_ASSETS.json
(losses, wall-clock, depth statistics, and the depth-MAD against a trained
checkpoint of the port's format when checkpoints/our_nets holds one),
results/plots and results/htmls the plots.  The summary goes to --out
(default <root>/build/run_real_torch.json, never the JAX tool's
RUN_REAL.json).

With files missing it prints the itemised list, writes the summary with
"skipped": true and exits 2.  The port fetches nothing: the files come from
`python download_data.py` on a connected machine, or a copied tree.
"""

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]

GAN_CKPTS = {  # the reference configs' gan_ckpt_path per category
    "face": "checkpoints/stylegan2/stylegan2-celeba-config-e.pt",
    "cat": "checkpoints/stylegan2/stylegan2-cat-config-f.pt",
    "car": "checkpoints/stylegan2/stylegan2-car-config-e.pt",
    "church": "checkpoints/stylegan2/stylegan2-church-config-e.pt",
}
FAST_PRIOR = 50
FAST_STAGES = [{"step1": 20, "step2": 20, "step3": 20}]


def required_assets(category):
    """(path, purpose) for everything the real run needs."""
    return [
        (GAN_CKPTS.get(category, GAN_CKPTS["face"]),
         "pretrained StyleGAN2 g_ema/d (reference model.py:31-35)"),
        ("checkpoints/view_light/view_mvn.pth",
         "view MVN stats (reference model.py:449-456)"),
        ("checkpoints/view_light/light_mvn.pth",
         "light MVN stats (reference model.py:449-456)"),
        ("checkpoints/vgg/vgg16.pth",
         "VGG16 backbone for LPIPS (reference lpips/pretrained_networks.py)"),
        ("checkpoints/lpips/vgg.pth",
         "LPIPS linear heads v0.1 (reference lpips/dist_model.py:71-75)"),
        (os.path.join("data", category, "list.txt"),
         "real images + latents (reference dataset.py)"),
    ]


def missing_assets(category, root=REPO):
    return [(p, why) for p, why in required_assets(category)
            if not os.path.exists(os.path.join(root, p))]


def _write(out, payload):
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)


def reconstruct(args):
    """The present path, run in the asset root.  Returns the result
    record."""
    from gan2shape_torch.convert.reference import build_frozen_assets
    from gan2shape_torch.core.checkpoint import CheckpointManager, load_nets
    from gan2shape_torch.core.dataset import ImageLatentDataset
    from gan2shape_torch.core.trainer import Trainer
    from gan2shape_torch.device import resolve_device, synchronize
    from gan2shape_torch.tools.full_instance_run import FULL_STAGES
    from gan2shape_torch.utils import plotting
    from gan2shape_torch.utils.config import load_config

    device = resolve_device(args.device)  # before any file is read
    config = load_config(category=args.category,
                         config_dir=str(REPO / "configs"),
                         minimal_config=str(REPO / "minimal_config.yml"))
    out_dir = os.path.join("results", "real_assets", args.category)
    os.makedirs(out_dir, exist_ok=True)
    data = ImageLatentDataset(os.path.join(config["root_path"],
                                           args.category),
                              image_size=config["image_size"],
                              subset=[args.image])
    if args.fast:
        config["n_epochs_prior"] = FAST_PRIOR
        stages = FAST_STAGES
    else:
        stages = FULL_STAGES

    trainer = Trainer(config, save_ckpts=False, device=device)
    build_frozen_assets(trainer.model, config)

    synchronize(trainer.device)
    t0 = time.perf_counter()
    history = trainer.fit(data, stages=stages)
    synchronize(trainer.device)
    wall = time.perf_counter() - t0

    image = torch.as_tensor(np.asarray(data[0][0]),
                            device=trainer.device)[None]
    with torch.no_grad():
        recon_im, recon_depth = (t.cpu().numpy()
                                 for t in trainer.evaluate(image))
    depth = recon_depth[0]
    np.save(os.path.join(out_dir, "depth.npy"), depth)
    tag = f"real_{args.category}_{args.image}"
    plotting.plot_reconstructions(recon_im, recon_depth, total_it="real",
                                  im_idx=tag)
    plotting.plot_3d_depth(depth, image=recon_im, img_idx=tag)

    result = {
        "category": args.category,
        "image_index": args.image,
        "schedule": "fast" if args.fast else "reference-full",
        "wall_s": round(wall, 1),
        "final_losses": {k: round(float(v), 4)
                         for k, v in history[-1].items()
                         if k.startswith("loss_")},
        "depth_stats": {
            "min": float(depth.min()), "max": float(depth.max()),
            "mean": float(depth.mean()),
            "finite": bool(np.isfinite(depth).all()),
        },
        "artifacts": sorted(os.listdir(out_dir))
        + [f"results/plots/recon_it_real_im_{tag}.png",
           f"results/htmls/depth_{tag}.html"],
    }

    # depth-MAD against a trained checkpoint of the port's format; only its
    # absence is reported, a checkpoint that fails to load raises
    ref_dir = config.get("our_nets_ckpts", {}).get("VLADE_nets")
    if ref_dir and os.path.isdir(ref_dir):
        mgr = CheckpointManager(ref_dir)
        manifests = mgr.select(args.category)
        if not manifests:
            result["depth_mad_vs_reference_ckpt"] = (
                f"unavailable: no checkpoint under {ref_dir}/"
                f"{args.category}")
        else:
            load_nets(trainer.model, mgr.load_manifest(manifests[-1]))
            with torch.no_grad():
                ref_depth = trainer.evaluate(image)[1][0].cpu().numpy()
            result["depth_mad_vs_reference_ckpt"] = float(
                np.abs(depth - ref_depth).mean())

    _write(os.path.join(out_dir, "REAL_ASSETS.json"), result)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--category", default="face")
    parser.add_argument("--image", type=int, default=0,
                        help="dataset index to reconstruct")
    parser.add_argument("--fast", action="store_true",
                        help="smoke-size schedule instead of the full "
                             "reference schedule")
    parser.add_argument("--root", default=str(REPO),
                        help="the asset tree (data/, checkpoints/); results "
                             "are written there too")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--out", default=None,
                        help="the summary JSON (default "
                             "<root>/build/run_real_torch.json)")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    out = os.path.abspath(args.out or os.path.join(root, "build",
                                                   "run_real_torch.json"))

    missing = missing_assets(args.category, root)
    if missing:
        print(f"real-asset run blocked — missing files under {root}:")
        for p, why in missing:
            print(f"  {p}  ({why})")
        print("fetch them with `python download_data.py` on a connected "
              "machine, then rerun this command.")
        _write(out, {"ok": False, "skipped": True,
                     "category": args.category,
                     "missing": [p for p, _ in missing]})
        return 2

    here = os.getcwd()
    os.chdir(root)  # the config's relative paths and results/ live there
    try:
        result = reconstruct(args)
    finally:
        os.chdir(here)
    _write(out, {"ok": True, "skipped": False, **result})
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    sys.exit(main())
