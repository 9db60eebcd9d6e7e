"""Project images into a StyleGAN2 generator's latent space.

The JAX package's tools/project.py: same flags and outputs.  Each input is
resized (shortest side, LANCZOS) and centre-cropped to min(--size, 256);
the projector fits a w (--w_plus: W+) latent and the noise maps for
--step steps against LPIPS-VGG.  Outputs: `<name>-project.png` in the
working directory for each input, and in a `latents/` folder beside the
first input `<first input name>.npz` (`<stem>_latent`, `<stem>_img` per
input, `noise_<k>` per layer) and `<input name>.npy` per input, the latent
alone, which `gan2shape_torch.core.dataset.load_latent` reads.  Without
--vgg_ckpt / --lpips_ckpt files LPIPS has seeded random weights.

    python -m gan2shape_torch.tools.project --ckpt checkpoint.pt \\
        --size 256 img1.png img2.png
"""

import argparse
import os

import numpy as np
import torch

from gan2shape_torch.tools.generate import load_generator, save_png

LPIPS_SEED = 1


def load_image(path, size):
    """Shortest side to `size` (LANCZOS), centre crop, to [-1, 1] CHW."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = size / min(w, h)
        im = im.resize((max(size, round(w * scale)),
                        max(size, round(h * scale))), Image.LANCZOS)
        w, h = im.size
        left, top = (w - size) // 2, (h - size) // 2
        im = im.crop((left, top, left + size, top + size))
        arr = np.asarray(im, np.float32) / 255.0
    return arr.transpose(2, 0, 1) * 2.0 - 1.0


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Image projector to the generator latent spaces")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--lr_rampup", type=float, default=0.05)
    parser.add_argument("--lr_rampdown", type=float, default=0.25)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--noise", type=float, default=0.05)
    parser.add_argument("--noise_ramp", type=float, default=0.75)
    parser.add_argument("--step", type=int, default=1000)
    parser.add_argument("--noise_regularize", type=float, default=1e5)
    parser.add_argument("--mse", type=float, default=0)
    parser.add_argument("--w_plus", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lpips_ckpt", type=str,
                        default="checkpoints/lpips/vgg.pth")
    parser.add_argument("--vgg_ckpt", type=str,
                        default="checkpoints/vgg/vgg16.pth")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be "
                             "present)")
    parser.add_argument("files", metavar="FILES", nargs="+")
    return parser.parse_args(argv)


def build_lpips(vgg_ckpt, lpips_ckpt, device):
    """LPIPS-VGG from the reference files, or seeded random weights."""
    from gan2shape_torch.convert.reference import load_lpips
    from gan2shape_torch.models.layers import reset_parameters
    from gan2shape_torch.models.lpips import LPIPS

    lpips = LPIPS()
    if os.path.exists(vgg_ckpt) and os.path.exists(lpips_ckpt):
        load_lpips(lpips, vgg_ckpt, lpips_ckpt)
    else:
        print(">>> LPIPS weights not found — random-feature perceptual "
              "distance (run download_data.py for the real assets) <<<")
        reset_parameters(lpips, torch.Generator().manual_seed(LPIPS_SEED))
    return lpips.to(device).eval()


def run(args):
    """Project the files; returns the projector's result."""
    from gan2shape_torch.projector import Projector

    resize = min(args.size, 256)
    gen = load_generator(args.ckpt, args.size, args.channel_multiplier,
                         args.device)
    device = gen.input.input.device
    imgs = torch.as_tensor(np.stack([load_image(f, resize)
                                     for f in args.files]), device=device)
    lpips = build_lpips(args.vgg_ckpt, args.lpips_ckpt, device)
    proj = Projector(gen, lpips, w_plus=args.w_plus, lr=args.lr,
                     noise=args.noise, noise_ramp=args.noise_ramp,
                     noise_regularize_weight=args.noise_regularize,
                     mse_weight=args.mse, lr_rampup=args.lr_rampup,
                     lr_rampdown=args.lr_rampdown)

    def report(rec):
        print(f"step {rec['step']}: perceptual: {rec['perceptual']:.4f}; "
              f"noise regularize: {rec['noise_regularize']:.6f}; "
              f"mse: {rec['mse']:.4f}; lr: {rec['lr']:.4f}")

    result = proj.project(torch.Generator(device).manual_seed(args.seed),
                          imgs, steps=args.step, progress=report)

    out_dir = os.path.join(os.path.dirname(args.files[0]) or ".", "latents")
    os.makedirs(out_dir, exist_ok=True)
    latent = result["latent"].cpu().numpy()
    image = result["image"].cpu().numpy()
    payload = {}
    for i, input_name in enumerate(args.files):
        stem = os.path.splitext(os.path.basename(input_name))[0]
        save_png(image[i], f"{stem}-project.png")
        payload[f"{stem}_latent"] = latent[i]
        payload[f"{stem}_img"] = image[i]
        np.save(os.path.join(
            out_dir, os.path.basename(input_name) + ".npy"), latent[i])
    for k, nz in enumerate(result["noises"]):
        payload[f"noise_{k}"] = nz.cpu().numpy()
    np.savez(os.path.join(
        out_dir, os.path.basename(args.files[0]) + ".npz"), **payload)
    print("saved latents to", out_dir)
    return result


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
