"""Sample images and their w latents from a trained StyleGAN2 generator.

Reads the `g_ema` of a reference-layout `.pt` checkpoint (a released
StyleGAN2 file or one that `gan2shape_torch.tools.train_gan` wrote), draws
z ~ N(0, 1) in --pics batches of --sample, maps and truncates toward the
mean of --truncation_mean mapped draws, and writes each image to
`{save_path}/{count:06d}.png` and its truncated w to
`{save_path}/latents/{count:06d}.npy` (the latent the GAN2Shape dataset
reads).  The noise maps are drawn once per run from --seed.

    python -m gan2shape_torch.tools.generate --ckpt checkpoint/000000.pt \\
        --size 256 --pics 20 --truncation 0.7
"""

import argparse
import os

import numpy as np
import torch


def load_generator(ckpt_path, size, channel_multiplier, device=None):
    """The `g_ema` of a reference-layout checkpoint as a frozen Generator on
    `device` (default CUDA)."""
    from gan2shape_torch.convert.reference import (
        load_reference_state_dict, load_torch_file,
    )
    from gan2shape_torch.device import resolve_device
    from gan2shape_torch.models.stylegan2 import Generator

    device = resolve_device(device)
    gen = Generator(size, style_dim=512, n_mlp=8,
                    channel_multiplier=channel_multiplier)
    load_reference_state_dict(gen, load_torch_file(ckpt_path)["g_ema"],
                              f"{ckpt_path} g_ema")
    return gen.to(device).eval().requires_grad_(False)


def save_png(img_chw, path):
    """A (3, H, W) image in [-1, 1] as an 8-bit PNG."""
    from PIL import Image

    arr = np.clip((np.asarray(img_chw) + 1) * 0.5, 0, 1)
    arr = (arr.transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Generate GAN samples")
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--sample", type=int, default=1,
                        help="samples per batch")
    parser.add_argument("--pics", type=int, default=20,
                        help="number of batches")
    parser.add_argument("--truncation", type=float, default=0.7)
    parser.add_argument("--truncation_mean", type=int, default=4096)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save_path", type=str, default="sample")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be "
                             "present)")
    return parser.parse_args(argv)


@torch.no_grad()
def run(args):
    """Write the samples; returns the number written."""
    gen = load_generator(args.ckpt, args.size, args.channel_multiplier,
                         args.device)
    os.makedirs(os.path.join(args.save_path, "latents"), exist_ok=True)
    device = gen.input.input.device
    rng = torch.Generator(device).manual_seed(args.seed)
    mean_latent = None
    if args.truncation < 1:
        mean_latent = gen.mean_latent(args.truncation_mean, rng)
    noise = gen.make_noise(rng, device)

    count = 0
    for _ in range(args.pics):
        z = torch.randn(args.sample, 512, generator=rng, device=device)
        w = gen.style_forward(z)
        img, _ = gen([w], noise, input_is_w=True,
                     truncation=args.truncation,
                     truncation_latent=mean_latent)
        # the saved latent is the truncated w
        if mean_latent is not None:
            w = mean_latent + args.truncation * (w - mean_latent)
        img, w = img.cpu().numpy(), w.cpu().numpy()
        for j in range(args.sample):
            stem = str(count).zfill(6)
            save_png(img[j], os.path.join(args.save_path, f"{stem}.png"))
            np.save(os.path.join(args.save_path, "latents", f"{stem}.npy"),
                    w[j])
            count += 1
        print(f"\r{count}/{args.pics * args.sample}", end="", flush=True)
    print()
    return count


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
