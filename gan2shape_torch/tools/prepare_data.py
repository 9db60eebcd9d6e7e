"""Prepare the multi-resolution record cache for StyleGAN2 training.

Walks an image folder, resizes each image's shortest side to every requested
size (LANCZOS by default) and centre-crops it, and writes one flat uint8 CHW
record file per size plus `meta.json`, which
`gan2shape_torch.core.dataset.MultiResolutionDataset` reads through the
native mmap cache.  The files are those of the JAX package's
tools/prepare_data.py, byte for byte.  With n_worker > 1 the workers are
spawned, so a script that calls `prepare` guards its entry with
`if __name__ == "__main__"`.

    python -m gan2shape_torch.tools.prepare_data --out data/gan_cache \\
        --size 128,256 --n_worker 8 path/to/images
"""

import argparse
import json
import multiprocessing
import os
from functools import partial

import numpy as np

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def find_images(root):
    """Sorted recursive listing of the image files under `root`."""
    files = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if os.path.splitext(name)[1].lower() in IMG_EXTS:
                files.append(os.path.join(dirpath, name))
    return sorted(files)


def resize_and_convert(img, size, resample):
    """Shortest side to `size`, centre crop; returns CHW uint8."""
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, round(w * scale)),
                      max(size, round(h * scale))), resample)
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, np.uint8).transpose(2, 0, 1)


def resize_worker(item, sizes, resample):
    from PIL import Image
    i, file = item
    with Image.open(file) as img:
        img = img.convert("RGB")
        out = [resize_and_convert(img, size, resample) for size in sizes]
    return i, out


def prepare(out_dir, files, n_worker, sizes, resample):
    """Write `{size}.bin` for every size (record i at offset i * 3 * size²,
    so workers may finish in any order) and `meta.json`."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(files)
    outs = {}
    for size in sizes:
        f = open(os.path.join(out_dir, f"{size}.bin"), "wb+")
        f.truncate(n * 3 * size * size)
        outs[size] = f

    work = list(enumerate(files))
    fn = partial(resize_worker, sizes=sizes, resample=resample)
    done = 0
    # spawned, not forked: a caller that has run torch holds its threads
    # (and maybe a CUDA context), which a forked child inherits mid-state
    pool = (multiprocessing.get_context("spawn").Pool(n_worker)
            if n_worker > 1 else None)
    try:
        it = pool.imap_unordered(fn, work) if pool else map(fn, work)
        for i, imgs in it:
            for size, img in zip(sizes, imgs):
                outs[size].seek(i * 3 * size * size)
                outs[size].write(img.tobytes())
            done += 1
            if done % 100 == 0 or done == n:
                print(f"\r{done}/{n}", end="", flush=True)
        print()
    finally:
        if pool is not None:
            pool.close()
            pool.join()
        for f in outs.values():
            f.close()
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"length": n, "sizes": sizes, "layout": "chw_uint8"}, f)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Preprocess images for GAN training")
    parser.add_argument("--out", type=str, required=True,
                        help="output cache directory")
    parser.add_argument("--size", type=str, default="128,256,512,1024",
                        help="comma-separated resolutions")
    parser.add_argument("--n_worker", type=int, default=8)
    parser.add_argument("--resample", type=str, default="lanczos",
                        choices=["lanczos", "bilinear"])
    parser.add_argument("path", type=str, help="path to the image folder")
    return parser.parse_args(argv)


def main(argv=None):
    from PIL import Image

    args = parse_args(argv)
    resample = {"lanczos": Image.LANCZOS,
                "bilinear": Image.BILINEAR}[args.resample]
    sizes = [int(s.strip()) for s in args.size.split(",")]
    files = find_images(args.path)
    if not files:
        raise SystemExit(f"no images under {args.path}")
    print(f"Make dataset of image sizes: {', '.join(map(str, sizes))} "
          f"({len(files)} images)")
    prepare(args.out, files, args.n_worker, sizes, resample)


if __name__ == "__main__":
    main()
