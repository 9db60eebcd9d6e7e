"""Host-side data: images and their per-image GAN w-latents.

A dataset folder holds a `list.txt` manifest (one file name per line, the
first CSV field), the images, and `latents/<name>.pt` (a torch tensor, a
dict with a "latent" entry, or a dict of such dicts) or a `.npy` sibling,
which wins when both exist.  Images are decoded by PIL, resized bilinearly to
`image_size` and scaled to [-1, 1].

Items are numpy arrays (image (3, H, W) float32, latent (512,) float32);
the trainer moves them to its device.

`MultiResolutionDataset` is the StyleGAN2 trainer's data: the record files
that `gan2shape_torch.tools.prepare_data` writes, read through the native
mmap cache (gan2shape_torch/native).
"""

import json
from os import path

import numpy as np
import torch


def _read_list(root_dir, list_filename):
    with open(path.join(root_dir, list_filename)) as f:
        return [line.strip().split(",")[0] for line in f if line.strip()]


def load_image(img_path, image_size):
    from PIL import Image
    with Image.open(img_path) as im:
        im = im.convert("RGB")
        if im.size != (image_size, image_size):
            im = im.resize((image_size, image_size), Image.BILINEAR)
        arr = np.asarray(im, np.float32) / 255.0
    return arr.transpose(2, 0, 1) * 2.0 - 1.0


def load_latent(latent_path):
    npy = latent_path.rsplit(".", 1)[0] + ".npy"
    if path.exists(npy):
        latent = np.load(npy)
    else:
        latent = torch.load(latent_path, map_location="cpu",
                            weights_only=False)
        if isinstance(latent, dict):
            if "latent" not in latent:
                latent = latent.popitem()[1]
            latent = latent["latent"]
        latent = latent.detach().numpy()
    latent = np.asarray(latent, np.float32)
    if latent.ndim == 2 and latent.shape[0] == 1:
        latent = latent[0]
    return latent


class ImageDataset:
    def __init__(self, root_dir, list_filename="list.txt", image_size=128,
                 subset=None):
        self.root_dir = root_dir
        self.image_size = image_size
        try:
            self.file_list = _read_list(root_dir, list_filename)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"{e}\nDid you forget to run download_data.py?") from e
        if subset is not None:
            self.file_list = [self.file_list[i] for i in subset]

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index):
        return load_image(path.join(self.root_dir, self.file_list[index]),
                          self.image_size)


class LatentDataset:
    def __init__(self, root_dir, list_filename="list.txt",
                 latent_folder="latents", subset=None):
        self.root_dir = root_dir
        self.latent_folder = latent_folder
        self.file_list = _read_list(root_dir, list_filename)
        if subset is not None:
            self.file_list = [self.file_list[i] for i in subset]

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index):
        name = self.file_list[index].split(".")[0] + ".pt"
        return load_latent(path.join(self.root_dir, self.latent_folder, name))


class ImageLatentDataset:
    """(image, w latent, index) triples."""

    def __init__(self, root_dir, list_filename="list.txt", image_size=128,
                 latent_folder="latents", subset=None):
        self.image_dataset = ImageDataset(root_dir, list_filename, image_size,
                                          subset)
        self.latent_dataset = LatentDataset(root_dir, list_filename,
                                            latent_folder, subset)
        if len(self.image_dataset) != len(self.latent_dataset):
            raise ValueError("images and latents differ in number")

    def __len__(self):
        return len(self.image_dataset)

    def __getitem__(self, index):
        return (self.image_dataset[index], self.latent_dataset[index], index)


class MultiResolutionDataset:
    """A prepared folder: `meta.json` ({"length", "sizes", "layout"}) and one
    flat uint8 CHW record file `{res}.bin` per resolution.  Batches are CPU
    float32 tensors in [-1, 1]."""

    def __init__(self, root, resolution=256):
        from gan2shape_torch.native import TensorCache

        try:
            with open(path.join(root, "meta.json")) as f:
                meta = json.load(f)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"{e}\nRun gan2shape_torch.tools.prepare_data to build the "
                f"cache") from e
        if resolution not in meta["sizes"]:
            raise ValueError(f"resolution {resolution} not in prepared "
                             f"sizes {meta['sizes']}")
        self.resolution = resolution
        self.length = int(meta["length"])
        self.cache = TensorCache(path.join(root, f"{resolution}.bin"),
                                 self.length, (3, resolution, resolution),
                                 "uint8")

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        return self.get_batch([index])[0]

    def get_batch(self, indices, flip=None):
        """Records `indices`; `flip` is an optional boolean mask of samples
        to mirror horizontally (the reference's RandomHorizontalFlip)."""
        batch = self.cache.get_batch(indices)
        if flip is not None:
            flip = np.asarray(flip, bool)
            batch[flip] = batch[flip][..., ::-1]
        return torch.from_numpy(batch)
