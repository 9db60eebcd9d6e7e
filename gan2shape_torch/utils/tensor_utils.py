"""Small tensor helpers, the counterpart of the JAX package's
utils/tensor_utils.py (the reference's renderer/utils.py and utils.py).
The random ones draw from an explicit `torch.Generator` where JAX takes a
key; each result lies on the generator's device."""

import torch


def mm_normalize(x, min=0.0, max=1.0):
    """Min-max normalize to [min, max]."""
    x_min = torch.min(x)
    x_max = torch.max(x)
    x_z = (x - x_min) / torch.clamp_min(x_max - x_min, 1e-12)
    return x_z * (max - min) + min


def rand_range(generator, size, min, max):
    """Uniform in [min, max)."""
    return torch.rand(size, generator=generator,
                      device=generator.device) * (max - min) + min


def rand_posneg_range(generator, size, min, max):
    """Uniform magnitude in [min, max) with a random sign."""
    sign = (torch.rand(size, generator=generator, device=generator.device)
            > 0.5).float() * 2 - 1
    return sign * rand_range(generator, size, min, max)


def get_grid(b, h, w, normalize=True):
    """(b, h, w, 2) (x, y) pixel grid, y down: in [-1, 1] when `normalize`,
    else integer pixel coordinates."""
    if normalize:
        h_range = torch.linspace(-1, 1, h)
        w_range = torch.linspace(-1, 1, w)
    else:
        h_range = torch.arange(0, h, dtype=torch.float32)
        w_range = torch.arange(0, w, dtype=torch.float32)
    yy, xx = torch.meshgrid(h_range, w_range, indexing="ij")
    return torch.stack([xx, yy], -1)[None].expand(b, h, w, 2)


def get_mask_range(mask):
    """Bounding box (max_y, min_y, max_x, min_x) of a (H, W) boolean mask;
    (-1, H, -1, W) for an empty one."""
    h, w = mask.shape
    ys = torch.any(mask, dim=1)
    xs = torch.any(mask, dim=0)
    idx_y = torch.arange(h, device=mask.device)
    idx_x = torch.arange(w, device=mask.device)
    return (torch.max(torch.where(ys, idx_y, -1)),
            torch.min(torch.where(ys, idx_y, h)),
            torch.max(torch.where(xs, idx_x, -1)),
            torch.min(torch.where(xs, idx_x, w)))
