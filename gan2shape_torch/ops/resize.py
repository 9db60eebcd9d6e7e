"""Image resize as two matrix products: bilinear (align_corners=False) when
growing, area (adaptive average) when shrinking — the reference's
F.interpolate modes — and align_corners=True bilinear."""

from functools import lru_cache

import numpy as np
import torch


def _interp_matrix(src, in_size, out_size):
    x0 = np.floor(src)
    frac = src - x0
    i0 = np.clip(x0, 0, in_size - 1).astype(np.int64)
    i1 = np.clip(x0 + 1, 0, in_size - 1).astype(np.int64)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), (1.0 - frac).astype(np.float32))
    np.add.at(m, (rows, i1), frac.astype(np.float32))
    return m


@lru_cache(maxsize=None)
def _bilinear_matrix(in_size, out_size):
    dst = np.arange(out_size, dtype=np.float64)
    return _interp_matrix((dst + 0.5) * (in_size / out_size) - 0.5, in_size,
                          out_size)


@lru_cache(maxsize=None)
def _bilinear_ac_matrix(in_size, out_size):
    if out_size == 1:
        m = np.zeros((1, in_size), np.float32)
        m[0, 0] = 1.0
        return m
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    return _interp_matrix(src, in_size, out_size)


@lru_cache(maxsize=None)
def _area_matrix(in_size, out_size):
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = int(np.floor(i * in_size / out_size))
        end = int(np.ceil((i + 1) * in_size / out_size))
        m[i, start:end] = 1.0 / (end - start)
    return m


def _apply_separable(x, mh, mw):
    mh = torch.as_tensor(mh, device=x.device, dtype=x.dtype)
    mw = torch.as_tensor(mw, device=x.device, dtype=x.dtype)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def resize(image, size):
    """Resize (..., H, W) to `size` = (new_h, new_w): bilinear when growing,
    area when shrinking (decided on H), identity when equal."""
    h, w = image.shape[-2], image.shape[-1]
    nh, nw = int(size[0]), int(size[1])
    if nh == h and nw == w:
        return image
    if nh > h:
        return _apply_separable(image, _bilinear_matrix(h, nh),
                                _bilinear_matrix(w, nw))
    return _apply_separable(image, _area_matrix(h, nh), _area_matrix(w, nw))


def resize_bilinear_align_corners(image, size):
    h, w = image.shape[-2], image.shape[-1]
    nh, nw = int(size[0]), int(size[1])
    if nh == h and nw == w:
        return image
    return _apply_separable(image, _bilinear_ac_matrix(h, nh),
                            _bilinear_ac_matrix(w, nw))


def crop(tensor, crop_size):
    """Center crop on the last two axes."""
    margin = (tensor.shape[-2] - crop_size) // 2
    return tensor[..., margin:margin + crop_size, margin:margin + crop_size]
