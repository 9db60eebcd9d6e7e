"""Depth-shape priors for the depth-net pretraining target, in numpy (one
host-side preprocessing step per image): box, masked_box, smoothed_box,
ellipsoid, confidence, smoothed_confidence.

The masks come from `core.masking.make_masking_model`: the segmentation
net when the category's parsing checkpoint exists, else the deterministic
center-ellipse `FallbackMasker` (the `box` prior needs none).
"""

import math

import numpy as np


def get_mask_range(mask):
    """Bounding box of a boolean mask: (max_y, min_y, max_x, min_x)."""
    ys, xs = np.nonzero(mask)
    return ys.max(), ys.min(), xs.max(), xs.min()


class FallbackMasker:
    """Center-ellipse confidence mask in [0, 1]."""

    def __init__(self, image_size):
        self.image_size = image_size

    def confidence_mask(self, image):
        s = self.image_size
        yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        cy = cx = (s - 1) / 2
        d = np.sqrt(((yy - cy) / (0.45 * s)) ** 2
                    + ((xx - cx) / (0.38 * s)) ** 2)
        return np.clip(1.5 - d, 0.0, 1.0)[None].astype(np.float32)

    def image_mask(self, image):
        return (self.confidence_mask(image) > 0.5).astype(np.float32)


class PriorGenerator:
    """Callable: image (C, H, W) or (1, C, H, W) in [-1, 1] -> depth prior
    (1, H, W) float32.  Without `masking_model`, the masker of
    `make_masking_model` (its net on `device`)."""

    def __init__(self, image_size, category, prior, noise_threshold=0.7,
                 near=0.91, far=1.02, masking_model=None, device=None):
        if not hasattr(self, f"_{prior}_prior"):
            raise NotImplementedError(f"unknown prior: {prior}")
        self.image_size = image_size
        self.category = category
        self.prior = prior
        self.noise_threshold = noise_threshold
        self.near = near
        self.far = far
        self.base_prior = np.full((1, image_size, image_size), far,
                                  np.float32)
        if masking_model is None:
            masking_model = FallbackMasker(image_size)
        self.masking_model = masking_model

    def __call__(self, image):
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[None]
        return np.asarray(getattr(self, f"_{self.prior}_prior")(image),
                          np.float32)

    def _box_prior(self, _):
        s = self.image_size
        cx = cy = s // 2
        bh, bw = int(s * 0.25), int(s * 0.4)
        prior = np.zeros((1, s, s), np.float32)
        prior[0, cx - bw:cx + bw, cy - bh:cy + bh] = 1
        return prior

    def _masked_box_prior(self, image):
        mask = np.asarray(self.masking_model.image_mask(image))
        mask = mask.reshape(-1, self.image_size, self.image_size)[0:1]
        mask = np.where(mask < self.noise_threshold, 0.0, mask)
        mask = (mask - self.noise_threshold) / (1 - self.noise_threshold)
        return self.far - self.base_prior * mask

    def _smooth(self, prior):
        """Three 11x11 normalised-box correlations, each rescaled to
        [near, far] and far-padded back to size."""
        k, pad, n_convs = 11, 5, 3
        filt = np.ones((k, k), np.float32)
        filt /= np.linalg.norm(filt)
        p = prior[0]
        for _ in range(n_convs):
            n = p.shape[0] - k + 1
            out = np.zeros((n, n), np.float32)
            for i in range(k):
                for j in range(k):
                    out += p[i:i + n, j:j + n] * filt[i, j]
            out = self.near + (out - out.min()) * (self.far - self.near) \
                / max(out.max() - out.min(), 1e-12)
            p = np.pad(out, pad, constant_values=self.far)
        return p[None]

    def _smoothed_box_prior(self, image):
        return self._smooth(self._masked_box_prior(image))

    def _ellipsoid_prior(self, image):
        radius = 0.4
        s = self.image_size
        mask = np.asarray(self.masking_model.image_mask(image))
        mask = mask.reshape(-1, s, s)[0] >= self.noise_threshold
        if not mask.any():
            mask = np.ones_like(mask)
        max_y, min_y, max_x, min_x = get_mask_range(mask)
        r_pixel = (max_x - min_x) / 2
        ratio = (max_y - min_y) / max(max_x - min_x, 1)
        c_x = (max_x + min_x) / 2
        c_y = (max_y + min_y) / 2
        i, j = np.meshgrid(np.linspace(0, s - 1, s), np.linspace(0, s - 1, s),
                           indexing="ij")
        i = (i - s / 2) / ratio + s / 2
        temp = math.sqrt(radius ** 2 - (radius - (self.far - self.near)) ** 2)
        dist = np.sqrt((i - c_y) ** 2 + (j - c_x) ** 2)
        area = dist <= r_pixel
        dist_rescale = dist / max(r_pixel, 1e-12) * temp
        depth = radius - np.sqrt(
            np.abs(radius ** 2 - dist_rescale ** 2)) + self.near
        prior = self.base_prior.copy()
        prior[0, area] = depth[area]
        return prior

    def _confidence_prior(self, image):
        mask = np.asarray(self.masking_model.confidence_mask(image))
        mask = mask.reshape(-1, self.image_size, self.image_size)[0:1]
        return self.far - self.base_prior * mask

    def _smoothed_confidence_prior(self, image):
        return self._smooth(self._confidence_prior(image))
