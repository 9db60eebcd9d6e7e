"""The port's depth priors against the JAX package's: every prior of
`PriorGenerator` (box, masked_box, smoothed_box, ellipsoid, confidence,
smoothed_confidence) for every category (face, cat, car, church), at the
configs' image size of 128, on one image.

Both packages take the same deterministic masker (`masking_model=`), so
the test holds the prior logic, not a segmentation net (the nets are held
in test_torch_segmentation.py).  The masker gives church an all-ones mask,
as the segmentation masker does for a category that is not a VOC class,
and the other categories an image-dependent ellipse of their own.  An
empty mask, where no pixel is the category's, must take the all-ones
fallback of the ellipsoid prior in both packages.

Both packages compute the priors in numpy with the same operations, so the
tolerance is none: the priors are bit-equal.
"""

import numpy as np
import pytest

from gan2shape_tpu.core.priors import PriorGenerator as JPriorGenerator

from gan2shape_torch.core.priors import PriorGenerator

S = 128
PRIORS = ["box", "masked_box", "smoothed_box", "ellipsoid", "confidence",
          "smoothed_confidence"]
CATEGORIES = ["face", "cat", "car", "church"]
# the semi-axes of each category's ellipse, as fractions of the image
AXES = {"face": (0.45, 0.38), "cat": (0.40, 0.30), "car": (0.22, 0.46)}


class Masker:
    """A deterministic masker with the interface the priors call: the
    confidence mask an ellipse of the category's axes, its edge softened
    and scaled by the image's brightness; the hard mask that above 0.5.
    `empty` gives masks with no pixel set."""

    def __init__(self, category, empty=False):
        self.category = category
        self.empty = empty

    def confidence_mask(self, image):
        image = np.asarray(image, np.float32).reshape(-1, 3, S, S)
        if self.empty:
            return np.zeros((1, S, S), np.float32)
        if self.category == "church":
            return np.ones((1, S, S), np.float32)
        ay, ax = AXES[self.category]
        yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
        d = np.sqrt(((yy - 0.55 * S) / (ay * S)) ** 2
                    + ((xx - 0.5 * S) / (ax * S)) ** 2)
        light = 0.75 + 0.25 * (image[0].mean(0) + 1) / 2
        return np.clip((1.6 - d) * light, 0.0, 1.0)[None].astype(np.float32)

    def image_mask(self, image):
        return (self.confidence_mask(image) > 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (3, S, S)).astype(np.float32)


def _both(prior, category, masker, image):
    got = PriorGenerator(S, category, prior, masking_model=masker)(image)
    want = np.asarray(JPriorGenerator(S, category, prior,
                                      masking_model=masker)(image))
    return got, want


@pytest.mark.parametrize("category", CATEGORIES)
@pytest.mark.parametrize("prior", PRIORS)
def test_prior_matches_jax(prior, category, image):
    got, want = _both(prior, category, Masker(category), image)
    assert got.dtype == np.float32 and got.shape == (1, S, S)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    if prior.startswith("smoothed"):
        assert got.min() >= 0.91 - 1e-6 and got.max() <= 1.02 + 1e-6
    if prior != "box" and category != "church":
        # the masker's ellipse shows: the prior is not the church's
        other, _ = _both(prior, "church", Masker("church"), image)
        assert np.abs(got - other).max() > 1e-2


@pytest.mark.parametrize("prior", PRIORS)
def test_empty_mask_matches_jax(prior, image):
    got, want = _both(prior, "car", Masker("car", empty=True), image)
    assert got.dtype == np.float32 and got.shape == (1, S, S)
    np.testing.assert_array_equal(got, want)
    if prior == "ellipsoid":
        # the all-ones fallback: the ellipsoid of a mask over the image
        ones, _ = _both(prior, "church", Masker("church"), image)
        np.testing.assert_array_equal(got, ones)
