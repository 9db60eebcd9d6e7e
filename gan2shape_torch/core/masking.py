"""The masking model of the priors and the evaluation.

The segmentation nets (BiSeNet for faces, PSPNet-50 otherwise) are not
ported yet (ROADMAP A5).  Without a parsing checkpoint the JAX package falls
back to the deterministic `FallbackMasker`, and so does the port; with one,
the JAX package would use the network, so the port refuses rather than
quietly giving other masks.
"""

import logging
from os import path

from gan2shape_torch.core.priors import FallbackMasker

log = logging.getLogger(__name__)


def make_masking_model(category, image_size=128,
                       ckpt_dir="checkpoints/parsing"):
    ckpt = path.join(ckpt_dir, "bisenet.pth" if category == "face"
                     else "pspnet_voc.pth")
    if path.exists(ckpt):
        raise NotImplementedError(
            f"{ckpt} exists, but the segmentation nets that read it are not "
            "ported yet (ROADMAP A5); move it away to run with the fallback "
            "masker")
    log.warning("segmentation masker unavailable (no segmentation checkpoint "
                "at %s); using fallback", ckpt)
    return FallbackMasker(image_size)
