"""The masking model of the priors and the evaluation: a frozen
segmentation net on the model's device, and the mask logic in numpy around
it.

face -> BiSeNet face parser (19 classes, input 512²);
other categories -> PSPNet-50 (21 VOC classes, input 473²).

Weights come from the reference's checkpoints
(`checkpoints/parsing/{bisenet,pspnet_voc}.pth`).  Without the file,
`make_masking_model` gives the deterministic `FallbackMasker`, as the JAX
package does; a file that exists but does not load is an error (the JAX
package falls back on any error, which turns a broken weights file into a
centre ellipse without a word).
"""

import logging
from os import path

import numpy as np
import torch

from gan2shape_torch.core.priors import FallbackMasker
from gan2shape_torch.device import resolve_device
from gan2shape_torch.models.segmentation import BiSeNet, PSPNet
from gan2shape_torch.ops.resize import resize

log = logging.getLogger(__name__)

CATEGORIES = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
              "car", "cat", "chair", "cow", "diningtable", "dog",
              "horse", "motorbike", "person", "pottedplant",
              "sheep", "sofa", "train", "tvmonitor"]
CATEGORY2NUMBER = {c: i + 1 for i, c in enumerate(CATEGORIES)}


def checkpoint_path(category, ckpt_dir="checkpoints/parsing"):
    return path.join(ckpt_dir, "bisenet.pth" if category == "face"
                     else "pspnet_voc.pth")


def strip_module(state_dict):
    """A state_dict without the `module.` prefix of a DataParallel save."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_parsing_checkpoint(filename):
    """The state_dict of a reference parsing checkpoint (bare, or under
    "state_dict")."""
    sd = torch.load(filename, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{filename} holds no state_dict")
    return strip_module(sd)


def _np(t):
    return t.detach().cpu().numpy()


class MaskingModel:
    """`confidence_mask` (soft, [0, 1]) and `image_mask` (hard, or with
    `depth` the depth NaN'd outside the mask) of images (3, H, W) or
    (1, 3, H, W) in [-1, 1], at `image_size`.  `state_dict` injects
    weights instead of reading `ckpt_dir`."""

    def __init__(self, category, image_size=128,
                 ckpt_dir="checkpoints/parsing", state_dict=None,
                 device=None):
        self.category = category
        self.image_size = image_size
        self.device = resolve_device(device)
        self.net_size = 512 if category == "face" else 473
        self.net = BiSeNet(n_classes=19) if category == "face" \
            else PSPNet(classes=21)
        if state_dict is None:
            ckpt = checkpoint_path(category, ckpt_dir)
            state_dict = load_parsing_checkpoint(ckpt)
            log.info("loaded segmentation weights from %s", ckpt)
        self.net.load_state_dict(strip_module(state_dict))
        self.net.to(self.device)

    @torch.no_grad()
    def logits(self, image):
        """Net logits (B, classes, net_size, net_size) on the host."""
        image = torch.as_tensor(np.asarray(image, np.float32),
                                device=self.device)
        if image.dim() == 3:
            image = image[None]
        image = resize(image, (self.net_size, self.net_size))
        return _np(self.net(image))

    def _to_image_size(self, mask):
        s = self.image_size
        return _np(resize(torch.as_tensor(mask), (s, s)))[0]

    def confidence_mask(self, image, depth=None):
        out = self.logits(image)
        if self.category in CATEGORIES:
            n = CATEGORY2NUMBER[self.category]
            mask = out[:, n:n + 1]
        elif self.category == "face":
            mask = out[:, 1:13].sum(1, keepdims=True)
        else:
            mask = np.ones_like(out[:, 0:1])
        mask = mask - mask.min()
        mask = mask / max(mask.max(), 1e-12)
        return self._to_image_size(mask)

    def image_mask(self, image, depth=None):
        out = self.logits(image)
        if self.category in CATEGORIES:
            lab = out.argmax(1)[:, None]
            mask = lab == CATEGORY2NUMBER[self.category]
        elif self.category == "face":
            out = np.concatenate([out[:, :17], out[:, 18:]], 1)
            lab = out.argmax(1)[:, None]
            mask_all = (lab >= 1) == (lab != 16)
            mask_face = (lab >= 1) == (lab <= 13)
            mask = mask_all & mask_face
        else:
            mask = np.ones_like(out[:, 0:1], bool)
        if not mask.any():
            log.warning("did not find any %s in image", self.category)
            mask = np.ones_like(mask)
        if depth is not None:
            depth = _np(resize(torch.as_tensor(np.asarray(depth, np.float32)),
                               (self.net_size, self.net_size))).copy()
            depth[~mask[0]] = np.nan
            mask = depth
        return self._to_image_size(mask.astype(np.float32))


def make_masking_model(category, image_size=128,
                       ckpt_dir="checkpoints/parsing", device=None):
    """A MaskingModel on `device` when the category's parsing checkpoint
    exists (an unreadable one raises), else the FallbackMasker."""
    ckpt = checkpoint_path(category, ckpt_dir)
    if path.exists(ckpt):
        return MaskingModel(category, image_size, ckpt_dir, device=device)
    log.warning("segmentation masker unavailable (no segmentation checkpoint "
                "at %s); using fallback", ckpt)
    return FallbackMasker(image_size)
