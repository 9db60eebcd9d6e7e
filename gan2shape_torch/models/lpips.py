"""LPIPS perceptual distance, VGG16 'net-lin' (the GAN2Shape loss):
ScalingLayer -> VGG16 relu1_2..relu5_3 taps -> per-tap unit normalisation
-> squared difference -> 1x1 'lin' heads (no bias) -> spatial mean -> sum.

State names: `vgg.features.{i}.*` (torchvision VGG16 `features`) and
`lin{k}.model.1.weight` (lpips v0.1 heads; index 0 is the dropout slot,
identity at inference)."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan2shape_torch.models.layers import Conv2d, ReLU

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)
VGG_CHNS = (64, 128, 256, 512, 512)
_TAP_AFTER = {3, 8, 15, 22, 29}  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3


class _MaxPool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 2, 2)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        c_in = 3
        for item in _VGG_CFG:
            if item == "M":
                layers.append(_MaxPool())
            else:
                layers += [Conv2d(c_in, item, 3, 1, 1), ReLU()]
                c_in = item
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAP_AFTER:
                taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    def __init__(self, chn_in):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   Conv2d(chn_in, 1, 1, 1, 0, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """Returns per-sample (B, 1, 1, 1) distances."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for k, c in enumerate(VGG_CHNS):
            setattr(self, f"lin{k}", NetLinLayer(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, in0, in1):
        f0 = self.vgg((in0 - self.shift) / self.scale)
        f1 = self.vgg((in1 - self.shift) / self.scale)
        val = 0.0
        for k in range(len(VGG_CHNS)):
            n0 = f0[k] / (torch.sqrt(torch.sum(f0[k] ** 2, 1, keepdim=True))
                          + 1e-10)
            n1 = f1[k] / (torch.sqrt(torch.sum(f1[k] ** 2, 1, keepdim=True))
                          + 1e-10)
            d = getattr(self, f"lin{k}")((n0 - n1) ** 2)
            val = val + torch.mean(d, dim=(2, 3), keepdim=True)
        return val
