"""LPIPS perceptual distance (the GAN2Shape loss and the projector's) and the
reference PerceptualLoss's other distances.

LPIPS: ScalingLayer -> backbone taps -> per-tap unit normalisation ->
squared difference -> 1x1 'lin' heads (no bias; the `net-lin` mode) or a
plain channel sum (`lpips_heads=False`, the `net` mode) -> spatial mean ->
sum over the taps.  Backbones, in torchvision's `features` layout:
  vgg      VGG16, taps relu1_2 .. relu5_3 (5)
  alex     AlexNet, a tap after each conv's relu (5)
  squeeze  SqueezeNet 1.1, taps after features[1, 4, 7, 9, 10, 11, 12] (7)

State names: `{backbone}.features.*` (torchvision) and `lin{k}.model.1.weight`
(lpips v0.1 heads; index 0 is the dropout slot, identity at inference).

`perceptual_distance` is the reference's PerceptualLoss surface: 'net-lin',
'net', 'L2' and 'DSSIM', the last two in RGB or Lab.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, ReLU, relu
from .precision import act_dtype

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)

BACKBONE_CHNS = {
    "vgg": (64, 128, 256, 512, 512),
    "alex": (64, 192, 384, 256, 256),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}


class _MaxPool(nn.Module):
    def __init__(self, kernel=2, stride=2, ceil_mode=False):
        super().__init__()
        self.kernel, self.stride, self.ceil_mode = kernel, stride, ceil_mode

    def forward(self, x):
        return F.max_pool2d(x, self.kernel, self.stride,
                            ceil_mode=self.ceil_mode)


class _Trunk(nn.Module):
    """`features` (an nn.Sequential) with the outputs after `TAPS` kept."""
    TAPS = ()

    def forward(self, x):
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.TAPS:
                taps.append(x)
        return taps


class VGG16Features(_Trunk):
    TAPS = (3, 8, 15, 22, 29)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

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


class AlexFeatures(_Trunk):
    TAPS = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            Conv2d(3, 64, 11, 4, 2), ReLU(), _MaxPool(3, 2),
            Conv2d(64, 192, 5, 1, 2), ReLU(), _MaxPool(3, 2),
            Conv2d(192, 384, 3, 1, 1), ReLU(),
            Conv2d(384, 256, 3, 1, 1), ReLU(),
            Conv2d(256, 256, 3, 1, 1), ReLU())


class Fire(nn.Module):
    """torchvision's SqueezeNet fire module (its parameter names)."""

    def __init__(self, cin, squeeze, expand):
        super().__init__()
        self.squeeze = Conv2d(cin, squeeze, 1, 1, 0)
        self.expand1x1 = Conv2d(squeeze, expand, 1, 1, 0)
        self.expand3x3 = Conv2d(squeeze, expand, 3, 1, 1)

    def forward(self, x):
        s = relu(self.squeeze(x))
        return torch.cat([relu(self.expand1x1(s)),
                          relu(self.expand3x3(s))], 1)


class SqueezeFeatures(_Trunk):
    TAPS = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            Conv2d(3, 64, 3, 2, 0), ReLU(), _MaxPool(3, 2, True),
            Fire(64, 16, 64), Fire(128, 16, 64), _MaxPool(3, 2, True),
            Fire(128, 32, 128), Fire(256, 32, 128), _MaxPool(3, 2, True),
            Fire(256, 48, 192), Fire(384, 48, 192),
            Fire(384, 64, 256), Fire(512, 64, 256))


TRUNKS = {"vgg": VGG16Features, "alex": AlexFeatures,
          "squeeze": SqueezeFeatures}


class NetLinLayer(nn.Module):
    def __init__(self, chn_in):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   Conv2d(chn_in, 1, 1, 1, 0, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """Returns per-sample (B, 1, 1, 1) distances.  `lpips_heads=False` builds
    no heads: the `net` mode, a unit-weight sum over the normalised
    feature differences."""

    def __init__(self, backbone="vgg", lpips_heads=True):
        super().__init__()
        if backbone not in TRUNKS:
            raise ValueError(f"unknown LPIPS backbone {backbone!r}; one of "
                             f"{sorted(TRUNKS)}")
        self.backbone = backbone
        self.lpips_heads = lpips_heads
        self.chns = BACKBONE_CHNS[backbone]
        setattr(self, backbone, TRUNKS[backbone]())
        if lpips_heads:
            for k, c in enumerate(self.chns):
                setattr(self, f"lin{k}", NetLinLayer(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, in0, in1):
        # the frozen trunk runs in the policy's activation dtype; the unit
        # norm, the difference and the heads in f32
        trunk = getattr(self, self.backbone)
        adt = act_dtype()
        f0 = trunk(((in0 - self.shift) / self.scale).to(adt))
        f1 = trunk(((in1 - self.shift) / self.scale).to(adt))
        val = 0.0
        for k in range(len(self.chns)):
            fk0, fk1 = f0[k].float(), f1[k].float()
            n0 = fk0 / (torch.sqrt(torch.sum(fk0 ** 2, 1, keepdim=True))
                        + 1e-10)
            n1 = fk1 / (torch.sqrt(torch.sum(fk1 ** 2, 1, keepdim=True))
                        + 1e-10)
            diff = (n0 - n1) ** 2
            if self.lpips_heads:
                d = getattr(self, f"lin{k}")(diff)
            else:
                d = torch.sum(diff, 1, keepdim=True)
            val = val + torch.mean(d, dim=(2, 3), keepdim=True)
        return val


# ---------------- the distances without a network ----------------

def rgb2lab(x):
    """sRGB in [-1, 1], NCHW -> CIELAB (D65), as skimage converts."""
    rgb = torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    r, g, b = lin[:, 0], lin[:, 1], lin[:, 2]
    xx = 0.412453 * r + 0.357580 * g + 0.180423 * b
    yy = 0.212671 * r + 0.715160 * g + 0.072169 * b
    zz = 0.019334 * r + 0.119193 * g + 0.950227 * b
    white = (0.95047, 1.0, 1.08883)
    d = 6.0 / 29.0

    def f(t):
        # the clamp only keeps the cube root's gradient finite where the
        # other branch is taken
        return torch.where(t > d ** 3,
                           torch.pow(torch.clamp(t, min=d ** 3), 1.0 / 3.0),
                           t / (3 * d * d) + 4.0 / 29)

    fx, fy, fz = f(xx / white[0]), f(yy / white[1]), f(zz / white[2])
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], 1)


def l2_distance(in0, in1, colorspace="RGB"):
    """Per-sample mean squared difference; in Lab, half of it on L/100."""
    if colorspace.lower() == "lab":
        a, b = rgb2lab(in0) / 100.0, rgb2lab(in1) / 100.0
        return 0.5 * torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return torch.mean((in0 - in1) ** 2, dim=(1, 2, 3))


def _ssim(p0, p1, drange, sigma=1.5):
    """Gaussian-windowed SSIM as skimage's compare_ssim(gaussian_weights=
    True, multichannel=True): 11-tap window, K1 0.01, K2 0.03, sample
    covariance, channel mean."""
    radius = 5
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=p0.device)
    g = torch.exp(-0.5 * (t / sigma) ** 2)
    g = g / g.sum()
    kh = g.reshape(1, 1, -1, 1)
    kw = g.reshape(1, 1, 1, -1)

    def blur(x):
        b, c, h, w = x.shape
        y = F.conv2d(F.conv2d(x.reshape(b * c, 1, h, w), kh), kw)
        return y.reshape(b, c, y.shape[-2], y.shape[-1])

    c1 = (0.01 * drange) ** 2
    c2 = (0.03 * drange) ** 2
    mu0 = blur(p0)
    mu1 = blur(p1)
    n = (2 * radius + 1) ** 2
    cov_norm = n / (n - 1.0)
    s00 = cov_norm * (blur(p0 * p0) - mu0 * mu0)
    s11 = cov_norm * (blur(p1 * p1) - mu1 * mu1)
    s01 = cov_norm * (blur(p0 * p1) - mu0 * mu1)
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den, dim=(1, 2, 3))


def dssim_distance(in0, in1, colorspace="RGB"):
    """(1 - SSIM) / 2 on 0-255 RGB or on Lab."""
    if colorspace.lower() == "lab":
        return (1.0 - _ssim(rgb2lab(in0), rgb2lab(in1), 100.0)) / 2.0
    p0 = (in0 + 1.0) * 127.5
    p1 = (in1 + 1.0) * 127.5
    return (1.0 - _ssim(p0, p1, 255.0)) / 2.0


def perceptual_distance(lpips, in0, in1, model="net-lin", colorspace="RGB",
                        normalize=False):
    """The reference PerceptualLoss as a function.  For 'net-lin' and 'net'
    it is the LPIPS module `lpips`, whose backbone and heads (with them
    'net-lin', without 'net') make the distance; 'L2' and 'DSSIM' take
    None.  normalize=True maps [0, 1] inputs to [-1, 1]."""
    if normalize:
        in0 = 2 * in0 - 1
        in1 = 2 * in1 - 1
    m = model.lower()
    if m in ("net-lin", "net"):
        return lpips(in0, in1)
    if m == "l2":
        return l2_distance(in0, in1, colorspace)
    if m in ("dssim", "ssim"):
        return dssim_distance(in0, in1, colorspace)
    raise ValueError(f"unknown perceptual model {model!r}")
