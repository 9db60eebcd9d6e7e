"""The frozen segmentation nets behind the masks and the priors: PSPNet-50
(21 VOC classes, every category but faces) and BiSeNet (19 face-parsing
classes).

Module paths are the reference's torch state_dict names (hszhao/semseg's
PSPNet, zllrunning/face-parsing's BiSeNet), so the released
`checkpoints/parsing/{pspnet_voc,bisenet}.pth` load with `load_state_dict`
once a `module.` prefix is stripped, and `convert_pspnet` / `convert_bisenet`
of the JAX package read the same dicts.  The heads that only train (PSPNet's
`aux`, BiSeNet's `conv_out16` / `conv_out32`) are kept for the state_dict and
never run: inference returns the main logits at the input's resolution, as
the JAX nets do.  The nets stay in eval mode, so their `nn.BatchNorm2d`s
normalise by the frozen running statistics.  The JAX package's
`DilatedConv2d` is `nn.Conv2d`'s own `dilation` here (`_conv`).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan2shape_torch.models.layers import relu
from gan2shape_torch.ops.resize import resize_bilinear_align_corners


def _conv(cin, cout, k, stride=1, padding=0, dilation=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride, padding, dilation, bias=bias)


class _Frozen(nn.Module):
    """A net that is only ever evaluated: train() keeps it in eval mode,
    and no parameter asks for a gradient."""

    def train(self, mode=True):
        return super().train(False)

    def freeze(self):
        self.requires_grad_(False)
        return self.eval()

    def init_weights(self, generator):
        """Seeded random weights: every convolution kaiming-normal (fan_out,
        relu gain), as the reference ResNets initialise theirs, drawn on
        the CPU so one seed gives the same weights on every device; biases
        and BatchNorm at their defaults."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.out_channels * math.prod(m.kernel_size)
                    std = math.sqrt(2.0 / fan_out)
                    m.weight.copy_(torch.randn(m.weight.shape,
                                               generator=generator) * std)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
        return self


# ---------------- ResNet blocks and trunks ----------------

class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes, 1, stride), nn.BatchNorm2d(planes))

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return relu(out + res)


class Bottleneck(nn.Module):
    """1x1, dilated 3x3 (which carries the stride), 1x1 x4."""

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes * 4, 1, stride),
                nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return relu(out + res)


class ResNet18Trunk(nn.Module):
    """conv7 stem and four BasicBlock layers; returns feat8, feat16,
    feat32 (BiSeNet's context path)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        widths = ((64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2))
        for i, (cin, cout, stride) in enumerate(widths, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                BasicBlock(cin, cout, stride), BasicBlock(cout, cout)))

    def forward(self, x):
        x = relu(self.bn1(self.conv1(x)))
        x = self.layer1(F.max_pool2d(x, 3, 2, 1))
        feat8 = self.layer2(x)
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class _MaxPool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 3, 2, 1)


class _ReLU(nn.Module):
    def forward(self, x):
        return relu(x)


class ResNet50DeepTrunk(_Frozen):
    """The deep-stem ResNet-50 (three 3x3 convolutions in `layer0`) with
    layers 3 and 4 dilated 2 and 4 at stride 1: output stride 8."""

    def __init__(self):
        super().__init__()
        self.layer0 = nn.Sequential(
            _conv(3, 64, 3, 2, 1), nn.BatchNorm2d(64), _ReLU(),
            _conv(64, 64, 3, 1, 1), nn.BatchNorm2d(64), _ReLU(),
            _conv(64, 128, 3, 1, 1), nn.BatchNorm2d(128), _ReLU(), _MaxPool())
        spec = ((128, 64, 3, 1, 1), (256, 128, 4, 2, 1), (512, 256, 6, 1, 2),
                (1024, 512, 3, 1, 4))
        for i, (inplanes, planes, blocks, stride, dilation) in enumerate(
                spec, start=1):
            layer = [Bottleneck(inplanes, planes, stride, dilation,
                                downsample=True)]
            layer += [Bottleneck(planes * 4, planes, 1, dilation)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*layer))

    def forward(self, x):
        x = self.layer0(x)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


# ---------------- PSPNet ----------------

class _Head(nn.Sequential):
    """conv3x3-BN-ReLU-dropout-conv1x1 (indices 0, 1 and 4 hold weights;
    the dropout is the identity at inference)."""

    def __init__(self, cin, mid, classes):
        super().__init__(_conv(cin, mid, 3, 1, 1), nn.BatchNorm2d(mid),
                         _ReLU(), nn.Identity(),
                         _conv(mid, classes, 1, bias=True))


class _AdaptiveAvgPool(nn.Module):
    def __init__(self, size):
        super().__init__()
        self.size = size

    def forward(self, x):
        # bin i averages input [floor(i*n/o), ceil((i+1)*n/o))
        return F.adaptive_avg_pool2d(x, self.size)


class _PPM(nn.Module):
    """Pyramid pooling: features.{i} = (pool to bins[i], conv1x1, BN,
    ReLU), each resized back and concatenated after the input."""

    def __init__(self, cin, cout, bins):
        super().__init__()
        self.features = nn.ModuleList(
            nn.Sequential(_AdaptiveAvgPool(b), _conv(cin, cout, 1),
                          nn.BatchNorm2d(cout), _ReLU()) for b in bins)

    def forward(self, x):
        size = x.shape[-2:]
        return torch.cat([x] + [resize_bilinear_align_corners(f(x), size)
                                for f in self.features], 1)


class PSPNet(ResNet50DeepTrunk):
    """PSPNet-50 logits (B, classes, H, W) for inputs with (H-1) and (W-1)
    divisible by 8."""

    def __init__(self, classes=21, bins=(1, 2, 3, 6)):
        super().__init__()
        self.ppm = _PPM(2048, 2048 // len(bins), bins)
        self.cls = _Head(4096, 512, classes)
        self.aux = _Head(1024, 256, classes)  # training only
        self.freeze()

    def forward(self, x):
        h, w = x.shape[-2:]
        if (h - 1) % 8 or (w - 1) % 8:
            raise ValueError(f"PSPNet needs (H-1) and (W-1) divisible by 8, "
                             f"got {h}x{w}")
        feat = self.ppm(super().forward(x))
        return resize_bilinear_align_corners(self.cls(feat), (h, w))


# ---------------- BiSeNet ----------------

class ConvBNReLU(nn.Module):
    def __init__(self, in_chan, out_chan, ks=3, stride=1, padding=1):
        super().__init__()
        self.conv = _conv(in_chan, out_chan, ks, stride, padding)
        self.bn = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        return relu(self.bn(self.conv(x)))


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_chan, out_chan):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan)
        self.conv_atten = _conv(out_chan, out_chan, 1)
        self.bn_atten = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean((2, 3),
                                                        keepdim=True)))
        return feat * torch.sigmoid(atten)


def _up_nearest(x, size):
    """Nearest upsampling by an exact integer factor."""
    b, c, h, w = x.shape
    oh, ow = int(size[0]), int(size[1])
    if oh % h or ow % w:
        raise ValueError(f"nearest upsampling {h}x{w} -> {oh}x{ow} needs "
                         "integer factors")
    fy, fx = oh // h, ow // w
    return x[:, :, :, None, :, None].expand(b, c, h, fy, w, fx).reshape(
        b, c, oh, ow)


class FeatureFusionModule(nn.Module):
    def __init__(self, in_chan, out_chan):
        super().__init__()
        self.convblk = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv1 = _conv(out_chan, out_chan // 4, 1)
        self.conv2 = _conv(out_chan // 4, out_chan, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        atten = relu(self.conv1(feat.mean((2, 3), keepdim=True)))
        atten = torch.sigmoid(self.conv2(atten))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_chan, mid_chan, n_classes):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan)
        self.conv_out = _conv(mid_chan, n_classes, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18Trunk()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean((2, 3), keepdim=True))
        feat32_sum = self.arm32(feat32) + avg
        feat32_up = self.conv_head32(_up_nearest(feat32_sum,
                                                 feat16.shape[-2:]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(_up_nearest(feat16_sum,
                                                 feat8.shape[-2:]))
        return feat8, feat16_up


class BiSeNet(_Frozen):
    """Face-parsing logits (B, n_classes, H, W)."""

    def __init__(self, n_classes=19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)  # training only
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)  # training only
        self.freeze()

    def forward(self, x):
        feat8, feat_cp8 = self.cp(x)
        out = self.conv_out(self.ffm(feat8, feat_cp8))
        return resize_bilinear_align_corners(out, x.shape[-2:])
