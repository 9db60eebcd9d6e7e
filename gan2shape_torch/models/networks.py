"""The five trainable GAN2Shape nets (V, L, D, A, E) as nn.Sequential stacks
whose state_dict names are the reference's (`network.{i}.*`)."""

import math

import torch.nn as nn

from gan2shape_torch.models.layers import (
    AvgPool2d, Conv2d, ConvTranspose2d, GroupNorm, LeakyReLU, ReLU, Tanh,
    UpsampleNearest,
)


def encoder_widths(size):
    nf = max(4096 // size, 16)
    n_down = max(int(math.log2(size)) - 2, 1)
    return nf, [min(nf * 2 ** i, nf * 16) for i in range(n_down)]


class Encoder(nn.Module):
    """Stride-2 conv4 + ReLU stages down to 4x4, valid conv4, 1x1 conv, tanh
    (the reference's 5-stage stack at 128 px; smaller sizes drop stages)."""

    def __init__(self, cin, cout, size):
        super().__init__()
        nf, widths = encoder_widths(size)
        layers = []
        c_in = cin
        for c_out in widths:
            layers += [Conv2d(c_in, c_out, 4, 2, 1, bias=False), ReLU()]
            c_in = c_out
        layers += [Conv2d(c_in, nf * 16, 4, 1, 0, bias=False), ReLU(),
                   Conv2d(nf * 16, cout, 1, 1, 0, bias=False), Tanh()]
        self.network = nn.Sequential(*layers)

    def forward(self, x):
        return self.network(x).reshape(x.shape[0], -1)


class ViewpointNet(Encoder):
    """V: 6-dof viewpoint (rot xyz, trans xy, trans z)."""

    def __init__(self, image_size=128):
        super().__init__(3, 6, image_size)


class LightingNet(Encoder):
    """L: 4-dof lighting (ambient, diffuse, direction xy)."""

    def __init__(self, image_size=128):
        super().__init__(3, 4, image_size)


class EncoderDecoder(nn.Module):
    """Conv encoder-decoder of DepthNet/AlbedoNet (layer indices are the
    reference's)."""

    def __init__(self, cin, cout, size, activation=None, zdim=256):
        super().__init__()
        nf = max(4096 // size, 16)
        gn = 8 if size >= 128 else 16
        layers = [
            Conv2d(cin, nf, 4, 2, 1, bias=False), GroupNorm(gn, nf),
            LeakyReLU(),
            Conv2d(nf, nf * 2, 4, 2, 1, bias=False), GroupNorm(gn * 2, nf * 2),
            LeakyReLU(),
            Conv2d(nf * 2, nf * 4, 4, 2, 1, bias=False),
            GroupNorm(gn * 4, nf * 4), LeakyReLU(),
            Conv2d(nf * 4, nf * 8, 4, 2, 1, bias=False), LeakyReLU(),
            Conv2d(nf * 8, zdim, 4, 1, 0, bias=False), ReLU(),
            ConvTranspose2d(zdim, nf * 8, 4, 1, 0, bias=False), ReLU(),
            Conv2d(nf * 8, nf * 8, 3, 1, 1, bias=False), ReLU(),
            ConvTranspose2d(nf * 8, nf * 4, 4, 2, 1, bias=False),
            GroupNorm(gn * 4, nf * 4), ReLU(),
            Conv2d(nf * 4, nf * 4, 3, 1, 1, bias=False),
            GroupNorm(gn * 4, nf * 4), ReLU(),
            ConvTranspose2d(nf * 4, nf * 2, 4, 2, 1, bias=False),
            GroupNorm(gn * 2, nf * 2), ReLU(),
            Conv2d(nf * 2, nf * 2, 3, 1, 1, bias=False),
            GroupNorm(gn * 2, nf * 2), ReLU(),
            ConvTranspose2d(nf * 2, nf, 4, 2, 1, bias=False),
            GroupNorm(gn, nf), ReLU(),
            Conv2d(nf, nf, 3, 1, 1, bias=False), GroupNorm(gn, nf), ReLU(),
            UpsampleNearest(),
            Conv2d(nf, nf, 3, 1, 1, bias=False), GroupNorm(gn, nf), ReLU(),
            Conv2d(nf, nf, 5, 1, 2, bias=False), GroupNorm(gn, nf), ReLU(),
            Conv2d(nf, cout, 5, 1, 2, bias=False),
        ]
        if activation == "tanh":
            layers.append(Tanh())
        self.network = nn.Sequential(*layers)

    def forward(self, x):
        return self.network(x)


class DepthNet(EncoderDecoder):
    """D: raw depth map (tanh is applied after mean-centering, in the
    model)."""

    def __init__(self, image_size=128):
        super().__init__(3, 1, image_size)


class AlbedoNet(EncoderDecoder):
    """A: albedo in [-1, 1]."""

    def __init__(self, image_size=128):
        super().__init__(3, 3, image_size, activation="tanh")


class ResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.res_path = nn.Sequential(ReLU(), Conv2d(cin, cout, 3, 2, 1),
                                      ReLU(), Conv2d(cout, cout, 3, 1, 1))
        self.identity_path = nn.Sequential(AvgPool2d(),
                                           Conv2d(cin, cout, 1, 1, 0))

    def forward(self, x):
        return self.identity_path(x) + self.res_path(x)


class OffsetEncoder(nn.Module):
    """E: pseudo-image -> w-space offset.  The 64-px branch produces the
    full `cout` channels (the reference passed a float channel count there
    and crashed)."""

    def __init__(self, image_size=128, cin=3, cout=512):
        super().__init__()
        if image_size not in (64, 128):
            raise ValueError("OffsetEncoder supports 64 and 128 px")
        nf = 16
        layers = [Conv2d(cin, 2 * nf, 4, 2, 1), ReLU(),
                  ResBlock(2 * nf, 4 * nf), ResBlock(4 * nf, 8 * nf),
                  ResBlock(8 * nf, 16 * nf)]
        top = 16 * nf
        if image_size == 128:
            layers.append(ResBlock(16 * nf, 32 * nf))
            top = 32 * nf
        layers += [Conv2d(top, 2 * top, 4, 1, 0), ReLU(),
                   Conv2d(2 * top, cout, 1, 1, 0)]
        self.network = nn.Sequential(*layers)

    def forward(self, x):
        return self.network(x).reshape(x.shape[0], -1)
