"""StyleGAN2 generator and discriminator (the frozen GAN), with the
rosinality state_dict names the reference checkpoints use.

ModulatedConv2d modulates the activations and demodulates the outputs,
y = demod(style) * conv(x * style, scale * W), which equals the per-sample
modulated weight of the reference (a conv is linear in per-input-channel
scaling) and needs no grouped conv.  FIR resampling is ops.upfirdn2d.

Both nets are frozen stacks of the precision policy: the synthesis and the
discriminator keep their activations in `act_dtype()`, with the weights
cast at each call (the parameters stay f32), and return the image, the
score and the feature taps in f32.  The mapping, the truncation and the
demodulation stay f32.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gan2shape_torch.ops.fused_act import (
    bias_act, fused_leaky_relu, inverse_fused_leaky_relu,
)
from gan2shape_torch.ops.upfirdn2d import setup_filter, upfirdn2d
from gan2shape_torch.distributed import gather_rows, local_slice
from gan2shape_torch.utils.precision import act_dtype


def channel_map(channel_multiplier):
    return {4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier}


def _normal_(t, generator, std=1.0):
    """Draw on the CPU (where `generator` lives) and copy, so one seed gives
    the same weights on every device."""
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).normal_(0.0, std, generator=generator))


class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x ** 2, dim=1, keepdim=True) + 1e-8)


class Blur(nn.Module):
    """FIR blur with explicit padding (kernel is a constant, not state)."""

    def __init__(self, kernel, pad, gain=1):
        super().__init__()
        self.register_buffer(
            "kernel", torch.as_tensor(setup_filter(kernel, gain)),
            persistent=False)
        self.pad = pad

    def forward(self, x, up=1):
        return upfirdn2d(x, self.kernel, up=up, pad=self.pad)


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, bias=True, bias_init=0.0, lr_mul=1.0,
                 activation=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        self.bias_init = bias_init
        self.lr_mul = lr_mul
        self.activation = activation
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator, 1.0 / self.lr_mul)
        if self.bias is not None:
            nn.init.constant_(self.bias, self.bias_init)

    def forward(self, x):
        out = torch.matmul(x, (self.weight * self.scale).to(x.dtype).T)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        if self.bias is not None:
            out = out + (self.bias * self.lr_mul).to(out.dtype)
        return out

    def invert(self, x):
        if self.activation == "fused_lrelu":
            out = inverse_fused_leaky_relu(
                x.reshape(x.shape + (1, 1)),
                self.bias * self.lr_mul).reshape(x.shape)
        else:
            out = x - self.bias * self.lr_mul
        w_inv = torch.linalg.inv(self.weight * self.scale)
        return torch.matmul(out, w_inv.T)


class EqualConv2d(nn.Module):
    def __init__(self, in_channel, out_channel, kernel_size, stride=1,
                 padding=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channel, in_channel, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.stride = stride
        self.padding = padding
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        out = F.conv2d(x, (self.weight * self.scale).to(x.dtype),
                       stride=self.stride, padding=self.padding)
        if self.bias is not None:
            out = out + self.bias.reshape(1, -1, 1, 1).to(out.dtype)
        return out


class ModulatedConv2d(nn.Module):
    def __init__(self, in_channel, out_channel, kernel_size, style_dim,
                 demodulate=True, upsample=False, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(
            1, out_channel, in_channel, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        if upsample:
            factor = 2
            p = (len(blur_kernel) - factor) - (kernel_size - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2 + factor - 1,
                                           p // 2 + 1), gain=factor ** 2)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)

    def forward(self, x, style):
        out, demod = self.conv_and_demod(x, style)
        if demod is not None:
            out = out * demod[:, :, None, None].to(out.dtype)
        return out

    def conv_and_demod(self, x, style):
        """The convolution of the modulated input, and the demodulation
        factors (B, out) unapplied (None without demodulation), for
        StyledConv's fused epilogue."""
        style = self.modulation(style)  # (B, in)
        wgt = self.weight[0] * self.scale  # (out, in, k, k)
        demod = None
        if self.demodulate:
            # a normalisation constant: f32 under every activation dtype
            wsq = torch.sum(wgt ** 2, dim=(2, 3))  # (out, in)
            demod = torch.rsqrt(torch.matmul(style.float() ** 2, wsq.T)
                                + 1e-8)
        x = x * style[:, :, None, None].to(x.dtype)
        wgt = wgt.to(x.dtype)
        if self.upsample:
            out = F.conv_transpose2d(x, wgt.transpose(0, 1), stride=2)
            out = self.blur(out)
        else:
            out = F.conv2d(x, wgt, padding=self.kernel_size // 2)
        return out, demod


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.weight)

    def weighted(self, noise, dtype):
        """w * noise in `dtype`, which StyledConv's epilogue adds."""
        return (self.weight * noise).to(dtype)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channel):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class ConstantInput(nn.Module):
    def __init__(self, channel, size=4):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channel, size, size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.input, generator)

    def forward(self, batch):
        return self.input.repeat(batch, 1, 1, 1)


class StyledConv(nn.Module):
    def __init__(self, in_channel, out_channel, kernel_size, style_dim,
                 upsample=False, blur_kernel=(1, 3, 3, 1), demodulate=True):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size,
                                    style_dim, demodulate=demodulate,
                                    upsample=upsample,
                                    blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)

    def forward(self, x, style, noise):
        """activate(noise(conv(x, style))) as one epilogue (ops.bias_act)."""
        out, demod = self.conv.conv_and_demod(x, style)
        return bias_act(out, demod, self.noise.weighted(noise, out.dtype),
                        self.activate.bias)


class ToRGB(nn.Module):
    def __init__(self, in_channel, style_dim, upsample=True,
                 blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        if upsample:
            p = len(blur_kernel) - 2
            self.upsample = Blur(blur_kernel, ((p + 1) // 2 + 1, p // 2),
                                 gain=4)
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim,
                                    demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.bias)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            out = out + self.upsample(skip, up=2)
        return out


class _Noises(nn.Module):
    def __init__(self, num_layers):
        super().__init__()
        for i in range(num_layers):
            res = 2 ** ((i + 5) // 2)
            self.register_buffer(f"noise_{i}", torch.zeros(1, 1, res, res))


class Generator(nn.Module):
    """StyleGAN2 synthesis + mapping MLP (`style.0` is PixelNorm)."""

    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2,
                 blur_kernel=(1, 3, 3, 1), lr_mlp=0.01):
        super().__init__()
        self.size = size
        self.style_dim = style_dim
        self.n_mlp = n_mlp
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        chans = channel_map(channel_multiplier)

        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp,
                        activation="fused_lrelu") for _ in range(n_mlp)])
        self.input = ConstantInput(chans[4])
        self.conv1 = StyledConv(chans[4], chans[4], 3, style_dim,
                                blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(chans[4], style_dim, upsample=False)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.noises = _Noises(self.num_layers)
        in_ch = chans[4]
        for i in range(3, self.log_size + 1):
            out_ch = chans[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim,
                                         upsample=True,
                                         blur_kernel=blur_kernel))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim,
                                         blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(out_ch, style_dim))
            in_ch = out_ch

    # ---------------- mapping ----------------

    def style_forward(self, x, skip=0, depth=100):
        """Run mapping layers [skip, min(depth, n_mlp + 1)); layer 0 is
        PixelNorm."""
        out = x
        for i, layer in enumerate(self.style):
            if i >= depth:
                break
            if i >= skip:
                out = layer(out)
        return out

    def style_invert(self, x, skip=0, depth=100):
        """Inverse mapping through every layer but PixelNorm."""
        out = x
        n = self.n_mlp + 1
        for i in range(n):
            if i == n - 1 or i >= depth:
                break
            if i >= skip:
                out = self.style[self.n_mlp - i].invert(out)
        return out

    def mean_latent(self, n_latent, generator=None):
        z = torch.randn(n_latent, self.style_dim, generator=generator,
                        device=self.input.input.device)
        return self.style_forward(z).mean(0, keepdim=True)

    def make_noise(self, generator=None, device="cpu"):
        return [torch.randn(1, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2),
                            generator=generator, device=device)
                for i in range(self.num_layers)]

    def noise_list(self):
        return [getattr(self.noises, f"noise_{i}")
                for i in range(self.num_layers)]

    # ---------------- synthesis ----------------

    def forward(self, styles, noise=None, inject_index=None, truncation=1.0,
                truncation_latent=None, input_is_w=False,
                return_features=False):
        """Returns (image, features or None).  `noise` defaults to the
        stored `noises` buffers."""
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_w:
            styles = [self.style_forward(s) for s in styles]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]
        if noise is None:
            noise = self.noise_list()

        if len(styles) == 1:
            s = styles[0]
            latent = s[:, None].expand(-1, self.n_latent, -1) \
                if s.dim() < 3 else s
        elif len(styles) == 2:
            if inject_index is None:
                raise ValueError("style mixing needs an explicit inject_index")
            latent = torch.cat([
                styles[0][:, None].expand(-1, inject_index, -1),
                styles[1][:, None].expand(-1, self.n_latent - inject_index,
                                          -1)], 1)
        else:
            latent = torch.stack(styles, 1)

        # the synthesis runs in the activation dtype; the mapping and the
        # truncation above stay f32
        adt = act_dtype()
        latent = latent.to(adt)
        noise = [n.to(adt) for n in noise]
        out = self.input(latent.shape[0]).to(adt)
        out = self.conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        features = []
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * idx](out, latent[:, i], noise[1 + 2 * idx])
            out = self.convs[2 * idx + 1](out, latent[:, i + 1],
                                          noise[2 + 2 * idx])
            skip = to_rgb(out, latent[:, i + 2], skip)
            features.append(out)
            i += 2
        return skip.float(), ([f.float() for f in features]
                              if return_features else None)

    def invert(self, latent_projection, truncation=1.0, mean_latent=None,
               noise=None):
        """Re-synthesise from a projected latent = (offset, latent)."""
        offset, latent = latent_projection
        img, _ = self([latent], noise=noise, input_is_w=True,
                      truncation=truncation, truncation_latent=mean_latent)
        return torch.clamp(img, -1.0, 1.0), offset


class ConvLayer(nn.Sequential):
    """[Blur,] EqualConv2d[, FusedLeakyReLU] — the reference's Sequential, so
    indices (and state_dict names) match."""

    def __init__(self, in_channel, out_channel, kernel_size, downsample=False,
                 blur_kernel=(1, 3, 3, 1), bias=True, activate=True):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size,
                                  stride=stride, padding=padding,
                                  bias=bias and not activate))
        if activate:
            if bias:
                layers.append(FusedLeakyReLU(out_channel))
            else:
                layers.append(_ScaledLeakyReLU())
        super().__init__(*layers)


class _ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return fused_leaky_relu(x, None)


class ResBlock(nn.Module):
    def __init__(self, in_channel, out_channel, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True,
                              blur_kernel=blur_kernel, activate=False,
                              bias=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator with `ftr_num` early-exit feature taps."""

    def __init__(self, size, channel_multiplier=2, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        chans = channel_map(channel_multiplier)
        log_size = int(math.log2(size))
        convs = [ConvLayer(3, chans[size], 1)]
        in_ch = chans[size]
        for i in range(log_size, 2, -1):
            out_ch = chans[2 ** (i - 1)]
            convs.append(ResBlock(in_ch, out_ch, blur_kernel))
            in_ch = out_ch
        self.convs = nn.Sequential(*convs)
        self.stddev_group = 4
        self.stddev_feat = 1
        self.final_conv = ConvLayer(in_ch + 1, chans[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(chans[4] * 16, chans[4], activation="fused_lrelu"),
            EqualLinear(chans[4], 1))

    def forward(self, x, ftr_num=100, split_batch=False):
        """Returns (score or 0, feature taps after every block but the
        first, stopping once `ftr_num` taps are collected).  With
        `split_batch`, x is this rank's equal slice of a batch split over
        the process group, and the minibatch standard deviation is the
        whole batch's (its groups strided over the whole batch, as on one
        device)."""
        out = x.to(act_dtype())
        features = []
        for i, block in enumerate(self.convs):
            out = block(out)
            if i > 0:
                features.append(out.float())
            if len(features) >= ftr_num:
                return x.new_zeros(()), features
        if not split_batch:
            stddev = self._minibatch_stddev(out)
        else:
            # the rows of every rank, gathered differentiably: a rank's
            # features get the gradient of every rank's loss through them
            full = gather_rows(out)
            stddev = self._minibatch_stddev(full)[local_slice(full.shape[0])]
        out = self.final_conv(torch.cat([out, stddev], 1))
        features.append(out.float())
        out = self.final_linear(out.reshape(out.shape[0], -1))
        return out.float(), features

    def _minibatch_stddev(self, out):
        """(B, stddev_feat, h, w): the feature standard deviation over
        groups of min(B, stddev_group) samples strided B / group apart."""
        batch, channel, height, width = out.shape
        group = min(batch, self.stddev_group)
        stddev = out.reshape(group, -1, self.stddev_feat,
                             channel // self.stddev_feat, height, width)
        stddev = torch.sqrt(stddev.var(0, unbiased=False) + 1e-8)
        stddev = stddev.mean((2, 3, 4), keepdim=True).squeeze(2)
        return stddev.repeat(group, 1, height, width)
