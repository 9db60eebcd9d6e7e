"""Fused bias + scaled LeakyReLU (StyleGAN2's fused_bias_act), plain torch."""

import torch


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=2 ** 0.5):
    """scale * leaky_relu(x + bias); `bias` broadcasts over axis 1 for >=2-D
    inputs.  The slope applies where x + bias < 0 (x == 0 passes through, as
    in the JAX package, so gradients at 0 agree)."""
    if bias is not None:
        shape = [1] * x.dim()
        shape[1] = -1
        x = x + bias.reshape(shape).to(x.dtype)
    return scale * torch.where(x >= 0, x, x * negative_slope)


def inverse_fused_leaky_relu(x, bias, negative_slope=0.2, scale=2 ** 0.5):
    """Analytic inverse, used by the generator's `style_invert`."""
    y = x / scale
    y = torch.where(y >= 0, y, y / negative_slope)
    return y - bias.reshape((1, -1) + (1,) * (x.dim() - 2))
