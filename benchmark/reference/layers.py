"""Basic layers of the trainable nets, with torch's default
(kaiming-uniform, bound 1/sqrt(fan_in)) initialisation drawn from an
explicit generator, and activations whose gradient at exactly 0 matches the
JAX package (relu splits a tie evenly, lrelu passes it)."""

import math
from contextlib import contextmanager

import torch
import torch.nn as nn
import torch.nn.functional as F


_DRAWS = []  # a list of (tensor, law, scale) lists, innermost last


@contextmanager
def recording():
    """Inside the block the seeded initialisers draw nothing: each appends
    (tensor, 'uniform' | 'normal', bound or std) to the list yielded, for
    a caller that draws every tensor itself."""
    draws = []
    _DRAWS.append(draws)
    try:
        yield draws
    finally:
        _DRAWS.pop()


def record_draw(t, law, scale):
    """True when a `recording()` block took the draw."""
    if not _DRAWS:
        return False
    _DRAWS[-1].append((t, law, scale))
    return True


def _uniform_(t, bound, generator):
    """Draw on the CPU (where `generator` lives) and copy, or only record
    the draw inside `recording()`."""
    if record_draw(t, "uniform", bound):
        return
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                              generator=generator))


class Conv2d(nn.Conv2d):
    def reset_parameters(self, generator=None):
        k = self.kernel_size[0]
        bound = 1.0 / math.sqrt(self.in_channels * k * k)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        """Weights cast to the input's dtype: a frozen trunk runs its
        activations in the policy's `act_dtype` on f32 weights."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def reset_parameters(self, generator=None):
        k = self.kernel_size[0]
        # torch counts fan_in over weight dim 1 (out_channels) here
        bound = 1.0 / math.sqrt(self.out_channels * k * k)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)


class GroupNorm(nn.GroupNorm):
    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


def relu(x):
    return torch.maximum(x, x.new_zeros(()))


def lrelu(x, slope=0.2):
    return torch.where(x >= 0, x, x * slope)


class ReLU(nn.Module):
    def forward(self, x):
        return relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, slope=0.2):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return lrelu(x, self.slope)


class Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)


class AvgPool2d(nn.Module):
    def forward(self, x):
        return F.avg_pool2d(x, 2, 2)


class UpsampleNearest(nn.Module):
    def forward(self, x):
        return upsample_nearest(x, 2)


def upsample_nearest(x, factor=2):
    return x.repeat_interleave(factor, 2).repeat_interleave(factor, 3)


def reset_parameters(module, generator):
    """Re-initialise every submodule that defines reset_parameters, in
    module order, from `generator`."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
