"""StyleGAN2's convolution epilogue (fused_bias_act, with the demodulation
and the noise taken in):

    y = scale * leaky_relu(x * demod[b, c] + noise + bias[c])

`demod` (B, C), `noise` (the weighted noise w * noise, (1 or B, 1, *x's
spatial dims), in x's dtype) and `bias` (C) are each optional; x is
(B, C, ...) with any number of spatial dims, none for a linear layer.
The slope applies where the pre-activation is < 0: an exact 0 passes with
slope 1, as in the JAX package, so gradients at 0 agree.

`bias_act` takes a CUDA tensor through the hand-written kernel pair of
csrc/bias_act.cu: one pass forward, one backward, each an autograd Function
whose own backward is again these kernels (the mask of pre >= 0 applied to
other operands), so every order of derivative runs through them.  Its
forward and grad_x equal `bias_act_plain` and its autograd value for value;
grad_demod and grad_bias are sums taken in another (fixed) order.  A CPU
tensor takes `bias_act_plain`.  `_forward_plain` (the plain chain) and
`_grad_plain` are the kernels' arithmetic in torch, with a boolean mask for
the kernels' mask bits: the Functions run them on CPU tensors, which only
the tests hand them.
"""

import torch

from gan2shape_torch.ops import _cuda

SQRT2 = 2 ** 0.5
_DTYPES = (torch.float32, torch.bfloat16)


def _per_channel(t, dims):
    """demod (B, C) or bias (C,) shaped to broadcast over a `dims`-dim x."""
    lead = tuple(t.shape) if t.dim() == 2 else (1, -1)
    return t.reshape(lead + (1,) * (dims - 2))


def bias_act_plain(x, demod=None, noise=None, bias=None, negative_slope=0.2,
                   scale=SQRT2):
    """The epilogue as the plain chain of torch operations."""
    return _forward_plain(x, demod, noise, bias, None, negative_slope, scale,
                          want_mask=False)[0]


def bias_act(x, demod=None, noise=None, bias=None, negative_slope=0.2,
             scale=SQRT2):
    """See the module docstring."""
    if x.device.type != "cuda":
        return bias_act_plain(x, demod, noise, bias, negative_slope, scale)
    if x.dtype not in _DTYPES or x.dim() < 2:
        raise ValueError(f"bias_act on the card takes (B, C, ...) f32 or "
                         f"bf16, got {x.dtype} {tuple(x.shape)}")
    b, c = x.shape[:2]
    if demod is not None:
        if tuple(demod.shape) != (b, c):
            raise ValueError(f"demod {tuple(demod.shape)} != {(b, c)}")
        demod = demod.float().contiguous()
    if noise is not None:
        if noise.dtype != x.dtype or noise.dim() != x.dim() or \
                noise.shape[0] not in (1, b) or noise.shape[1] != 1 or \
                noise.shape[2:] != x.shape[2:]:
            raise ValueError(f"noise {noise.dtype} {tuple(noise.shape)} does "
                             f"not broadcast over x {tuple(x.shape)}")
        noise = noise.contiguous()
    if bias is not None:
        if tuple(bias.shape) != (c,):
            raise ValueError(f"bias {tuple(bias.shape)} != {(c,)}")
        bias = bias.float().contiguous()
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, demod, noise,
                                                         bias)):
        return _BiasAct.apply(x, demod, noise, bias, None, negative_slope,
                              scale)
    return _forward(x, demod, noise, bias, None, negative_slope, scale,
                    want_mask=False)[0]


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=SQRT2):
    """scale * leaky_relu(x + bias); `bias` broadcasts over axis 1."""
    return bias_act(x, bias=bias, negative_slope=negative_slope, scale=scale)


def inverse_fused_leaky_relu(x, bias, negative_slope=0.2, scale=SQRT2):
    """Analytic inverse, used by the generator's `style_invert`."""
    y = x / scale
    y = torch.where(y >= 0, y, y / negative_slope)
    return y - bias.reshape((1, -1) + (1,) * (x.dim() - 2))


# ---------------- the kernels and their arithmetic in torch ----------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(x, demod, noise, bias, mask, slope, gain, want_mask):
    """y, and the mask of pre >= 0 if `want_mask` (None otherwise); a
    `mask` given is applied instead of pre >= 0."""
    if x.device.type != "cuda":
        return _forward_plain(x, demod, noise, bias, mask, slope, gain,
                              want_mask)
    n = x.numel()
    b, c = x.shape[:2]
    y = torch.empty_like(x)
    mask_out = None
    if want_mask and mask is None:
        mask_out = torch.empty(4 * ((n + 127) // 128), dtype=torch.int32,
                               device=x.device)
    err = _cuda.load("bias_act").g2s_bias_act(
        x.data_ptr(), _ptr(demod), _ptr(noise), _ptr(bias), _ptr(mask),
        y.data_ptr(), _ptr(mask_out), int(x.dtype == torch.bfloat16), b, c,
        n // (b * c) if n else 0,
        int(noise is not None and noise.shape[0] != 1), slope, gain,
        _cuda.stream_of(x))
    _cuda.check(err, "bias_act")
    _cuda.LAUNCHES["bias_act"] += 1
    return y, (mask if mask_out is None and want_mask else mask_out)


def _grad(g, mask, x, demod, noise_shape, need_x, need_demod, need_noise,
          need_bias, slope, gain):
    """(grad_x, grad_demod, grad_noise, grad_bias) of the epilogue at the
    incoming gradient `g`, each None where it is not asked for."""
    if g.device.type != "cuda":
        return _grad_plain(g, mask, x, demod, noise_shape, need_x,
                           need_demod, need_noise, need_bias, slope, gain)
    g = g.contiguous()
    b, c = g.shape[:2]
    hw = g.numel() // (b * c) if b * c else 0
    f32 = dict(dtype=torch.float32, device=g.device)
    gx = torch.empty_like(g) if need_x else None
    # grad_noise sums the gradient before the demodulation over channels
    gpre = None
    if need_noise:
        gpre = gx if gx is not None and demod is None else torch.empty_like(g)
    gd = torch.empty((b, c), **f32) if need_demod else None
    gb = torch.empty((c,), **f32) if need_bias else None
    part = torch.empty((b * c,), **f32) if need_bias else None
    err = _cuda.load("bias_act").g2s_bias_act_grad(
        g.data_ptr(), mask.data_ptr(), _ptr(x), _ptr(demod), _ptr(gx),
        None if gpre is gx else _ptr(gpre), _ptr(gd), _ptr(gb), _ptr(part),
        int(g.dtype == torch.bfloat16), b, c, hw, slope, gain,
        _cuda.stream_of(g))
    _cuda.check(err, "bias_act_grad")
    _cuda.LAUNCHES["bias_act_grad"] += 1
    gn = gpre.sum_to_size(noise_shape) if need_noise else None
    return gx, gd, gn, gb


def _forward_plain(x, demod, noise, bias, mask, slope, gain, want_mask):
    """The plain chain, with its mask of pre >= 0 (or a given mask)."""
    v = x
    if demod is not None:
        v = v * _per_channel(demod, x.dim()).to(x.dtype)
    if noise is not None:
        v = v + noise
    if bias is not None:
        v = v + _per_channel(bias, x.dim()).to(x.dtype)
    m = v >= 0 if mask is None else mask
    return gain * torch.where(m, v, v * slope), (m if want_mask else None)


def _grad_plain(g, mask, x, demod, noise_shape, need_x, need_demod,
                need_noise, need_bias, slope, gain):
    gpre = g * gain
    gpre = torch.where(mask, gpre, gpre * slope)
    gx = gd = gn = gb = None
    if need_x:
        gx = gpre if demod is None else \
            gpre * _per_channel(demod, g.dim()).to(g.dtype)
    spatial = tuple(range(2, g.dim()))
    # demod and bias are f32 (f64 in the tests' gradchecks)
    wide = torch.promote_types(g.dtype, torch.float32)
    if need_demod:
        gd = (gpre * x).sum(spatial).to(wide)
    if need_noise:
        gn = gpre.sum_to_size(noise_shape)
    if need_bias:
        gb = gpre.sum((0,) + spatial).to(wide)
    return gx, gd, gn, gb


# ---------------- autograd ----------------


class _BiasAct(torch.autograd.Function):
    """y = the epilogue of (x, demod, noise, bias) under `mask` (pre >= 0
    where None).  Keeps the mask, x where demod's gradient is asked for
    (as the plain chain's multiply keeps it) and demod."""

    @staticmethod
    def forward(ctx, x, demod, noise, bias, mask, slope, gain):
        y, mask = _forward(x, demod, noise, bias, mask, slope, gain,
                           want_mask=True)
        need_x, need_demod = ctx.needs_input_grad[:2]
        ctx.save_for_backward(mask, x if need_demod else None,
                              demod if need_x else None)
        ctx.meta = (None if noise is None else noise.shape, slope, gain)
        return y

    @staticmethod
    def backward(ctx, g):
        mask, x, demod = ctx.saved_tensors
        noise_shape, slope, gain = ctx.meta
        args = (g, mask, x, demod, noise_shape, *ctx.needs_input_grad[:4],
                slope, gain)
        grads = _BiasActGrad.apply(*args) if torch.is_grad_enabled() \
            else _grad(*args)
        return (*grads, None, None, None)


class _BiasActGrad(torch.autograd.Function):
    """The epilogue's gradients at `g` (see `_grad`); its own backward runs
    the kernels again under the same mask."""

    @staticmethod
    def forward(ctx, g, mask, x, demod, noise_shape, need_x, need_demod,
                need_noise, need_bias, slope, gain):
        ctx.save_for_backward(g, mask, x, demod)
        ctx.meta = (noise_shape, slope, gain)
        return _grad(g, mask, x, demod, noise_shape, need_x, need_demod,
                     need_noise, need_bias, slope, gain)

    @staticmethod
    def backward(ctx, gg_x, gg_demod, gg_noise, gg_bias):
        g, mask, x, demod = ctx.saved_tensors
        noise_shape, slope, gain = ctx.meta
        need_g, _, need_x, need_demod = ctx.needs_input_grad[:4]
        d_g = d_x = d_demod = None
        if need_g:
            # every output is linear in the masked, scaled g
            if gg_x is not None or gg_noise is not None or \
                    gg_bias is not None:
                d_g = _masked(gg_x, None if gg_x is None else demod,
                              gg_noise, gg_bias, mask, g, slope, gain)
            if gg_demod is not None and x is not None:
                term = _masked(x, gg_demod, None, None, mask, g, slope, gain)
                d_g = term if d_g is None else d_g + term
        if need_x and gg_demod is not None:
            d_x = _BiasActGrad.apply(g, mask, None, gg_demod.contiguous(),
                                     None, True, False, False, False, slope,
                                     gain)[0]
        if need_demod and gg_x is not None:
            d_demod = _BiasActGrad.apply(g, mask, gg_x.contiguous(), None,
                                         None, False, True, False, False,
                                         slope, gain)[1]
        return (d_g, None, d_x, d_demod) + (None,) * 7


def _masked(x, demod, noise, bias, mask, like, slope, gain):
    """The epilogue under a given mask, shaped like `like` (x None reads
    zeros), through `_BiasAct` so that it is differentiable again."""
    x = torch.zeros_like(like) if x is None else x.contiguous()
    return _BiasAct.apply(x, demod if demod is None else demod.contiguous(),
                          noise if noise is None else noise.contiguous(),
                          bias if bias is None else bias.contiguous(), mask,
                          slope, gain)
