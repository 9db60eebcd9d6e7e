"""StyleGAN2's convolution epilogue (csrc/bias_act.cu): `bias_act_kernel`
forward, `bias_act_grad_kernel` and `bias_sum_kernel` backward, called
through `ops.fused_act._forward` and `._grad`, which the autograd
Functions look up as module globals.  The least bytes are those the
elementwise passes must move: the per-plane operands (demodulation, bias,
a noise plane) are left out, as the kernel table's bounds leave them."""

MODULE = "gan2shape_torch.ops.fused_act"
KERNELS = ("bias_act_kernel", "bias_act_grad_kernel", "bias_sum_kernel")
METRIC = "bias_act_roofline"


def mask_bytes(n):
    """The mask of pre >= 0: a bit an element, in whole 128-element chunks
    (four int32 words a chunk)."""
    return 16 * ((n + 127) // 128)


def forward_bytes(x, demod, noise, bias, mask, slope, gain, want_mask):
    """x read and y written; the mask written (asked for) or read (given)."""
    n = x.numel()
    return (2 * n * x.element_size()
            + (mask_bytes(n) if want_mask or mask is not None else 0))


def grad_bytes(g, mask, x, demod, noise_shape, need_x, need_demod,
               need_noise, need_bias, slope, gain):
    """g and the mask read; x read where grad_demod is asked for; grad_x
    written where asked for; the gradient before the demodulation written
    where grad_noise is asked for and it is not grad_x itself."""
    n, size = g.numel(), g.element_size()
    streams = 1 + bool(need_demod) + bool(need_x) + bool(
        need_noise and not (need_x and demod is None))
    return streams * n * size + mask_bytes(n)


CALLS = {"_forward": forward_bytes, "_grad": grad_bytes}
