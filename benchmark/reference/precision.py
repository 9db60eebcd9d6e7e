"""The reference's precision: float32 throughout.  The caller sets the TF32
flags of cuBLAS and cuDNN (off for the reference, on for its control); the
geometry runs in exact f32 under either (`exact_matmul`, `exact_f32`), as
in the program."""

from contextlib import contextmanager

import torch


def resolve_device(device=None):
    return torch.device("cuda" if device is None else device)


def act_dtype():
    return torch.float32


@contextmanager
def exact_f32():
    """TF32 off in cuBLAS and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _ExactMatmul(torch.autograd.Function):
    """torch.matmul of operands of two or more dims whose forward and
    backward both run in exact f32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with exact_f32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        with exact_f32():
            if ctx.needs_input_grad[0]:
                grad_a = torch.matmul(grad, b.mT).sum_to_size(a.shape)
            if ctx.needs_input_grad[1]:
                grad_b = torch.matmul(a.mT, grad).sum_to_size(b.shape)
        return grad_a, grad_b


def exact_matmul(a, b):
    """`torch.matmul(a, b)` (both at least 2-D) in exact f32 under every
    policy, forward and backward."""
    return _ExactMatmul.apply(a, b)
