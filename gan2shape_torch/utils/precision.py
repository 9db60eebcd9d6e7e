"""The precision policy: how float32 matmuls and convolutions run on CUDA,
and the activation dtype of the frozen stacks (the StyleGAN2 generator and
discriminator, the LPIPS trunk).

`matmul_precision` names how cuBLAS and cuDNN treat float32 operands:

  'highest'  exact f32: TF32 off in cuBLAS and cuDNN;
  'high'     TF32 in both (a 10-bit mantissa in the products, f32 sums);
  'default'  the fastest mode for f32 tensors.  On an H100 that is TF32 as
             well: cuDNN has no single-pass bf16 mode for f32 inputs.  The
             bf16 half of the JAX package's 'default' (single-pass bf16 on
             the TPU's matrix unit) is `act_dtype`'s job here.

`act_dtype` names the dtype the frozen stacks keep their activations in:
'float32', 'bfloat16', or 'auto' (f32 on every device in this package).
Their weights stay f32 and are cast at each call, so a GAN trained under
'bfloat16' keeps f32 parameters and gradients.

Set either from the model config (`matmul_precision`, `act_dtype`: read by
`GAN2Shape`), from the environment (`G2S_MATMUL_PRECISION`,
`G2S_ACT_DTYPE`, read at import), or with the setters.  The default is
'highest' / 'float32': exact f32, which every parity check of the port is
taken at.  `resolve_device` applies the current policy to the torch flags,
so building a module never undoes what a config set.

Geometry stays exact f32 under every policy, forward and backward: the
renderer's and the view sampler's matmuls and the resize go through
`exact_matmul`, and the FIR filter runs under `exact_f32`.  A context
around a forward call alone would not do: autograd runs the backward
matmuls later, under the global flags.  The one torch API used for the
flags is the `allow_tf32` pair; torch raises when it is mixed with the
newer `fp32_precision` attributes.

`deterministic()` is a context in which two runs of the same work on the
card repeat bit for bit.  It is not part of the policy, and no trainer
turns it on by default.
"""

import os
from contextlib import contextmanager

import torch

MATMUL_PRECISIONS = ("highest", "high", "default")
_ACT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_matmul_name(name):
    """Validate before assigning: a bad name must not poison the state."""
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of "
                         f"{list(MATMUL_PRECISIONS)}, got {name!r}")
    return name


def _check_act_name(name):
    if name is not None and name != "auto" and name not in _ACT_DTYPES:
        raise ValueError(f"act_dtype must be one of {sorted(_ACT_DTYPES)}, "
                         f"'auto', or None, got {name!r}")
    return name


_matmul_name = _check_matmul_name(
    os.environ.get("G2S_MATMUL_PRECISION", "highest"))
_act_name = _check_act_name(os.environ.get("G2S_ACT_DTYPE", "auto"))


def set_matmul_precision(name):
    """Set the policy and apply it to the torch flags at once."""
    global _matmul_name
    _matmul_name = _check_matmul_name(str(name))
    apply_matmul_precision()


def matmul_precision():
    return _matmul_name


def apply_matmul_precision():
    """Set cuBLAS's and cuDNN's TF32 flags to the current policy."""
    tf32 = _matmul_name != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def set_act_dtype(name):
    global _act_name
    _act_name = _check_act_name(None if name is None else str(name))


def act_dtype():
    """The frozen stacks' activation dtype; 'auto' and None are f32."""
    return _ACT_DTYPES.get(_act_name, torch.float32)


@contextmanager
def policy(matmul=None, act=None):
    """Run the block under `matmul` / `act` (None keeps that part) and
    restore the policy that was set before, whatever happens inside."""
    saved = (_matmul_name, _act_name)
    try:
        if matmul is not None:
            set_matmul_precision(matmul)
        if act is not None:
            set_act_dtype(act)
        yield
    finally:
        set_matmul_precision(saved[0])
        set_act_dtype(saved[1])


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


# cuBLAS repeats its results only with a fixed workspace layout, read from
# the environment when its first handle is made
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@contextmanager
def deterministic():
    """Inside the block two runs of the same work on the card give the same
    bits: cuDNN's deterministic algorithms without autotuning, and torch's
    deterministic mode, which raises on any op without a deterministic CUDA
    kernel (and fills fresh tensors from `torch.empty`).  The flags are
    restored after.  `CUBLAS_WORKSPACE_CONFIG` is set to
    `CUBLAS_WORKSPACE_CONFIG` if unset, but cuBLAS reads it only once, when
    its first handle is made: a process that has already run a matmul on
    the card must have had it in its environment from the start.  The
    port's own kernels are deterministic under every setting."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


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
