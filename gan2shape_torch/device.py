"""Device selection and the f32 numerics policy for CUDA."""

import torch


def resolve_device(device=None):
    """`device` or CUDA by default.  Raises when CUDA is asked for (or
    defaulted to) and no GPU is present: the port never falls back to the
    CPU on its own.  On CUDA, TF32 is switched off for matmuls and cuDNN
    convolutions, because the reference numerics are exact f32."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
