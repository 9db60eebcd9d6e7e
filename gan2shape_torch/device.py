"""Device selection; on CUDA it applies the precision policy."""

import torch

from gan2shape_torch.utils.precision import apply_matmul_precision


def resolve_device(device=None):
    """`device` or CUDA by default.  Raises when CUDA is asked for (or
    defaulted to) and no GPU is present: the port never falls back to the
    CPU on its own.  On CUDA, the TF32 flags of cuBLAS and cuDNN are set to
    the current `matmul_precision` (exact f32 by default), so a module built
    after the policy was set keeps it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU")
        apply_matmul_precision()
    return device
