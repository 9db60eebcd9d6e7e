"""Device selection; on CUDA it applies the precision policy."""

import subprocess

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


def describe(device):
    """What a measurement ran on: on CUDA the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (the device's name alone where nvidia-smi does not answer), else
    the device type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or torch.cuda.get_device_name(index)


def synchronize(device):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
