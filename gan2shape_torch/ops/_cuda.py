"""Build, load and launch-count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with ctypes.  Libraries are built at first
use into `build/kernels/` at the repository root (listed in .gitignore), under
a name keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  `build()` starts one `nvcc` per
source at once.

Every wrapper that launches a kernel adds one to `LAUNCHES[name]` right where
it launches, and nowhere else; `reset_launches()` zeroes the counts.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("window", "raster")

# --fmad=false keeps mul and add separately rounded, so the rasterizer's key
# arithmetic stays bit-equal to the plain version (see csrc/raster.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "window": {
        "g2s_fetch2x2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "g2s_splat2x2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "raster": {
        "g2s_raster_place": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
        "g2s_raster_tests": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P),
    },
}

LAUNCHES = {"raster_place": 0, "raster_tests": 0, "fetch2x2": 0,
            "splat2x2": 0}

_loaded = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES):
    """Compile every missing library in `names`, all nvcc processes at once.
    Returns {name: compiler output} for the ones built; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, out)  # atomic: a concurrent process sees whole files
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name):
    """The ctypes library for csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def stream_of(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err, what):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def check_cuda_tensor(t, name, dtype, ndim):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
