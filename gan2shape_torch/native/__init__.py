"""ctypes bindings of the mmap record cache (src/cache.cpp): flat binary
files of fixed-size records, read into float32 batches by a C++ thread pool.

The library is built with `g++` at first use into `build/native/` at the
repository root (listed in .gitignore), under a name keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused.  A failed build, or a file that cannot be opened as the records
asked for, raises: there is no silent fallback reader.  `read_records_plain`
is the same read in numpy, the plain version the tests hold the library to.

Layout of a cache file: raw C-order records, record i at byte offset
i * prod(record_shape) * itemsize.  dtype 'uint8' records are scaled to
float32 in [-1, 1] (x * 2/255 - 1); 'float32' records are copied through.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "cache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# -ffp-contract=off keeps x * scale - 1 two roundings, as numpy computes it
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-ffp-contract=off")
DTYPES = {"uint8": 0, "float32": 1}

_lib = None


def library_path():
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libg2s_cache-{digest[:16]}.so"


def build():
    """Compile the library unless it exists; returns its path.  Raises with
    the compiler's output if `g++` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build the native cache:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process sees whole files
    return out


def get_lib():
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.g2s_cache_open.restype = ctypes.c_void_p
        lib.g2s_cache_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int]
        lib.g2s_cache_close.argtypes = [ctypes.c_void_p]
        lib.g2s_cache_get_batch.restype = ctypes.c_int
        lib.g2s_cache_get_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.g2s_cache_prefetch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        if lib.g2s_version() != 1:
            raise RuntimeError("native cache: unexpected library version")
        _lib = lib
    return _lib


def _int64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class TensorCache:
    """Reader over a flat binary record file of `n` records of
    `record_shape`; `get_batch` returns float32 numpy arrays."""

    def __init__(self, cache_path, n, record_shape, dtype="uint8"):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.n = int(n)
        self.record_shape = tuple(record_shape)
        self.record_elems = int(np.prod(record_shape))
        self.dtype = dtype
        self._handle = None
        self._lib = get_lib()
        self._handle = self._lib.g2s_cache_open(
            str(cache_path).encode(), self.n, self.record_elems,
            DTYPES[dtype])
        if not self._handle:
            raise OSError(f"native cache cannot open {cache_path} as {n} "
                          f"{dtype} records of {self.record_shape} (missing "
                          f"or too short)")

    def get_batch(self, indices):
        indices = np.ascontiguousarray(indices, np.int64)
        out = np.empty((len(indices), self.record_elems), np.float32)
        if self._handle is None:
            raise ValueError("native cache is closed")
        rc = self._lib.g2s_cache_get_batch(
            self._handle, _int64_ptr(indices), len(indices),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IndexError(f"native get_batch failed (rc={rc}): indices "
                             f"must lie in [0, {self.n})")
        return out.reshape((len(indices),) + self.record_shape)

    def prefetch(self, indices):
        if self._handle:
            indices = np.ascontiguousarray(indices, np.int64)
            self._lib.g2s_cache_prefetch(self._handle, _int64_ptr(indices),
                                         len(indices))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.g2s_cache_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def read_records_plain(cache_path, n, record_shape, indices, dtype="uint8"):
    """The plain version of `TensorCache.get_batch`, by numpy memmap."""
    np_dtype = np.uint8 if dtype == "uint8" else np.float32
    mm = np.memmap(cache_path, dtype=np_dtype, mode="r",
                   shape=(int(n), int(np.prod(record_shape))))
    recs = mm[np.asarray(indices, np.int64)]
    out = (recs.astype(np.float32) * np.float32(2.0 / 255.0)
           - np.float32(1.0)) if dtype == "uint8" else \
        recs.astype(np.float32)
    return out.reshape((len(recs),) + tuple(record_shape))


def build_image_cache(dataset, cache_path, image_size):
    """Decode every image of an ImageDataset-like object (items (3, H, W)
    float in [-1, 1]) into a uint8 record file; returns its TensorCache."""
    n = len(dataset)
    with open(cache_path, "wb") as f:
        for i in range(n):
            img = np.asarray(dataset[i])
            u8 = np.clip((img + 1.0) * 0.5 * 255.0 + 0.5, 0,
                         255).astype(np.uint8)
            f.write(u8.tobytes())
    return TensorCache(cache_path, n, (3, image_size, image_size), "uint8")
