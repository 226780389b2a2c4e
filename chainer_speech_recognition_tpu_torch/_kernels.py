"""Build and load the hand-written CUDA kernels in ``csrc/``.

All ``.cu`` sources compile with ONE ``nvcc`` call into a shared library
with a plain C interface, loaded with ``ctypes``; nothing includes
PyTorch's headers, so the build takes seconds. The build runs at the first
launch, into ``_build/`` beside this file (git-ignored), keyed by a hash of
the sources and flags, so a fresh checkout builds everything on its own.
Importing this module needs no ``nvcc``: CPU-only hosts import every
module of the port and never launch a kernel.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises if that is not 0 and counts
the launches, so a run can prove that its main path went through the
kernel (``chip_smoke.py`` resets the counts before the path and reads them
after).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0

    def launch(self, *args) -> None:
        fn = getattr(library(), self.symbol)
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} "
                f"({library().csr_error_string(err).decode()})")
        self.launches += 1


# (pointers..., sizes..., stream): see the matching csrc/*.cu entry point
FRONTEND_LOGMEL = Kernel("csr_frontend_logmel",
                         [_P, _I, _I, _I, _P, _P, _I, _P, _P])
GRU_FWD = Kernel("csr_gru_fwd",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
GREEDY = Kernel("csr_greedy",
                [_P, _P, _I, _I, _I, _P, _P, _P])
KERNELS = {"frontend_logmel": FRONTEND_LOGMEL, "gru_fwd": GRU_FWD,
           "greedy": GREEDY}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> str:
    """Compile ``csrc/*.cu`` into one shared library (cached by content)
    and return its path; fills ``build_info`` (seconds, compiler log)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    so = os.path.join(_BUILD, f"libcsr_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        if build_info.get("path") != so:       # built by an earlier process
            build_info.update(path=so, seconds=0.0, cached=True, log="")
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cu = [s for s in _sources() if s.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(path=so, seconds=time.perf_counter() - t0,
                      cached=False, log=proc.stdout + proc.stderr)
    return so


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for k in KERNELS.values():
                fn = getattr(lib, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
            lib.csr_error_string.argtypes = [ctypes.c_int]
            lib.csr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
