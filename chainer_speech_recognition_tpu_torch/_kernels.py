"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` source compiles with its own ``nvcc -c``, all started
together, and one more ``nvcc`` links the objects into a shared library
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
after). A launch into a stream that is capturing a CUDA graph runs nothing
and is held out of the counts (:func:`capturing`); each replay of the
graph adds the launches captured in it (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        held = _held
        with _count_lock:
            if held is not None and _stream_capturing():
                held[self] = held.get(self, 0) + 1
            else:
                self.launches += 1


# (pointers..., sizes..., stream): see the matching csrc/*.cu entry point
FRONTEND_LOGMEL = Kernel("csr_frontend_logmel",
                         [_P, _I, _I, _I, _P, _P, _I, _P, _P])
GREEDY = Kernel("csr_greedy",
                [_P, _P, _I, _I, _I, _I, _P, _P, _P])
CTC_FWD = Kernel("csr_ctc_fwd",
                 [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
CTC_BWD = Kernel("csr_ctc_bwd",
                 [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
# the recurrences' (..., T, B, H, ndir, C, bf16, stream): C is the bf16
# cluster kernels' blocks a cluster (ops/rnn_cuda.lstm_plan, gru_plan),
# unread under fp32
GRU_FWD = Kernel("csr_gru_fwd", [_P] * 5 + [_I] * 6 + [_P])
GRU_FWD_TRAIN = Kernel("csr_gru_fwd_train", [_P] * 6 + [_I] * 6 + [_P])
GRU_BWD = Kernel("csr_gru_bwd", [_P] * 8 + [_I] * 6 + [_P])
LSTM_FWD = Kernel("csr_lstm_fwd", [_P] * 5 + [_I] * 6 + [_P])
LSTM_FWD_TRAIN = Kernel("csr_lstm_fwd_train", [_P] * 7 + [_I] * 6 + [_P])
LSTM_BWD = Kernel("csr_lstm_bwd", [_P] * 7 + [_I] * 6 + [_P])
# the stream forms': (..., T, B, H, ndir, emit_t, C, bf16, stream)
GRU_FWD_STREAM = Kernel("csr_gru_fwd_stream", [_P] * 7 + [_I] * 7 + [_P])
LSTM_FWD_STREAM = Kernel("csr_lstm_fwd_stream", [_P] * 7 + [_I] * 7 + [_P])
FRONTEND_LOGMEL_FRAMES = Kernel("csr_frontend_logmel_frames",
                                [_P, _I, _I, _P, _P, _I, _P, _P])
# flash attention: (tensors..., dims, strides) with dims and strides host
# int arrays (ops/attention_cuda.py), then the bf16 flag and the stream
FLASH_FWD = Kernel("csr_flash_fwd", [_P] * 8 + [_I, _P])
FLASH_BWD_DQ = Kernel("csr_flash_bwd_dq", [_P] * 10 + [_I, _P])
FLASH_BWD_DKV = Kernel("csr_flash_bwd_dkv", [_P] * 11 + [_I, _P])
# the recurrences' dW: (ys, g1, ld1, n1, g2, ld2, n2, out, T, B, H, ndir,
# stream)
DW = Kernel("csr_dw", [_P, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P])
# the prefix beam, narrow (K <= 32, order <= 9) and wide (any other call):
# (the address of its argument struct, ops/beam_cuda.BeamArgs, stream)
BEAM = Kernel("csr_beam", [_P, _P])
BEAM_WIDE = Kernel("csr_beam_wide", [_P, _P])
KERNELS = {"frontend_logmel": FRONTEND_LOGMEL, "gru_fwd": GRU_FWD,
           "greedy": GREEDY, "gru_fwd_train": GRU_FWD_TRAIN,
           "gru_bwd": GRU_BWD, "ctc_fwd": CTC_FWD, "ctc_bwd": CTC_BWD,
           "lstm_fwd": LSTM_FWD, "lstm_fwd_train": LSTM_FWD_TRAIN,
           "lstm_bwd": LSTM_BWD, "gru_fwd_stream": GRU_FWD_STREAM,
           "lstm_fwd_stream": LSTM_FWD_STREAM,
           "frontend_logmel_frames": FRONTEND_LOGMEL_FRAMES,
           "flash_fwd": FLASH_FWD, "flash_bwd_dq": FLASH_BWD_DQ,
           "flash_bwd_dkv": FLASH_BWD_DKV, "dw": DW, "beam": BEAM,
           "beam_wide": BEAM_WIDE}

# functions of the library that launch nothing (no count): (H, out) →
# out = (shared memory bytes, clusters the card holds at once); the CTC
# kernels' (S, bwd, out) → out = their launch shape (ops/ctc_cuda.ctc_plan);
# the dW kernel's (T, B, H, N, ndir, out) → its launch shape
# (ops/rnn_cuda.dw_plan);
# the beam's (T, V, K, ctx_len, wide, out) → its launch plan
# (ops/beam_cuda.beam_plan)
HELPERS = {f"csr_{cell}_{form}_occupancy": [_I, ctypes.POINTER(_I)]
           for cell in ("gru", "lstm") for form in ("fwd", "bwd")}
HELPERS["csr_ctc_plan"] = [_I, _I, ctypes.POINTER(_I)]
HELPERS["csr_dw_plan"] = [_I] * 5 + [ctypes.POINTER(_I)]
HELPERS["csr_beam_plan"] = [_I] * 5 + [ctypes.POINTER(_I)]

_lock = threading.Lock()
_count_lock = threading.Lock()
_held: dict | None = None         # {Kernel: n} while a graph is captured
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to the kernels' counts: a CUDA graph's replay
    launches the kernels captured in it without calling their wrappers
    (``train/step.make_cached_train_step``)."""
    with _count_lock:
        for name, n in counts.items():
            KERNELS[name].launches += n


def _stream_capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured: launches into a capturing stream
    (from the capturing thread, and from autograd's thread for the
    backward) are held out of the counts and gathered into the yielded
    ``{name: n}`` (filled on exit). Launches into other streams (a window
    fetch on its own stream meanwhile) count as usual."""
    global _held
    held: dict = {}
    with _count_lock:
        if _held is not None:
            raise RuntimeError("kernel launches: nested capture")
        _held = held
    out: dict[str, int] = {}
    try:
        yield out
    finally:
        with _count_lock:
            _held = None
        out.update({name: held[k] for name, k in KERNELS.items()
                    if k in held})


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
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(cu, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = "".join(f"nvcc failed on {os.path.basename(s)} "
                     f"({p.returncode}):\n{log}\n"
                     for s, p, log in zip(cu, procs, logs) if p.returncode)
    link = None if failed else subprocess.run(
        [_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True,
        text=True)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed or link.returncode != 0:
        raise RuntimeError(failed or f"nvcc link failed ({link.returncode})"
                           f":\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, so)
    build_info.update(path=so, seconds=time.perf_counter() - t0,
                      cached=False, log="".join(logs) + link.stdout
                      + link.stderr)
    return so


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for symbol, argtypes in [*((k.symbol, k.argtypes)
                                       for k in KERNELS.values()),
                                     *HELPERS.items()]:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.csr_error_string.argtypes = [ctypes.c_int]
            lib.csr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def call(symbol: str, *args) -> int:
    """Call one of ``HELPERS`` → its return value (a CUDA status)."""
    return getattr(library(), symbol)(*args)


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


def check_cpu_tensor(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on the CPU (where wrappers take the plain
    versions)."""
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")
