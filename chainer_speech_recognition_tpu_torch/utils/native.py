"""Build and load the port's host C++ library (``native/edit_distance.cpp``):
the batch edit distance that CER scoring calls once a batch.

The source compiles with ``g++`` at first use into ``_build/`` beside the
package (git-ignored), keyed by a hash of the source and flags, as
``_kernels.build`` builds the CUDA kernels: each process compiles to a
temporary file named by its pid and moves it into place with
``os.replace``, so processes that build at once (test workers) never read
one another's half-written output. A failed build raises with the
compiler's log; there is no silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "edit_distance.cpp")
_BUILD = os.path.join(_PKG, "_build")
# portable flags: no -march=native, so the library never needs the host
# that built it
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> str:
    """Compile ``SOURCE`` (cached by content) → the shared library's path."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    so = os.path.join(_BUILD, f"libcsr_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """Build (at first use) and load the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.edit_distance_batch_i32.restype = None
            lib.edit_distance_batch_i32.argtypes = [
                _I32P, _I32P, _I32P, _I32P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _I64P]
            _lib = lib
    return _lib


def edit_distance_batch_native(hyps: np.ndarray, hyp_lens: np.ndarray,
                               refs: np.ndarray,
                               ref_lens: np.ndarray) -> np.ndarray:
    """Levenshtein distances of N padded id rows: ``hyps`` [N, Sh] and
    ``refs`` [N, Sr] int32, true lengths in ``*_lens`` [N] → int64[N], in
    one call."""
    h = np.ascontiguousarray(hyps, np.int32)
    r = np.ascontiguousarray(refs, np.int32)
    hl = np.ascontiguousarray(hyp_lens, np.int32)
    rl = np.ascontiguousarray(ref_lens, np.int32)
    n = h.shape[0]
    if (h.ndim != 2 or r.ndim != 2 or r.shape[0] != n
            or hl.shape != (n,) or rl.shape != (n,)):
        raise ValueError(f"edit_distance_batch_native: shapes {h.shape}, "
                         f"{hl.shape}, {r.shape}, {rl.shape}")
    if n and (hl.min() < 0 or rl.min() < 0 or hl.max() > h.shape[1]
              or rl.max() > r.shape[1]):
        raise ValueError("edit_distance_batch_native: a length exceeds its "
                         "row")
    out = np.empty(n, np.int64)
    library().edit_distance_batch_i32(
        h.ctypes.data_as(_I32P), hl.ctypes.data_as(_I32P),
        r.ctypes.data_as(_I32P), rl.ctypes.data_as(_I32P),
        n, h.shape[1], r.shape[1], out.ctypes.data_as(_I64P))
    return out
