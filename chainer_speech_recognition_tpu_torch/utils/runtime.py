"""Runtime helpers (port of ``utils/runtime.py``): the profiler trace.

The reference's module has two more functions, both specific to JAX, and
the port gives neither a counterpart by design:

* ``respect_jax_platforms`` makes an explicit ``JAX_PLATFORMS`` win over a
  platform pinned by the image. The port names its device explicitly
  instead: every CLI takes ``--device`` (``cli/common.resolve_device``:
  ``cuda`` raises without a card, never a silent CPU fallback).
* ``enable_compilation_cache`` keeps XLA's compiled programs across runs.
  The port compiles no program at run time; its CUDA kernels are built
  once into ``_build/`` beside the package, keyed by a hash of the sources
  and the compiler flags (``_kernels.build``), and a later run loads that
  library.
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE = "trace.json"       # the trace's file name in ``log_dir``


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda"):
    """Context manager: a ``torch.profiler`` trace around a window (host
    activity, and the card's on a CUDA ``device``), which waits for the
    card before it stops and then writes a Chrome/Perfetto trace to
    ``log_dir/trace.json``; yields the profiler (``key_averages()``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])])
    with prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE))
