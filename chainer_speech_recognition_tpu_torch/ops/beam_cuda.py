"""The prefix beam's kernel (``csrc/beam.cu``): one launch scans a batch
(or one streaming chunk) of log-probs, orders the final beams and traces
back the kept ones — ``decode/beam.beam_chunk_plain``'s contract, CUDA
tensors only.

Two forms, one launch either way. The narrow form (``csr_beam``, counted
as ``beam``) keeps one lane a beam in its merges and its state in static
shared memory: K ≤ 32 and an LM context of ≤ 8 lanes (order ≤ 9). Every
other call takes the wide form (``csr_beam_wide``, counted as
``beam_wide``): any K up to ``MAX_WIDTH`` (the tracebacks pack a parent
into 16 bits) and any LM order, its top-K a radix select. ``beam_plan``
reads the launch plan from the library: the form, whether the lp rows are
staged in shared memory, whether the chunk's tracebacks fit there (else a
[B, T, K] int32 scratch in device memory holds them) and, for the wide
form, whether its per-row workspace (the state, the LM context lanes, the
merge lists and the survivors) does (else a [B, bytes] scratch holds it).
Nothing here takes the plain version: what the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels

MAX_WIDTH = 32767      # beam width, csrc/beam.cu kMaxWideBeam
MAX_SYMBOLS = 32767    # V, the reference's own limit (decode/beam.py:57)
_LM_KINDS = {"none": 0, "dense": 1, "hashed": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class BeamArgs(ctypes.Structure):
    """csrc/beam.cu ``struct BeamArgs``, field for field."""
    _fields_ = [(n, _P) for n in (
        "lp", "lengths", "pb_in", "pnb_in", "h_in", "h2_in", "ph_in",
        "ph2_in", "last_in", "ctx_in", "pb_out", "pnb_out", "h_out",
        "h2_out", "ph_out", "ph2_out", "last_out", "ctx_out", "lm_table",
        "lm_rows", "tb_scratch", "ws_scratch", "out_chars", "out_counts", "out_parent0",
        "out_final")] + [(n, _I) for n in (
            "B", "T", "V", "K", "ctx_len", "lm_kind", "lm_order",
            "rows_fp16", "cap", "probes")] + [
        ("alpha", _F), ("beta", _F), ("keep", _I), ("width", _I),
        ("ordered", _I)]


class BeamPlan(NamedTuple):
    wide: int        # 1: the wide form (csr_beam_wide)
    staged: int      # 1: lp rows double-buffered in shared memory
    tb_shared: int   # 1: the tracebacks in shared memory, 0: in scratch
    ws_shared: int   # 1: the wide form's workspace in shared memory (1 for
    #                  the narrow form's static state), 0: in scratch
    smem: int        # dynamic shared memory a block, bytes
    ws_bytes: int    # the wide form's workspace a row, bytes (0: narrow)


def beam_plan(T: int, V: int, K: int, ctx_len: int = 1,
              wide: bool = False) -> BeamPlan:
    """The launch plan ``csrc/beam.cu`` takes for a call (``wide``: the
    wide form at any K, as the card tests hold it to the narrow one);
    needs the card's build."""
    out = (ctypes.c_int * 6)()
    _kernels.call("csr_beam_plan", T, V, K, ctx_len, int(wide), out)
    return BeamPlan(*out)


def beam_chunk_cuda(lp, lengths, state, dlm, alpha: float, beta: float,
                    keep: int, width: int, ordered: bool, wide: bool = False):
    """One launch: ``beam_chunk_plain``'s outputs (chars, counts, parent0,
    final, new state) for CUDA tensors. ``wide`` takes the wide form where
    the plan would take the narrow one."""
    B, T, V = lp.shape
    pb, pnb, h, h2, ph, ph2, last, ctx = state
    K, CL = pb.shape[1], ctx.shape[2]
    if not 1 <= K <= MAX_WIDTH:
        raise ValueError(f"beam kernel: beam width {K} outside 1..{MAX_WIDTH} "
                         "(the tracebacks pack a parent into 16 bits)")
    if T < 1 or not 1 <= V <= MAX_SYMBOLS or CL < 1:
        raise ValueError(f"beam kernel: T = {T}, V = {V} (1..{MAX_SYMBOLS}) "
                         f"or LM context {CL} (>= 1) not taken")
    if not 0 <= keep <= K or width < 0:
        raise ValueError(f"beam kernel: keep {keep} (<= {K}) or width "
                         f"{width} out of range")
    dev = lp.device
    _kernels.check_cuda_tensor("lp", lp, torch.float32, (B, T, V))
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    _kernels.check_cuda_tensor("lengths", lengths, torch.int32, (B,))
    for name, x, dt in (("pb", pb, torch.float32), ("pnb", pnb, torch.float32),
                        ("hashes", h, torch.int32), ("hashes2", h2, torch.int32),
                        ("phashes", ph, torch.int32),
                        ("phashes2", ph2, torch.int32),
                        ("last", last, torch.int32)):
        _kernels.check_cuda_tensor(name, x, dt, (B, K))
    _kernels.check_cuda_tensor("ctx", ctx, torch.int32, (B, K, CL))
    kind = _LM_KINDS[dlm.kind]
    table = rows = None
    cap = 0
    if kind == 1:
        table = dlm.table
        _kernels.check_cuda_tensor("lm table", table, torch.float32,
                                   (table.shape[0], V))
    elif kind == 2:
        table, rows = dlm.table, dlm.rows
        cap = table.shape[0]
        _kernels.check_cuda_tensor("lm table", table, torch.int32, (cap, 3))
        if rows.dtype not in (torch.float32, torch.float16):
            raise ValueError(f"lm rows: fp32 or fp16, got {rows.dtype}")
        _kernels.check_cuda_tensor("lm rows", rows, rows.dtype,
                                   (rows.shape[0], V))
        if cap & (cap - 1):
            raise ValueError(f"hashed LM capacity {cap} is not a power of 2")

    plan = beam_plan(T, V, K, CL, wide)
    scratch = (None if plan.tb_shared else
               torch.empty((B, T, K), dtype=torch.int32, device=dev))
    ws = (None if plan.ws_shared else
          torch.empty((B, plan.ws_bytes), dtype=torch.uint8, device=dev))
    new = tuple(torch.empty_like(x) for x in state)
    chars = torch.empty((B, keep, width), dtype=torch.int32, device=dev)
    counts = torch.empty((B, keep), dtype=torch.int32, device=dev)
    parent0 = torch.empty((B, keep), dtype=torch.int32, device=dev)
    final = torch.empty((B, K), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    args = BeamArgs(
        lp.data_ptr(), lengths.data_ptr(), *(x.data_ptr() for x in state),
        *(x.data_ptr() for x in new), ptr(table), ptr(rows), ptr(scratch),
        ptr(ws), chars.data_ptr(), counts.data_ptr(), parent0.data_ptr(),
        final.data_ptr(), B, T, V, K, CL, kind, dlm.order,
        int(rows is not None and rows.dtype == torch.float16), cap,
        dlm.probes, alpha, beta, keep, width, int(ordered))
    kernel = _kernels.BEAM_WIDE if plan.wide else _kernels.BEAM
    kernel.launch(ctypes.addressof(args), _kernels.stream_ptr(lp))
    return chars, counts, parent0, final, new
