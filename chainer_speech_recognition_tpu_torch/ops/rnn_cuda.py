"""Bidirectional GRU and LSTM recurrence kernels (``csrc/gru_fwd.cu``,
``csrc/gru_bwd.cu``, ``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``), the
weight-gradient kernel of their training backward (``csrc/dw.cu``) and
their autograd Functions.

Port of ``ops/rnn_pallas.py``, with the same layout (G = 3 gates for the
GRU, 4 for the LSTM):

  xs    [T, R=ndir·B, G·H] stream dtype — input pre-activations; rows
                         [d·B, (d+1)·B) use w[d]: for a bidirectional layer
                         (ndir = 2) rows [0, B) are the forward direction,
                         rows [B, 2B) the time-reversed backward direction;
                         a forward-only layer (ndir = 1) has rows [0, B)
  w     [ndir, H, G·H] fp32 — recurrent weights per direction (ndir is w's
                         leading extent: 2, or 1 for a forward-only layer,
                         in every form: a forward-only layer runs its one
                         W, where the TPU path duplicates it)
  lo/hi [R, 1]        fp32 — step t is live for a row iff lo ≤ t < hi
  ys    [T, R, H]     fp32 — the carries h, frozen outside [lo, hi)
  cs    [T, R, H]     fp32 — the LSTM cell states c, frozen likewise
                         (training)
  gates [T, R, 4H]    stream dtype — per step, (r, z, n, hp_n) for the GRU,
                         (i, f, o, u) for the LSTM (training)
  h0    [R, C]        fp32 — the stream forms' initial carry (C = H for the
                         GRU, 2H = h‖c for the LSTM)
  carry [R, C]        fp32 — the stream forms' carry after ``emit_t`` steps

The stream dtype is bf16 under bf16 compute and the compute dtype
otherwise (``stream_dtype``, as ``rnn_pallas._stream_dt``). The recurrent
products round their operands to the compute dtype and accumulate in fp32;
carries and gate math are fp32 (fp64 when the compute dtype is fp64, which
only the tests use). The LSTM's forget gate has the reference's +1 bias.

Eight recurrence kernels, each with its wrapper (the kernel for CUDA tensors, the
plain version for CPU tensors):

* ``gru_scan`` / ``lstm_scan``: the residual-free forward
  (``birnn_pallas``'s primal);
* ``gru_scan_stream`` / ``lstm_scan_stream``: the residual-free forward of
  a streaming window (``birnn_pallas_stream``), seeded from ``h0`` and
  returning (ys, the carry after ``emit_t`` steps);
* ``gru_scan_train`` / ``lstm_scan_train``: the forward that also writes
  the residuals (``gates``, and ``cs`` for the LSTM);
* ``gru_bwd`` → (dxs, dhn) and ``lstm_bwd`` → dxs: the reverse-time
  gradient walk.

Under bf16 compute every form of both cells, the three forwards
(residual-free, stream, training) and the backward, multiplies on the
tensor cores. Up to H = 512 (``RESIDENT_MAX``) they run on thread-block
clusters (``lstm_plan``, ``gru_plan``; 16 rows a cluster), each block
keeping its slice of W in shared memory (C = H / 32 blocks, or H / 16 in
the GRU's backward up to H = 256; ``lstm_fwd_tc_weights``,
``lstm_bwd_tc_weights``, ``gru_fwd_tc_weights``, ``gru_bwd_tc_weights``).
Past it, up to H = 2048 (``MAX_HIDDEN``), W no longer fits a cluster's
shared memory. Every bf16 form of both cells then runs the persistent form
(``persist_plan``): one cooperative launch of about sms / ndir blocks a
direction over the whole card (of any SM count from ndir up: a block of
more than ``GROUP_TILES`` unit tiles runs them in groups), W spread over
their shared memory
(``persist_fwd_weights``, ``persist_lstm_fwd_weights``,
``persist_bwd_weights``, ``persist_gru_bwd_weights``: fragment order),
every row of a direction multiplied at each step and the step's exchange
through a global workspace behind one grid barrier a step; the LSTM's
forwards and the GRU's backward stage that exchange (A) in shared memory
before their products. Under
fp32 the FMA kernels read W as it is (the GRU's forward), transposed (its
backward) or as k-quads (the LSTM's), one hidden unit a thread up to H =
512, two up to 1024 and four above. The stream wrappers take the laid-out
W from a cache kept per weight tensor (``stream_launch_args``), since a
streaming window calls every layer once; the other wrappers lay it out at
each call.

``BiGRUScan`` and ``BiLSTMScan`` are ``birnn_pallas``'s custom VJP, for
both direction counts: the training forward, the backward kernel, then
dW = Σ_t h_prevᵀ·dgate with
compute-dtype operands and fp32 accumulation (``_dw_einsum``; for the LSTM
the masked dg is dxs itself) through ``rnn_dw``: under bf16 on the card
the dW kernel (``csrc/dw.cu``, ``dw_cuda``), which reads ys and the gate
gradients in place by TMA and multiplies on wgmma, one launch a layer
(the GRU's two products in one); otherwise the plain ``dw_plain``.

``kernel_takes(H)`` is the hidden sizes the kernels take and the gate of
``models/rnn.py``'s ``auto`` routing; ``ROUTED`` counts the path each
layer call took.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _kernels


# per-call routing log: models/rnn.py adds one to the path each layer call
# takes (the kernels' wrappers, or the plain scan)
ROUTED = {"kernel": 0, "scan": 0}


# the largest hidden size whose bf16 kernels keep W in a cluster's shared
# memory, and the largest the kernels take (the persistent form between)
RESIDENT_MAX, MAX_HIDDEN = 512, 2048
SMEM_MAX = 232448       # shared memory a block may use on an H100 (227 KB)
SMS = 132               # an H100 SXM's SMs: the plans' default


def kernel_takes(H: int) -> bool:
    """The hidden sizes the kernels take: 32 ≤ H ≤ 2048 with H % 32 == 0,
    every H % 128 == 0 the reference's kernels take up to 2048 among them
    (the bf16 kernels: clusters of C ≤ 16 blocks, W resident in their
    shared memory up to H = 512; above, the persistent form; the fp32 FMA
    kernels: up to four units a thread of 512)."""
    return H % 32 == 0 and 32 <= H <= MAX_HIDDEN


def stream_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else compute_dtype


def _acc_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(compute_dtype, torch.float32)


def _dot2(x, wc, transpose: bool = False):
    """Per-direction product (``rnn_pallas._dot2``): rows [d·B, (d+1)·B)
    of ``x`` times ``wc[d]`` (or its transpose), B = rows / ndir."""
    B = x.shape[0] // wc.shape[0]
    return torch.cat([x[d * B:(d + 1) * B] @ (wd.T if transpose else wd)
                      for d, wd in enumerate(wc)], dim=0)


def _gru_step(xp, hp, h, H):
    r = torch.sigmoid(xp[:, :H] + hp[:, :H])
    z = torch.sigmoid(xp[:, H:2*H] + hp[:, H:2*H])
    n = torch.tanh(xp[:, 2*H:] + r * hp[:, 2*H:])
    return r, z, n, (1.0 - z) * n + z * h


def _scan(xs, w, lo, hi, compute_dtype, gates: bool, h0=None, emit_t=0):
    """→ (ys, gates or None, the carry after ``emit_t`` steps); h starts
    from ``h0`` (zeros when None)."""
    T, R, _ = xs.shape
    H = w.shape[1]
    acc = _acc_dtype(compute_dtype)
    wc = w.to(compute_dtype).to(acc)                        # [ndir, H, 3H]
    h = (torch.zeros((R, H), dtype=acc, device=xs.device) if h0 is None
         else h0.to(acc))
    carry = h
    ys = torch.empty((T, R, H), dtype=acc, device=xs.device)
    gs = (torch.empty((T, R, 4 * H), dtype=xs.dtype, device=xs.device)
          if gates else None)
    for t in range(T):
        hp = _dot2(h.to(compute_dtype).to(acc), wc)
        r, z, n, h_new = _gru_step(xs[t].to(acc), hp, h, H)
        valid = (lo <= t) & (t < hi)                       # [R, 1]
        h = torch.where(valid, h_new, h)
        ys[t] = h
        if t < emit_t:
            carry = h
        if gates:
            gs[t] = torch.cat([r, z, n, hp[:, 2*H:]], dim=1).to(xs.dtype)
    return ys, gs, carry


def gru_scan_plain(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the residual-free kernel (any device;
    autograd can differentiate it)."""
    return _scan(xs, w, lo, hi, compute_dtype, gates=False)[0]


def gru_scan_train_plain(xs, w, lo, hi, compute_dtype):
    """Plain version of the training forward: (ys, gates)."""
    return _scan(xs, w, lo, hi, compute_dtype, gates=True)[:2]


def gru_scan_stream_plain(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """Plain version of the stream kernel: (ys [T,R,H], carry [R,H]), h
    seeded from ``h0`` [R, H] fp32; ``carry`` is h after step
    ``emit_t - 1`` (``h0`` itself when ``emit_t`` is 0), frozen outside
    each row's [lo, hi) like ys."""
    _check_emit(emit_t, xs.shape[0])
    ys, _, carry = _scan(xs, w, lo, hi, compute_dtype, False, h0, emit_t)
    return ys, carry


def gru_bwd_plain(gates, w, lo, hi, h_prev, g, compute_dtype):
    """Plain version of the backward kernel: (dxs [T,R,3H], dhn [T,R,H])
    in the stream dtype, given the incoming gradient ``g`` of ys."""
    T, R, _ = gates.shape
    H = w.shape[1]
    acc = _acc_dtype(compute_dtype)
    wc = w.to(compute_dtype).to(acc)
    dh = torch.zeros((R, H), dtype=acc, device=gates.device)
    dxs = torch.empty((T, R, 3 * H), dtype=gates.dtype, device=gates.device)
    dhn = torch.empty((T, R, H), dtype=gates.dtype, device=gates.device)
    for t in reversed(range(T)):
        gt = gates[t].to(acc)
        r, z, n, hn = gt[:, :H], gt[:, H:2*H], gt[:, 2*H:3*H], gt[:, 3*H:]
        dh_total = g[t].to(acc) + dh
        dz = dh_total * (h_prev[t].to(acc) - n) * z * (1.0 - z)
        dn = dh_total * (1.0 - z) * (1.0 - n * n)
        dr = dn * hn * r * (1.0 - r)
        dhn_t = dn * r
        dhp = torch.cat([dr, dz, dhn_t], dim=1).to(compute_dtype).to(acc)
        dh_prev = dh_total * z + _dot2(dhp, wc, transpose=True)
        valid = (lo <= t) & (t < hi)
        dxs[t] = torch.where(valid, torch.cat([dr, dz, dn], dim=1),
                             0.0).to(gates.dtype)
        dhn[t] = torch.where(valid, dhn_t, 0.0).to(gates.dtype)
        dh = torch.where(valid, dh_prev, dh_total)
    return dxs, dhn


def _lstm_gates(xp, hp, H):
    g = xp + hp
    i = torch.sigmoid(g[:, :H])
    f = torch.sigmoid(g[:, H:2*H] + 1.0)            # forget bias +1
    o = torch.sigmoid(g[:, 2*H:3*H])
    u = torch.tanh(g[:, 3*H:])
    return i, f, o, u


def _lstm_scan(xs, w, lo, hi, compute_dtype, residuals: bool, h0=None,
               emit_t=0):
    """→ (ys, cs, gates, the carry h‖c after ``emit_t`` steps); cs and
    gates are None without residuals; h‖c starts from ``h0`` (zeros when
    None)."""
    T, R, _ = xs.shape
    H = w.shape[1]
    acc = _acc_dtype(compute_dtype)
    wc = w.to(compute_dtype).to(acc)                        # [ndir, H, 4H]
    if h0 is None:
        h = torch.zeros((R, H), dtype=acc, device=xs.device)
        c = torch.zeros_like(h)
    else:
        h, c = h0.to(acc)[:, :H], h0.to(acc)[:, H:]
    carry = (h, c)
    ys = torch.empty((T, R, H), dtype=acc, device=xs.device)
    cs = torch.empty_like(ys) if residuals else None
    gs = (torch.empty((T, R, 4 * H), dtype=xs.dtype, device=xs.device)
          if residuals else None)
    for t in range(T):
        hp = _dot2(h.to(compute_dtype).to(acc), wc)
        i, f, o, u = _lstm_gates(xs[t].to(acc), hp, H)
        c_new = f * c + i * u
        h_new = o * torch.tanh(c_new)
        valid = (lo <= t) & (t < hi)                       # [R, 1]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        ys[t] = h
        if t < emit_t:
            carry = (h, c)
        if residuals:
            cs[t] = c
            gs[t] = torch.cat([i, f, o, u], dim=1).to(xs.dtype)
    return ys, cs, gs, torch.cat(carry, dim=1)


def lstm_scan_plain(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the residual-free LSTM kernel (any device;
    autograd can differentiate it)."""
    return _lstm_scan(xs, w, lo, hi, compute_dtype, residuals=False)[0]


def lstm_scan_train_plain(xs, w, lo, hi, compute_dtype):
    """Plain version of the LSTM training forward: (ys, cs, gates)."""
    return _lstm_scan(xs, w, lo, hi, compute_dtype, residuals=True)[:3]


def lstm_scan_stream_plain(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """Plain version of the LSTM stream kernel: (ys [T,R,H], carry [R,2H]
    = h‖c after step ``emit_t - 1``, ``h0`` itself when ``emit_t`` is 0),
    h‖c seeded from ``h0`` [R, 2H] fp32."""
    _check_emit(emit_t, xs.shape[0])
    ys, _, _, carry = _lstm_scan(xs, w, lo, hi, compute_dtype, False, h0,
                                 emit_t)
    return ys, carry


def lstm_bwd_plain(gates, w, lo, hi, cs, g, compute_dtype):
    """Plain version of the LSTM backward kernel: dxs [T,R,4H] in the
    stream dtype (the masked gate pre-activation gradients), given the
    incoming gradient ``g`` of ys. The reference's c_prev stream is cs one
    step back (0 at t = 0), read from cs here as the kernel does."""
    T, R, _ = gates.shape
    H = w.shape[1]
    acc = _acc_dtype(compute_dtype)
    wc = w.to(compute_dtype).to(acc)
    dh = torch.zeros((R, H), dtype=acc, device=gates.device)
    dc = torch.zeros_like(dh)
    dxs = torch.empty((T, R, 4 * H), dtype=gates.dtype, device=gates.device)
    for t in reversed(range(T)):
        gt = gates[t].to(acc)
        i, f, o, u = gt[:, :H], gt[:, H:2*H], gt[:, 2*H:3*H], gt[:, 3*H:]
        dh_total = g[t].to(acc) + dh
        tc = torch.tanh(cs[t].to(acc))
        do = dh_total * tc * o * (1.0 - o)
        dct = dc + dh_total * o * (1.0 - tc * tc)
        c_prev = cs[t - 1].to(acc) if t > 0 else torch.zeros_like(dh)
        df = dct * c_prev * f * (1.0 - f)
        di = dct * u * i * (1.0 - i)
        du = dct * i * (1.0 - u * u)
        dg = torch.cat([di, df, do, du], dim=1)
        dgc = dg.to(compute_dtype).to(acc)
        dh_prev = _dot2(dgc, wc, transpose=True)
        valid = (lo <= t) & (t < hi)
        dxs[t] = torch.where(valid, dg, 0.0).to(gates.dtype)
        dh = torch.where(valid, dh_prev, dh_total)
        dc = torch.where(valid, dct * f, dc)
    return dxs


def _check_sizes(T: int, R: int, H: int, compute_dtype,
                 cell: str = "gru", ndir: int = 2) -> torch.dtype:
    """Raise unless the kernels take these sizes; → the stream dtype."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{cell} kernel: compute dtype {compute_dtype} is "
                         "not supported (float32 or bfloat16)")
    if ndir not in (1, 2) or R % ndir or R < ndir or T < 1:
        raise ValueError(f"{cell} kernel: need T >= 1, ndir 1 or 2 and R a "
                         f"positive multiple of ndir (got T={T}, R={R}, "
                         f"ndir={ndir})")
    if not kernel_takes(H):
        raise ValueError(f"{cell} kernel: hidden size {H} unsupported "
                         f"(32 <= H <= {MAX_HIDDEN}, H % 32 == 0: in bf16 W "
                         f"in shared memory up to H = {RESIDENT_MAX}, spread "
                         "over the card above; in fp32 up to 4 units a "
                         "thread)")
    return stream_dtype(compute_dtype)


def _check_emit(emit_t: int, T: int) -> None:
    if not 0 <= emit_t <= T:
        raise ValueError(f"stream kernel: emit_t={emit_t} outside [0, T={T}]")


def _check_weights(w, lo, hi, R: int, H: int, G: int = 3,
                   ndir: int = 2) -> None:
    _kernels.check_cuda_tensor("w", w, torch.float32, (ndir, H, G * H))
    _kernels.check_cuda_tensor("lo", lo, torch.float32, (R, 1))
    _kernels.check_cuda_tensor("hi", hi, torch.float32, (R, 1))


def _check_scan(xs, w, lo, hi, compute_dtype, cell: str = "gru",
                ndir: int = 2):
    """→ (T, B, H, stream dtype); R = ndir·B."""
    T, R, _ = xs.shape
    H = w.shape[1]
    G = 3 if cell == "gru" else 4
    sdt = _check_sizes(T, R, H, compute_dtype, cell, ndir)
    _kernels.check_cuda_tensor("xs", xs, sdt, (T, R, G * H))
    _check_weights(w, lo, hi, R, H, G, ndir)
    return T, R // ndir, H, sdt


def _check_stream(xs, w, lo, hi, h0, compute_dtype, emit_t, cell):
    """→ (T, B, H, ndir) of a stream launch; h0 is [R, C] fp32."""
    ndir = w.shape[0]
    T, B, H, _ = _check_scan(xs, w, lo, hi, compute_dtype, cell, ndir)
    C = H if cell == "gru" else 2 * H
    _kernels.check_cuda_tensor("h0", h0, torch.float32, (ndir * B, C))
    _check_emit(emit_t, T)
    return T, B, H, ndir


def gru_scan_cuda(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Residual-free kernel launch (CUDA tensors only; raises on shapes it
    does not take); ndir = w.shape[0]."""
    ndir = w.shape[0]
    T, B, H, _ = _check_scan(xs, w, lo, hi, compute_dtype, ndir=ndir)
    wk, C = _gru_launch_args(w, B, compute_dtype, "fwd")
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    work = _work("gru", "fwd", w, B, compute_dtype)
    _kernels.GRU_FWD.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), _ptr(work), T, B, H, ndir, C, _sms(w),
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys


def gru_scan_stream_cuda(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """Stream kernel launch: (ys, carry); CUDA tensors only."""
    T, B, H, ndir = _check_stream(xs, w, lo, hi, h0, compute_dtype, emit_t,
                                  "gru")
    wk, C = stream_launch_args("gru", w, B, compute_dtype)
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    carry = torch.empty_like(h0)
    work = _work("gru", "fwd", w, B, compute_dtype)
    _kernels.GRU_FWD_STREAM.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), carry.data_ptr(), _ptr(work), T, B, H,
        ndir, emit_t, C, _sms(w), int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(xs))
    return ys, carry


def gru_scan_train_cuda(xs, w, lo, hi, compute_dtype):
    """Training forward launch: (ys, gates); CUDA tensors only; ndir =
    w.shape[0]."""
    ndir = w.shape[0]
    T, B, H, sdt = _check_scan(xs, w, lo, hi, compute_dtype, ndir=ndir)
    wk, C = _gru_launch_args(w, B, compute_dtype, "fwd")
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    gates = torch.empty((T, ndir * B, 4 * H), dtype=sdt, device=xs.device)
    work = _work("gru", "fwd", w, B, compute_dtype)
    _kernels.GRU_FWD_TRAIN.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), gates.data_ptr(), _ptr(work), T, B, H, ndir, C, _sms(w),
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys, gates


def gru_bwd_cuda(gates, w, lo, hi, ys, g, compute_dtype):
    """Backward kernel launch: (dxs, dhn); CUDA tensors only; ndir =
    w.shape[0]. The kernel reads h_prev as ``ys`` one step back (zeros at
    t = 0), so no shifted copy of ys is made."""
    T, R, _ = gates.shape
    ndir, H = w.shape[:2]
    sdt = _check_sizes(T, R, H, compute_dtype, ndir=ndir)
    _check_weights(w, lo, hi, R, H, ndir=ndir)
    _kernels.check_cuda_tensor("gates", gates, sdt, (T, R, 4 * H))
    _kernels.check_cuda_tensor("ys", ys, torch.float32, (T, R, H))
    _kernels.check_cuda_tensor("g", g, torch.float32, (T, R, H))
    B = R // ndir
    wk, C = _gru_launch_args(w, B, compute_dtype, "bwd")
    dxs = torch.empty((T, R, 3 * H), dtype=sdt, device=gates.device)
    dhn = torch.empty((T, R, H), dtype=sdt, device=gates.device)
    work = _work("gru", "bwd", w, B, compute_dtype)
    _kernels.GRU_BWD.launch(
        gates.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), g.data_ptr(), dxs.data_ptr(), dhn.data_ptr(),
        _ptr(work), T, B, H, ndir, C, _sms(w),
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(gates))
    return dxs, dhn


def _lstm_fwd_weights(w, compute_dtype):
    """W [ndir, H, 4H] → the fp32 forward kernel's k-quads [ndir, H/4, 4H,
    4]: element [d, k4, col, kk] is W[d, 4·k4 + kk, col]."""
    ndir, H = w.shape[:2]
    return w.to(compute_dtype).reshape(ndir, H // 4, 4, 4 * H).transpose(
        2, 3).contiguous()


def _lstm_bwd_weights(w, compute_dtype):
    """W [ndir, H, 4H] → the fp32 backward kernel's k-quads of Wᵀ, [ndir,
    H, H, 4]: element [d, k4, j, kk] is W[d, j, 4·k4 + kk]."""
    ndir, H = w.shape[:2]
    return w.to(compute_dtype).reshape(ndir, H, H, 4).transpose(1, 2) \
        .contiguous()


def _fwd_tc_weights(w, C: int):
    """W [ndir, H, G·H] → the bf16 cluster forward's slices [ndir, C, G, U,
    H] bf16, U = H / C: element [d, c, g, u, k] is W[d, k, g·H + c·U + u],
    the gate columns of block c's units, k-major."""
    ndir, H, GH = w.shape
    return w.to(torch.bfloat16).reshape(ndir, H, GH // H, C, H // C).permute(
        0, 3, 2, 4, 1).contiguous()


def _bwd_tc_weights(w, C: int):
    """W [ndir, H, G·H] → the bf16 cluster backward's slices [ndir, C, H,
    G, U]
    bf16, U = H / C: element [d, c, j, g, u] is W[d, j, g·H + c·U + u],
    block c's gate columns of every row j of W."""
    ndir, H, GH = w.shape
    return w.to(torch.bfloat16).reshape(ndir, H, GH // H, C, H // C).permute(
        0, 3, 1, 2, 4).contiguous()


def lstm_fwd_tc_weights(w, C: int):
    """W [ndir, H, 4H] → the bf16 cluster forward's slices [ndir, C, 4, U,
    H] bf16, U = H / C: element [d, c, g, u, k] is W[d, k, g·H + c·U + u],
    the gate columns of block c's units, k-major (``csrc/lstm_fwd.cu``)."""
    return _fwd_tc_weights(w, C)


def lstm_bwd_tc_weights(w, C: int):
    """W [ndir, H, 4H] → the bf16 cluster backward's slices [ndir, C, H,
    4, U]
    bf16, U = H / C: element [d, c, j, g, u] is W[d, j, g·H + c·U + u],
    block c's gate columns of every row j of W (``csrc/lstm_bwd.cu``)."""
    return _bwd_tc_weights(w, C)


def gru_fwd_tc_weights(w, C: int):
    """W [ndir, H, 3H] → the bf16 cluster forward's slices [ndir, C, 3, U,
    H] bf16, U = H / C: element [d, c, g, u, k] is W[d, k, g·H + c·U + u]
    for the gates (r, z, n) (``csrc/gru_fwd.cu``)."""
    return _fwd_tc_weights(w, C)


def gru_bwd_tc_weights(w, C: int):
    """W [ndir, H, 3H] → the bf16 cluster backward's slices [ndir, C, H,
    3, U]
    bf16, U = H / C: element [d, c, j, g, u] is W[d, j, g·H + c·U + u]
    (``csrc/gru_bwd.cu``)."""
    return _bwd_tc_weights(w, C)


# the persistent form: (B columns a unit tile, warps a block, k-steps a
# hidden unit of the reduction: K = H / 16 forward, G·H / 16 backward,
# fp32 [ndir·B, H] arrays a slot carries in the workspace, the columns of
# a product at most where A is staged in shared memory: None, A is read
# from L2)
PERSIST = {"gru_fwd": (3, 4, 1 / 16, 0, None),
           "lstm_bwd": (1, 8, 1 / 4, 2, None),
           "lstm_fwd": (4, 4, 1 / 16, 1, 12),
           "gru_bwd": (1, 8, 3 / 16, 1, 4)}
PASS_ROWS = 32          # rows a pass of the persistent form: two m16 tiles
GROUP_TILES = 4         # tiles a group at most: the kernels' built widths
STAGES = 4              # slots of a warp's staged ring
STREAM_CHUNK = 2        # k-steps a slot of it where W is streamed


class PersistPlan(NamedTuple):
    blocks: int         # NB: blocks a direction (grid NB · ndir ≤ sms)
    tiles: int          # nt: n8 tiles of units a block (the last block of
                        # a direction may own fewer), run in ``groups``
    warps: int          # a block's warps, each a share of the k-steps
    ksteps: int         # K: k-steps of the product
    resident: int       # kr: k-steps a warp keeps in shared memory at most
                        # (the rest of its share read from L2 each step)
    passes: int         # ⌈B / 32⌉ passes of 32 rows a step
    smem: int           # dynamic shared memory a block, bytes
    work: int           # the global workspace, bytes
    chunk: int          # k-steps a slot of a warp's staged ring (0: A is
                        # read from L2)
    groups: int         # ng = ⌈nt / GROUP_TILES⌉ groups a block, one after
                        # another in each step (1 on 132 SMs at every H)

    @property
    def width(self) -> int:
        """Tiles a group, ⌈nt / ng⌉: the kernel instantiation's (1-4)."""
        return -(-self.tiles // self.groups)


def stage_bytes(ncw: int, streamed: bool) -> int:
    """Bytes of one k-step in a slot of the staged ring: A's two m-tiles of
    32 lanes × 16 bytes, and B's ``ncw`` columns (32 lanes × 8 bytes each)
    where the warps stream some of W through the ring."""
    return 1024 + (ncw * 256 if streamed else 0)


def persist_plan(name: str, H: int, B: int, ndir: int,
                 sms: int = SMS) -> PersistPlan:
    """The persistent form's launch (``csrc/rnn_mma.cuh``'s
    ``persist_plan``; ``name`` a key of ``PERSIST``) on a card of ``sms``
    ≥ ndir SMs: nt = ⌈(H / 8) / (sms // ndir)⌉ unit tiles a block, NB =
    ⌈(H / 8) / nt⌉ blocks a direction, one block an SM; the block runs its
    tiles as ng = ⌈nt / GROUP_TILES⌉ groups of nw8 = ⌈nt / ng⌉ (``width``;
    the last group's tiles past nt are zero columns that own nothing), each
    group's product and gate math in turn within a step. Shared memory:
    the warps' partial sums of one group (warps × 2 m-tiles × nc = cols ·
    nw8 columns × 512 bytes), as many k-steps of each warp's share of the
    B fragments of every group (ng · nc · 256 bytes a k-step) as fit (0
    where none do: then all of W is read at each step), and for the LSTM's
    forwards and the GRU's backward a ring of ``STAGES`` slots a warp of
    ``chunk`` k-steps of A (``stage_bytes``): beside all of a warp's W,
    chunks as large as fit up to ⌈kq / STAGES⌉ (kq = ⌈K / warps⌉: then the
    ring holds the whole of the warp's A), else slots of ``STREAM_CHUNK``
    k-steps that carry the streamed B too (a product's columns: the LSTM
    forward at 16 columns runs two halves of 8) and as many resident
    k-steps as fit beside them. The workspace: the grid barrier's counter
    (256 bytes), two A buffers of ndir · passes · 32 rows × K k-steps of 16
    columns in bf16 (1024 · K bytes a pass and direction), and the fp32
    [ndir · B, H] arrays a slot carries (the LSTM backward: dc and
    dh_total; the LSTM forward: c; the GRU backward: dh). Every SM count
    from ndir up has a plan (an H100 SXM's 132 give ng = 1 at every H; an
    H100 PCIe's 114 give ng = 2 at H ≥ 1856, ndir 2)."""
    if not kernel_takes(H) or H <= RESIDENT_MAX:
        raise ValueError(f"persist_plan: hidden size {H} unsupported "
                         f"({RESIDENT_MAX} < H <= {MAX_HIDDEN}, "
                         "H % 32 == 0)")
    if sms < ndir:
        raise ValueError(f"persist_plan: {sms} SMs hold no block of each of "
                         f"{ndir} directions")
    cols, warps, per_unit, carried, ncmax = PERSIST[name]
    K = int(H * per_unit)
    units = H // 8
    tiles = -(-units // (sms // ndir))
    groups = -(-tiles // GROUP_TILES)
    blocks = -(-units // tiles)
    nc = cols * -(-tiles // groups)
    part = warps * 2 * nc * 512
    kq = -(-K // warps)
    wk = groups * nc * 256          # W bytes a k-step, every group's
    chunk = 0
    if ncmax is None:
        kr = min(kq, (SMEM_MAX - part) // (warps * wk))
        smem = part + warps * kr * wk
    else:
        room = (SMEM_MAX - part) // warps
        ncw = nc // -(-nc // ncmax)
        whole = -(-kq // STAGES)
        if kq * wk + STAGES * stage_bytes(ncw, False) <= room:
            kr = kq
            chunk = min(whole, (room - kq * wk)
                        // (STAGES * stage_bytes(ncw, False)))
        else:
            chunk = STREAM_CHUNK
            kr = (room - STAGES * chunk * stage_bytes(ncw, True)) // wk
        smem = part + warps * (kr * wk + STAGES * chunk
                               * stage_bytes(ncw, kr < kq))
    passes = -(-B // PASS_ROWS)
    work = 256 + 2 * ndir * passes * 1024 * K + carried * ndir * B * H * 4
    return PersistPlan(blocks, tiles, warps, K, kr, passes, smem, work,
                       chunk, groups)


def _sms(t: torch.Tensor) -> int:
    """The SMs of ``t``'s card (``SMS`` for a CPU tensor): the count every
    plan of a launch on ``t`` is made for, and that the launch passes to
    the library. Tests emulate a card of fewer SMs by patching it."""
    if t.is_cuda:
        return torch.cuda.get_device_properties(t.device).multi_processor_count
    return SMS


def _fwd_fragments(w, blocks: int, tiles: int, groups: int = 1):
    """W [ndir, H, G·H] → a persistent forward's B fragments [ndir, NB,
    ng·H/16, nw8, G, 32, 4] bf16 (nw8 = ⌈nt / ng⌉): element [d, c, g·H/16 +
    ks, i, gt, l, e] is W[d, 16·ks + 2·(l % 4) + e % 2 + 8·(e // 2), gt·H +
    u] for unit u = 8·(nt·c + nw8·g + i) + l // 4 (zero where nw8·g + i ≥
    nt or u ≥ H), lane l's four values of the m16n8k16 B fragment of gate
    gt of tile i of the block's group g at k-step ks: each group's slice
    contiguous; with one group [ndir, NB, H/16, nt, G, 32, 4]."""
    ndir, H, GH = w.shape
    G, width = GH // H, -(-tiles // groups)
    wb = torch.nn.functional.pad(w.to(torch.bfloat16).reshape(ndir, H, G, H),
                                 (0, 8 * blocks * tiles - H))
    if groups * width > tiles:      # the last group's columns past nt
        wb = torch.nn.functional.pad(
            wb.reshape(ndir, H, G, blocks, tiles, 8),
            (0, 0, 0, groups * width - tiles))
    return wb.reshape(ndir, H // 16, 2, 4, 2, G, blocks, groups, width,
                      8).permute(0, 6, 7, 1, 8, 5, 9, 3, 2, 4).reshape(
        ndir, blocks, groups * H // 16, width, G, 32, 4).contiguous()


def _bwd_fragments(w, blocks: int, tiles: int, groups: int = 1):
    """W [ndir, H, G·H] → a persistent backward's B fragments [ndir, NB,
    ng·G·H/16, nw8, 32, 4] bf16: block c's operand B[k, j] = W[d, j, k]
    over the G·H gate columns k, element [d, c, g·G·H/16 + ks, i, l, e] =
    W[d, j, 16·ks + 2·(l % 4) + e % 2 + 8·(e // 2)] for j = 8·(nt·c + nw8·g
    + i) + l // 4 (zero where nw8·g + i ≥ nt or j ≥ H): lane l's four
    values of the B fragment of tile i of the block's group g at k-step
    ks; with one group [ndir, NB, G·H/16, nt, 32, 4]."""
    ndir, H, GH = w.shape
    width = -(-tiles // groups)
    wb = torch.nn.functional.pad(w.to(torch.bfloat16),
                                 (0, 0, 0, 8 * blocks * tiles - H))
    if groups * width > tiles:      # the last group's rows past nt
        wb = torch.nn.functional.pad(wb.reshape(ndir, blocks, tiles, 8, GH),
                                     (0, 0, 0, 0, 0, groups * width - tiles))
    return wb.reshape(ndir, blocks, groups, width, 8, GH // 16, 2, 4,
                      2).permute(0, 1, 2, 5, 3, 4, 7, 6, 8).reshape(
        ndir, blocks, groups * GH // 16, width, 32, 4).contiguous()


def persist_fwd_weights(w, blocks: int, tiles: int, groups: int = 1):
    """W [ndir, H, 3H] → the persistent GRU forward's B fragments [ndir,
    NB, ng·H/16, nw8, 3, 32, 4] bf16 (``csrc/gru_fwd.cu``;
    ``_fwd_fragments`` with G = 3: gates r, z, n); block c copies its
    [g][ks][i][gt][l] slice into shared memory as far as it fits."""
    return _fwd_fragments(w, blocks, tiles, groups)


def persist_lstm_fwd_weights(w, blocks: int, tiles: int, groups: int = 1):
    """W [ndir, H, 4H] → the persistent LSTM forward's B fragments [ndir,
    NB, ng·H/16, nw8, 4, 32, 4] bf16 (``csrc/lstm_fwd.cu``;
    ``_fwd_fragments`` with G = 4: gates i, f, o, u); block c copies its
    [g][ks][i][gt][l] slice into shared memory as far as it fits and stages
    the rest a step."""
    return _fwd_fragments(w, blocks, tiles, groups)


def persist_bwd_weights(w, blocks: int, tiles: int, groups: int = 1):
    """W [ndir, H, 4H] → the persistent LSTM backward's B fragments [ndir,
    NB, ng·H/4, nw8, 32, 4] bf16 (``csrc/lstm_bwd.cu``; ``_bwd_fragments``
    over the 4H gate columns)."""
    return _bwd_fragments(w, blocks, tiles, groups)


def persist_gru_bwd_weights(w, blocks: int, tiles: int, groups: int = 1):
    """W [ndir, H, 3H] → the persistent GRU backward's B fragments [ndir,
    NB, ng·3H/16, nw8, 32, 4] bf16 (``csrc/gru_bwd.cu``; ``_bwd_fragments``
    over the 3H gate columns r, z, n)."""
    return _bwd_fragments(w, blocks, tiles, groups)


@functools.lru_cache(maxsize=None)
def _persist_occupancy(name: str, H: int, ndir: int, B: int, sms: int,
                       device: int) -> tuple:
    out = (ctypes.c_longlong * 8)()
    fn = f"csr_{name}_persist_plan"
    with torch.cuda.device(device):
        err = _kernels.call(fn, H, ndir, B, sms, out)
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err} at H = {H}, ndir {ndir}, "
                           f"{sms} SMs")
    return tuple(out)


def persist_occupancy(name: str, H: int, ndir: int, B: int, sms: int,
                      device=None) -> tuple:
    """(blocks a direction, tiles a block, resident k-steps a warp, shared
    memory bytes, blocks the card holds at once, workspace bytes, k-steps a
    slot of the staged ring, groups a block) of the persistent form at B
    rows a direction, planned for ``sms`` SMs, as the kernel library
    computes them on ``device``'s card (``csr_{name}_persist_plan``; the
    current card by default; it refuses an ``sms`` below ndir or above the
    card's); needs the card."""
    index = None if device is None else torch.device(device).index
    return _persist_occupancy(name, H, ndir, B, sms,
                              torch.cuda.current_device() if index is None
                              else index)


def _persists(H: int) -> bool:
    """Whether a bf16 launch at H is the persistent form: every form of
    both cells past ``RESIDENT_MAX``."""
    return kernel_takes(H) and H > RESIDENT_MAX


def _work(cell: str, form: str, w, B: int, compute_dtype):
    """The persistent form's workspace of a launch on ``w``'s card, the
    bytes the kernel library's plan gives (``persist_occupancy``; None for
    every other launch, which reads none)."""
    ndir, H = w.shape[:2]
    if compute_dtype != torch.bfloat16 or not _persists(H):
        return None
    n = persist_occupancy(f"{cell}_{form}", H, ndir, B, _sms(w), w.device)[5]
    return torch.empty(n, dtype=torch.uint8, device=w.device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# the resident cluster kernels' units a block and rows a cluster
# (csrc/rnn_mma.cuh kUnits, kRows); a block runs a thread a (row, unit) pair
UNITS, ROWS = 32, 16


class RnnPlan(NamedTuple):
    cluster: int        # C: blocks a cluster, each owning H / C units
    rows: int           # M: rows a cluster (of one direction)
    smem: int           # dynamic shared memory a block, bytes
    clusters: int       # ndir · ⌈B / M⌉


def _cluster_only(name: str, H: int) -> None:
    if H > RESIDENT_MAX:
        raise ValueError(f"{name}: H = {H} runs the persistent form "
                         "(persist_plan), no cluster")


def gru_units(H: int, form: str) -> int:
    """Units a block of the GRU's cluster kernels: the backward takes 16 up
    to H = 256 (C = H / 16 ≤ 16 blocks, the largest cluster), where 16
    blocks of 16 ran in 0.846× the time of 8 blocks of 32 at bigru's width;
    everything else UNITS (``csrc/rnn_mma.cuh``'s ``gru_bwd_units``). Past
    ``RESIDENT_MAX`` no form runs a cluster (``persist_plan``)."""
    _cluster_only("gru_units", H)
    return 16 if form == "bwd" and H <= 256 else UNITS


def lstm_units(H: int) -> int:
    """Units a block of the LSTM's cluster kernels: UNITS (none past
    ``RESIDENT_MAX``: the persistent form)."""
    _cluster_only("lstm_units", H)
    return UNITS


def _tc_smem(form: str, H: int, G: int, U: int = UNITS) -> int:
    """Shared memory of a block of the bf16 cluster kernels of a cell with
    G gates and U units a block (``csrc/rnn_mma.cuh``'s ``fwd_smem`` and
    ``bwd_smem``; a padded bf16 row of K values is 2K + 16 bytes):
    forward, the W slice (G·U rows of H), the double buffer of h (2·ROWS
    rows of H) and the partial sums of the product's four k-quarters (4 ×
    G gates × ROWS rows of U + 8 fp32); backward, the W slice (H rows of
    G·U), this block's gate gradients (ROWS rows of G·U) and the double
    buffer of the partial sums (2 × ROWS × H fp32). None past
    ``RESIDENT_MAX`` (the persistent form's is ``persist_plan``'s)."""
    _cluster_only("_tc_smem", H)
    if form == "bwd":
        return (H + ROWS) * (2 * G * U + 16) + 2 * ROWS * H * 4
    return (G * U + 2 * ROWS) * (2 * H + 16) + 4 * G * ROWS * (U + 8) * 4


def lstm_smem(form: str, H: int) -> int:
    """``_tc_smem`` of the LSTM (4 gates, ``lstm_units``)."""
    return _tc_smem(form, H, 4, lstm_units(H))


def gru_smem(form: str, H: int) -> int:
    """``_tc_smem`` of the GRU (3 gates: r, z, n; ``gru_units``)."""
    return _tc_smem(form, H, 3, gru_units(H, form))


def _takes(name: str, H: int) -> None:
    if not kernel_takes(H):
        raise ValueError(f"{name}: hidden size {H} unsupported "
                         f"(32 <= H <= {MAX_HIDDEN}, H % 32 == 0)")


def _tc_plan(H: int, B: int, ndir: int, U: int, smem: int) -> RnnPlan:
    return RnnPlan(-(-H // U), ROWS, smem, ndir * -(-B // ROWS))


def lstm_plan(H: int, B: int, ndir: int, form: str, sms: int = SMS):
    """The bf16 kernels' launch for hidden size H, B rows a direction,
    ``form`` "fwd" (both forward forms) or "bwd": an ``RnnPlan`` of
    clusters of C = H / 32 blocks, each owning 32 units (whole n8 tiles)
    and running a thread a (row, unit) pair, so each block reads the
    fewest bytes of W from its shared memory a step; 16 rows (one m16
    tile) a cluster; ndir · ⌈B / 16⌉ clusters. Past ``RESIDENT_MAX`` the
    persistent form of both forms (a ``PersistPlan`` on a card of ``sms``
    SMs)."""
    _takes("lstm_plan", H)
    if _persists(H):
        return persist_plan(f"lstm_{form}", H, B, ndir, sms)
    return _tc_plan(H, B, ndir, lstm_units(H), lstm_smem(form, H))


def gru_plan(H: int, B: int, ndir: int, form: str, sms: int = SMS):
    """``lstm_plan`` for the GRU's kernels, three gate columns a unit: C =
    H / ``gru_units(H, form)`` blocks a cluster (32 units a block, but 16
    in the backward up to H = 256), 16 rows a cluster; past
    ``RESIDENT_MAX`` the persistent form of both forms (a
    ``PersistPlan``)."""
    _takes("gru_plan", H)
    if _persists(H):
        return persist_plan(f"gru_{form}", H, B, ndir, sms)
    return _tc_plan(H, B, ndir, gru_units(H, form), gru_smem(form, H))


def launch_blocks(plan) -> int:
    """The C argument of a bf16 launch: a cluster's blocks, or the
    persistent form's blocks a direction."""
    return plan.blocks if isinstance(plan, PersistPlan) else plan.cluster


def _occupancy(cell: str, H: int, form: str) -> tuple[int, int]:
    out = (ctypes.c_int * 2)()
    fn = f"csr_{cell}_{form}_occupancy"
    err = _kernels.call(fn, H, out)
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err}")
    return out[0], out[1]


def lstm_occupancy(H: int, form: str) -> tuple[int, int]:
    """(shared memory bytes, clusters the card holds at once) of the plan
    at H as the kernel library computes them
    (``cudaOccupancyMaxActiveClusters``); needs the card."""
    return _occupancy("lstm", H, form)


def gru_occupancy(H: int, form: str) -> tuple[int, int]:
    """``lstm_occupancy`` of the GRU's cluster kernels."""
    return _occupancy("gru", H, form)


def _lstm_launch_args(w, B: int, compute_dtype, form: str):
    """(weights as the kernel takes them, C) for a launch; C = 0 under
    fp32 (the FMA kernels)."""
    ndir, H = w.shape[:2]
    if compute_dtype != torch.bfloat16:
        wk = (_lstm_fwd_weights if form == "fwd" else _lstm_bwd_weights)(
            w, compute_dtype)
        return wk, 0
    p = lstm_plan(H, B, ndir, form, _sms(w))
    C = launch_blocks(p)
    if isinstance(p, PersistPlan):
        layout = (persist_lstm_fwd_weights if form == "fwd"
                  else persist_bwd_weights)
        return layout(w, p.blocks, p.tiles, p.groups), C
    return (lstm_fwd_tc_weights if form == "fwd" else lstm_bwd_tc_weights)(
        w, C), C


def _gru_launch_args(w, B: int, compute_dtype, form: str):
    """(weights as the kernel takes them, C) for a launch; C = 0 under
    fp32: the FMA kernels take W (forward) or Wᵀ [ndir, 3H, H] (backward,
    so its reads coalesce)."""
    ndir, H = w.shape[:2]
    if compute_dtype != torch.bfloat16:
        wk = w.to(compute_dtype)
        return (wk if form == "fwd" else wk.transpose(1, 2)).contiguous(), 0
    p = gru_plan(H, B, ndir, form, _sms(w))
    C = launch_blocks(p)
    if isinstance(p, PersistPlan):
        layout = (persist_fwd_weights if form == "fwd"
                  else persist_gru_bwd_weights)
        return layout(w, p.blocks, p.tiles, p.groups), C
    return (gru_fwd_tc_weights if form == "fwd" else gru_bwd_tc_weights)(
        w, C), C


# the stream wrappers' laid-out weights, one entry a weight tensor (a
# layer's ``rec``): (its key, the layout)
_STREAM_LAYOUTS = WeakIdKeyDictionary()


def stream_launch_args(cell: str, w, B: int, compute_dtype):
    """The forward's launch arguments (``_gru_launch_args`` or
    ``_lstm_launch_args``: the laid-out W and C) for a stream launch, the layout cached per weight tensor. The key is the tensor
    itself (not its data pointer, which a later tensor may reuse), its
    in-place version, the compute dtype, C and the persistent plan's tiles
    a block, so an in-place update (a reloaded checkpoint's ``copy_``),
    another tensor or another geometry at the same C misses. An inference
    tensor has no version and is laid out at each call."""
    args, plan = {"gru": (_gru_launch_args, gru_plan),
                  "lstm": (_lstm_launch_args, lstm_plan)}[cell]
    if w.is_inference():
        return args(w, B, compute_dtype, "fwd")
    ndir, H = w.shape[:2]
    p = (plan(H, B, ndir, "fwd", _sms(w))
         if compute_dtype == torch.bfloat16 else None)
    C = 0 if p is None else launch_blocks(p)
    key = (w._version, compute_dtype, C,
           p.tiles if isinstance(p, PersistPlan) else 0)
    hit = _STREAM_LAYOUTS.get(w)
    if hit is not None and hit[0] == key:
        return hit[1], C
    with torch.no_grad():
        wk, C = args(w, B, compute_dtype, "fwd")
    if wk is not w:         # w itself (fp32 GRU) would keep its key alive
        _STREAM_LAYOUTS[w] = (key, wk)
    return wk, C


def lstm_scan_cuda(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Residual-free LSTM kernel launch (CUDA tensors only; raises on
    shapes it does not take); ndir = w.shape[0]."""
    ndir = w.shape[0]
    T, B, H, _ = _check_scan(xs, w, lo, hi, compute_dtype, "lstm", ndir)
    wk, C = _lstm_launch_args(w, B, compute_dtype, "fwd")
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    work = _work("lstm", "fwd", w, B, compute_dtype)
    _kernels.LSTM_FWD.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), _ptr(work), T, B, H, ndir, C, _sms(w),
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys


def lstm_scan_stream_cuda(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """LSTM stream kernel launch: (ys, carry h‖c); CUDA tensors only."""
    T, B, H, ndir = _check_stream(xs, w, lo, hi, h0, compute_dtype, emit_t,
                                  "lstm")
    wk, C = stream_launch_args("lstm", w, B, compute_dtype)
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    carry = torch.empty_like(h0)
    work = _work("lstm", "fwd", w, B, compute_dtype)
    _kernels.LSTM_FWD_STREAM.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), carry.data_ptr(), _ptr(work), T, B, H,
        ndir, emit_t, C, _sms(w), int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(xs))
    return ys, carry


def lstm_scan_train_cuda(xs, w, lo, hi, compute_dtype):
    """LSTM training forward launch: (ys, cs, gates); CUDA tensors only;
    ndir = w.shape[0]."""
    ndir = w.shape[0]
    T, B, H, sdt = _check_scan(xs, w, lo, hi, compute_dtype, "lstm", ndir)
    wk, C = _lstm_launch_args(w, B, compute_dtype, "fwd")
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    cs = torch.empty_like(ys)
    gates = torch.empty((T, ndir * B, 4 * H), dtype=sdt, device=xs.device)
    work = _work("lstm", "fwd", w, B, compute_dtype)
    _kernels.LSTM_FWD_TRAIN.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), cs.data_ptr(), gates.data_ptr(), _ptr(work), T, B, H,
        ndir, C, _sms(w), int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(xs))
    return ys, cs, gates


def lstm_bwd_cuda(gates, w, lo, hi, cs, g, compute_dtype):
    """LSTM backward kernel launch: dxs; CUDA tensors only; ndir =
    w.shape[0]."""
    T, R, _ = gates.shape
    ndir, H = w.shape[:2]
    sdt = _check_sizes(T, R, H, compute_dtype, "lstm", ndir)
    _check_weights(w, lo, hi, R, H, 4, ndir)
    _kernels.check_cuda_tensor("gates", gates, sdt, (T, R, 4 * H))
    for name, t in (("cs", cs), ("g", g)):
        _kernels.check_cuda_tensor(name, t, torch.float32, (T, R, H))
    B = R // ndir
    wk, C = _lstm_launch_args(w, B, compute_dtype, "bwd")
    dxs = torch.empty((T, R, 4 * H), dtype=sdt, device=gates.device)
    work = _work("lstm", "bwd", w, B, compute_dtype)
    _kernels.LSTM_BWD.launch(
        gates.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        cs.data_ptr(), g.data_ptr(), dxs.data_ptr(), _ptr(work), T, B, H,
        ndir, C, _sms(w), int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(gates))
    return dxs


def gru_scan(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``birnn_pallas(xs, w, lo, hi, "gru", dtype)`` for inference: the
    kernel on the card, the plain version on the CPU."""
    if xs.is_cuda:
        return gru_scan_cuda(xs, w, lo, hi, compute_dtype)
    _kernels.check_cpu_tensor("gru_scan", xs)
    return gru_scan_plain(xs, w, lo, hi, compute_dtype)


def gru_scan_stream(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """``birnn_pallas_stream(xs, w, lo, hi, h0, "gru", dtype, emit_t)``
    → (ys, carry): the stream kernel on the card, the plain version on the
    CPU."""
    if xs.is_cuda:
        return gru_scan_stream_cuda(xs, w, lo, hi, h0.contiguous(),
                                    compute_dtype, emit_t)
    _kernels.check_cpu_tensor("gru_scan_stream", xs)
    return gru_scan_stream_plain(xs, w, lo, hi, h0, compute_dtype, emit_t)


def gru_scan_train(xs, w, lo, hi, compute_dtype):
    """(ys, gates): the training-forward kernel on the card, the plain
    version on the CPU."""
    if xs.is_cuda:
        return gru_scan_train_cuda(xs, w, lo, hi, compute_dtype)
    _kernels.check_cpu_tensor("gru_scan_train", xs)
    return gru_scan_train_plain(xs, w, lo, hi, compute_dtype)


def gru_bwd(gates, w, lo, hi, ys, g, compute_dtype):
    """(dxs, dhn) given the layer's carries ``ys``: the backward kernel on
    the card (h_prev read from ys in place), the plain version on the CPU
    (on ``shift_prev(ys)``)."""
    if gates.is_cuda:
        return gru_bwd_cuda(gates, w, lo, hi, ys.contiguous(),
                            g.contiguous(), compute_dtype)
    _kernels.check_cpu_tensor("gru_bwd", gates)
    return gru_bwd_plain(gates, w, lo, hi, shift_prev(ys), g, compute_dtype)


def lstm_scan(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``birnn_pallas(xs, w, lo, hi, "lstm", dtype)`` for inference: the
    kernel on the card, the plain version on the CPU."""
    if xs.is_cuda:
        return lstm_scan_cuda(xs, w, lo, hi, compute_dtype)
    _kernels.check_cpu_tensor("lstm_scan", xs)
    return lstm_scan_plain(xs, w, lo, hi, compute_dtype)


def lstm_scan_stream(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """``birnn_pallas_stream(xs, w, lo, hi, h0, "lstm", dtype, emit_t)``
    → (ys, carry h‖c): the stream kernel on the card, the plain version on
    the CPU."""
    if xs.is_cuda:
        return lstm_scan_stream_cuda(xs, w, lo, hi, h0.contiguous(),
                                     compute_dtype, emit_t)
    _kernels.check_cpu_tensor("lstm_scan_stream", xs)
    return lstm_scan_stream_plain(xs, w, lo, hi, h0, compute_dtype, emit_t)


def lstm_scan_train(xs, w, lo, hi, compute_dtype):
    """(ys, cs, gates): the LSTM training-forward kernel on the card, the
    plain version on the CPU."""
    if xs.is_cuda:
        return lstm_scan_train_cuda(xs, w, lo, hi, compute_dtype)
    _kernels.check_cpu_tensor("lstm_scan_train", xs)
    return lstm_scan_train_plain(xs, w, lo, hi, compute_dtype)


def lstm_bwd(gates, w, lo, hi, cs, g, compute_dtype):
    """dxs: the LSTM backward kernel on the card, the plain version on the
    CPU."""
    if gates.is_cuda:
        return lstm_bwd_cuda(gates, w, lo, hi, cs.contiguous(),
                             g.contiguous(), compute_dtype)
    _kernels.check_cpu_tensor("lstm_bwd", gates)
    return lstm_bwd_plain(gates, w, lo, hi, cs, g, compute_dtype)


def shift_prev(ys: torch.Tensor) -> torch.Tensor:
    """h_prev stream: [0, ys[0], ..., ys[T-2]]."""
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]], dim=0)


def dw_matmul(h_prev, dgate, B: int, compute_dtype):
    """dW[d] = Σ_t h_prev[t, d-rows]ᵀ · dgate[t, d-rows] → [ndir, H, G],
    ndir = rows / B (2, or 1 for a forward-only layer), with compute-dtype
    operands and fp32 accumulation (``_dw_einsum``): the operands are
    rounded to the compute dtype and multiplied in fp32, where a product of
    two bf16 values is exact. A forward-only layer's dW is the TPU path's
    sum of its duplicated halves: the same products of the same rows."""
    acc = _acc_dtype(compute_dtype)
    hp = h_prev.to(compute_dtype).to(acc)
    dg = dgate.to(compute_dtype).to(acc)
    H, G = hp.shape[-1], dg.shape[-1]
    return torch.stack([
        hp[:, d * B:(d + 1) * B].reshape(-1, H).T
        @ dg[:, d * B:(d + 1) * B].reshape(-1, G)
        for d in range(hp.shape[1] // B)])


def dw_plain(ys, dgate, B: int, compute_dtype):
    """Plain version of the dW kernel: ``dw_matmul`` on h_prev =
    ``shift_prev(ys)`` (``_dw_einsum(_shift_prev(ys), dgate)``)."""
    return dw_matmul(shift_prev(ys), dgate, B, compute_dtype)


class DwPlan(NamedTuple):
    rows: int           # bc: rows of a direction a K-tile
    frames: int         # kt: frames a K-tile (kt · bc % 16 == 0, <= 64)
    ktiles: int         # K-tiles a direction (frames 1 .. T - 1)
    split: int          # S: blocks a cluster along K
    tiles: int          # output tiles of 128 x 256, all directions
    smem: int           # dynamic shared memory a block, bytes


def dw_plan(T: int, B: int, H: int, N: int, ndir: int = 2) -> DwPlan:
    """The dW kernel's launch shape at (T, B, H, N, ndir) on this card, as
    the library (``csr_dw_plan``) computes it; needs the card."""
    out = (ctypes.c_int * 6)()
    err = _kernels.call("csr_dw_plan", T, B, H, N, ndir, out)
    if err:
        raise RuntimeError(f"csr_dw_plan: CUDA error {err}")
    return DwPlan(*out)


def _check_gate_slice(name: str, g, T: int, R: int) -> None:
    """A bf16 CUDA gate gradient [T, R, G] with unit column stride, a row
    stride ``ld`` (a column slice of a wider tensor) that is a multiple of
    8, frames ``R · ld`` apart and a 16-byte-aligned start: what the
    kernel's tensor maps take."""
    if not g.is_cuda or g.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected a bf16 CUDA tensor, got "
                         f"{g.dtype} on {g.device}")
    if g.dim() != 3 or tuple(g.shape[:2]) != (T, R) or g.shape[2] % 4:
        raise ValueError(f"{name}: expected shape ({T}, {R}, G) with "
                         f"G % 4 == 0, got {tuple(g.shape)}")
    ld = g.stride(1)
    if (g.stride(2) != 1 or ld % 8 or ld < g.shape[2]
            or g.stride(0) != R * ld or g.data_ptr() % 16):
        raise ValueError(f"{name}: strides {g.stride()} not taken (unit "
                         "column stride, a row stride that is a multiple "
                         "of 8 and frames R rows apart, 16-byte aligned)")


def dw_cuda(ys, dgates, B: int) -> torch.Tensor:
    """dW kernel launch (CUDA tensors only, bf16 compute): ``ys`` [T,
    ndir·B, H] fp32 itself (not shifted; ndir 2, or 1 for a forward-only
    layer) and one or two bf16 gate gradients [T, ndir·B, G_i], which may
    be column slices of a wider tensor, → one fp32 [ndir, H, Σ G_i]
    tensor, the second's columns after the first's (the GRU's
    ``dxs[..., :2H]`` and ``dhn`` in one launch, no cat)."""
    T, R, H = ys.shape
    if (not 1 <= len(dgates) <= 2 or B < 1 or R not in (B, 2 * B)
            or H % 4):
        raise ValueError(f"dw kernel: need ys [T, ndir·B, H], ndir 1 or 2, "
                         f"with H % 4 == 0 and one or two gate tensors (got "
                         f"ys {tuple(ys.shape)}, B={B}, {len(dgates)} "
                         "gates)")
    ndir = R // B
    _kernels.check_cuda_tensor("ys", ys, torch.float32, (T, R, H))
    for i, g in enumerate(dgates):
        _check_gate_slice(f"dgate[{i}]", g, T, R)
    g1, g2 = dgates[0], dgates[-1]
    n1 = g1.shape[2]
    n2 = g2.shape[2] if len(dgates) == 2 else 0
    if n2 and n1 % 64:
        raise ValueError(f"dw kernel: the first of two gate tensors needs "
                         f"G % 64 == 0 (got {n1})")
    out = torch.empty((ndir, H, n1 + n2), dtype=torch.float32,
                      device=ys.device)
    _kernels.DW.launch(ys.data_ptr(), g1.data_ptr(), g1.stride(1), n1,
                       g2.data_ptr(), g2.stride(1), n2, out.data_ptr(), T, B,
                       H, ndir, _kernels.stream_ptr(ys))
    return out


def rnn_dw(ys, dgates, B: int, compute_dtype) -> torch.Tensor:
    """The recurrent weights' gradient of a GRU or LSTM layer, [ndir, H,
    Σ G_i] fp32 (ndir = rows of ys / B): on the card under bf16 compute the
    dW kernel, one launch for all ``dgates``; on the card under fp32 the
    plain product (fp32
    ``torch.matmul``: a plain large product, as the fp32 recurrences keep
    their FMA kernels); on the CPU the plain version."""
    if ys.is_cuda and compute_dtype == torch.bfloat16:
        return dw_cuda(ys, dgates, B)
    if not ys.is_cuda:
        _kernels.check_cpu_tensor("rnn_dw", ys)
    dws = [dw_plain(ys, g, B, compute_dtype) for g in dgates]
    return dws[0] if len(dws) == 1 else torch.cat(dws, dim=2)


class BiGRUScan(torch.autograd.Function):
    """``birnn_pallas`` with its custom VJP: ys from (xs, w); gradients
    for xs (in the stream dtype) and w (fp32)."""

    @staticmethod
    def forward(ctx, xs, w, lo, hi, compute_dtype):
        ys, gates = gru_scan_train(xs, w, lo, hi, compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(w, lo, hi, ys, gates)
        return ys

    @staticmethod
    def backward(ctx, gy):
        w, lo, hi, ys, gates = ctx.saved_tensors
        cdt = ctx.compute_dtype
        ndir, H = w.shape[:2]
        B = ys.shape[1] // ndir
        dxs, dhn = gru_bwd(gates, w, lo, hi, ys, gy.to(ys.dtype), cdt)
        dw = rnn_dw(ys, (dxs[..., :2 * H], dhn), B, cdt)
        return dxs, dw.to(w.dtype), None, None, None


class BiLSTMScan(torch.autograd.Function):
    """``birnn_pallas(..., "lstm", ...)`` with its custom VJP: ys from
    (xs, w); gradients for xs (in the stream dtype) and w (fp32)."""

    @staticmethod
    def forward(ctx, xs, w, lo, hi, compute_dtype):
        ys, cs, gates = lstm_scan_train(xs, w, lo, hi, compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(w, lo, hi, ys, cs, gates)
        return ys

    @staticmethod
    def backward(ctx, gy):
        w, lo, hi, ys, cs, gates = ctx.saved_tensors
        cdt = ctx.compute_dtype
        B = ys.shape[1] // w.shape[0]
        dxs = lstm_bwd(gates, w, lo, hi, cs, gy.to(ys.dtype), cdt)
        dw = rnn_dw(ys, (dxs,), B, cdt)                # dg ≡ dxs (masked)
        return dxs, dw.to(w.dtype), None, None, None
