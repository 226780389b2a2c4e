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
(residual-free, stream, training) and the backward, runs on thread-block
clusters (``lstm_plan``, ``gru_plan``; 16 rows a cluster) and multiplies
on the tensor cores. Up to H = 512 (``RESIDENT_MAX``) each block keeps its
slice of W in shared memory (C = H / 32 blocks, or H / 16 in the GRU's
backward up to H = 256; ``lstm_fwd_tc_weights``, ``lstm_bwd_tc_weights``,
``gru_fwd_tc_weights``, ``gru_bwd_tc_weights``). Past it, up to H = 2048
(``MAX_HIDDEN``), W no longer fits a cluster's shared memory and each
block streams its slice from global memory at every step, straight into
the tensor cores' operand fragments (the streamed-W form: C = ⌈H / U⌉ ≤
16 blocks of U = ``wide_units(H)`` = 8·⌈H / 128⌉ units; W laid out in
fragment order by ``wide_fwd_weights`` and ``wide_bwd_weights``). Under
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
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _kernels


# per-call routing log: models/rnn.py adds one to the path each layer call
# takes (the kernels' wrappers, or the plain scan)
ROUTED = {"kernel": 0, "scan": 0}


# the largest hidden size whose bf16 kernels keep W in a cluster's shared
# memory, and the largest the kernels take (the streamed-W form between)
RESIDENT_MAX, MAX_HIDDEN = 512, 2048
SMEM_MAX = 232448       # shared memory a block may use on an H100 (227 KB)


def kernel_takes(H: int) -> bool:
    """The hidden sizes the kernels take: 32 ≤ H ≤ 2048 with H % 32 == 0,
    every H % 128 == 0 the reference's kernels take up to 2048 among them
    (the bf16 cluster kernels: C ≤ 16 blocks, W resident in their shared
    memory up to H = 512 and streamed from global memory above; the fp32
    FMA kernels: up to four units a thread of 512)."""
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
                         f"(32 <= H <= {MAX_HIDDEN}, H % 32 == 0: in bf16 a "
                         "cluster of at most 16 blocks, W in their shared "
                         f"memory up to H = {RESIDENT_MAX} and streamed "
                         "above; in fp32 up to 4 units a thread)")
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
    _kernels.GRU_FWD.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), T, B, H, ndir, C, int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(xs))
    return ys


def gru_scan_stream_cuda(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """Stream kernel launch: (ys, carry); CUDA tensors only."""
    T, B, H, ndir = _check_stream(xs, w, lo, hi, h0, compute_dtype, emit_t,
                                  "gru")
    wk, C = stream_launch_args("gru", w, B, compute_dtype)
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    carry = torch.empty_like(h0)
    _kernels.GRU_FWD_STREAM.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), carry.data_ptr(), T, B, H, ndir,
        emit_t, C, int(compute_dtype == torch.bfloat16),
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
    _kernels.GRU_FWD_TRAIN.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), gates.data_ptr(), T, B, H, ndir, C,
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
    _kernels.GRU_BWD.launch(
        gates.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), g.data_ptr(), dxs.data_ptr(), dhn.data_ptr(),
        T, B, H, ndir, C, int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(gates))
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


def wide_units(H: int) -> int:
    """Units a block of the streamed-W form (H > ``RESIDENT_MAX``):
    8·⌈H / 128⌉, whole n8 tiles, so C = ⌈H / U⌉ ≤ 16 (``csrc/rnn_mma.cuh``'s
    wide_units; the last block may own fewer, a multiple of 8)."""
    return 8 * -(-H // 128)


def wide_bwd_k(H: int, G: int) -> int:
    """The streamed-W backward's reduction extent: a block's G·U gate
    gradients, zero-padded to a multiple of 32 (two k-steps)."""
    return -(-G * wide_units(H) // 32) * 32


def _wide_part(H: int) -> int:
    """Bytes of one partial-sum buffer of the streamed-W backward: ROWS
    rows of the C·U units of the C source blocks, fp32."""
    U = wide_units(H)
    return ROWS * -(-H // U) * U * 4


def wide_bwd_bufs(H: int, G: int) -> int:
    """Partial-sum buffers of the streamed-W backward: two (one cluster
    barrier a step) where they fit beside the gate gradients, else one
    (a second barrier a step)."""
    gates = ROWS * (2 * wide_bwd_k(H, G) + 16)
    return 2 if gates + 2 * _wide_part(H) <= SMEM_MAX else 1


def wide_fwd_weights(w):
    """W [ndir, H, G·H] → the streamed-W forward's B fragments [ndir, H/8,
    H/16, G, 32, 4] bf16 (``csrc/rnn_mma.cuh``): element [d, ub, ks, g, l,
    e] is W[d, 16·ks + 2·(l % 4) + e % 2 + 8·(e // 2), g·H + 8·ub + l // 4],
    lane l's four values of the m16n8k16 B fragment of unit block ub's gate
    g at k-step ks; the warp owning ub reads them as [ks][g][l]."""
    ndir, H, GH = w.shape
    G = GH // H
    return w.to(torch.bfloat16).reshape(
        ndir, H // 16, 2, 4, 2, G, H // 8, 8).permute(
        0, 6, 1, 5, 7, 3, 2, 4).reshape(ndir, H // 8, H // 16, G, 32, 4) \
        .contiguous()


def wide_bwd_weights(w):
    """W [ndir, H, G·H] → the streamed-W backward's B fragments [ndir, C,
    H/32, K/16, 4, 32, 4] bf16, U = ``wide_units(H)``, C = ⌈H / U⌉, K =
    ``wide_bwd_k(H, G)``: block c's operand B[k, j] = W[d, j, g·H + U·c +
    u] at k = g·U + u (zero past G·U and for units U·c + u ≥ H), element
    [d, c, ng, ks, q, l, e] = B[16·ks + 2·(l % 4) + e % 2 + 8·(e // 2),
    32·ng + 8·q + l // 4]: lane l's four values of n-tile q of n-group ng
    at k-step ks."""
    ndir, H, GH = w.shape
    G, U = GH // H, wide_units(H)
    C, K = -(-H // U), wide_bwd_k(H, G)
    wb = torch.nn.functional.pad(
        w.to(torch.bfloat16).reshape(ndir, H, G, H), (0, C * U - H))
    wb = wb.reshape(ndir, H, G, C, U).permute(0, 3, 2, 4, 1).reshape(
        ndir, C, G * U, H)
    wb = torch.nn.functional.pad(wb, (0, 0, 0, K - G * U))
    return wb.reshape(ndir, C, K // 16, 2, 4, 2, H // 32, 4, 8).permute(
        0, 1, 6, 2, 7, 8, 4, 3, 5).reshape(
        ndir, C, H // 32, K // 16, 4, 32, 4).contiguous()


# the resident cluster kernels' units a block and rows a cluster
# (csrc/rnn_mma.cuh kUnits, kRows); a block runs a thread a (row, unit) pair
UNITS, ROWS = 32, 16


class RnnPlan(NamedTuple):
    cluster: int        # C: blocks a cluster, each owning H / C units
    rows: int           # M: rows a cluster (of one direction)
    smem: int           # dynamic shared memory a block, bytes
    clusters: int       # ndir · ⌈B / M⌉


def gru_units(H: int, form: str) -> int:
    """Units a block of the GRU's cluster kernels: the backward takes 16 up
    to H = 256 (C = H / 16 ≤ 16 blocks, the largest cluster), where 16
    blocks of 16 ran in 0.846× the time of 8 blocks of 32 at bigru's width;
    the streamed-W form ``wide_units(H)``; everything else UNITS
    (``csrc/rnn_mma.cuh``'s ``gru_bwd_units``)."""
    if H > RESIDENT_MAX:
        return wide_units(H)
    return 16 if form == "bwd" and H <= 256 else UNITS


def lstm_units(H: int) -> int:
    """Units a block of the LSTM's cluster kernels: UNITS, the streamed-W
    form ``wide_units(H)``."""
    return wide_units(H) if H > RESIDENT_MAX else UNITS


def _tc_smem(form: str, H: int, G: int, U: int = UNITS) -> int:
    """Shared memory of a block of the bf16 cluster kernels of a cell with
    G gates and U units a block (``csrc/rnn_mma.cuh``'s ``fwd_smem`` and
    ``bwd_smem``; a padded bf16 row of K values is 2K + 16 bytes):
    forward, the W slice (G·U rows of H), the double buffer of h (2·ROWS
    rows of H) and the partial sums of the product's four k-quarters (4 ×
    G gates × ROWS rows of U + 8 fp32); backward, the W slice (H rows of
    G·U), this block's gate gradients (ROWS rows of G·U) and the double
    buffer of the partial sums (2 × ROWS × H fp32). Past ``RESIDENT_MAX``
    the streamed-W form's: forward, the double buffer of h alone;
    backward, the gate gradients (ROWS rows of ``wide_bwd_k``) and
    ``wide_bwd_bufs`` buffers of partial sums (ROWS × C·U fp32)."""
    if H > RESIDENT_MAX:
        if form != "bwd":
            return 2 * ROWS * (2 * H + 16)
        return (ROWS * (2 * wide_bwd_k(H, G) + 16)
                + wide_bwd_bufs(H, G) * _wide_part(H))
    if form == "bwd":
        return (H + ROWS) * (2 * G * U + 16) + 2 * ROWS * H * 4
    return (G * U + 2 * ROWS) * (2 * H + 16) + 4 * G * ROWS * (U + 8) * 4


def lstm_smem(form: str, H: int) -> int:
    """``_tc_smem`` of the LSTM (4 gates, ``lstm_units``)."""
    return _tc_smem(form, H, 4, lstm_units(H))


def gru_smem(form: str, H: int) -> int:
    """``_tc_smem`` of the GRU (3 gates: r, z, n; ``gru_units``)."""
    return _tc_smem(form, H, 3, gru_units(H, form))


def _tc_plan(name: str, H: int, B: int, ndir: int, U: int,
             smem: int) -> RnnPlan:
    if not kernel_takes(H):
        raise ValueError(f"{name}: hidden size {H} unsupported "
                         f"(32 <= H <= {MAX_HIDDEN}, H % 32 == 0)")
    return RnnPlan(-(-H // U), ROWS, smem, ndir * -(-B // ROWS))


def lstm_plan(H: int, B: int, ndir: int, form: str) -> RnnPlan:
    """The bf16 cluster kernels' launch for hidden size H, B rows a
    direction, ``form`` "fwd" (both forward forms) or "bwd": C = H / 32
    blocks a cluster, each owning 32 units (whole n8 tiles) and running a
    thread a (row, unit) pair, so each block reads the fewest bytes of W
    from its shared memory a step; 16 rows (one m16 tile) a cluster;
    ndir · ⌈B / 16⌉ clusters. Past ``RESIDENT_MAX`` the streamed-W form:
    C = ⌈H / U⌉ blocks of U = ``wide_units(H)`` units."""
    return _tc_plan("lstm_plan", H, B, ndir, lstm_units(H),
                    lstm_smem(form, H))


def gru_plan(H: int, B: int, ndir: int, form: str) -> RnnPlan:
    """``lstm_plan`` for the GRU's cluster kernels, three gate columns a
    unit: C = ⌈H / ``gru_units(H, form)``⌉ blocks (32 units a block, but
    16 in the backward up to H = 256, and the streamed-W form's
    ``wide_units(H)`` past ``RESIDENT_MAX``), 16 rows a cluster."""
    return _tc_plan("gru_plan", H, B, ndir, gru_units(H, form),
                    gru_smem(form, H))


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
    C = lstm_plan(H, B, ndir, form).cluster
    if H > RESIDENT_MAX:
        return (wide_fwd_weights if form == "fwd" else wide_bwd_weights)(
            w), C
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
    C = gru_plan(H, B, ndir, form).cluster
    if H > RESIDENT_MAX:
        return (wide_fwd_weights if form == "fwd" else wide_bwd_weights)(
            w), C
    return (gru_fwd_tc_weights if form == "fwd" else gru_bwd_tc_weights)(
        w, C), C


# the stream wrappers' laid-out weights, one entry a weight tensor (a
# layer's ``rec``): (its key, the layout)
_STREAM_LAYOUTS = WeakIdKeyDictionary()


def stream_launch_args(cell: str, w, B: int, compute_dtype):
    """The forward's launch arguments (``_gru_launch_args`` or
    ``_lstm_launch_args``: the laid-out W and C) for a stream launch, the
    layout cached per weight tensor. The key is the tensor itself (not its
    data pointer, which a later tensor may reuse), its in-place version,
    the compute dtype and C, so an in-place update (a reloaded checkpoint's
    ``copy_``) or another tensor misses. An inference tensor has no
    version and is laid out at each call."""
    args, plan = {"gru": (_gru_launch_args, gru_plan),
                  "lstm": (_lstm_launch_args, lstm_plan)}[cell]
    if w.is_inference():
        return args(w, B, compute_dtype, "fwd")
    ndir, H = w.shape[:2]
    C = (plan(H, B, ndir, "fwd").cluster if compute_dtype == torch.bfloat16
         else 0)
    key = (w._version, compute_dtype, C)
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
    _kernels.LSTM_FWD.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), T, B, H, ndir, C,
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys


def lstm_scan_stream_cuda(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """LSTM stream kernel launch: (ys, carry h‖c); CUDA tensors only."""
    T, B, H, ndir = _check_stream(xs, w, lo, hi, h0, compute_dtype, emit_t,
                                  "lstm")
    wk, C = stream_launch_args("lstm", w, B, compute_dtype)
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    carry = torch.empty_like(h0)
    _kernels.LSTM_FWD_STREAM.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), carry.data_ptr(), T, B, H, ndir,
        emit_t, C, int(compute_dtype == torch.bfloat16),
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
    _kernels.LSTM_FWD_TRAIN.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), cs.data_ptr(), gates.data_ptr(), T, B, H, ndir, C,
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
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
    _kernels.LSTM_BWD.launch(
        gates.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        cs.data_ptr(), g.data_ptr(), dxs.data_ptr(), T, B, H, ndir, C,
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(gates))
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
