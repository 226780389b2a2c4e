"""Bidirectional GRU and LSTM recurrence kernels (``csrc/gru_fwd.cu``,
``csrc/gru_bwd.cu``, ``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) and their
autograd Functions.

Port of ``ops/rnn_pallas.py``, with the same layout (G = 3 gates for the
GRU, 4 for the LSTM):

  xs    [T, R=ndir·B, G·H] stream dtype — input pre-activations; rows
                         [d·B, (d+1)·B) use w[d]: for a bidirectional layer
                         (ndir = 2) rows [0, B) are the forward direction,
                         rows [B, 2B) the time-reversed backward direction;
                         a forward-only layer (ndir = 1) has rows [0, B)
  w     [ndir, H, G·H] fp32 — recurrent weights per direction (ndir is w's
                         leading extent: 2, or 1 for the forward-only
                         inference and stream forms; training takes 2)
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

Eight kernels, each with its wrapper (the kernel for CUDA tensors, the
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

``BiGRUScan`` and ``BiLSTMScan`` are ``birnn_pallas``'s custom VJP: the
training forward, the backward kernel, then dW = Σ_t h_prevᵀ·dgate as
matmuls with compute-dtype operands and fp32 accumulation (``_dw_einsum``;
for the LSTM the masked dg is dxs itself).

``kernel_takes(H)`` is the hidden sizes the kernels take and the gate of
``models/rnn.py``'s ``auto`` routing; ``ROUTED`` counts the path each
layer call took.
"""

from __future__ import annotations

import torch

from .. import _kernels


# per-call routing log: models/rnn.py adds one to the path each layer call
# takes (the kernels' wrappers, or the plain scan)
ROUTED = {"kernel": 0, "scan": 0}


def kernel_takes(H: int) -> bool:
    """The hidden sizes the kernels take (one thread per unit): 32 ≤ H ≤
    512 with H % 32 == 0."""
    return H % 32 == 0 and 32 <= H <= 512


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
        raise ValueError(f"{cell} kernel: hidden size {H} unsupported (one "
                         "thread per unit: 32 <= H <= 512, H % 32 == 0)")
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
    wk = w.to(compute_dtype).contiguous()
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    _kernels.GRU_FWD.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), T, B, H, ndir, int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(xs))
    return ys


def gru_scan_stream_cuda(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """Stream kernel launch: (ys, carry); CUDA tensors only."""
    T, B, H, ndir = _check_stream(xs, w, lo, hi, h0, compute_dtype, emit_t,
                                  "gru")
    wk = w.to(compute_dtype).contiguous()
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    carry = torch.empty_like(h0)
    _kernels.GRU_FWD_STREAM.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), carry.data_ptr(), T, B, H, ndir,
        emit_t, int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys, carry


def gru_scan_train_cuda(xs, w, lo, hi, compute_dtype):
    """Training forward launch: (ys, gates); CUDA tensors only."""
    T, B, H, sdt = _check_scan(xs, w, lo, hi, compute_dtype)
    wk = w.to(compute_dtype).contiguous()
    ys = torch.empty((T, 2 * B, H), dtype=torch.float32, device=xs.device)
    gates = torch.empty((T, 2 * B, 4 * H), dtype=sdt, device=xs.device)
    _kernels.GRU_FWD_TRAIN.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), gates.data_ptr(), T, B, H,
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys, gates


def gru_bwd_cuda(gates, w, lo, hi, h_prev, g, compute_dtype):
    """Backward kernel launch: (dxs, dhn); CUDA tensors only. W is passed
    transposed per direction ([2, 3H, H]) so the kernel's reads coalesce."""
    T, R, _ = gates.shape
    H = w.shape[1]
    sdt = _check_sizes(T, R, H, compute_dtype)
    _check_weights(w, lo, hi, R, H)
    _kernels.check_cuda_tensor("gates", gates, sdt, (T, R, 4 * H))
    _kernels.check_cuda_tensor("h_prev", h_prev, torch.float32, (T, R, H))
    _kernels.check_cuda_tensor("g", g, torch.float32, (T, R, H))
    wt = w.to(compute_dtype).transpose(1, 2).contiguous()
    dxs = torch.empty((T, R, 3 * H), dtype=sdt, device=gates.device)
    dhn = torch.empty((T, R, H), dtype=sdt, device=gates.device)
    _kernels.GRU_BWD.launch(
        gates.data_ptr(), wt.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h_prev.data_ptr(), g.data_ptr(), dxs.data_ptr(), dhn.data_ptr(),
        T, R // 2, H, int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(gates))
    return dxs, dhn


def _lstm_fwd_weights(w, compute_dtype):
    """W [ndir, H, 4H] → the forward kernel's k-quads [ndir, H/4, 4H, 4] in
    the compute dtype: element [d, k4, col, kk] is W[d, 4·k4 + kk, col]."""
    ndir, H = w.shape[:2]
    return w.to(compute_dtype).reshape(ndir, H // 4, 4, 4 * H).transpose(
        2, 3).contiguous()


def _lstm_bwd_weights(w, compute_dtype):
    """W [2, H, 4H] → the backward kernel's k-quads of Wᵀ, [2, H, H, 4] in
    the compute dtype: element [d, k4, j, kk] is W[d, j, 4·k4 + kk]."""
    H = w.shape[1]
    return w.to(compute_dtype).reshape(2, H, H, 4).transpose(1, 2) \
        .contiguous()


def lstm_scan_cuda(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Residual-free LSTM kernel launch (CUDA tensors only; raises on
    shapes it does not take); ndir = w.shape[0]."""
    ndir = w.shape[0]
    T, B, H, _ = _check_scan(xs, w, lo, hi, compute_dtype, "lstm", ndir)
    wq = _lstm_fwd_weights(w, compute_dtype)
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    _kernels.LSTM_FWD.launch(
        xs.data_ptr(), wq.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), T, B, H, ndir, int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(xs))
    return ys


def lstm_scan_stream_cuda(xs, w, lo, hi, h0, compute_dtype, emit_t: int):
    """LSTM stream kernel launch: (ys, carry h‖c); CUDA tensors only."""
    T, B, H, ndir = _check_stream(xs, w, lo, hi, h0, compute_dtype, emit_t,
                                  "lstm")
    wq = _lstm_fwd_weights(w, compute_dtype)
    ys = torch.empty((T, ndir * B, H), dtype=torch.float32, device=xs.device)
    carry = torch.empty_like(h0)
    _kernels.LSTM_FWD_STREAM.launch(
        xs.data_ptr(), wq.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), carry.data_ptr(), T, B, H, ndir,
        emit_t, int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys, carry


def lstm_scan_train_cuda(xs, w, lo, hi, compute_dtype):
    """LSTM training forward launch: (ys, cs, gates); CUDA tensors only."""
    T, B, H, sdt = _check_scan(xs, w, lo, hi, compute_dtype, "lstm")
    wq = _lstm_fwd_weights(w, compute_dtype)
    ys = torch.empty((T, 2 * B, H), dtype=torch.float32, device=xs.device)
    cs = torch.empty_like(ys)
    gates = torch.empty((T, 2 * B, 4 * H), dtype=sdt, device=xs.device)
    _kernels.LSTM_FWD_TRAIN.launch(
        xs.data_ptr(), wq.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), cs.data_ptr(), gates.data_ptr(), T, B, H,
        int(compute_dtype == torch.bfloat16), _kernels.stream_ptr(xs))
    return ys, cs, gates


def lstm_bwd_cuda(gates, w, lo, hi, cs, g, compute_dtype):
    """LSTM backward kernel launch: dxs; CUDA tensors only."""
    T, R, _ = gates.shape
    H = w.shape[1]
    sdt = _check_sizes(T, R, H, compute_dtype, "lstm")
    _check_weights(w, lo, hi, R, H, 4)
    _kernels.check_cuda_tensor("gates", gates, sdt, (T, R, 4 * H))
    for name, t in (("cs", cs), ("g", g)):
        _kernels.check_cuda_tensor(name, t, torch.float32, (T, R, H))
    wtq = _lstm_bwd_weights(w, compute_dtype)
    dxs = torch.empty((T, R, 4 * H), dtype=sdt, device=gates.device)
    _kernels.LSTM_BWD.launch(
        gates.data_ptr(), wtq.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        cs.data_ptr(), g.data_ptr(), dxs.data_ptr(), T, R // 2, H,
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


def gru_bwd(gates, w, lo, hi, h_prev, g, compute_dtype):
    """(dxs, dhn): the backward kernel on the card, the plain version on
    the CPU."""
    if gates.is_cuda:
        return gru_bwd_cuda(gates, w, lo, hi, h_prev.contiguous(),
                            g.contiguous(), compute_dtype)
    _kernels.check_cpu_tensor("gru_bwd", gates)
    return gru_bwd_plain(gates, w, lo, hi, h_prev, g, compute_dtype)


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
    """dW[d] = Σ_t h_prev[t, d-rows]ᵀ · dgate[t, d-rows] → [2, H, G] with
    compute-dtype operands and fp32 accumulation (``_dw_einsum``): the
    operands are rounded to the compute dtype and multiplied in fp32, where
    a product of two bf16 values is exact."""
    acc = _acc_dtype(compute_dtype)
    hp = h_prev.to(compute_dtype).to(acc)
    dg = dgate.to(compute_dtype).to(acc)
    H, G = hp.shape[-1], dg.shape[-1]
    return torch.stack([
        hp[:, :B].reshape(-1, H).T @ dg[:, :B].reshape(-1, G),
        hp[:, B:].reshape(-1, H).T @ dg[:, B:].reshape(-1, G)])


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
        H = w.shape[1]
        B = ys.shape[1] // 2
        h_prev = shift_prev(ys)
        dxs, dhn = gru_bwd(gates, w, lo, hi, h_prev, gy.to(ys.dtype), cdt)
        dw = torch.cat([dw_matmul(h_prev, dxs[..., :2 * H], B, cdt),
                        dw_matmul(h_prev, dhn, B, cdt)], dim=2)
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
        B = ys.shape[1] // 2
        dxs = lstm_bwd(gates, w, lo, hi, cs, gy.to(ys.dtype), cdt)
        dw = dw_matmul(shift_prev(ys), dxs, B, cdt)    # dg ≡ dxs (masked)
        return dxs, dw.to(w.dtype), None, None, None
