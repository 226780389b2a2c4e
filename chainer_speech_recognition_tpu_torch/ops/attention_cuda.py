"""Flash self-attention kernels (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``) and their autograd Function.

Port of ``ops/attention_pallas.py``. The semantics are those of
``reference_mhsa`` (the einsum path of ``models/attention.py``'s offline
MHSA): fp32 scores of the compute-dtype q and k, scaled by 1/√dh, keys at
or past a row's length masked at −1e30, with ``chunk > 0`` the chunk-causal
pattern of ``chunk_causal_mask`` on top, fp32 softmax, probabilities rounded
to the compute dtype before the value product. Layout at the public
functions is the reference's ``[B, T, h, dh]`` (q, k, v, out, dq, dk, dv);
the kernels read q, k, v and dO through their strides (the last dim must be
dense), so the q/k/v slices of the fused qkv projection need no copy. Per
row (b, head, t) the forward also writes ``lse [B, h, T]`` fp32 = m + log l,
the logsumexp of the masked scores, from which the backward recomputes the
probabilities; ``D [B, h, T]`` = rowsum(dO ⊙ O) is one torch op in
``FlashAttention.backward``, as the reference leaves it to XLA.

A row with no allowed key (length 0, or a padded query whose chunk window
lies wholly past the length) has out = 0 and lse = −1e30, and its
probabilities are 0 in the backward: every row stays finite. Rows with at
least one allowed key equal the reference's; only those reach a valid
frame (``ConformerBlock`` zeroes padded frames on exit).

Three kernels, each with a plain PyTorch version in this module and a
wrapper that launches the kernel for CUDA tensors and takes the plain
version for CPU tensors only:

* ``flash_fwd(q, k, v, lens, chunk, left) → (out, lse)``;
* ``flash_bwd_dq(q, k, v, lens, do, lse, d_rows, chunk, left) → dq``;
* ``flash_bwd_dkv(...) → (dk, dv)``, over every query row < T, padded
  rows included, so the gradient is the function's for any cotangent.

``FlashAttention`` is the custom VJP and ``flash_mhsa`` the entry the model
calls. ``supports(T, dh)`` is the ``auto`` routing gate; ``ROUTED`` counts
the path each offline MHSA call took (one count per call, not per trace).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels

NEG = -1e30                      # the masking constant of the reference
KERNEL_DH = 64                   # the head width the kernels are built for
                                 # (both presets': d 256 over 4 heads)
AUTO_MIN_T = 512                 # auto routes flash only for T' above this

# per-call routing log: models/attention.py adds one to the path each
# offline MHSA call takes
ROUTED = {"flash": 0, "einsum": 0}


def supports(T: int, dh: int) -> bool:
    """The ``auto`` gate: the reference's policy (flash only for long-form
    T' > 512, a speed and a training-quality decision, see
    ``attention_pallas.supports``) with the CUDA kernels' own head width
    in place of the TPU's lane rule."""
    return dh == KERNEL_DH and T > AUTO_MIN_T


# ------------------------------------------------------------ plain versions

def chunk_causal_mask(T: int, chunk: int, left_chunks: int,
                      device=None) -> torch.Tensor:
    """[T, T] bool: query t may attend key s iff s's chunk lies within
    ``[t's chunk − left_chunks, t's chunk]`` (``models/attention.py``'s
    ``chunk_causal_mask``)."""
    tc = torch.arange(T, device=device) // chunk
    return (tc[None, :] <= tc[:, None]) & (tc[None, :] >= tc[:, None]
                                           - left_chunks)


def allowed_mask(T: int, lens: torch.Tensor, chunk: int,
                 left_chunks: int) -> torch.Tensor:
    """[B, 1, T, T] bool: which (query, key) pairs each row may use."""
    ok = (torch.arange(T, device=lens.device)[None, :]
          < lens[:, None])[:, None, None, :]
    if chunk:
        ok = ok & chunk_causal_mask(T, chunk, left_chunks,
                                    lens.device)[None, None]
    return ok


def _scores(q, k, lens, chunk, left_chunks):
    """(masked fp32 scores [B, h, T, T], allowed mask)."""
    dh = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (dh ** -0.5)
    ok = allowed_mask(q.shape[1], lens, chunk, left_chunks)
    return torch.where(ok, s, NEG), ok


def flash_fwd_plain(q, k, v, lens, chunk: int = 0, left_chunks: int = 0):
    """Plain version of the forward kernel → (out [B, T, h, dh] in q's
    dtype, lse [B, h, T] fp32)."""
    s, ok = _scores(q, k, lens, chunk, left_chunks)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0                       # rows with an allowed key
    l = torch.where(live, l, 1.0)      # (so autograd sees no 0/0 either)
    acc = torch.einsum("bhts,bshd->bthd", p.to(q.dtype).float(), v.float())
    live_t = live.squeeze(-1).transpose(1, 2)[..., None]    # [B, T, h, 1]
    l_t = l.squeeze(-1).transpose(1, 2)[..., None]
    out = torch.where(live_t, acc / l_t, 0.0).to(q.dtype)
    lse = torch.where(live[..., 0], m[..., 0] + torch.log(l[..., 0]), NEG)
    return out, lse


def _bwd_terms(q, k, v, lens, do, lse, d_rows, chunk, left_chunks):
    """(p, ds) [B, h, T, T] fp32: probabilities recomputed from lse and
    ds = p ⊙ (dO·vᵀ − D)."""
    s, ok = _scores(q, k, lens, chunk, left_chunks)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    return p, p * (dp - d_rows[..., None])


def flash_bwd_dq_plain(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                       left_chunks: int = 0):
    """Plain version of the dQ kernel → dq [B, T, h, dh] in q's dtype."""
    _, ds = _bwd_terms(q, k, v, lens, do, lse, d_rows, chunk, left_chunks)
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(), k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                        left_chunks: int = 0):
    """Plain version of the dK/dV kernel → (dk, dv) [B, T, h, dh] in k's
    and v's dtypes."""
    p, ds = _bwd_terms(q, k, v, lens, do, lse, d_rows, chunk, left_chunks)
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).float(), q.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels

def _check_qkv(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must be dense (stride 1)")


def _geometry(q, k, v, lens, chunk, left_chunks, *extra):
    """Check the kernels' operands → (dims, strides) host int arrays."""
    B, T, h, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention: dtype {q.dtype} is not built")
    if dh != KERNEL_DH:
        raise ValueError(f"flash attention: head width {dh} is not built "
                         f"(the kernels take dh = {KERNEL_DH})")
    if B < 1 or T < 1 or h < 1:
        raise ValueError(f"flash attention: empty shape {tuple(q.shape)}")
    if chunk < 0 or left_chunks < 0:
        raise ValueError("flash attention: chunk and left_chunks must be >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)) + extra:
        _check_qkv(name, t, q.dtype, (B, T, h, dh))
    _kernels.check_cuda_tensor("lens", lens, torch.int32, (B,))
    dims = (ctypes.c_int * 6)(B, T, h, dh, chunk, left_chunks)
    strides = [s for _, t in (("q", q), ("k", k), ("v", v)) + extra
               for s in t.stride()[:3]]
    return dims, (ctypes.c_int * len(strides))(*strides)


def flash_fwd_cuda(q, k, v, lens, chunk: int = 0, left_chunks: int = 0):
    """Kernel launch: → (out [B, T, h, dh] contiguous, lse [B, h, T])."""
    dims, strides = _geometry(q, k, v, lens, chunk, left_chunks)
    B, T, h, dh = q.shape
    out = torch.empty((B, T, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, h, T), dtype=torch.float32, device=q.device)
    _kernels.FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), lse.data_ptr(), dims, strides,
        int(q.dtype == torch.bfloat16), _kernels.stream_ptr(q))
    return out, lse


def rows_aligned16(t: torch.Tensor) -> bool:
    """Whether every [..., dh] row of a bf16 ``[B, T, h, dh]`` tensor
    starts on 16 bytes (data pointer and b, t, h strides multiples of 8
    values), as the backward kernels' tensor-core path copies them."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0
                                          for s in t.stride()[:3])


def _check_bwd(lse, d_rows, q, k, v, do):
    B, T, h, _ = q.shape
    _kernels.check_cuda_tensor("lse", lse, torch.float32, (B, h, T))
    _kernels.check_cuda_tensor("d_rows", d_rows, torch.float32, (B, h, T))
    if q.dtype == torch.bfloat16:     # the tensor-core path's 16-byte copies
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if not rows_aligned16(t):
                raise ValueError(
                    f"{name}: the bf16 backward kernels need 16-byte aligned "
                    "rows (data pointer and b, t, h strides multiples of 8)")


def flash_bwd_dq_cuda(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                      left_chunks: int = 0):
    """Kernel launch: → dq [B, T, h, dh] contiguous."""
    dims, strides = _geometry(q, k, v, lens, chunk, left_chunks,
                              ("do", do))
    _check_bwd(lse, d_rows, q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernels.FLASH_BWD_DQ.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lens.data_ptr(), lse.data_ptr(), d_rows.data_ptr(), dq.data_ptr(),
        dims, strides, int(q.dtype == torch.bfloat16), _kernels.stream_ptr(q))
    return dq


def flash_bwd_dkv_cuda(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                       left_chunks: int = 0):
    """Kernel launch: → (dk, dv) [B, T, h, dh] contiguous."""
    dims, strides = _geometry(q, k, v, lens, chunk, left_chunks,
                              ("do", do))
    _check_bwd(lse, d_rows, q, k, v, do)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernels.FLASH_BWD_DKV.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lens.data_ptr(), lse.data_ptr(), d_rows.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dims, strides, int(q.dtype == torch.bfloat16),
        _kernels.stream_ptr(q))
    return dk, dv


# ----------------------------------------------------------------- wrappers

def flash_fwd(q, k, v, lens, chunk: int = 0, left_chunks: int = 0):
    """(out, lse): the forward kernel on the card, the plain version on
    the CPU."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, lens.to(torch.int32), chunk,
                              left_chunks)
    _kernels.check_cpu_tensor("flash_fwd", q)
    return flash_fwd_plain(q, k, v, lens, chunk, left_chunks)


def flash_bwd_dq(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                 left_chunks: int = 0):
    """dq: the dQ kernel on the card, the plain version on the CPU."""
    if q.is_cuda:
        return flash_bwd_dq_cuda(q, k, v, lens.to(torch.int32), do, lse,
                                 d_rows, chunk, left_chunks)
    _kernels.check_cpu_tensor("flash_bwd_dq", q)
    return flash_bwd_dq_plain(q, k, v, lens, do, lse, d_rows, chunk,
                              left_chunks)


def flash_bwd_dkv(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                  left_chunks: int = 0):
    """(dk, dv): the dK/dV kernel on the card, the plain version on the
    CPU."""
    if q.is_cuda:
        return flash_bwd_dkv_cuda(q, k, v, lens.to(torch.int32), do, lse,
                                  d_rows, chunk, left_chunks)
    _kernels.check_cpu_tensor("flash_bwd_dkv", q)
    return flash_bwd_dkv_plain(q, k, v, lens, do, lse, d_rows, chunk,
                               left_chunks)


class FlashAttention(torch.autograd.Function):
    """``_flash_core`` with its custom VJP: out from (q, k, v); gradients
    for q, k and v in their dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, lens, chunk, left_chunks):
        out, lse = flash_fwd(q, k, v, lens, chunk, left_chunks)
        ctx.chunk, ctx.left_chunks = chunk, left_chunks
        ctx.save_for_backward(q, k, v, lens, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lens, out, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if q.is_cuda and q.dtype == torch.bfloat16:
            # the bf16 kernels read 16-byte aligned rows; autograd may hand
            # over any strides, so a misaligned operand is copied, not refused
            q, k, v, do = (t if rows_aligned16(t) else
                           t.clone(memory_format=torch.contiguous_format)
                           for t in (q, k, v, do))
        # D = rowsum(dO ⊙ O): one elementwise reduce, as in the reference
        d_rows = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()                                   # [B, h, T]
        args = (q, k, v, lens, do, lse, d_rows, ctx.chunk, ctx.left_chunks)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_mhsa(q, k, v, lengths, chunk: int = 0, left_chunks: int = 0):
    """softmax(mask(q·kᵀ/√dh))·v for ``[B, T, h, dh]`` q/k/v (post-RoPE,
    in the compute dtype) and ``[B]`` valid lengths; differentiable in q,
    k and v. → ``[B, T, h, dh]`` in q's dtype."""
    return FlashAttention.apply(q, k, v, lengths, int(chunk),
                                int(left_chunks))
