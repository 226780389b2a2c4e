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
# the head widths the kernels take: the reference's set
# (attention_pallas.supports), dh = 64 for both presets (d 256 over 4
# heads) on the tensor-core kernels of one 64-wide tile, wider heads split
# into 64-column slices over blocks (csrc/attention_fwd.cu)
KERNEL_DHS = tuple(range(64, 513, 64))
AUTO_MIN_T = 512                 # auto routes flash only for T' above this

# per-call routing log: models/attention.py adds one to the path each
# offline MHSA call takes
ROUTED = {"flash": 0, "einsum": 0}


def supports(T: int, dh: int) -> bool:
    """The ``auto`` gate, the reference's (``attention_pallas.supports``):
    head widths of the kernels' set, and flash only for long-form T' >
    512, a speed and a training-quality decision."""
    return dh % 64 == 0 and dh <= 512 and T > AUTO_MIN_T


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


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ``x`` (fp32): the spacing of bf16
    values in x's binade, 2^(⌊log₂|x|⌋ − 7), and the subnormal spacing
    2⁻¹³³ below 2⁻¹²⁶ and at zero. Built from the exponent bits, so it is
    exact on any device."""
    _, e = torch.frexp(x.float())             # |x| = m·2^e, m in [0.5, 1)
    e = torch.where(x == 0, -133, torch.clamp(e - 8, min=-133)).to(
        torch.int32)                          # the ulp's exponent
    normal = (torch.clamp(e, min=-126) + 127) << 23
    subnormal = torch.ones_like(e) << torch.clamp(e + 149, max=22)
    return torch.where(e >= -126, normal, subnormal).view(torch.float32)


def bwd_rounding_room(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                      left_chunks: int = 0):
    """How far the bf16 backward kernels may legitimately differ from the
    plain versions by rounding p and ds to bf16 the other way: their
    products sum q·k and dO·v in another order, so an element near a bf16
    rounding midpoint may round one ulp apart. → (dq, dk, dv) fp32 [B, T,
    h, dh] = ((1/√dh)·Σₛ u(dsₜₛ)·|kₛ|, (1/√dh)·Σₜ u(dsₜₛ)·|qₜ|,
    Σₜ u(pₜₛ)·|dOₜ|) with u = ``bf16_ulp``; a gradient's bar is
    2⁻⁷·|b| + this + 1e-3."""
    p, ds = _bwd_terms(q, k, v, lens, do, lse, d_rows, chunk, left_chunks)
    scale = q.shape[-1] ** -0.5
    u_ds = bf16_ulp(ds)
    return (torch.einsum("bhts,bshd->bthd", u_ds, k.float().abs()) * scale,
            torch.einsum("bhts,bthd->bshd", u_ds, q.float().abs()) * scale,
            torch.einsum("bhts,bthd->bshd", bf16_ulp(p), do.float().abs()))


def bwd_planted_faults(q, k, v, lens, do, lse, d_rows, chunk: int = 0,
                       left_chunks: int = 0, tile: int = 1) -> dict:
    """Two faults a backward kernel could have, which the bf16 gradients'
    bar (``bwd_rounding_room``) must catch, each as what it adds to the
    plain versions' fp32 (dq, dk, dv) → {name: (ddq, ddk, ddv)}:

    * "p at 3 bits": p rounded to 3 mantissa bits (fp8 e4m3's) in dv and
      in ds = p ⊙ (dO·vᵀ − D), instead of bf16's 7;
    * "tile skipped": dq without the keys of 64-row tile ``tile``, dk and
      dv without its queries, as a loop that misses one tile."""
    p, ds = _bwd_terms(q, k, v, lens, do, lse, d_rows, chunk, left_chunks)
    scale = q.shape[-1] ** -0.5

    def grads(p, ds_q, ds_k):
        return (torch.einsum("bhts,bshd->bthd", ds_q.to(k.dtype).float(),
                             k.float()) * scale,
                torch.einsum("bhts,bthd->bshd", ds_k.to(q.dtype).float(),
                             q.float()) * scale,
                torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(),
                             do.float()))

    base = grads(p, ds, ds)
    m, e = torch.frexp(p)                     # p = m·2^e, m in [0.5, 1)
    p3 = torch.ldexp(torch.round(m * 16) / 16, e)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds3 = p3 * (dp - d_rows[..., None])
    rows = slice(64 * tile, 64 * (tile + 1))
    ds_q, ds_k, p_k = ds.clone(), ds.clone(), p.clone()
    ds_q[..., rows] = 0
    ds_k[..., rows, :] = 0
    p_k[..., rows, :] = 0
    return {name: tuple(a - b for a, b in zip(g, base))
            for name, g in (("p at 3 bits", grads(p3, ds3, ds3)),
                            ("tile skipped", grads(p_k, ds_q, ds_k)))}


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
    if dh not in KERNEL_DHS:
        raise ValueError(f"flash attention: head width {dh} is not built "
                         f"(the kernels take dh in {KERNEL_DHS}: dh % 64 "
                         "== 0, dh <= 512)")
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
    _check_aligned("forward", (("q", q), ("k", k), ("v", v)))
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
    values), as the kernels' tensor-core paths copy them."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0
                                          for s in t.stride()[:3])


def _check_aligned(kernels: str, operands) -> None:
    """The tensor-core paths' 16-byte copies: bf16 rows must be aligned."""
    for name, t in operands:
        if t.dtype == torch.bfloat16 and not rows_aligned16(t):
            raise ValueError(
                f"{name}: the bf16 {kernels} kernels need 16-byte aligned "
                "rows (data pointer and b, t, h strides multiples of 8)")


def _aligned(*ts):
    """The bf16 CUDA operands with rows that are not 16-byte aligned
    copied (autograd and callers may hand over any strides), the rest as
    they are."""
    return tuple(t if not (t.is_cuda and t.dtype == torch.bfloat16)
                 or rows_aligned16(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in ts)


def _check_bwd(lse, d_rows, q, k, v, do):
    B, T, h, _ = q.shape
    _kernels.check_cuda_tensor("lse", lse, torch.float32, (B, h, T))
    _kernels.check_cuda_tensor("d_rows", d_rows, torch.float32, (B, h, T))
    _check_aligned("backward", (("q", q), ("k", k), ("v", v), ("do", do)))


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
        q, k, v = _aligned(q, k, v)
        out, lse = flash_fwd(q, k, v, lens, chunk, left_chunks)
        ctx.chunk, ctx.left_chunks = chunk, left_chunks
        ctx.save_for_backward(q, k, v, lens, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lens, out, lse = ctx.saved_tensors
        do, = _aligned(do.to(q.dtype))
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
