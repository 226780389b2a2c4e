"""Greedy (best-path) CTC decoding: argmax → collapse repeats → drop blanks,
lengths masked (port of ``decode/greedy.py`` + ``decode/greedy_pallas.py``).

The per-frame stage is the kernel ``csrc/greedy.cu`` (``best_keep``: the
kernel on CUDA tensors, ``best_keep_plain`` on CPU tensors); the
compaction ``compact_kept`` stays plain torch, as it stays in XLA.

NaN rule: the reference's Pallas kernel's, not XLA argmax's — a frame
holding any NaN decodes to blank (``greedy_pallas.py:32-39``), where
``_greedy_decode_xla`` would return the first NaN's index.
"""

from __future__ import annotations

import torch

from chainer_speech_recognition_tpu.constants import BLANK_ID, PAD_LABEL_ID

from .. import _kernels


def best_keep_plain(logits: torch.Tensor, lengths: torch.Tensor):
    """[B, T, V] logits, [B] lengths → (best, keep) [B, T] int32."""
    B, T, _ = logits.shape
    x = logits.to(torch.float32)
    best = torch.argmax(x, dim=-1)                         # first max
    best = torch.where(torch.isnan(x).any(dim=-1), BLANK_ID, best)
    best = best.to(torch.int32)
    prev = torch.cat([torch.full((B, 1), BLANK_ID, dtype=torch.int32,
                                 device=x.device), best[:, :-1]], dim=1)
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])
    keep = (best != BLANK_ID) & (best != prev) & valid
    return best, keep.to(torch.int32)


def best_keep_cuda(logits: torch.Tensor, lengths: torch.Tensor):
    """Kernel launch: same contract as ``best_keep_plain``, CUDA only."""
    B, T, V = logits.shape
    if B < 1 or T < 1 or V < 1:
        raise ValueError(f"greedy kernel: empty logits {tuple(logits.shape)}")
    _kernels.check_cuda_tensor("logits", logits, torch.float32, (B, T, V))
    lengths = lengths.to(device=logits.device, dtype=torch.int32).contiguous()
    _kernels.check_cuda_tensor("lengths", lengths, torch.int32, (B,))
    best = torch.empty((B, T), dtype=torch.int32, device=logits.device)
    keep = torch.empty((B, T), dtype=torch.int32, device=logits.device)
    _kernels.GREEDY.launch(logits.data_ptr(), lengths.data_ptr(), B, T, V,
                           best.data_ptr(), keep.data_ptr(),
                           _kernels.stream_ptr(logits))
    return best, keep


def best_keep(logits: torch.Tensor, lengths: torch.Tensor):
    if logits.is_cuda:
        return best_keep_cuda(logits.to(torch.float32).contiguous(), lengths)
    if logits.device.type != "cpu":
        raise ValueError(f"greedy: unsupported device {logits.device}")
    return best_keep_plain(logits, lengths)


def compact_kept(best: torch.Tensor, keep: torch.Tensor, max_len: int):
    """[B, T] (symbol, keep) → ([B, max_len] int32 ids padded with
    PAD_LABEL_ID, [B] lengths clamped to max_len)."""
    B = best.shape[0]
    keep = keep.to(torch.bool)
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1           # [B, T]
    out_lens = torch.clamp(pos[:, -1] + 1, max=max_len)
    # non-kept and overflowing (pos >= max_len) symbols go to a trash slot
    slot = torch.where(keep, torch.clamp(pos, max=max_len), max_len)
    out = torch.full((B, max_len + 1), PAD_LABEL_ID, dtype=torch.int32,
                     device=best.device)
    src = torch.where(keep, best.to(torch.int32), PAD_LABEL_ID)
    out.scatter_(1, slot.to(torch.int64), src.to(torch.int32))
    return out[:, :max_len], out_lens.to(torch.int32)


def greedy_decode(logits: torch.Tensor, lengths: torch.Tensor,
                  max_len: int | None = None):
    """[B, T, V] logits, [B] frame lengths → (ids [B, max_len] int32 padded
    with PAD_LABEL_ID, out_lens [B] int32)."""
    best, keep = best_keep(logits, lengths)
    return compact_kept(best, keep, max_len or logits.shape[1])
