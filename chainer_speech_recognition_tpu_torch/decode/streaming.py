"""Online (streaming) recognition: latency-controlled chunked inference
(port of ``decode/streaming.py``).

Each window of PCM goes through the same device math as the reference's
compiled step, eagerly: the spectral stage (``cuda_frontend.
fused_logmel_rows``: the fused log-mel kernel on the card, its plain rfft
version on the CPU, so card streaming and card offline decode share one
spectral stage), causal CMVN with its carried stats, Δ/ΔΔ, and the
streaming model call, whose RNN layers take the stream kernels
(``ops/rnn_cuda.gru_scan_stream``/``lstm_scan_stream``). B streams advance
in lockstep; every carry (CMVN stats, RNN states, the previous chunk's
last frame id) stays on the recognizer's device between windows, and only
the emitted ids come back to the host.

How each component streams, as in the reference:

* **Front-end**: framing/STFT/mel are local (±256 samples); the PCM window
  carries that margin. CMVN must be ``features.cmvn_mode="causal"`` (or
  off), carried across chunks as (count, Σx, Σx², offset), exactly
  equivalent to the offline causal front-end. Δ/ΔΔ need ±4 frames, covered
  by the window's delta margin.
* **Conv stack**: a left margin of ``model.conv_receptive_margin()``
  frames, recomputed each chunk and dropped after the convs, keeps the
  interior conv outputs equal to the full-utterance computation; at the
  right edge they are exact when ``right_frames`` covers
  ``model.conv_right_margin()`` (``stream_geometry(...)["conv_exact"]``).
* **RNN stack**: the forward direction carries its state across chunk
  boundaries exactly; the backward direction starts fresh at the window's
  right edge (the latency-controlled BiRNN approximation, exact when a
  window reaches the utterance end). A forward-only stack (``uni_gru``)
  streams exactly at zero lookahead.
* **Chunk-causal attention** (``conformer_stream``, ``attn_chunk > 0``):
  the emit region is one attention chunk and the lookahead lives inside
  it (``right_frames`` must be 0); each block carries the post-RoPE keys
  and values of the last ``attn_left_chunks`` chunks and the causal
  conv's tail, and the model carries each row's positions (the model's
  ``init_stream_carries`` / ``reset_stream_rows``), so streaming equals
  the offline chunk-masked computation exactly. Global-attention models
  refuse to stream.
* **Greedy CTC collapse**: argmax per frame with the previous chunk's last
  raw frame id carried, so repeats collapse across boundaries.
* **Prefix beam search** (``decoder="beam"``, optional LM fusion): the
  beam recursion is causal, so the [B, K] hypothesis state carries across
  chunks exactly (``decode/beam.BeamStreamDecoder``: one launch of
  ``csrc/beam.cu`` a window on the card) — chunked beam equals the
  offline beam on the same logits. Tokens are finalized once every live
  beam agrees on them; ``flush`` tops up with the 1-best tail, and an
  endpoint closes a row's utterance with its 1-best tail
  (``end_rows``).

The host code (``stream_geometry``, ``decode_lockstep``, ``accept``,
``flush``, endpointing, ``_trim``, ``_assemble``) is the reference's,
line for line.

Over a data-parallel mesh (``mesh=``, ``parallel/mesh.py``; config 5
extended to online serving), when the lockstep batch splits evenly each
rank runs the window's device math (front-end, CMVN, model, with their
carries) on its own segment of the streams, and the window logits are
gathered back in the global order, so the decoder (greedy or the chunk
beam, replicated as in the reference) and the host state see the whole
batch on every rank: each rank returns what one device returns.

Latency = (chunk_frames + right_frames) × 10 ms of audio buffering plus
one window of compute; throughput scales with the lockstep batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import constants as C
from ..constants import BLANK_ID
from ..frontend.cuda_frontend import fused_logmel_rows
from ..frontend.torch_frontend import _delta, cmvn_causal
from ..parallel.mesh import all_gather_rows, row_segment
from .beam import BeamStreamDecoder

_D = 2 * C.DELTA_WINDOW          # logmel margin the Δ/ΔΔ stack needs (4)
_PAD = C.N_FFT // 2              # centered-STFT half window (256 samples)
_K = C.N_FFT // C.HOP_LENGTH     # full hop rows per frame (3)

__all__ = ["StreamingRecognizer", "stream_geometry", "decode_lockstep"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_geometry(model, chunk_frames: int, right_frames: int,
                    left_margin: int | None = None):
    """Resolve the chunk geometry (all in 10 ms feature frames, rounded to
    the conv subsampling factor ``s``):

    * ``C``  emitted frames per step, ``R`` lookahead frames;
    * ``La`` left recompute margin (≥ the conv stack's one-sided receptive
      field) — window-edge conv outputs inside it are discarded;
    * first window covers logmel frames ``[0, C+R+D)``; steady-state
      windows cover ``[t0−La−D, t0+C+R+D)`` where D is the Δ/ΔΔ margin;
    * ``conv_exact`` — True iff ``R`` covers the conv stack's RIGHT
      receptive reach past the emit region (``model.conv_right_margin()``),
      i.e. every emitted frame's conv receptive field is real audio; with
      a smaller lookahead the frames nearest each chunk boundary see
      zero-padded conv context (callers should surface this to the user).
    """
    ac = getattr(model.cfg, "attn_chunk", 0)
    if getattr(model.cfg, "attn_blocks", 0) and not ac:
        raise ValueError(
            "global-attention presets (model.attn_blocks > 0, attn_chunk "
            "== 0) have a global receptive field — chunked streaming "
            "cannot reproduce the offline computation; serve them with "
            "evaluate/decode, or train a chunk-causal preset "
            "(conformer_stream) to stream the attention family")
    s = model.subsample_factor()
    Cf = _round_up(max(chunk_frames, s), s)
    Rf = _round_up(max(right_frames, 0), s)
    La = _round_up(model.conv_receptive_margin() if left_margin is None
                   else left_margin, s)
    # steady-state windows start at t0 − La − D: the second window (t0 = C)
    # must not reach before the stream start, and the first window's CMVN
    # carry index C − La − D must cover ≥ 1 frame
    min_c = _round_up(La + _D + 1, s)
    if Cf < min_c:
        Cf = min_c
    if ac:
        # chunk-causal attention: the emit region must BE one attention
        # chunk (the KV-cache carries roll by exactly one chunk per step,
        # models/presets.py), and the lookahead lives INSIDE the chunk —
        # right_frames would shift the attention grid off its training-
        # time alignment, so it must be 0
        if right_frames:
            raise ValueError(
                "chunk-causal attention has its lookahead inside the "
                "chunk (attn_chunk covers it); right_frames must be 0")
        Cf, Rf = ac * s, 0
        if Cf < min_c:
            raise ValueError(
                f"attn_chunk={ac} gives a {Cf}-frame emit region, below "
                f"the geometry floor {min_c} (conv margin {La} + delta "
                f"margin {_D} + 1) — train with a larger attn_chunk")
    return {"s": s, "C": Cf, "R": Rf, "La": La,
            "conv_exact": Rf >= model.conv_right_margin(),
            "W_first": Cf + Rf + _D,              # logmel frames, first
            "W_mid": La + _D + Cf + Rf + _D}      # logmel frames, steady


def decode_lockstep(rec, order, read_signal):
    """Drive items through the recognizer in lockstep batches, yielding
    ``(item_indices, token_id_lists)`` per batch.

    The one shared copy of the lockstep-padding discipline of the bulk CLI
    (``cli/stream.py`` wav mode):

    * ``order`` — item indices, caller-sorted by length (bounded padding
      waste); ``read_signal(i)`` → float32 PCM for item ``i``;
    * the static batch's padding rows REUSE the first row's already-read
      signal (never re-read / re-resample the file);
    * audio buffers whole via ``accept(drain=False)`` — a single linear
      copy, no behavioral difference vs. piecewise feeding since nothing
      drains between calls — then ``flush(num_samples=...)`` emits every
      window with per-stream true lengths (the exact-lockstep semantics
      of ``StreamingRecognizer.accept``).
    """
    B = rec.batch
    for s0 in range(0, len(order), B):
        grp = list(order[s0 : s0 + B])
        sigs = [np.asarray(read_signal(i), np.float32) for i in grp]
        sigs += [sigs[0]] * (B - len(grp))            # static batch rows
        ns = np.asarray([len(x) for x in sigs], np.int64)
        pcm = np.zeros((B, int(ns.max())), np.float32)
        for r, x in enumerate(sigs):
            pcm[r, : len(x)] = x
        rec.reset()
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)
        em = rec.emitted                # one copy of all streams' outputs
        yield grp, em[: len(grp)]


def _window_logits(model, ext, frame_valid, cmvn_carry, rnn_carries, *,
                   W_lm, lo, W_ft, drop_left, carry_at, cmvn_index,
                   use_cmvn):
    """Device math of both window variants: PCM window → causal features →
    streaming model call. Returns (logits, emit_lens, new_cmvn_carry,
    new_rnn_carries)."""
    logmel = fused_logmel_rows(ext, W_lm)                   # [B, W_lm, M]

    tmask = (torch.arange(W_lm, device=ext.device)[None, :]
             < frame_valid[:, None])
    logmel = logmel * tmask[..., None]
    if use_cmvn:
        norm, new_cmvn = cmvn_causal(logmel, tmask, carry=cmvn_carry,
                                     carry_index=cmvn_index)
    else:
        norm, new_cmvn = logmel, ()
    d1 = _delta(norm, frame_valid)
    d2 = _delta(d1, frame_valid)
    feats = torch.stack([norm, d1, d2], dim=-1)             # [B, W_lm, M, 3]
    feats = feats * tmask[..., None, None]
    feats = feats[:, lo : lo + W_ft]
    feat_valid = torch.clamp(frame_valid - lo, 0, W_ft)

    logits, lens, new_rnn = model(
        feats.to(torch.float32), feat_valid, rnn_carries=rnn_carries,
        carry_at=carry_at, drop_left=drop_left)
    return logits, lens, new_cmvn, new_rnn


def _emit_greedy(logits, lens, prev_id, C_s):
    """Greedy collapse over the emitted chunk with the previous chunk's
    last raw frame id carried (decode/greedy.py's semantics across chunk
    boundaries)."""
    ids = torch.argmax(logits[:, :C_s], dim=-1).to(torch.int32)   # [B, C_s]
    n = torch.clamp(lens, 0, C_s)                                  # [B]
    prev = torch.cat([prev_id[:, None], ids[:, :-1]], dim=1)
    valid = (torch.arange(C_s, device=ids.device)[None, :] < n[:, None])
    keep = (ids != BLANK_ID) & (ids != prev) & valid
    last = torch.where(n > 0, torch.gather(
        ids, 1, torch.clamp(n - 1, min=0)[:, None].long())[:, 0], prev_id)
    return ids, keep, n, last


class StreamingRecognizer:
    """Incremental recognizer over ``batch`` lockstep PCM streams, on the
    model's device.

    >>> rec = StreamingRecognizer(model, cfg, batch=1)
    >>> for block in audio_blocks:          # arbitrary-size PCM pieces
    ...     new_ids = rec.accept(block)     # tokens finalized so far
    >>> tail = rec.flush()                  # end the utterances
    >>> full = rec.emitted                  # all ids per stream

    ``model`` is the port's ``AcousticModel`` with its weights (the
    reference passes flax params beside it). Requires
    ``features.cmvn_mode == "causal"`` (train the model with it).
    ``decoder="beam"`` decodes each window with the carried prefix beam
    (``beam`` wide, ``lm`` fused with ``lm_alpha``/``lm_beta``).
    ``accept`` feeds every stream the same number of samples (lockstep
    serving); streams of different true lengths end via
    ``flush(num_samples=[...])``.
    """

    def __init__(self, model, cfg, *, batch: int = 1,
                 chunk_frames: int = 64, right_frames: int = 16,
                 left_margin: int | None = None, decoder: str = "greedy",
                 beam: int = 8, lm=None, lm_alpha: float = 0.5,
                 lm_beta: float = 1.0, endpoint_ms: float | None = None,
                 mesh=None):
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder={decoder!r}: expected greedy|beam")
        self._decoder = decoder
        self._beam_args = (beam, lm, lm_alpha, lm_beta)
        # CTC endpointing: an utterance ends once the argmax has been
        # blank for >= endpoint_ms of audio (checked at chunk granularity)
        # — the finished segment lands in ``self.segments`` and the
        # decoder/RNN state resets for the next utterance (causal-CMVN
        # stats keep flowing: the channel does not change at a boundary)
        self._ep_frames = (None if endpoint_ms is None
                           else max(int(endpoint_ms / 10), 1))
        if cfg.features.cmvn_arg not in (False, "causal"):
            raise ValueError(
                "streaming needs features.cmvn_mode='causal' (or cmvn off): "
                "utterance CMVN cannot be computed online — retrain the "
                f"model accordingly (got cmvn_arg={cfg.features.cmvn_arg!r})")
        if cfg.features.use_cache:
            raise ValueError("streaming computes features on device; "
                             "features.use_cache is incompatible")
        self.model, self.cfg = model, cfg
        self.device = model.output.weight.device
        self.batch = batch
        self._mesh = (mesh if mesh is not None and mesh.size > 1
                      and batch % mesh.size == 0 else None)
        self._rows = row_segment(self._mesh, batch)   # this rank's streams
        g = stream_geometry(model, chunk_frames, right_frames, left_margin)
        self.geo = g
        s = g["s"]
        self._C_s = g["C"] // s
        self._use_cmvn = bool(cfg.features.cmvn_arg)
        # first window: logmel [0, C+R+D), no margins, offline start edge
        self._args_first = dict(W_lm=g["W_first"], lo=0, W_ft=g["C"] + g["R"],
                                drop_left=0, carry_at=self._C_s,
                                cmvn_index=g["C"] - g["La"] - _D)
        # steady state: logmel [t0−La−D, t0+C+R+D)
        self._args_mid = dict(W_lm=g["W_mid"], lo=_D,
                              W_ft=g["La"] + g["C"] + g["R"],
                              drop_left=g["La"] // s, carry_at=self._C_s,
                              cmvn_index=g["C"])
        self.reset()

    def _step(self, ext, frame_valid):
        """One window on the device: → (ids, out, n), and the carries
        advance in place of the old ones. Greedy: out is the keep mask of
        the collapse; beam: the emit region's fp32 logits, which the beam
        consumes on the device, and ids the raw argmax (the endpointer's)."""
        args = self._args_first if self._first else self._args_mid
        with torch.inference_mode():
            logits, lens, cmvn, rnn = _window_logits(
                self.model, ext, frame_valid,
                None if self._first else self._cmvn, self._rnn,
                use_cmvn=self._use_cmvn, **args)
            if self._mesh is not None:   # this rank's streams → all
                logits = all_gather_rows(self._mesh, logits)
                lens = all_gather_rows(self._mesh, lens)
            if self._beamdec is not None:
                C_s = self._C_s
                n = torch.clamp(lens, 0, C_s)
                ids = torch.argmax(logits[:, :C_s], dim=-1).to(torch.int32)
                self._cmvn, self._rnn = cmvn, rnn
                return ids, logits[:, :C_s].to(torch.float32), n
            ids, keep, n, last = _emit_greedy(logits, lens, self._prev,
                                              self._C_s)
        self._cmvn, self._rnn, self._prev = cmvn, rnn, last
        return ids, keep, n

    # ------------------------------------------------------------- state --

    def reset(self) -> None:
        B = self.batch
        self._buf = np.zeros((B, 0), np.float32)
        self._n = 0                      # buffered samples (per stream)
        self._base = 0                   # samples trimmed off _buf's front
        self._t0 = 0                     # next emit frame
        self._first = True
        self._trail = np.zeros((B,), np.int64)   # trailing blank subframes
        self._seg_start = [0] * B        # _out offset of the open segment
        # wall seconds per processed window (assembly + compute + result
        # pull) — the serving-latency signal; spans resets deliberately
        # (an observability log for the recognizer's lifetime)
        self.window_times: list[float] = getattr(self, "window_times", [])
        self.segments: list[list[tuple[list[int], int]]] = \
            [[] for _ in range(B)]       # (ids, end 10ms-frame) per utt
        self._cmvn = None                # device carry after first window
        # the model's carries hold this rank's streams only
        self._rnn = self.model.init_stream_carries(
            self._rows.stop - self._rows.start)
        self._prev = torch.full((B,), BLANK_ID, dtype=torch.int32,
                                device=self.device)
        self._out: list[list[int]] = [[] for _ in range(B)]
        self._finished = False
        if self._decoder == "beam":
            k, lm, a, bb = self._beam_args
            self._beamdec = BeamStreamDecoder(B, beam=k, lm=lm, alpha=a,
                                              beta=bb)
        else:
            self._beamdec = None

    @property
    def emitted(self) -> list[list[int]]:
        """All token ids emitted so far, per stream."""
        return [list(o) for o in self._out]

    # ------------------------------------------------------------- input --

    def accept(self, pcm, drain: bool = True) -> list[list[int]]:
        """Append PCM (``[n]`` or ``[batch, n]``, float in [-1, 1] or
        int16) to every stream and return the ids newly finalized by any
        chunks that became ready.

        Every sample fed here is treated as REAL audio for every stream —
        in lockstep serving, feed only common real audio and end the
        utterances with ``flush``. To batch-decode streams of different
        true lengths through the streaming path, buffer with
        ``drain=False`` and let ``flush(num_samples=[...])`` emit every
        window with per-stream validity."""
        if self._finished:
            raise RuntimeError("stream finished; call reset()")
        x = np.asarray(pcm)
        if x.ndim == 1:
            x = np.broadcast_to(x[None], (self.batch, x.shape[0]))
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = x.astype(np.float32, copy=False)
        if x.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} streams, got {x.shape}")
        self._buf = np.concatenate([self._buf, x], axis=1)
        self._n += x.shape[1]
        if not drain:
            return [[] for _ in range(self.batch)]
        return self._drain(finishing=False, total_frames=None)

    def flush(self, num_samples=None) -> list[list[int]]:
        """End the streams (optionally with per-stream true sample counts
        ≤ the fed length) and return the remaining ids."""
        if self._finished:
            return [[] for _ in range(self.batch)]
        if num_samples is None:
            ns = np.full((self.batch,), self._n, np.int64)
        else:
            ns = np.asarray(num_samples, np.int64)
            if ns.shape != (self.batch,) or np.any(ns > self._n):
                raise ValueError("num_samples must be [batch] and <= fed "
                                 f"samples ({self._n})")
        total = C.num_frames(ns)                       # frames per stream
        if np.any(total < self._t0):
            # eager draining (accept(drain=True)) already emitted tokens
            # from frames [0, _t0) of EVERY stream — a shorter declared
            # length would silently disown audio those tokens came from.
            # Unequal true lengths must buffer with drain=False.
            raise ValueError(
                f"num_samples declares fewer frames ({int(total.min())}) "
                f"than already emitted ({self._t0}); streams of different "
                "true lengths must buffer with accept(..., drain=False) "
                "before flush(num_samples=...)")
        self._finished = True
        out = self._drain(finishing=True, total_frames=total, lengths=ns)
        if self._beamdec is not None:
            # the drain finalized only the tokens every live beam agreed
            # on; at stream end the 1-best hypothesis wins outright (after
            # a final endpoint reset the finished rows' lists are empty,
            # so `best` only extends open utterances)
            for b, best in enumerate(self._beamdec.finish()):
                # _seg_start is 0 unless endpointing split the stream
                extra = best[len(self._out[b]) - self._seg_start[b]:]
                self._out[b].extend(extra)
                out[b].extend(extra)
        if self._ep_frames is not None:
            for b in range(self.batch):   # close the open segments
                seg = self._out[b][self._seg_start[b]:]
                if seg:
                    self.segments[b].append((seg, int(total[b])))
                    self._seg_start[b] = len(self._out[b])
        return out

    # ----------------------------------------------------------- windows --

    def _drain(self, *, finishing, total_frames, lengths=None):
        g = self.geo
        new: list[list[int]] = [[] for _ in range(self.batch)]
        while True:
            if self._first:
                W_lm, g0 = g["W_first"], 0
            else:
                W_lm, g0 = g["W_mid"], self._t0 - g["La"] - _D
            if finishing:
                if self._t0 >= int(total_frames.max()):
                    break
            else:
                # steady state needs every window frame fully real
                need = (g0 + W_lm - 1) * C.HOP_LENGTH + _PAD
                if self._n < need or (self._first and self._n < _PAD + 1):
                    break
            t_win = time.perf_counter()
            ext = self._assemble(g0, W_lm, lengths if finishing else None)
            if finishing:
                fv = np.clip(total_frames - g0, 0, W_lm)
            else:
                fv = np.full((self.batch,), W_lm, np.int64)
            ids, out, n = self._step(
                torch.from_numpy(ext[self._rows]).to(self.device),
                torch.from_numpy(fv[self._rows].astype(np.int64)).to(
                    self.device))
            if self._beamdec is not None:
                # tokens finalize when every live beam agrees on them
                for b, kept in enumerate(self._beamdec.step(out, n)):
                    self._out[b].extend(kept)
                    new[b].extend(kept)
                ids = ids.cpu().numpy()
            else:
                ids = ids.cpu().numpy()
                keep = out.cpu().numpy()
                for b in range(self.batch):
                    kept = ids[b][keep[b]].tolist()
                    self._out[b].extend(kept)
                    new[b].extend(kept)
            self._t0 += g["C"]
            self._first = False
            self.window_times.append(time.perf_counter() - t_win)
            if self._ep_frames is not None:
                self._endpoint_check(ids, n.cpu().numpy(), new)
            if not finishing:
                self._trim()
        return new

    def _endpoint_check(self, ids, n, new) -> None:
        """CTC endpointer: fire an utterance boundary for every stream
        whose argmax has been blank for >= endpoint_ms (threshold crossed
        at chunk granularity). ids [B, C_s] raw argmax, n [B] valid."""
        g = self.geo
        s = g["s"]
        fired, trail_at = [], {}
        for b in range(self.batch):
            row = ids[b, : n[b]]
            nz = np.nonzero(row != BLANK_ID)[0]
            if nz.size == 0:
                self._trail[b] += int(n[b])
            else:
                self._trail[b] = int(n[b]) - 1 - int(nz[-1])
            if self._trail[b] * s >= self._ep_frames:
                fired.append(b)
                trail_at[b] = int(self._trail[b])
                self._trail[b] = 0       # re-arms after more silence
        if not fired:
            return
        if self._beamdec is not None:
            # unfinalized 1-best tails land in the closing segments
            for b, tail in self._beamdec.end_rows(fired).items():
                self._out[b].extend(tail)
                new[b].extend(tail)
        rows = np.asarray(fired)
        for b in fired:
            seg = self._out[b][self._seg_start[b]:]
            if seg:                      # silence-only periods: reset only
                end = self._t0 - trail_at[b] * s      # ~last speech frame
                self.segments[b].append((seg, int(end)))
                self._seg_start[b] = len(self._out[b])
        # next utterance starts fresh: model stream state + greedy repeat
        # carry reset (causal-CMVN stats continue — same channel)
        idx = torch.from_numpy(rows).to(self.device)
        r = self._rows                   # the model's carries: local rows
        local = rows[(rows >= r.start) & (rows < r.stop)] - r.start
        if local.size:
            self._rnn = self.model.reset_stream_rows(
                self._rnn, torch.from_numpy(local).to(self.device))
        self._prev = self._prev.index_fill(0, idx, BLANK_ID)

    def _trim(self) -> None:
        """Bound host memory on long-form streams: PCM the next window
        can no longer reach is dropped from the front of the buffer
        (in >=16 s slabs so the copies amortize). Only the eager-drain
        path trims; buffered lockstep decoding (drain=False) holds the
        caller-supplied audio whole anyway."""
        g = self.geo
        nxt = (self._t0 - g["La"] - _D) * C.HOP_LENGTH - _PAD
        cut = min(nxt, self._n)
        if cut - self._base >= 262_144:
            self._buf = self._buf[:, cut - self._base :].copy()
            self._base = cut

    def _assemble(self, g0: int, W_lm: int, lengths) -> np.ndarray:
        """Host window assembly: PCM samples (with start/end reflection
        where the window overlaps a stream boundary) laid out so that
        ``frame_signal`` position p ↔ sample ``g0·HOP − 256 + p``."""
        B = self.batch
        SZ = (W_lm + _K + 1) * C.HOP_LENGTH
        start = g0 * C.HOP_LENGTH - _PAD
        ext = np.zeros((B, SZ), np.float32)
        base = self._base            # samples trimmed off _buf's front:
        for b in range(B):           # absolute position p lives at p−base
            L = int(lengths[b]) if lengths is not None else self._n
            buf = self._buf[b]
            # real samples [max(start,0), min(L, start+SZ))
            s0 = max(start, base)    # start ≥ base by trim monotonicity
            s1 = min(L, start + SZ)
            if s1 > s0:
                ext[b, s0 - start : s1 - start] = buf[s0 - base : s1 - base]
            if start < 0 and L >= 1:
                # start reflection: sample −k = buf[k], k = 1.._PAD — only
                # the first windows reach here, long before any trim
                # (base == 0: _trim's 16 s slab floor guarantees it)
                k = np.minimum(np.arange(1, -start + 1), max(L - 1, 0))
                ext[b, :-start] = buf[k][::-1]
            if lengths is not None and L < start + SZ and L - 1 >= base:
                # end reflection: sample L+k = buf[L−2−k], k = 0.._PAD−1
                k0 = max(L, start)                     # first refl sample
                kk = np.arange(k0, min(L + _PAD, start + SZ))
                src = np.clip(L - 2 - (kk - L), base, max(L - 1, base))
                ext[b, kk - start] = buf[src - base]
        return ext
