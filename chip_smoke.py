"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's serving path (``chainer_speech_recognition_tpu_torch``)
at the full width of the ``bigru`` preset with random weights made from a
seed, and fails (exit code != 0, no result line) if any phase fails:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel in ``csrc/`` from the checkout (nvcc);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the decode path gives it (32 wavs of 10 s), with the stated
   tolerances, and both timed with CUDA events (warm, median);
4. inputs: a ``bigru`` checkpoint (config.json + msgpack params written by
   the port's own writer), a 63-symbol vocab and 64 synthetic wavs of
   8-10 s;
5. decode: the port's decode CLI on the 64 wavs (two chunks of 32) on the
   card; every kernel must show launches from that run; a second, warm run
   gives utterances per second and the real-time factor;
6. CPU parity: 4 of the wavs through the same checkpoint on the CPU (the
   kernels' plain versions): finite logits of the same shape within the
   bf16 bar of the card's.

The last two lines of stdout are the kernel table and the device line as
JSON. Only JAX-free host modules of the reference package are imported
(config, vocab, wav I/O, synthetic audio); the run checks at the end that
no ``jax``/``flax`` module was loaded.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PRESET = "bigru"
SEED = 0
N_WAVS, BATCH = 64, 32
WAV_SECONDS = (8.0, 10.0)
CHECK_B, CHECK_SECONDS = 32, 10.0     # kernel-check shapes: one full chunk
PARITY_WAVS = 4
TOL = {"frontend_logmel": 5e-4,       # tests/test_pallas_frontend.py:34
       "gru_bf16": 3e-2,              # tests/test_rnn_pallas.py:81
       "gru_fp32": 1e-4,
       "greedy": 0}                   # exact
MIN_LAUNCHES = {"frontend_logmel": 2, "gru_fwd": 6, "greedy": 2}
SOURCES = {
    "frontend_logmel": (
        "chainer_speech_recognition_tpu_torch/csrc/frontend_logmel.cu",
        "chainer_speech_recognition_tpu/frontend/pallas_frontend.py:116"),
    "gru_fwd": (
        "chainer_speech_recognition_tpu_torch/csrc/gru_fwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:79"),
    "greedy": (
        "chainer_speech_recognition_tpu_torch/csrc/greedy.cu",
        "chainer_speech_recognition_tpu/decode/greedy_pallas.py:26"),
}


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def time_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, warm)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def synth_signal(rng, seconds: float, vocab_size: int) -> np.ndarray:
    from chainer_speech_recognition_tpu.data.synthetic import make_utterance

    n = int(round(seconds * 10))            # 1600-sample tones: 10 per s
    ids = [int(k) for k in rng.integers(1, vocab_size, n)]
    return make_utterance(rng, ids, tone_len=1600, vocab_size=vocab_size)[0]


def random_state_dict(model, rng) -> dict:
    """Fan-in-scaled normal weights (biases 0.1·normal) for every tensor
    of the port's state_dict, from the numpy seed."""
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(".bias"):
            sd[k] = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = shape[-2] if k.endswith(".rec") else int(
                np.prod(shape[1:]))
            sd[k] = rng.standard_normal(shape) / np.sqrt(fan_in)
        sd[k] = sd[k].astype(np.float32)
    return sd


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    import torch

    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {name}")
    return name, smi


def phase_build() -> None:
    from chainer_speech_recognition_tpu_torch import _kernels

    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    info = _kernels.build_info
    print(f"[build] {os.path.basename(so)} in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s, "
          f"cached={info['cached']})")
    for line in info.get("log", "").splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_kernels(dev, rng) -> dict:
    """Each kernel vs its plain version at the decode path's shapes."""
    import torch

    from chainer_speech_recognition_tpu import constants as C
    from chainer_speech_recognition_tpu.config import preset_config
    from chainer_speech_recognition_tpu_torch.decode.greedy import (
        best_keep_cuda, best_keep_plain)
    from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
        fused_logmel_rows_cuda)
    from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
        _K, extend_signal, logmel_from_extended)
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        gru_scan_cuda, gru_scan_plain)

    mcfg = preset_config(PRESET).model
    out = {}

    # front-end: one full chunk of 10 s wavs (the last one 8 s: ragged)
    n = int(CHECK_SECONDS * C.SAMPLE_RATE)
    sigs = np.zeros((CHECK_B, n), np.float32)
    lens = np.full(CHECK_B, n, np.int32)
    lens[-1] = int(WAV_SECONDS[0] * C.SAMPLE_RATE)
    for i in range(CHECK_B):
        s = synth_signal(rng, lens[i] / C.SAMPLE_RATE, mcfg.vocab_size)
        sigs[i, : len(s)] = s
        lens[i] = len(s)
    T = C.num_frames(n)
    ext = extend_signal(torch.from_numpy(sigs).to(dev),
                        torch.from_numpy(lens).to(dev), T + _K + 1)
    got = fused_logmel_rows_cuda(ext, T)
    want = logmel_from_extended(ext, T)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[kernels] frontend_logmel ext {tuple(ext.shape)} -> "
          f"{tuple(got.shape)}: max abs {err:.3e} (tol {TOL['frontend_logmel']})")
    check(bool(torch.isfinite(got).all()), "frontend_logmel: non-finite")
    check(err <= TOL["frontend_logmel"], "frontend_logmel disagrees")
    out["frontend_logmel"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fused_logmel_rows_cuda(ext, T)),
        plain_ms=time_ms(lambda: logmel_from_extended(ext, T)))

    # GRU: [T', 2B, 3H] at the subsampled length of 10 s
    Tp = T
    for s in mcfg.conv_stride_time:
        Tp = -(-Tp // s)
    H, B = mcfg.rnn_hidden, CHECK_B
    flen = torch.from_numpy(lens // C.HOP_LENGTH + 1)
    for s in mcfg.conv_stride_time:
        flen = conv_out_length(flen, s)
    lens_f = flen.to(torch.float32)
    lo = torch.cat([torch.zeros(B), Tp - lens_f])[:, None].to(dev)
    hi = torch.cat([lens_f, torch.full((B,), float(Tp))])[:, None].to(dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 3 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs32 = torch.from_numpy(rng.standard_normal(
        (Tp, 2 * B, 3 * H)).astype(np.float32)).to(dev)
    for tag, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xs = xs32.to(torch.bfloat16) if tag == "bf16" else xs32
        got = gru_scan_cuda(xs, w, lo, hi, cdt)
        want = gru_scan_plain(xs, w, lo, hi, cdt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL[f"gru_{tag}"]
        print(f"[kernels] gru_fwd {tag} xs {tuple(xs.shape)}: max abs "
              f"{err:.3e} (tol {tol})")
        check(bool(torch.isfinite(got).all()), f"gru_fwd {tag}: non-finite")
        check(err <= tol, f"gru_fwd {tag} disagrees")
        timing = dict(
            max_abs_err=err,
            ms=time_ms(lambda: gru_scan_cuda(xs, w, lo, hi, cdt)),
            plain_ms=time_ms(lambda: gru_scan_plain(xs, w, lo, hi, cdt),
                             warmup=1, reps=3))
        print(f"[kernels] gru_fwd {tag}: {timing['ms']:.3f} ms, plain "
              f"{timing['plain_ms']:.3f} ms")
        if cdt == torch.bfloat16:       # the preset's compute dtype
            out["gru_fwd"] = timing

    # greedy: random logits + planted ties, NaN frames, lengths 0, 1, T'
    V = mcfg.vocab_size
    logits = rng.standard_normal((B, Tp, V)).astype(np.float32)
    logits[0, 3, [5, 9]] = 7.0              # tie → first index
    logits[0, 4, [9, 5]] = 7.0              # same tie: a repeat
    logits[1, 2, 7] = np.nan                # one NaN in a frame → blank
    logits[1, 2, 3] = 50.0
    logits[1, 5, :] = np.nan                # all-NaN frame → blank
    logits[2, 6, :] = 1.0                   # all-equal frame → index 0
    glens = flen.clone().to(torch.int32)
    glens[3], glens[4], glens[5] = 0, 1, Tp
    lg = torch.from_numpy(logits).to(dev)
    gl = glens.to(dev)
    kb, kk = best_keep_cuda(lg, gl)
    pb, pk = best_keep_plain(lg, gl)
    torch.cuda.synchronize()
    mism = int((kb != pb).sum() + (kk != pk).sum())
    print(f"[kernels] greedy logits {tuple(lg.shape)}: {mism} mismatches "
          f"(exact), best[1,2]={int(kb[1, 2])} best[1,5]={int(kb[1, 5])}")
    check(mism == 0, "greedy disagrees with its plain version")
    check(int(kb[1, 2]) == 0 and int(kb[1, 5]) == 0 and int(kb[0, 3]) == 5,
          "greedy: NaN/tie rule broken")
    out["greedy"] = dict(max_abs_err=float(mism),
                         ms=time_ms(lambda: best_keep_cuda(lg, gl)),
                         plain_ms=time_ms(lambda: best_keep_plain(lg, gl)))
    for name, t in out.items():
        print(f"[kernels] {name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}"
              f" ms, max abs {t['max_abs_err']:.3e}")
    return out


def phase_inputs(root: str, rng) -> tuple[str, str, list[str], float]:
    from chainer_speech_recognition_tpu import constants as C
    from chainer_speech_recognition_tpu.config import preset_config
    from chainer_speech_recognition_tpu.utils.wav import write_wav
    from chainer_speech_recognition_tpu.vocab import Vocab
    from chainer_speech_recognition_tpu_torch.bridge import state_dict_to_flax
    from chainer_speech_recognition_tpu_torch.checkpoint import save_params
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)

    cfg = preset_config(PRESET)
    V = cfg.model.vocab_size
    model = build_model(cfg.model)
    ckpt = os.path.join(root, "ckpt")
    path = save_params(ckpt, state_dict_to_flax(
        random_state_dict(model, rng)), cfg)
    vocab = os.path.join(root, "vocab.txt")
    Vocab(["<blank>"] + [chr(0x3042 + i) for i in range(V - 1)]).save(vocab)
    wavs, total = [], 0.0
    for i in range(N_WAVS):
        sig = synth_signal(rng, rng.uniform(*WAV_SECONDS), V)
        wavs.append(os.path.join(root, f"utt{i:03d}.wav"))
        write_wav(wavs[-1], sig)
        total += len(sig) / C.SAMPLE_RATE
    print(f"[inputs] {PRESET} checkpoint {os.path.basename(path)} "
          f"({sum(p.numel() for p in model.parameters())} params), "
          f"{V - 1}-symbol vocab, {N_WAVS} wavs, {total:.3f} s of audio")
    return ckpt, vocab, wavs, total


def run_decode(args: list[str]) -> tuple[list[str], float]:
    import torch

    from chainer_speech_recognition_tpu_torch.cli import decode

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        decode.main(args)
    torch.cuda.synchronize()
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def phase_decode(ckpt, vocab, wavs, audio_s) -> dict:
    from chainer_speech_recognition_tpu_torch import _kernels

    args = ["--ckpt-dir", ckpt, "--vocab", vocab, "--batch", str(BATCH),
            "--device", "cuda", *wavs]
    _kernels.reset_launches()
    lines, cold = run_decode(args)
    launches = _kernels.launches()
    print(f"[decode] cold run {cold:.3f} s, launches {launches}")
    check(len(lines) == len(wavs), f"decode printed {len(lines)} lines")
    check([l.split("\t")[0] for l in lines] == wavs,
          "decode output is not in input order")
    check(all(len(l.split("\t")) == 2 for l in lines), "malformed lines")
    for name, need in MIN_LAUNCHES.items():
        check(launches[name] >= need, f"{name}: {launches[name]} launches on "
              f"the decode path, expected >= {need}")
    for l in lines[:2]:
        print(f"[decode] {os.path.basename(l.split(chr(9))[0])}: "
              f"{l.split(chr(9))[1][:40]!r}")
    lines2, warm = run_decode(args)
    check(lines2 == lines, "warm decode differs from the cold one")
    print(f"[decode] warm run {warm:.3f} s: {len(wavs) / warm:.3f} utt/s, "
          f"RTF {warm / audio_s:.6f} ({audio_s:.3f} s of audio)")
    return launches


def phase_parity(ckpt, wavs, dev) -> float:
    import torch

    from chainer_speech_recognition_tpu.utils.wav import read_wav
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model
    from chainer_speech_recognition_tpu_torch.frontend import select_frontend

    sigs = [read_wav(w) for w in wavs[:PARITY_WAVS]]
    n = max(len(s) for s in sigs)
    x = np.zeros((len(sigs), n), np.float32)
    for i, s in enumerate(sigs):
        x[i, : len(s)] = s
    lens = np.asarray([len(s) for s in sigs], np.int32)
    res = []
    for d in (dev, torch.device("cpu")):
        cfg, model, _ = load_model(ckpt, device=d)
        with torch.inference_mode():
            feats, fl = select_frontend(cfg.features)(
                torch.from_numpy(x).to(d), torch.from_numpy(lens).to(d),
                apply_cmvn=cfg.features.cmvn_arg)
            logits, ol = model(feats, fl)
        res.append((logits.float().cpu(), ol.cpu()))
    (lc, oc), (lp, op) = res
    check(lc.shape == lp.shape and torch.equal(oc, op), "parity: shapes")
    check(bool(torch.isfinite(lc).all()), "parity: non-finite card logits")
    err = float((lc - lp).abs().max())
    print(f"[parity] logits {tuple(lc.shape)} card vs CPU: max abs "
          f"{err:.3e} (tol {TOL['gru_bf16']}), |logits| max "
          f"{float(lp.abs().max()):.3f}")
    check(err <= TOL["gru_bf16"], "card and CPU logits disagree")
    return err


def main() -> int:
    try:
        import torch

        kind, _ = phase_device()
        dev = torch.device("cuda", 0)
        phase_build()
        rng = np.random.default_rng(SEED)
        timings = phase_kernels(dev, rng)
        with tempfile.TemporaryDirectory() as root:
            ckpt, vocab, wavs, audio_s = phase_inputs(root, rng)
            launches = phase_decode(ckpt, vocab, wavs, audio_s)
            phase_parity(ckpt, wavs, dev)
        loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "flax"))
        check(not loaded, f"JAX modules were imported: {loaded[:5]}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1], launches=launches[name],
                    **timings[name]) for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
