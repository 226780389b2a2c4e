"""The port needs no JAX and nothing of the JAX package: in a fresh
interpreter where ``jax``/``flax``/``optax`` and
``chainer_speech_recognition_tpu`` cannot be imported, every module of
chainer_speech_recognition_tpu_torch imports, the plain decode path runs
once end to end (a BiGRU and a cut conformer), the stream CLI streams a
forward-only model over a few windows, one CPU train step runs through
the train loop (alone, then as the one rank of a gloo group: the
data-parallel path of ``parallel/mesh.py``), the data tools and the evaluate CLI run once
(make_synthetic, preprocess --pack, evaluate on the packed dev set), and a
beam + LM decode runs (train_lm, decode --beam --lm)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile, os
for name in ("jax", "jaxlib", "flax", "optax",
             "chainer_speech_recognition_tpu"):
    sys.modules[name] = None          # any import of them raises ImportError

import numpy as np
import torch

import chainer_speech_recognition_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)

from chainer_speech_recognition_tpu_torch.bridge import state_dict_to_flax
from chainer_speech_recognition_tpu_torch.checkpoint import (
    latest_checkpoint, save_params)
from chainer_speech_recognition_tpu_torch.cli import decode
from chainer_speech_recognition_tpu_torch.config import preset_config
from chainer_speech_recognition_tpu_torch.data.corpus import (
    Utterance, save_index)
from chainer_speech_recognition_tpu_torch.data.synthetic import make_utterance
from chainer_speech_recognition_tpu_torch.models.presets import build_model
from chainer_speech_recognition_tpu_torch.train.loop import train
from chainer_speech_recognition_tpu_torch.utils.wav import write_wav
from chainer_speech_recognition_tpu_torch.vocab import Vocab

torch.set_num_threads(1)
cfg = preset_config("bigru").override({
    "model.conv_channels": [4, 4], "model.rnn_hidden": 32,
    "model.rnn_layers": 1, "model.vocab_size": 6})
rng = np.random.default_rng(0)
sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.3
      for k, v in build_model(cfg.model).state_dict().items()}
root = tempfile.mkdtemp()
save_params(os.path.join(root, "ckpt"), state_dict_to_flax(sd), cfg)
vocab = Vocab(["<blank>", "a", "b", "c", "d", "e"])
vocab.save(os.path.join(root, "v.txt"))
wav = os.path.join(root, "u.wav")
write_wav(wav, make_utterance(rng, [1, 3, 2])[0])
decode.main(["--ckpt-dir", os.path.join(root, "ckpt"), "--vocab",
             os.path.join(root, "v.txt"), "--device", "cpu", wav])

# a cut conformer (2 blocks, d = 64, h = 1) decodes with attn_impl=flash:
# the flash kernels' plain versions on the CPU
ccfg = preset_config("conformer").override({
    "model.conv_channels": [4, 4], "model.attn_blocks": 2,
    "model.attn_dim": 64, "model.attn_heads": 1, "model.vocab_size": 6,
    "model.attn_impl": "flash"})
csd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.3
       for k, v in build_model(ccfg.model).state_dict().items()}
save_params(os.path.join(root, "cckpt"), state_dict_to_flax(csd), ccfg)
cwav = os.path.join(root, "c.wav")
write_wav(cwav, make_utterance(rng, [2, 4])[0])
decode.main(["--ckpt-dir", os.path.join(root, "cckpt"), "--vocab",
             os.path.join(root, "v.txt"), "--device", "cpu", cwav])

# the forward-only online preset streams four windows through the CLI
from chainer_speech_recognition_tpu_torch.cli import stream
ucfg = preset_config("uni_gru").override({
    "model.conv_channels": [4, 4], "model.rnn_hidden": 32,
    "model.rnn_layers": 1, "model.vocab_size": 6})
usd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.3
       for k, v in build_model(ucfg.model).state_dict().items()}
save_params(os.path.join(root, "uckpt"), state_dict_to_flax(usd), ucfg)
swav = os.path.join(root, "s.wav")
write_wav(swav, make_utterance(rng, [1, 3, 2, 4, 5])[0])
stream.main(["--ckpt-dir", os.path.join(root, "uckpt"), "--vocab",
             os.path.join(root, "v.txt"), "--device", "cpu",
             "--chunk-frames", "16", "--right-frames", "0", swav])

# one train step (and its checkpoint) on the CPU
utts = [Utterance("u", wav, "acb", 4800)]
tcfg = cfg.override({"buckets.boundaries": [64], "buckets.batch_sizes": [1],
                     "buckets.max_label_len": 8, "train.total_steps": 1,
                     "train.log_every": 1,
                     "train.data_mode": "stream", "train.loader_workers": 1,
                     "train.checkpoint_dir": os.path.join(root, "tckpt")})
state = train(tcfg, utts, vocab, device="cpu")
assert state.step == 1, state.step
assert latest_checkpoint(os.path.join(root, "tckpt")).endswith(
    "step_00000001.msgpack")
# the same step as the one rank of a gloo group: the data-parallel path
# (parallel/mesh.py, the all-reduce in the step, the writer rank)
import torch.distributed as dist
from chainer_speech_recognition_tpu_torch.parallel.mesh import make_mesh
dist.init_process_group("gloo", world_size=1, rank=0, init_method="file://"
                        + os.path.join(root, "store"))
assert make_mesh(tcfg.parallel, "cpu").distributed
state = train(tcfg.override({"train.checkpoint_dir": os.path.join(
    root, "dckpt")}), utts, vocab, device="cpu")
dist.destroy_process_group()
assert state.step == 1 and latest_checkpoint(os.path.join(root, "dckpt"))
# the parity path's tools: a confusable corpus, packed, scored on its pack
from chainer_speech_recognition_tpu_torch.cli import (
    evaluate, make_synthetic, preprocess)
corpus, prep = os.path.join(root, "corpus"), os.path.join(root, "prep")
make_synthetic.main(["--out", corpus, "--style", "confusable", "--utts",
                     "4", "--vocab", "6", "--min-labels", "2",
                     "--max-labels", "4", "--min-seconds", "0.4",
                     "--max-seconds", "0.6", "--seed", "1"])
preprocess.main(["--corpus", corpus, "--out", prep, "--dev-fraction", "0.5",
                 "--pack"])
ecfg = cfg.override({"model.vocab_size": len(Vocab.load(
    os.path.join(prep, "vocab.txt")))})
esd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.3
       for k, v in build_model(ecfg.model).state_dict().items()}
save_params(os.path.join(root, "eckpt"), state_dict_to_flax(esd), ecfg)
evaluate.main(["--ckpt-dir", os.path.join(root, "eckpt"), "--data-dir", prep,
               "--device", "cpu", "--index", "dev.pack", "--set",
               "buckets.boundaries=[128]", "buckets.batch_sizes=[2]"])
# config 4: an LM trained on the prep dir, then a beam + LM decode
from chainer_speech_recognition_tpu_torch.cli import train_lm
train_lm.main(["--data-dir", prep, "--order", "2"])
decode.main(["--ckpt-dir", os.path.join(root, "ckpt"), "--vocab",
             os.path.join(root, "v.txt"), "--device", "cpu", "--beam", "4",
             "--nbest", "2", wav])
evaluate.main(["--ckpt-dir", os.path.join(root, "eckpt"), "--data-dir", prep,
               "--device", "cpu", "--index", "dev.pack", "--set",
               "buckets.boundaries=[128]", "buckets.batch_sizes=[2]",
               "--compare", "--beam", "4", "--lm",
               os.path.join(prep, "lm_2gram.arpa")])
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in (
              "jax", "jaxlib", "flax", "optax",
              "chainer_speech_recognition_tpu")]
assert not loaded, loaded
print("MODULES", len(mods))
"""


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1].startswith("MODULES ") and int(lines[-1].split()[1]) >= 30
    assert any(l.split("\t")[0].endswith("u.wav") for l in lines)  # decode
    assert any(l.split("\t")[0].endswith("c.wav") for l in lines)  # conformer
    assert any(l.split("\t")[0].endswith("s.wav") for l in lines)  # stream
    assert any(l.startswith("step       1 |") for l in lines)       # train
    assert any(l.startswith("packed 2 utterances") for l in lines)  # pack
    assert any(l.startswith("CER ") and "| 2 utts |" in l
               for l in lines)                                      # evaluate
    assert any(l.startswith("trained 2-gram LM") for l in lines)    # train_lm
    assert any(l.split("\t")[0].endswith("u.wav") and l.split("\t")[1] == "2"
               for l in lines)                                      # n-best
    assert any(l.startswith("CER[beam4+lm] ") for l in lines)       # compare
