"""The port needs no JAX: in a fresh interpreter where ``jax``/``flax``
cannot be imported, every module of chainer_speech_recognition_tpu_torch
imports and the plain decode path runs once end to end."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile, os
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None          # any import of them raises ImportError

import numpy as np
import torch

import chainer_speech_recognition_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)

from chainer_speech_recognition_tpu.config import preset_config
from chainer_speech_recognition_tpu.data.synthetic import make_utterance
from chainer_speech_recognition_tpu.utils.wav import write_wav
from chainer_speech_recognition_tpu.vocab import Vocab
from chainer_speech_recognition_tpu_torch.bridge import state_dict_to_flax
from chainer_speech_recognition_tpu_torch.checkpoint import save_params
from chainer_speech_recognition_tpu_torch.cli import decode
from chainer_speech_recognition_tpu_torch.models.presets import build_model

cfg = preset_config("bigru").override({
    "model.conv_channels": [4, 4], "model.rnn_hidden": 32,
    "model.rnn_layers": 1, "model.vocab_size": 6})
rng = np.random.default_rng(0)
sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.3
      for k, v in build_model(cfg.model).state_dict().items()}
root = tempfile.mkdtemp()
save_params(os.path.join(root, "ckpt"), state_dict_to_flax(sd), cfg)
Vocab(["<blank>", "a", "b", "c", "d", "e"]).save(os.path.join(root, "v.txt"))
wav = os.path.join(root, "u.wav")
write_wav(wav, make_utterance(rng, [1, 3, 2])[0])
decode.main(["--ckpt-dir", os.path.join(root, "ckpt"), "--vocab",
             os.path.join(root, "v.txt"), "--device", "cpu", wav])
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in ("jax", "jaxlib", "flax")]
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
    assert lines[-1].startswith("MODULES ") and int(lines[-1].split()[1]) >= 14
    assert lines[-2].split("\t")[0].endswith("u.wav")      # decode output
