"""Checkpoints without JAX (port of ``train/checkpoint.py`` and of
``cli/evaluate.py::load_model_and_params``'s read side).

A checkpoint directory holds ``step_XXXXXXXX.msgpack`` files in the layout
of ``flax.serialization.to_bytes(TrainState)`` and the frozen
``config.json``. The msgpack reader and writer here use only the stdlib and
numpy (the machine that trains may have neither ``msgpack`` nor ``flax``)
and handle the subset flax emits: maps, arrays, str, bin, int, float, nil,
bool, and the extension types 1 (ndarray = msgpack ``(shape, dtype name,
C-order bytes)``) and 3 (numpy scalar, the same payload). Anything else
raises. (flax splits leaves over 1 GiB into chunk dicts; no model here has
one.)

``save_checkpoint`` writes the whole train state — ``params`` as the flax
tree, ``opt_state`` as ``to_state_dict`` of optax's state, ``step`` and
``rng`` — so the reference's ``restore_checkpoint`` (and its evaluate and
decode CLIs) load a port checkpoint, and ``restore_checkpoint`` resumes
the port from either package's checkpoints. Writes are write-to-temp +
rename; the last ``keep`` checkpoints are kept. In a data-parallel run
(``parallel/mesh.py``) rank 0 alone writes, the other ranks wait for it
at a barrier, and every rank reads on resume.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from .bridge import (load_flax_params, opt_state_from_flax, opt_state_to_flax,
                     state_dict_to_flax)
from .config import Config
from .parallel.mesh import barrier
from .train.state import copy_into

_CKPT_RE = re.compile(r"^step_(\d{8,})\.msgpack$")
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------

def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, data = _Reader(payload).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":      # numpy has no bf16: widen bit-exactly
        bits = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, np.dtype(name)).reshape(shape).copy()


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read_all(self):
        obj = self.read()
        if self.pos != len(self.buf):
            raise ValueError("msgpack: trailing bytes")
        return obj

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}               # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        num = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in num:
            return self.unpack(num[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: unsupported extension type {code}")


def msgpack_restore(data: bytes):
    """msgpack bytes (flax subset) → nested dicts / lists of numpy leaves."""
    return _Reader(data).read_all()


def _pack_header(out: bytearray, n: int, fix: int | None, fix_max: int,
                 codes: tuple[int, int, int]) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0]:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    kinds = ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
             (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64),
             (0xD0, ">b", -(1 << 7), 1 << 7), (0xD1, ">h", -(1 << 15), 1 << 15),
             (0xD2, ">i", -(1 << 31), 1 << 31),
             (0xD3, ">q", -(1 << 63), 1 << 63))
    for code, fmt, lo, hi in kinds:
        if lo <= v < hi:
            out += struct.pack(">B", code) + struct.pack(fmt, v)
            return
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _pack_header(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError(f"msgpack: cannot pack dtype {arr.dtype}")
        payload = bytearray()
        _pack(payload, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        _pack_ext(out, code, bytes(payload))
    else:
        raise ValueError(f"msgpack: cannot pack {type(obj).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Nested dicts / lists of numpy leaves → msgpack bytes that
    ``flax.serialization.msgpack_restore`` reads back."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ---------------------------------------------------------------------------
# checkpoint directories
# ---------------------------------------------------------------------------

def list_checkpoints(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((f for f in os.listdir(ckpt_dir) if _CKPT_RE.match(f)),
                  key=lambda f: int(_CKPT_RE.match(f).group(1)))


def latest_checkpoint(ckpt_dir: str) -> str | None:
    ckpts = list_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def load_config(ckpt_dir: str) -> Config:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return Config.from_json(f.read())


def read_params(path: str) -> dict:
    """The flax parameter tree (``TrainState.params['params']``) of one
    checkpoint file, as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    try:
        return state["params"]["params"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"{path}: no params/params tree in the "
                         "checkpoint") from e


def _average(trees: list):
    """Leafwise fp32 mean, cast back to the last tree's leaf dtype (as
    ``load_model_and_params`` averages)."""
    last = trees[-1]
    if isinstance(last, dict):
        return {k: _average([t[k] for t in trees]) for k in last}
    acc = trees[0].astype(np.float32)
    for t in trees[1:]:
        acc = acc + t.astype(np.float32)
    return (acc * np.float32(1.0 / len(trees))).astype(last.dtype)


def load_params(ckpt_dir: str, average_last: int = 1) -> tuple[dict, str]:
    """(flax param tree, description) of the latest checkpoint, or the
    leafwise average of the last ``average_last`` ones."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")
    if average_last <= 1:
        return read_params(path), path
    names = list_checkpoints(ckpt_dir)[-average_last:]
    if len(names) < average_last:
        raise SystemExit(
            f"--average-last {average_last}: only {len(names)} "
            f"checkpoints in {ckpt_dir} (raise train.keep_checkpoints)")
    trees = [read_params(os.path.join(ckpt_dir, n)) for n in names]
    return _average(trees), f"avg[{','.join(names)}]"


def _write_atomic(path: str, data: bytes) -> None:
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def save_params(ckpt_dir: str, params: dict, config: Config,
                step: int = 0) -> str:
    """Write ``{"params": {"params": params}, "step": step}`` as
    ``step_XXXXXXXX.msgpack`` plus ``config.json`` (both atomically): a
    serving checkpoint the port reads, made without JAX. It holds no
    optimizer state, so the reference can decode from it only through
    this module, not resume training."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.msgpack")
    _write_atomic(path, msgpack_serialize(
        {"params": {"params": params}, "step": np.asarray(step, np.int32)}))
    _write_atomic(os.path.join(ckpt_dir, "config.json"),
                  config.to_json().encode())
    return path


def save_checkpoint(ckpt_dir: str, state, config: Config,
                    keep: int = 3, mesh=None) -> str:
    """Write ``state`` (``train/state.TrainState``) as
    ``step_XXXXXXXX.msgpack``, rewrite ``config.json``, and delete all but
    the newest ``keep`` checkpoints. Over a ``mesh`` (the state is
    replicated) rank 0 writes and every rank returns after the write."""
    if keep < 1:
        raise ValueError(f"keep={keep}: must retain at least the checkpoint "
                         "just written")
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.msgpack")
    if mesh is not None and mesh.distributed:
        if mesh.is_writer:
            _write_state(ckpt_dir, path, state, config, keep)
        barrier(mesh)
        return path
    _write_state(ckpt_dir, path, state, config, keep)
    return path


def _write_state(ckpt_dir: str, path: str, state, config: Config,
                 keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = {"params": {"params": state_dict_to_flax(state.model.state_dict())},
            "opt_state": opt_state_to_flax(state.opt_state),
            "step": np.asarray(state.step, np.int32),
            "rng": np.asarray(state.rng, np.uint32)}
    _write_atomic(path, msgpack_serialize(tree))
    _write_atomic(os.path.join(ckpt_dir, "config.json"),
                  config.to_json().encode())
    for old in list_checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))


def restore_checkpoint(path: str, state) -> None:
    """Load a full checkpoint (written by either package) into ``state`` in
    place: parameters and optimizer state (strict against the state's own
    layout) into their tensors, step and rng."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if "opt_state" not in tree:
        raise ValueError(f"{path}: no optimizer state (a params-only "
                         "serving checkpoint cannot resume training)")
    load_flax_params(state.model, tree["params"]["params"])
    # into the state's own tensors: a captured train step reads them
    copy_into(state.opt_state,
               opt_state_from_flax(tree["opt_state"], state.opt_state))
    state.step = int(tree["step"])
    state.rng = np.asarray(tree["rng"], np.uint32)
