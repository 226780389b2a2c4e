"""Map the reference's flax parameter tree onto the port's state_dict and
back.

* Dense kernel ``[in, out]`` ↔ Linear weight ``[out, in]``;
* NHWC Conv kernel ``[kt, kf, in, out]`` ↔ Conv2d weight ``[out, in, kt, kf]``;
* BiRNN ``rec [ndir, H, G·H]`` is kept as it is (the kernel's layout);
* module names are the same except ``ConvSubsampler_0`` ↔ ``subsampler``.

Unknown, missing or mis-shaped keys raise: a silently skipped tensor would
serve garbage.
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"ConvSubsampler_0": "subsampler"}
_RENAME_BACK = {v: k for k, v in _RENAME.items()}


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``params`` tree (nested dicts of arrays, without the outer
    ``{"params": ...}``) → the port's state_dict (fp32 CPU tensors)."""
    sd = {}
    for path, arr in _flatten(params).items():
        *mods, leaf = path
        mods = [_RENAME.get(m, m) for m in mods]
        if leaf == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf in ("bias", "rec"):
            name = leaf
        else:
            raise KeyError(f"bridge: unknown flax parameter {'/'.join(path)} "
                           f"{arr.shape}")
        sd[".".join(mods + [name])] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    """Inverse of ``flax_to_state_dict``: port state_dict → flax tree of
    fp32 numpy arrays."""
    tree: dict = {}
    for key, t in sd.items():
        arr = t.detach().cpu().to(torch.float32).numpy() \
            if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
        *mods, name = key.split(".")
        mods = [_RENAME_BACK.get(m, m) for m in mods]
        if name == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif name == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif name in ("bias", "rec"):
            leaf = name
        else:
            raise KeyError(f"bridge: unknown state_dict entry {key} "
                           f"{tuple(arr.shape)}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def load_flax_params(model: torch.nn.Module, params: dict) -> None:
    """Load a flax ``params`` tree into ``model`` (strict: every key and
    shape must match)."""
    sd = flax_to_state_dict(params)
    want = model.state_dict()
    unknown = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if unknown or missing:
        raise KeyError(f"bridge: checkpoint/model mismatch; unknown "
                       f"{unknown}, missing {missing}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"bridge: {k} has shape {tuple(v.shape)} in the "
                             f"checkpoint, {tuple(want[k].shape)} in the model")
    model.load_state_dict(sd, strict=True)
