"""Weights between the flax layout and the port's ``state_dict``.

Port of the flax side of ``mpinets_tpu/model/checkpoint.py``. The flax
variables arrive as a nested dict of numpy arrays (``{"params": {...}}``
or the bare params tree), so no JAX is needed:

* flax ``Dense`` ``kernel [in, out]`` -> ``Linear.weight [out, in]``;
* flax ``GroupNorm`` ``scale`` / ``bias`` -> ``weight`` / ``bias``;
* the path of module names becomes the dotted ``state_dict`` key, which
  :class:`mpinets_torch.model.policy.MotionPolicyNetwork` spells alike.

Arrays are converted to float32 (the committed checkpoint is bf16; the
upcast is exact). ``.npz`` files carry the flax tree flattened with "/"
keys, the format ``cli.serve`` reads.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def params_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables (numpy leaves) -> ``MotionPolicyNetwork`` state_dict."""
    params = variables.get("params", variables)
    state = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf).astype(np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        key = ".".join(path[:-1] + (_LEAF_TO_TORCH[path[-1]],))
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def flax_from_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: -> ``{"params": {...}}`` numpy."""
    params: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        arr = tensor.detach().cpu().float().numpy()
        if leaf == "weight":
            is_dense = arr.ndim == 2
            leaf = "kernel" if is_dense else "scale"
            if is_dense:
                arr = arr.T
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": params}


def save_flax_npz(path, variables: Mapping[str, Any]) -> None:
    """Write a flax variables tree (numpy leaves) as one ``.npz``."""
    flat = {"/".join(p): np.asarray(v).astype(np.float32)
            for p, v in _flatten(variables.get("params", variables))}
    np.savez(path, **flat)


def load_flax_npz(path) -> Dict[str, Any]:
    """Read :func:`save_flax_npz`'s file back into ``{"params": {...}}``."""
    params: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = params
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return {"params": params}
