"""Weights between the flax layout and the port's ``state_dict``, and the
trainer's checkpoints.

Port of ``mpinets_tpu/model/checkpoint.py``. The flax variables arrive as
a nested dict of numpy arrays (``{"params": {...}}`` or the bare params
tree), so no JAX is needed:

* flax ``Dense`` ``kernel [in, out]`` -> ``Linear.weight [out, in]``;
* flax ``GroupNorm`` ``scale`` / ``bias`` -> ``weight`` / ``bias``;
* the path of module names becomes the dotted ``state_dict`` key, which
  :class:`mpinets_torch.model.policy.MotionPolicyNetwork` spells alike.

Arrays are converted to float32 (the committed checkpoint is bf16; the
upcast is exact). ``.npz`` files carry the flax tree flattened with "/"
keys, the format ``cli.serve`` reads.

Train checkpoints keep the JAX package's directory layout
(``checkpoint.py:136-196``): ``step_%08d/`` every wall-clock interval,
``last/`` and ``best/`` with a ``<name>.step`` marker beside them, each
written to a temporary directory and renamed. What a directory holds is the
port's own: ``state.pt``, written by ``torch.save`` with the model's
parameters, the optimizer state, the step and the EMA parameters.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

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


# ---------------------------------------------------------------------------
# Train checkpoints (the Lightning ModelCheckpoint equivalent,
# reference run_training.py:85-104)
# ---------------------------------------------------------------------------

_STATE_FILE = "state.pt"


def _write_state(path: Path, state) -> None:
    """``state`` (a :class:`mpinets_torch.train.learner.TrainState`) into
    the directory ``path``, by way of a temporary directory."""
    tmp = path.parent / f".{path.name}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save({
        "params": state.model.state_dict(),
        "opt_state": state.optimizer.state_dict(),
        "step": int(state.step),
        "ema_params": None if state.ema is None else state.ema.state_dict(),
    }, tmp / _STATE_FILE)
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)


def save_checkpoint(directory, step: int, state) -> None:
    """Save a train state under ``directory/step_%08d``."""
    _write_state(Path(directory).absolute() / f"step_{step:08d}", state)


def save_named_checkpoint(directory, name: str, step: int, state) -> None:
    """Overwrite ``directory/name`` (``last``, ``best``) with the state and
    record ``step`` in ``directory/name.step``."""
    base = Path(directory).absolute()
    _write_state(base / name, state)
    (base / f"{name}.step").write_text(str(step))


def named_checkpoint_step(directory, name: str) -> Optional[int]:
    marker = Path(directory).absolute() / f"{name}.step"
    return int(marker.read_text()) if marker.exists() else None


def latest_checkpoint(directory) -> Optional[Path]:
    """Newest resumable checkpoint: ``last`` if there is one, else the
    highest ``step_*``."""
    base = Path(directory).absolute()
    if (base / "last").exists():
        return base / "last"
    steps = sorted(base.glob("step_*"))
    return steps[-1] if steps else None


def checkpoint_step(path) -> int:
    """The training step a checkpoint directory holds."""
    path = Path(path)
    if path.name.startswith("step_"):
        return int(path.name[len("step_"):])
    marker = path.parent / f"{path.name}.step"
    return int(marker.read_text()) if marker.exists() else 0


def restore_checkpoint(path, state):
    """Load a checkpoint into ``state``'s model, optimizer and EMA (same
    architecture; tensors land on the model's device) and return the state
    at the saved step."""
    device = next(state.model.parameters()).device
    blob = torch.load(Path(path) / _STATE_FILE, map_location=device, weights_only=True)
    state.model.load_state_dict(blob["params"])
    state.optimizer.load_state_dict(blob["opt_state"])
    if (blob["ema_params"] is None) != (state.ema is None):
        raise ValueError("the checkpoint and the state disagree on EMA parameters")
    if state.ema is not None:
        state.ema.load_state_dict(blob["ema_params"])
    return state._replace(step=blob["step"])
