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
keys, the format ``cli.serve`` reads; bf16 leaves are kept there as their
``uint16`` bits, half the bytes of f32.

The reference's published PyTorch-Lightning checkpoint
(``mpinets_hybrid_expert.ckpt``, its ``MotionPolicyNetwork`` of
``mpinets/model.py:35-91,355-426``) arrives through
:func:`convert_torch_state_dict` (the JAX package's importer,
``checkpoint.py:36-133``), which maps its ``state_dict`` onto the same
flax-layout numpy tree, so :func:`params_from_flax` loads it:

* ``nn.Linear`` ``weight [out, in]`` -> ``kernel [in, out]``;
* pointnet2_ops ``SharedMLP`` 1x1 ``Conv2d`` ``weight [out, in, 1, 1]`` ->
  ``kernel [in, out]`` (the conv is pointwise, so it is a dense layer);
* ``nn.GroupNorm`` ``weight`` / ``bias`` -> ``scale`` / ``bias``.

Its keys: ``point_cloud_encoder.SA_modules.{0,1,2}.mlps.0.layer{j}.conv.
weight|bias`` (spellings vary across pointnet2_ops versions, so the convs
are matched per SA module by regex and sorted by layer index),
``point_cloud_encoder.fc_layer.{0,3,6}`` (Linear) and ``.{1,4}``
(GroupNorm), ``feature_encoder.{0,2,4,6,8}``, ``decoder.{0,2,4,6}``.

Train checkpoints keep the JAX package's directory layout
(``checkpoint.py:136-196``): ``step_%08d/`` every wall-clock interval,
``last/`` and ``best/`` with a ``<name>.step`` marker beside them, each
written to a temporary directory and renamed. What a directory holds is the
port's own: ``state.pt``, written by ``torch.save`` with the model's
parameters, the optimizer state, the step and the EMA parameters.
"""

from __future__ import annotations

import re
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


def _npz_leaf(v) -> np.ndarray:
    """bfloat16 as its ``uint16`` bits (numpy has no bf16 of its own);
    anything else as float32."""
    arr = np.asarray(v)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr.astype(np.float32)


def save_flax_npz(path, variables: Mapping[str, Any]) -> None:
    """Write a flax variables tree (numpy leaves) as one ``.npz``: as
    float32, or a bfloat16 tree as its bits, compressed."""
    flat = {"/".join(p): _npz_leaf(v) for p, v in _flatten(variables.get("params", variables))}
    bits = any(v.dtype == np.uint16 for v in flat.values())
    (np.savez_compressed if bits else np.savez)(path, **flat)


def load_flax_npz(path) -> Dict[str, Any]:
    """Read :func:`save_flax_npz`'s file back into ``{"params": {...}}``
    (``uint16`` leaves, bf16 bits, widened to float32 exactly)."""
    params: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = params
            for name in parents:
                node = node.setdefault(name, {})
            arr = data[key]
            if arr.dtype == np.uint16:
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            node[leaf] = arr
    return {"params": params}


# ---------------------------------------------------------------------------
# The reference's PyTorch-Lightning checkpoints
# ---------------------------------------------------------------------------

def _strip_prefix(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Drop Lightning wrappers: keep keys from the first occurrence of a
    known top-level module name onward; convert tensors to numpy."""
    tops = ("point_cloud_encoder.", "feature_encoder.", "decoder.")
    out = {}
    for key, value in state_dict.items():
        for top in tops:
            pos = key.find(top)
            if pos >= 0:
                out[key[pos:]] = np.asarray(
                    value.detach().cpu().numpy() if hasattr(value, "detach") else value)
                break
    return out


def _dense_leaf(weight: np.ndarray, bias: np.ndarray) -> Dict[str, np.ndarray]:
    w = weight
    if w.ndim == 4:  # 1x1 conv
        if w.shape[2:] != (1, 1):
            raise ValueError(f"a SharedMLP conv must be 1x1, got weight {w.shape}")
        w = w[:, :, 0, 0]
    return {"kernel": np.ascontiguousarray(w.T), "bias": bias}


def convert_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's torch ``state_dict`` -> flax-layout ``{"params": ...}``
    (numpy leaves), the tree :func:`params_from_flax` loads."""
    sd = _strip_prefix(state_dict)
    encoder: Dict[str, Any] = {}
    for sa_idx in range(3):
        pattern = re.compile(
            rf"point_cloud_encoder\.SA_modules\.{sa_idx}\."
            r"(?:mlps?\.0\.)?(?:layer)?(\d+)\.?(?:conv\.)?weight$"
        )
        convs = sorted((int(m.group(1)), key) for key in sd for m in [pattern.match(key)] if m)
        if len(convs) != 3:
            raise ValueError(
                f"SA module {sa_idx}: expected 3 conv layers, matched {convs}; "
                f"keys: {[k for k in sd if f'SA_modules.{sa_idx}' in k]}")
        encoder[f"sa{sa_idx}"] = {"mlp": {
            f"conv{out_idx}": _dense_leaf(sd[wkey], sd[wkey[: -len("weight")] + "bias"])
            for out_idx, (_, wkey) in enumerate(convs)
        }}

    # FC head: Linear at 0/3/6, GroupNorm at 1/4
    fc = "point_cloud_encoder.fc_layer"
    for name, idx in (("fc0", 0), ("fc1", 3), ("fc2", 6)):
        encoder[name] = _dense_leaf(sd[f"{fc}.{idx}.weight"], sd[f"{fc}.{idx}.bias"])
    for name, idx in (("gn0", 1), ("gn1", 4)):
        encoder[name] = {"scale": sd[f"{fc}.{idx}.weight"], "bias": sd[f"{fc}.{idx}.bias"]}
    params: Dict[str, Any] = {"point_cloud_encoder": encoder}

    # q encoder (Sequential indices 0, 2, 4, 6, 8), decoder (0, 2, 4, 6)
    for prefix, torch_name, indices in (("feature_encoder", "feature_encoder", (0, 2, 4, 6, 8)),
                                        ("decoder", "decoder", (0, 2, 4, 6))):
        for out_idx, torch_idx in enumerate(indices):
            params[f"{prefix}_{out_idx}"] = _dense_leaf(
                sd[f"{torch_name}.{torch_idx}.weight"], sd[f"{torch_name}.{torch_idx}.bias"])
    return {"params": params}


def load_torch_checkpoint(path) -> Dict[str, Any]:
    """Read a Lightning ``.ckpt`` (or a bare state-dict ``.pt``) on the CPU
    and convert it (:func:`convert_torch_state_dict`). The file is a full
    pickle (``weights_only=False``), as Lightning writes it: load only
    checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return convert_torch_state_dict(state_dict)


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
