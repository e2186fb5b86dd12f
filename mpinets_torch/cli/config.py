"""Typed configuration for training jobs.

Port of ``mpinets_tpu/cli/config.py``: one dataclass tree with the same
fields and defaults, loadable from YAML in this layout (data:/loss:/optim:/
model:/rollout: sections) or in the reference's ``jobconfig.yaml`` layout
(``run_training.py:134-163``, ``jobconfig.yaml:23-40``). PyYAML is imported
only when a YAML path is given.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional


@dataclasses.dataclass
class DataConfig:
    data_dir: str = "/data"
    #: 'hybrid_solutions' or 'global_solutions' (jobconfig.yaml:29).
    trajectory_key: str = "hybrid_solutions"
    num_robot_points: int = 2048
    num_obstacle_points: int = 4096
    num_target_points: int = 128
    #: Train-time joint noise sigma (jobconfig.yaml:31).
    random_scale: float = 0.015
    #: Use the on-device synthetic generator instead of HDF5 files.
    synthetic: bool = False
    #: Cache the split's arrays in host RAM at open (hdf5 mode): removes the
    #: h5py random-row gathers from the input stream.
    in_memory: bool = False


@dataclasses.dataclass
class LossConfig:
    point_match_loss_weight: float = 1.0
    collision_loss_weight: float = 5.0  # jobconfig.yaml:23-25


@dataclasses.dataclass
class OptimConfig:
    learning_rate: float = 1e-4  # model.py:72
    gradient_clip_val: float = 1.0  # run_training.py:110
    batch_size: int = 10  # per device, jobconfig.yaml:37
    max_epochs: int = 500  # run_training.py:109
    #: bf16 compute (the reference uses fp16 AMP, run_training.py:112).
    bf16: bool = True
    #: Warmup + cosine-decay schedule (0 decay_steps = the reference's
    #: constant lr) and parameter EMA for validation/checkpoints (0.0 = off).
    warmup_steps: int = 0
    decay_steps: int = 0
    ema_decay: float = 0.0


@dataclasses.dataclass
class ModelConfig:
    """Set-abstraction stage sizes (reference architecture defaults,
    ``model.py:364-383``); configurable for tests and scaling sweeps."""

    sa_npoints: tuple = (512, 128)
    sa_nsamples: tuple = (128, 128)
    sa_radii: tuple = (0.05, 0.3)


@dataclasses.dataclass
class RolloutConfig:
    val_rollout_length: int = 69  # model.py:272
    eval_rollout_length: int = 150  # run_inference.py:55
    control_dt: float = 0.08  # 12 Hz, run_inference.py:297
    #: actor-learner mode: every ``actor_interval`` learner steps, roll the
    #: current policy out on-device and feed a DAgger-relabeled batch back
    #: into the learner (0 = offline BC only). In synthetic mode the
    #: relabeling expert is the min-jerk pseudo-expert; in hdf5 mode it is
    #: the real SDF-optimizer expert over the dataset's scenes.
    actor_interval: int = 0
    #: closed-loop steps per actor rollout
    actor_rollout_steps: int = 20
    #: SDF-optimizer steps for the real-scene DAgger relabeling expert
    dagger_opt_steps: int = 60


@dataclasses.dataclass
class TrainJobConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    rollout: RolloutConfig = dataclasses.field(default_factory=RolloutConfig)
    #: Minutes between wall-clock checkpoints (jobconfig.yaml:34).
    checkpoint_interval: int = 60
    #: Batches between validation passes (jobconfig.yaml:35).
    validation_interval: int = 3000
    save_checkpoint_dir: str = "checkpoints"
    experiment_name: str = "mpinets_torch"
    description: str = ""
    seed: int = 0
    #: Validation problems per pass (the reference validates on the whole
    #: val file; cap for wall-clock control).
    max_val_problems: int = 128
    #: checkpoint directory to resume from ("" = fresh start); restores the
    #: `last` checkpoint and continues the step counter
    resume_from: str = ""


#: reference jobconfig.yaml key -> (section, field) mapping so the
#: reference's YAML files load unchanged.
_REFERENCE_KEYS = {
    "checkpoint_interval": ("", "checkpoint_interval"),
    "validation_interval": ("", "validation_interval"),
    "batch_size": ("optim", "batch_size"),
    "save_checkpoint_dir": ("", "save_checkpoint_dir"),
    "experiment_name": ("", "experiment_name"),
    "description": ("", "description"),
}
_REFERENCE_SECTIONS = {
    "training_model_parameters": {
        "point_match_loss_weight": ("loss", "point_match_loss_weight"),
        "collision_loss_weight": ("loss", "collision_loss_weight"),
    },
    "data_module_parameters": {
        "data_dir": ("data", "data_dir"),
        "trajectory_key": ("data", "trajectory_key"),
        "num_obstacle_points": ("data", "num_obstacle_points"),
        "num_target_points": ("data", "num_target_points"),
        "random_scale": ("data", "random_scale"),
    },
    "shared_parameters": {
        "num_robot_points": ("data", "num_robot_points"),
    },
}


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None
                ) -> TrainJobConfig:
    """Build a config from YAML (``path``) and ``overrides`` (the same
    layout as a dict). Accepts this package's nested layout or the
    reference's jobconfig.yaml layout; unknown keys raise ``KeyError``."""
    cfg = TrainJobConfig()
    raw: Dict[str, Any] = {}
    if path is not None:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    raw.update(overrides or {})

    def set_field(section: str, field: str, value):
        target = getattr(cfg, section) if section else cfg
        if not hasattr(target, field):
            raise KeyError(f"unknown config key {section}.{field}")
        setattr(target, field, value)

    for key, value in raw.items():
        if key in ("gpus",):  # reference leftover; device count is ambient
            continue
        if key in _REFERENCE_SECTIONS and isinstance(value, dict):
            for sub_key, sub_value in value.items():
                if sub_key not in _REFERENCE_SECTIONS[key]:
                    raise KeyError(f"unknown config key {key}.{sub_key}")
                set_field(*_REFERENCE_SECTIONS[key][sub_key], sub_value)
        elif key in _REFERENCE_KEYS:
            set_field(*_REFERENCE_KEYS[key], value)
        elif key in ("data", "loss", "optim", "model", "rollout") and isinstance(value, dict):
            for sub_key, sub_value in value.items():
                set_field(key, sub_key, sub_value)
        elif hasattr(cfg, key) and not dataclasses.is_dataclass(getattr(cfg, key)):
            setattr(cfg, key, value)
        else:
            raise KeyError(f"unknown config key {key!r}")
    return cfg


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def experiment_dir(cfg: TrainJobConfig, experiment_id: str) -> Path:
    return Path(cfg.save_checkpoint_dir).resolve() / experiment_id
