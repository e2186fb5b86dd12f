"""The trainer: data-parallel BC learning with periodic
closed-loop validation, wall-clock + epoch-end checkpointing, and JSONL
metric logging.

Port of ``mpinets_tpu/train/trainer.py`` (reference
``mpinets/run_training.py:43-204``). Lightning's DDP/NCCL becomes one
process per card in a ``torch.distributed`` group
(:func:`mpinets_torch.parallel.mesh.multihost_init`: ``torchrun``, or
``MPINETS_COORDINATOR``) stepping the DP step
(:func:`mpinets_torch.train.learner.make_data_parallel_step`), which needs
no collective in a single process. Lightning's ``ModelCheckpoint`` pair
(every N minutes and at epoch end, ``run_training.py:85-104``) becomes
``step_*``/``last``/``best`` checkpoints written by rank 0; W&B becomes a
local JSONL stream with the reference's log keys (``point_match_loss``,
``collision_loss``, ``val_loss``, ``avg_target_error``,
``avg_collision_rate``; ``model.py:233-239,347-352``), also rank 0's.
Every rank validates the same problems with the same draws, so the ranks
agree on ``best``.

Data modes:

* ``hdf5``: the published dataset layout, streamed by
  :class:`mpinets_torch.data.hdf5.InstanceLoader` (seeded per rank) with
  the per-item assembly (:func:`mpinets_torch.data.hdf5.prepare_train_batch`)
  inside the DP step, on the device; validation problems come from the VAL
  split.
* ``synthetic``: on-device pseudo-expert batches
  (:func:`mpinets_torch.data.synthetic.training_batch`, seeded per rank).

Actor-learner mode (``rollout.actor_interval`` > 0): every
``actor_interval`` learner steps a DAgger collector rolls the current
policy out and the learner takes one more DP step on its relabelled batch,
logged under ``actor_*`` with ``actor_env_steps_per_s`` and
``actor_learner_samples_per_s``. Synthetic data:
:func:`mpinets_torch.train.actor.make_dagger_collector`; hdf5: the
real-scene collector (:func:`mpinets_torch.train.actor.make_real_dagger_collector`)
on training trajectories, which also logs ``dagger_accept_frac``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
import uuid
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from mpinets_torch.cli.config import TrainJobConfig, experiment_dir, to_dict
from mpinets_torch.data import hdf5 as hdf5_data
from mpinets_torch.data import synthetic
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.kernels import kinematics
from mpinets_torch.model import checkpoint as ckpt
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.parallel.mesh import (
    fold_seed,
    local_device,
    make_mesh,
    multihost_init,
    process_count,
    process_index,
)
from mpinets_torch.train import learner, validate
from mpinets_torch.utils.device import resolve_device


class MetricLogger:
    """Append-only JSONL metrics + stdout echo (the W&B stand-in)."""

    def __init__(self, path: Optional[Path], echo_every: int = 50):
        self.path = path
        self.echo_every = echo_every
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, metrics: Dict[str, float], force_echo=False) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if force_echo or step % self.echo_every == 0:
            printable = " ".join(f"{k}={v:.5f}" for k, v in metrics.items())
            print(f"[step {step}] {printable}", flush=True)


@dataclasses.dataclass
class Trainer:
    cfg: TrainJobConfig
    test: bool = False  # --test smoke mode (run_training.py:68-70)
    should_log: bool = True
    should_checkpoint: bool = True
    #: the train forward: None = by device, the kernel-backed forward
    #: (:mod:`mpinets_torch.model.fused_train`) on ``cuda`` and the plain
    #: policy on the CPU. True runs the kernel-backed forward on the CPU too
    #: (its wrappers compute their plain versions there); False is refused
    #: on ``cuda``, where the plain policy would run no kernel.
    fused: Optional[bool] = None
    #: wall-clock budget in seconds (None = unbounded): the run stops,
    #: checkpoints and returns when rank 0 finds it spent
    time_budget_s: Optional[float] = None
    #: the device to train on (None = ``cuda``, rank r on ``cuda:LOCAL_RANK``;
    #: ``"cpu"`` for the plain path)
    device: Optional[str] = None

    def __post_init__(self):
        cfg = self.cfg
        device = resolve_device(self.device)
        if self.fused is False and device.type == "cuda":
            raise ValueError("fused=False: on cuda the trainer runs the kernel-backed forward; "
                             "the plain policy runs on device='cpu'")
        # the process group first (no-op without a coordinator or torchrun)
        self._owns_group = multihost_init(device=device)
        self.device = local_device(device)
        self.rank, self.world = process_index(), process_count()
        self.mesh = make_mesh() if dist.is_initialized() else None
        self.global_batch = cfg.optim.batch_size * self.world
        #: rows of the global batch this process produces (one card a process)
        self.host_batch = cfg.optim.batch_size
        self.sizes = PointCloudSizes(
            robot=cfg.data.num_robot_points,
            obstacle=cfg.data.num_obstacle_points,
            target=cfg.data.num_target_points,
        )
        self.model = MotionPolicyNetwork(
            compute_dtype=torch.bfloat16 if cfg.optim.bf16 else torch.float32,
            sa_npoints=tuple(cfg.model.sa_npoints),
            sa_nsamples=tuple(cfg.model.sa_nsamples),
            sa_radii=tuple(cfg.model.sa_radii),
            device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed),
        )
        self.optimizer = learner.make_optimizer(
            self.model.parameters(), cfg.optim.learning_rate, cfg.optim.gradient_clip_val,
            warmup_steps=cfg.optim.warmup_steps, decay_steps=cfg.optim.decay_steps,
        )
        experiment_id = [f"{cfg.experiment_name}-{uuid.uuid4().hex[:8]}"]
        if self.mesh is not None:
            dist.broadcast_object_list(experiment_id, src=0)
        self.experiment_id = experiment_id[0]
        self.ckpt_dir = experiment_dir(cfg, self.experiment_id)
        #: rank 0 alone writes the logs, the config and the checkpoints
        self.writes = self.rank == 0
        self.logger = MetricLogger(
            self.ckpt_dir / "metrics.jsonl" if self.should_log and self.writes else None)

    def _log(self, step: int, row: Dict[str, float], force_echo=False) -> None:
        if self.writes:
            self.logger.log(step, row, force_echo)

    def _agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a decision that ends the loop)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, src=0)
        return bool(t.item())

    # -- data ---------------------------------------------------------------

    def _synthetic_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        # each rank builds its own block of the global batch (the DDP-rank
        # data split, run_training.py:71-77)
        generator = torch.Generator(self.device).manual_seed(fold_seed(self.cfg.seed, 1, self.rank))
        while True:
            yield synthetic.training_batch(
                generator, self.host_batch, sizes=self.sizes,
                random_scale=self.cfg.data.random_scale, device=self.device,
            )

    def _hdf5_batches(self, loader: hdf5_data.InstanceLoader) -> Iterator[Dict[str, torch.Tensor]]:
        for raw in loader:
            yield hdf5_data.to_device(raw, self.device)

    def _make_stream(self):
        """-> (batch iterator, batches_per_epoch, prepare_fn or None)."""
        cfg = self.cfg
        if cfg.data.synthetic:
            return self._synthetic_batches(), 1000, None
        dataset = hdf5_data.TrajectoryDataset(
            cfg.data.data_dir, cfg.data.trajectory_key, hdf5_data.DatasetType.TRAIN,
            in_memory=cfg.data.in_memory,
        )
        self._train_dataset = dataset
        loader = hdf5_data.InstanceLoader(dataset, self.host_batch,
                                          seed=cfg.seed + 7919 * self.rank,
                                          pin_memory=self.device.type == "cuda")
        prepare_fn = functools.partial(hdf5_data.prepare_train_batch, sizes=self.sizes,
                                       random_scale=cfg.data.random_scale, train=True)
        return self._hdf5_batches(loader), loader.batches_per_epoch(), prepare_fn

    def _val_problems(self) -> synthetic.Problem:
        n = 3 if self.test else self.cfg.max_val_problems
        n = max(self.world, n // self.world * self.world)
        if self.cfg.data.synthetic:
            generator = torch.Generator(self.device).manual_seed(fold_seed(self.cfg.seed, 999))
            return synthetic.random_problem_batch(generator, n, device=self.device)
        dataset = hdf5_data.TrajectoryDataset(
            self.cfg.data.data_dir, self.cfg.data.trajectory_key, hdf5_data.DatasetType.VAL)
        batch = dataset.read_trajectory_batch(np.arange(min(n, dataset.num_trajectories)))
        rot, trans = kinematics.eff_pose(torch.as_tensor(batch["raw_goal"], device=self.device))
        return synthetic.Problem(
            q0=torch.as_tensor(batch["raw_configuration"], device=self.device),
            target_rot=rot, target_trans=trans,
            scene=hdf5_data.scene_from_arrays(batch, self.device),
        )

    # -- main loop ------------------------------------------------------------

    def run(self) -> learner.TrainState:
        try:
            return self._run()
        finally:
            if self._owns_group and dist.is_initialized():
                dist.destroy_process_group()

    def _run(self) -> learner.TrainState:
        cfg = self.cfg
        stream, batches_per_epoch, prepare_fn = self._make_stream()
        state = learner.init_state(self.model, self.optimizer, ema=cfg.optim.ema_decay > 0)

        start_step = 0
        if cfg.resume_from:
            resume_dir = ckpt.latest_checkpoint(cfg.resume_from)
            if resume_dir is None:
                raise FileNotFoundError(f"no checkpoint under {cfg.resume_from}")
            state = ckpt.restore_checkpoint(resume_dir, state)
            start_step = ckpt.checkpoint_step(resume_dir)
            print(f"resumed from {resume_dir} at step {start_step}", flush=True)
        learner.broadcast_state(state, self.mesh)

        fused = self.device.type == "cuda" if self.fused is None else self.fused
        train_apply_fn = None
        if fused:
            from mpinets_torch.model.fused_train import make_fused_train_apply

            train_apply_fn = make_fused_train_apply(self.model.compute_dtype)
        print(f"train forward path: {'kernels' if fused else 'plain'}", flush=True)
        make_step = functools.partial(
            learner.make_data_parallel_step, self.mesh,
            point_match_weight=cfg.loss.point_match_loss_weight,
            collision_weight=cfg.loss.collision_loss_weight,
            apply_fn=train_apply_fn, ema_decay=cfg.optim.ema_decay,
        )
        step_fn = make_step(prepare_fn=prepare_fn)
        # validate the EMA parameters when enabled: best/last are judged by them
        validate_fn = validate.make_validation_fn(
            state.ema if state.ema is not None else state.model,
            cfg.rollout.val_rollout_length, self.sizes, device=self.device,
        )
        val_problems = self._val_problems()

        max_epochs = 1 if self.test else cfg.optim.max_epochs
        limit_batches = 10 if self.test else batches_per_epoch
        val_interval = 2 if self.test else cfg.validation_interval

        if self.should_log and self.writes:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            with open(self.ckpt_dir / "config.json", "w") as f:
                json.dump(to_dict(cfg), f, indent=2)
        print(f"experiment {self.experiment_id}: rank {self.rank} of {self.world} on "
              f"{self.device}, global batch {self.global_batch}, "
              f"{limit_batches} batches/epoch x {max_epochs} epochs", flush=True)

        # actor-learner mode: a DAgger collector rolls the current policy out
        # and its relabelled batch takes a DP step of the same learner;
        # synthetic data relabels with the min-jerk pseudo-expert, hdf5 data
        # rolls out on the dataset's scenes and relabels with the SDF
        # optimizer's expert
        actor_interval = cfg.rollout.actor_interval
        collect_fn = None
        real_actor = not cfg.data.synthetic
        if actor_interval:
            from mpinets_torch.train import actor

            if real_actor:
                collect_fn = actor.make_real_dagger_collector(
                    self.model, cfg.rollout.actor_rollout_steps, self.sizes,
                    opt_steps=cfg.rollout.dagger_opt_steps, device=self.device)
                actor_rng = np.random.default_rng(cfg.seed + 0xDA66)
            else:
                collect_fn = actor.make_dagger_collector(
                    self.model, cfg.rollout.actor_rollout_steps, self.sizes, device=self.device)
            actor_step = make_step()

        last_ckpt_time = time.time()
        t_run_start = time.time()
        tick = None
        out_of_time = False
        best_monitor = float("inf")
        step = start_step
        for epoch in range(max_epochs):
            if out_of_time:
                break
            for _ in range(limit_batches):
                if self.time_budget_s is not None and self._agree(
                        time.time() - t_run_start > self.time_budget_s):
                    print(f"wall-clock budget reached at step {step}", flush=True)
                    out_of_time = True
                    break
                batch = next(stream)
                if prepare_fn is not None:
                    state, metrics = step_fn(state, batch, fold_seed(cfg.seed, step))
                else:
                    state, metrics = step_fn(state, batch)
                step += 1

                if collect_fn is not None and step % actor_interval == 0:
                    t_actor = time.time()
                    generator = torch.Generator(self.device).manual_seed(
                        fold_seed(cfg.seed, 0xDA66, step))
                    row = {}
                    if real_actor:
                        idx = actor_rng.integers(0, self._train_dataset.num_trajectories,
                                                 size=self.host_batch)
                        raw = self._train_dataset.read_trajectory_batch(idx)
                        dagger, info = collect_fn(hdf5_data.to_device(raw, self.device),
                                                  generator)
                        row = {k: float(v) for k, v in info.items()}
                    else:
                        dagger = collect_fn(self.host_batch, generator)
                    state, a_metrics = actor_step(state, dagger)
                    row = {**{f"actor_{k}": float(v) for k, v in a_metrics.items()}, **row}
                    dt_actor = time.time() - t_actor
                    # the actor-learner split: closed-loop env-steps collected
                    # and learner samples consumed per second of actor time
                    row["actor_env_steps_per_s"] = (
                        cfg.rollout.actor_rollout_steps * self.host_batch / max(dt_actor, 1e-9))
                    row["actor_learner_samples_per_s"] = self.global_batch / max(dt_actor, 1e-9)
                    self._log(step, row)

                if step % 50 == 0 or step == 1:
                    host = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    if tick is not None:
                        host["steps_per_s"] = (step - tick[1]) / max(now - tick[0], 1e-9)
                        host["env_samples_per_s"] = host["steps_per_s"] * self.global_batch
                    tick = (now, step)
                    self._log(step, host)

                if step % val_interval == 0:
                    generator = torch.Generator(self.device).manual_seed(
                        fold_seed(cfg.seed, 0x5A11, step))
                    val = {k: float(v) for k, v in validate_fn(val_problems, generator).items()}
                    self._log(step, val, force_echo=True)
                    # monitored best checkpoint (Lightning monitor="val_loss",
                    # run_training.py:91-104): collision-free success first,
                    # target error breaks ties while it is zero
                    monitor = val["avg_target_error"] - 10.0 * val["val_success_free"]
                    if monitor < best_monitor:
                        best_monitor = monitor
                        if self.should_checkpoint and self.writes:
                            ckpt.save_named_checkpoint(self.ckpt_dir, "best", step, state)

                if (self.should_checkpoint and self.writes
                        and time.time() - last_ckpt_time > cfg.checkpoint_interval * 60):
                    ckpt.save_checkpoint(self.ckpt_dir, step, state)
                    ckpt.save_named_checkpoint(self.ckpt_dir, "last", step, state)
                    last_ckpt_time = time.time()

            if self.should_checkpoint and self.writes:
                ckpt.save_named_checkpoint(self.ckpt_dir, "last", step, state)
                last_ckpt_time = time.time()
            print(f"epoch {epoch} done at step {step}", flush=True)

        return state
