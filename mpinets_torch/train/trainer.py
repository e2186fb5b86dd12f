"""The trainer: behavior cloning on one device with periodic
closed-loop validation, checkpoints and JSONL metric logging.

Port of ``mpinets_tpu/train/trainer.py`` (reference
``mpinets/run_training.py:43-204``) in its synthetic data mode: batches come
from :func:`mpinets_torch.data.synthetic.training_batch` on the device.
Lightning's ``ModelCheckpoint`` pair (every N minutes and at epoch end,
``run_training.py:85-104``) becomes ``step_*``/``last``/``best``
checkpoints; W&B becomes a local JSONL stream with the reference's log keys
(``point_match_loss``, ``collision_loss``, ``val_loss``,
``avg_target_error``, ``avg_collision_rate``; ``model.py:233-239,347-352``).

Actor-learner mode (``rollout.actor_interval`` > 0, synthetic data): every
``actor_interval`` learner steps the DAgger collector
(:func:`mpinets_torch.train.actor.make_dagger_collector`) rolls the current
policy out and the learner takes one more step on its relabelled batch,
logged under ``actor_*`` with ``actor_env_steps_per_s`` and
``actor_learner_samples_per_s``.

Not ported yet: the hdf5 data mode and with it the hdf5 actor mode (the
real-scene collector, :func:`mpinets_torch.train.actor.make_real_dagger_collector`,
is ported; the dataset reader is ``ROADMAP.md`` A11), and data
parallelism over several cards (A13).
"""

from __future__ import annotations

import dataclasses
import json
import time
import uuid
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from mpinets_torch.cli.config import TrainJobConfig, experiment_dir, to_dict
from mpinets_torch.data import synthetic
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.model import checkpoint as ckpt
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.train import learner, validate
from mpinets_torch.utils.device import resolve_device


def _seed(*parts: int) -> int:
    """One generator seed from several integers."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0] >> 1)


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
    #: checkpoints and returns when it is spent
    time_budget_s: Optional[float] = None
    #: the device to train on (None = ``cuda``; ``"cpu"`` for the plain path)
    device: Optional[str] = None

    def __post_init__(self):
        cfg = self.cfg
        if not cfg.data.synthetic and cfg.rollout.actor_interval:
            raise NotImplementedError(
                "the hdf5 actor mode needs the hdf5 data mode, which is not ported "
                "(ROADMAP.md queue A item 11); its collector is "
                "mpinets_torch.train.actor.make_real_dagger_collector")
        if not cfg.data.synthetic:
            raise NotImplementedError(
                "the hdf5 data mode is not ported (ROADMAP.md queue A item 11); "
                "use the synthetic data mode")
        self.device = resolve_device(self.device)
        if self.fused is False and self.device.type == "cuda":
            raise ValueError("fused=False: on cuda the trainer runs the kernel-backed forward; "
                             "the plain policy runs on device='cpu'")
        self.global_batch = cfg.optim.batch_size
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
        self.experiment_id = f"{cfg.experiment_name}-{uuid.uuid4().hex[:8]}"
        self.ckpt_dir = experiment_dir(cfg, self.experiment_id)
        self.logger = MetricLogger(self.ckpt_dir / "metrics.jsonl" if self.should_log else None)

    # -- data ---------------------------------------------------------------

    def _synthetic_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        generator = torch.Generator(self.device).manual_seed(_seed(self.cfg.seed, 1))
        while True:
            yield synthetic.training_batch(
                generator, self.global_batch, sizes=self.sizes,
                random_scale=self.cfg.data.random_scale, device=self.device,
            )

    def _val_problems(self) -> synthetic.Problem:
        n = 3 if self.test else self.cfg.max_val_problems
        generator = torch.Generator(self.device).manual_seed(_seed(self.cfg.seed, 999))
        return synthetic.random_problem_batch(generator, n, device=self.device)

    # -- main loop ------------------------------------------------------------

    def run(self) -> learner.TrainState:
        cfg = self.cfg
        stream, batches_per_epoch = self._synthetic_batches(), 1000
        state = learner.init_state(self.model, self.optimizer, ema=cfg.optim.ema_decay > 0)

        start_step = 0
        if cfg.resume_from:
            resume_dir = ckpt.latest_checkpoint(cfg.resume_from)
            if resume_dir is None:
                raise FileNotFoundError(f"no checkpoint under {cfg.resume_from}")
            state = ckpt.restore_checkpoint(resume_dir, state)
            start_step = ckpt.checkpoint_step(resume_dir)
            print(f"resumed from {resume_dir} at step {start_step}", flush=True)

        fused = self.device.type == "cuda" if self.fused is None else self.fused
        train_apply_fn = None
        if fused:
            from mpinets_torch.model.fused_train import make_fused_train_apply

            train_apply_fn = make_fused_train_apply(
                self.model.compute_dtype, sa_npoints=self.model.sa_npoints)
        print(f"train forward path: {'kernels' if fused else 'plain'}", flush=True)
        step_fn = learner.make_train_step(
            point_match_weight=cfg.loss.point_match_loss_weight,
            collision_weight=cfg.loss.collision_loss_weight,
            apply_fn=train_apply_fn, ema_decay=cfg.optim.ema_decay,
        )
        # validate the EMA parameters when enabled: best/last are judged by them
        validate_fn = validate.make_validation_fn(
            state.ema if state.ema is not None else state.model,
            cfg.rollout.val_rollout_length, self.sizes, device=self.device,
        )
        val_problems = self._val_problems()

        max_epochs = 1 if self.test else cfg.optim.max_epochs
        limit_batches = 10 if self.test else batches_per_epoch
        val_interval = 2 if self.test else cfg.validation_interval

        if self.should_log:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            with open(self.ckpt_dir / "config.json", "w") as f:
                json.dump(to_dict(cfg), f, indent=2)
        print(f"experiment {self.experiment_id}: {self.device}, batch {self.global_batch}, "
              f"{limit_batches} batches/epoch x {max_epochs} epochs", flush=True)

        # actor-learner mode: the DAgger collector rolls the current policy
        # out and its relabelled batch takes a step of the same learner
        actor_interval = cfg.rollout.actor_interval
        collect_fn = None
        if actor_interval:
            from mpinets_torch.train.actor import make_dagger_collector

            collect_fn = make_dagger_collector(self.model, cfg.rollout.actor_rollout_steps,
                                               self.sizes, device=self.device)

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
                if (self.time_budget_s is not None
                        and time.time() - t_run_start > self.time_budget_s):
                    print(f"wall-clock budget reached at step {step}", flush=True)
                    out_of_time = True
                    break
                state, metrics = step_fn(state, next(stream))
                step += 1

                if collect_fn is not None and step % actor_interval == 0:
                    t_actor = time.time()
                    generator = torch.Generator(self.device).manual_seed(
                        _seed(cfg.seed, 0xDA66, step))
                    state, a_metrics = step_fn(state, collect_fn(self.global_batch, generator))
                    row = {f"actor_{k}": float(v) for k, v in a_metrics.items()}
                    dt_actor = time.time() - t_actor
                    # the actor-learner split: closed-loop env-steps collected
                    # and learner samples consumed per second of actor time
                    row["actor_env_steps_per_s"] = (
                        cfg.rollout.actor_rollout_steps * self.global_batch / max(dt_actor, 1e-9))
                    row["actor_learner_samples_per_s"] = self.global_batch / max(dt_actor, 1e-9)
                    self.logger.log(step, row)

                if step % 50 == 0 or step == 1:
                    host = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    if tick is not None:
                        host["steps_per_s"] = (step - tick[1]) / max(now - tick[0], 1e-9)
                        host["env_samples_per_s"] = host["steps_per_s"] * self.global_batch
                    tick = (now, step)
                    self.logger.log(step, host)

                if step % val_interval == 0:
                    generator = torch.Generator(self.device).manual_seed(
                        _seed(cfg.seed, 0x5A11, step))
                    val = {k: float(v) for k, v in validate_fn(val_problems, generator).items()}
                    self.logger.log(step, val, force_echo=True)
                    # monitored best checkpoint (Lightning monitor="val_loss",
                    # run_training.py:91-104): collision-free success first,
                    # target error breaks ties while it is zero
                    monitor = val["avg_target_error"] - 10.0 * val["val_success_free"]
                    if self.should_checkpoint and monitor < best_monitor:
                        best_monitor = monitor
                        ckpt.save_named_checkpoint(self.ckpt_dir, "best", step, state)

                if (self.should_checkpoint
                        and time.time() - last_ckpt_time > cfg.checkpoint_interval * 60):
                    ckpt.save_checkpoint(self.ckpt_dir, step, state)
                    ckpt.save_named_checkpoint(self.ckpt_dir, "last", step, state)
                    last_ckpt_time = time.time()

            if self.should_checkpoint:
                ckpt.save_named_checkpoint(self.ckpt_dir, "last", step, state)
                last_ckpt_time = time.time()
            print(f"epoch {epoch} done at step {step}", flush=True)

        return state
