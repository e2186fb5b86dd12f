"""Actor side of the actor-learner loop: policy rollouts that feed the
learner DAgger-relabelled batches.

Port of ``mpinets_tpu/train/actor.py``. The current policy is rolled out
closed-loop on the device, and the states it visits are relabelled by an
expert: "what would you do HERE" -- the correction the reference
approximates offline with train-time joint noise
(``data_loader.py:167-179``). Two collectors:

* :func:`make_dagger_collector`, synthetic: fresh random problems, the
  min-jerk pseudo-expert (:func:`mpinets_torch.data.synthetic.min_jerk_trajectory`)
  re-planned from each visited state;
* :func:`make_real_dagger_collector`: problems from a dataset batch, the SDF
  trajectory optimizer (:mod:`mpinets_torch.pipeline.expert`) planning from
  each visited state, with a fallback to the stored expert step where its
  plan fails.

Both return batches with the key layout of
:func:`mpinets_torch.data.synthetic.training_batch`, so the learner step
consumes them unchanged. On ``cuda`` the rollout takes the kernel-backed
inference forward (:func:`mpinets_torch.model.fused.make_fused_apply`), as
the trainer's validation does, so every actor step launches the FPS, ball
query and SA kernels.

Draws are split from the construction (:class:`DaggerDraws`), so a test can
hand a collector the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mpinets_torch.data.synthetic import (
    Problem,
    min_jerk_trajectory,
    random_configuration,
    random_scene,
)
from mpinets_torch.geom.assembly import PointCloudSizes, assemble_point_cloud
from mpinets_torch.geom.scene import ObstacleDraws, SceneSet, draw_obstacle_samples
from mpinets_torch.kernels import ik, kinematics
from mpinets_torch.pipeline import expert
from mpinets_torch.robot import point_banks
from mpinets_torch.rollout.engine import make_rollout_fn
from mpinets_torch.train.learner import scene_from_batch
from mpinets_torch.utils.device import resolve_device
from mpinets_torch.utils.normalization import normalize_franka_joints


class DaggerDraws(NamedTuple):
    """The random numbers behind one collected batch of B rows."""

    t: torch.Tensor                 # [B] visited step of the rollout's trajectory
    robot_indices: torch.Tensor     # [B, sizes.robot] bank indices of the relabelled cloud
    obstacle: ObstacleDraws         # [B, sizes.obstacle] its obstacle points
    scene: Optional[SceneSet] = None        # [B] synthetic scenes (real: the batch's)
    q0: Optional[torch.Tensor] = None       # [B, 7] synthetic starts
    q_goal: Optional[torch.Tensor] = None   # [B, 7] synthetic goals
    t_expert: Optional[torch.Tensor] = None  # [B] fallback step of the stored expert (real)
    #: the rollout's first cloud [B, N, 4] and per-step robot-bank indices
    #: [T, B, sizes.robot]; None: the rollout draws them from the generator
    rollout_cloud: Optional[torch.Tensor] = None
    rollout_indices: Optional[torch.Tensor] = None


def draw_dagger(generator: torch.Generator, batch_size: int, rollout_steps: int,
                sizes: PointCloudSizes = PointCloudSizes(), device=None) -> DaggerDraws:
    """Draws for :func:`make_dagger_collector`'s ``collect``: random scenes,
    starts and goals, the visited step in [0, rollout_steps] and the
    relabelled cloud's draws."""
    scene = random_scene(generator, batch_size, device=device)
    q0 = random_configuration(generator, (batch_size,), device)
    q_goal = random_configuration(generator, (batch_size,), device)
    t = torch.randint(0, rollout_steps + 1, (batch_size,), generator=generator, device=device)
    robot = torch.randint(0, point_banks.DEFAULT_BANK_SIZE, (batch_size, sizes.robot),
                          generator=generator, device=device)
    obstacle = draw_obstacle_samples(scene, sizes.obstacle, generator)
    return DaggerDraws(t, robot, obstacle, scene, q0, q_goal)


def draw_real_dagger(generator: torch.Generator, scene: SceneSet, rollout_steps: int,
                     expert_length: int, sizes: PointCloudSizes = PointCloudSizes()
                     ) -> DaggerDraws:
    """Draws for :func:`make_real_dagger_collector`'s ``collect`` on a batch
    of ``scene`` [B]: the visited step in [1, rollout_steps], the stored
    expert's fallback step in [0, expert_length - 1) and the relabelled
    cloud's draws."""
    b = scene.cuboid_centers.shape[0]
    device = scene.cuboid_centers.device
    t = torch.randint(1, rollout_steps + 1, (b,), generator=generator, device=device)
    t_expert = torch.randint(0, expert_length - 1, (b,), generator=generator, device=device)
    robot = torch.randint(0, point_banks.DEFAULT_BANK_SIZE, (b, sizes.robot),
                          generator=generator, device=device)
    obstacle = draw_obstacle_samples(scene, sizes.obstacle, generator)
    return DaggerDraws(t, robot, obstacle, t_expert=t_expert)


def _rollout(model, rollout_steps, sizes, apply_fn, device):
    if apply_fn is None and device.type == "cuda":
        from mpinets_torch.model.fused import make_fused_apply

        apply_fn = make_fused_apply(model.compute_dtype, sa_npoints=model.sa_npoints)
    return make_rollout_fn(model, max_steps=rollout_steps, sizes=sizes, stop_on_success=False,
                           record_trajectory=True, apply_fn=apply_fn, device=device)


def _batch(xyz, q_state, q_sup, trans_goal, scene) -> Dict[str, torch.Tensor]:
    return {
        "xyz": xyz,
        "configuration": normalize_franka_joints(q_state),
        "supervision": normalize_franka_joints(q_sup),
        "target_position": trans_goal,
        **{f: getattr(scene, f) for f in SceneSet._fields},
    }


def _visited(traj: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """traj [B, T, 7] at step t [B] of each row -> [B, 7]."""
    return traj[torch.arange(traj.shape[0], device=traj.device), t.long()]


def make_dagger_collector(
    model,
    rollout_steps: int = 20,
    sizes: PointCloudSizes = PointCloudSizes(),
    apply_fn=None,
    device=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> ``collect(batch_size, generator=None, draws=None) -> batch``: roll
    the model's CURRENT weights out on fresh synthetic problems and relabel
    each row's visited state with the pseudo-expert's next step toward the
    goal. Runs on ``device`` (default ``cuda``); ``apply_fn`` overrides the
    rollout's forward (default: the kernels on ``cuda``, the plain policy
    on the CPU)."""
    device = resolve_device(device)
    rollout = _rollout(model, rollout_steps, sizes, apply_fn, device)

    @torch.no_grad()
    def collect(batch_size: int, generator: Optional[torch.Generator] = None,
                draws: Optional[DaggerDraws] = None) -> Dict[str, torch.Tensor]:
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        if draws is None:
            draws = draw_dagger(generator, batch_size, rollout_steps, sizes, device)
        scene = draws.scene.to(device)
        q_goal = draws.q_goal.to(device)
        rot_goal, trans_goal = kinematics.eff_pose(q_goal)
        problem = Problem(draws.q0.to(device), rot_goal, trans_goal, scene)
        traj = rollout(problem, generator, init_cloud=draws.rollout_cloud,
                       robot_indices=draws.rollout_indices).trajectories    # [B, T+1, 7]
        q_t = _visited(traj, draws.t.to(device))
        # DAgger relabel: the expert's next step from the VISITED state
        q_next = min_jerk_trajectory(q_t, q_goal)[:, 1]
        xyz = assemble_point_cloud(q_t, rot_goal, trans_goal, scene, sizes,
                                   robot_indices=draws.robot_indices.to(device),
                                   obstacle_draws=ObstacleDraws(*(x.to(device)
                                                                  for x in draws.obstacle)))
        return _batch(xyz, q_t, q_next, trans_goal, scene)

    return collect


def make_real_dagger_collector(
    model,
    rollout_steps: int = 20,
    sizes: PointCloudSizes = PointCloudSizes(),
    apply_fn=None,
    opt_steps: int = 60,
    device=None,
) -> Callable[..., Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """-> ``collect(problem_batch, generator=None, draws=None) -> (batch,
    {"dagger_accept_frac"})``: roll the model out on problems from a
    dataset batch (``expert`` [B, T, 7], ``raw_configuration``,
    ``raw_goal`` [B, 7] and the scene arrays) and relabel each visited
    state with the SDF optimizer's plan (``opt_steps`` steps) from it to the
    problem's goal configuration over the row's own scene. A relabel is
    accepted when the plan is free of scene and self collisions, within the
    real limits, and the visited state is free; otherwise the row falls
    back to the stored expert step at a random timestep (a plain BC
    sample)."""
    device = resolve_device(device)
    rollout = _rollout(model, rollout_steps, sizes, apply_fn, device)

    @torch.no_grad()
    def collect(problem_batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                draws: Optional[DaggerDraws] = None):
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        batch = {k: torch.as_tensor(v, device=device) for k, v in problem_batch.items()}
        scene = scene_from_batch(batch)
        expert_traj = batch["expert"]                                      # [B, T, 7]
        q_goal = batch["raw_goal"]
        rot_goal, trans_goal = kinematics.eff_pose(q_goal)
        if draws is None:
            draws = draw_real_dagger(generator, scene, rollout_steps, expert_traj.shape[1], sizes)
        problem = Problem(batch["raw_configuration"], rot_goal, trans_goal, scene)
        traj = rollout(problem, generator, init_cloud=draws.rollout_cloud,
                       robot_indices=draws.rollout_indices).trajectories    # [B, S+1, 7]
        q_t = _visited(traj, draws.t.to(device))

        # the real expert: an SDF-optimized path from the VISITED state
        opt = expert.optimize_trajectory(q_t, q_goal, scene, steps=opt_steps)  # [B, L, 7]
        path_ok = (
            ~expert.env_collision_any(opt, scene)
            & ~kinematics.self_collision(opt).any(-1)
            & kinematics.within_limits(opt, use_real_constraints=True).all(-1)
            & ik.franka_free_space(q_t, scene)
        )
        t_exp = draws.t_expert.to(device)
        q_bc = _visited(expert_traj, t_exp)
        q_bc_next = _visited(expert_traj, t_exp + 1)
        q_state = torch.where(path_ok[:, None], q_t, q_bc)
        q_sup = torch.where(path_ok[:, None], opt[:, 1], q_bc_next)
        xyz = assemble_point_cloud(q_state, rot_goal, trans_goal, scene, sizes,
                                   robot_indices=draws.robot_indices.to(device),
                                   obstacle_draws=ObstacleDraws(*(x.to(device)
                                                                  for x in draws.obstacle)))
        info = {"dagger_accept_frac": path_ok.float().mean()}
        return _batch(xyz, q_state, q_sup, trans_goal, scene), info

    return collect
