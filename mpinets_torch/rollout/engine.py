"""The lockstep closed-loop rollout engine.

Port of ``mpinets_tpu/rollout/engine.py``. A batch of problems steps in
lockstep through a Python loop over time (the JAX package scans). The
reference's per-problem early exit (``run_inference.py:137-191``) is a
per-env done mask: once an env meets the success predicate its
configuration is frozen, so the trajectory and ``num_steps`` match the
sequential semantics while the whole batch keeps stepping.

Draws come from a ``torch.Generator``. A caller may pass the draws instead:
the initial cloud and the per-step robot-bank indices, which lets a test
replay the JAX package's draws (``mpinets_tpu/rollout/engine.py:110,129,165``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mpinets_torch.data.synthetic import Problem
from mpinets_torch.geom.assembly import (
    PointCloudSizes,
    assemble_point_cloud,
    assemble_point_cloud_with_obstacles,
    update_robot_points,
)
from mpinets_torch.kernels import kinematics
from mpinets_torch.robot import sampler
from mpinets_torch.utils import trace
from mpinets_torch.utils.device import resolve_device
from mpinets_torch.utils.normalization import (
    normalize_franka_joints,
    unnormalize_franka_joints,
)

#: Eval-time maximum rollout length (run_inference.py:55).
MAX_ROLLOUT_LENGTH = 150
#: Validation rollout length (model.py:272).
VAL_ROLLOUT_LENGTH = 69
#: Success tolerances (run_inference.py:179-187, metrics.py:514-519).
POS_TOLERANCE = 0.01       # 1 cm
ORI_TOLERANCE_DEG = 15.0   # 15 degrees


class RolloutResult(NamedTuple):
    """Outputs of a lockstep rollout over a batch of problems."""

    trajectories: torch.Tensor  # [B, T+1, 7] unnormalized configs (q0 first)
    success: torch.Tensor       # [B] bool: success predicate ever hit
    num_steps: torch.Tensor     # [B] int32: steps taken until success (or T)
    final_q: torch.Tensor       # [B, 7]


def orientation_error_deg(rot_a: torch.Tensor, rot_b: torch.Tensor) -> torch.Tensor:
    """Geodesic SO(3) angle between rotation matrices, in degrees:
    arccos((tr(Ra^T Rb) - 1) / 2)."""
    tr = torch.einsum("...ij,...ij->...", rot_a, rot_b)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def success_predicate(
    q: torch.Tensor,
    target_rot: torch.Tensor,
    target_trans: torch.Tensor,
    pos_tol: float = POS_TOLERANCE,
    ori_tol_deg: float = ORI_TOLERANCE_DEG,
) -> torch.Tensor:
    """EE within 1 cm and 15 deg of the target (run_inference.py:176-187).
    q: [..., 7] -> bool [...]."""
    rot, trans = kinematics.eff_pose(q)
    pos_err = torch.linalg.norm(trans - target_trans, dim=-1)
    ori_err = orientation_error_deg(rot, target_rot)
    return (pos_err < pos_tol) & (ori_err < ori_tol_deg)


def make_rollout_fn(
    model,
    max_steps: int = MAX_ROLLOUT_LENGTH,
    sizes: PointCloudSizes = PointCloudSizes(),
    stop_on_success: bool = True,
    record_trajectory: bool = True,
    apply_fn: Optional[Callable[..., torch.Tensor]] = None,
    device=None,
) -> Callable[..., RolloutResult]:
    """Build the lockstep rollout ``(problem, generator=None, init_cloud=None,
    robot_indices=None) -> RolloutResult`` on ``device`` (default ``cuda``;
    raises when there is none unless ``device="cpu"``).

    ``stop_on_success=True`` reproduces ``rollout_until_success``
    (frozen-when-done); ``False`` always steps (``model.py:170-182``).
    ``record_trajectory=False`` drops the [B, T+1, 7] trajectory stack.
    ``apply_fn(model, xyz, q_norm)`` overrides the policy forward (e.g.
    :func:`mpinets_torch.model.fused.make_fused_apply`); default
    ``model(xyz, q_norm)``.

    The rollout draws the initial cloud and each step's robot points from
    ``generator`` (a fresh one seeded 0 when None), unless given
    ``init_cloud`` [B, N, 4] and ``robot_indices`` [T, B, sizes.robot]
    (bank indices), which it then uses as they are.
    """
    device = resolve_device(device)
    policy = apply_fn if apply_fn is not None else (lambda m, xyz, q: m(xyz, q))

    @torch.no_grad()
    def rollout(problem: Problem, generator: Optional[torch.Generator] = None,
                init_cloud: Optional[torch.Tensor] = None,
                robot_indices: Optional[torch.Tensor] = None) -> RolloutResult:
        problem = problem.to(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        b = problem.q0.shape[0]

        if init_cloud is not None:
            xyz = init_cloud.to(device).clone()
        elif problem.obstacle_points is not None:
            xyz = assemble_point_cloud_with_obstacles(
                problem.q0, problem.target_rot, problem.target_trans,
                problem.obstacle_points, sizes, generator,
            )
        else:
            xyz = assemble_point_cloud(
                problem.q0, problem.target_rot, problem.target_trans,
                problem.scene, sizes, generator,
            )
        q_norm = normalize_franka_joints(problem.q0)
        if stop_on_success:
            done = success_predicate(problem.q0, problem.target_rot, problem.target_trans)
        else:
            done = torch.zeros((b,), dtype=torch.bool, device=device)
        num_steps = torch.zeros((b,), dtype=torch.int32, device=device)
        qs = [problem.q0]

        for t in range(max_steps):
            with trace.span("rollout.policy"):
                delta = policy(model, xyz, q_norm)
            with trace.span("rollout.env"):
                q_norm_next = torch.clamp(q_norm + delta, -1.0, 1.0)  # model.py:171
                if stop_on_success:
                    q_norm_next = torch.where(done[:, None], q_norm, q_norm_next)
                q_next = unnormalize_franka_joints(q_norm_next)
                success = success_predicate(q_next, problem.target_rot, problem.target_trans)
                num_steps = num_steps + (~done).to(torch.int32)
                if stop_on_success:
                    done = done | success
                # Resample the robot segment at the new config (model.py:180-181).
                robot = sampler.sample_robot_points(
                    q_next, generator, sizes.robot,
                    indices=None if robot_indices is None else robot_indices[t].to(device),
                )
                xyz = update_robot_points(xyz, robot)
            q_norm = q_norm_next
            if record_trajectory:
                qs.append(q_next)

        q_final = unnormalize_franka_joints(q_norm)
        traj = torch.stack(qs, dim=1) if record_trajectory else q_final[:, None, :]
        success_f = (
            done if stop_on_success
            else success_predicate(q_final, problem.target_rot, problem.target_trans)
        )
        return RolloutResult(traj, success_f, num_steps, q_final)

    return rollout


def frozen_trajectory_mask(result: RolloutResult) -> torch.Tensor:
    """[B, T+1] bool: True for timesteps at/before each env's stop step
    (the valid prefix of the frozen-tail lockstep trajectory)."""
    t = result.trajectories.shape[1]
    steps = torch.arange(t, device=result.num_steps.device)[None, :]
    return steps <= result.num_steps[:, None]
