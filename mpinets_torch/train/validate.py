"""Training-time validation: closed-loop rollout metrics.

Port of ``mpinets_tpu/train/validate.py`` (the reference's
``validation_step``, ``mpinets/model.py:252-318``): roll the policy out 69
steps from each validation problem with no early exit, then report the
final end-effector errors, success rates and the share of rollouts whose
scene spheres (``with_base_link=False``) ever touch the scene.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from mpinets_torch.data.synthetic import Problem
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.kernels import kinematics, sdf
from mpinets_torch.robot import franka
from mpinets_torch.rollout.engine import make_rollout_fn
from mpinets_torch.utils.device import resolve_device


def make_validation_fn(
    model,
    rollout_length: int = 69,
    sizes: PointCloudSizes = PointCloudSizes(),
    device=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> ``validate(problem, generator=None) -> {name: scalar tensor}`` for
    ``model``, on ``device`` (default ``cuda``).

    The rollout takes the kernel-backed forward on ``cuda``, at any cloud
    size, and the plain policy on the CPU, as the JAX package does on and
    off the TPU.
    """
    device = resolve_device(device)
    apply_fn = None
    if device.type == "cuda":
        from mpinets_torch.model.fused import make_fused_apply

        apply_fn = make_fused_apply(model.compute_dtype)
    rollout = make_rollout_fn(model, max_steps=rollout_length, sizes=sizes,
                              stop_on_success=False, apply_fn=apply_fn, device=device)
    radii = torch.as_tensor(franka.SCENE_SPHERE_RADII, dtype=torch.float32, device=device)
    flip = torch.diag(torch.tensor([-1.0, -1.0, 1.0], device=device))
    deg15 = math.radians(15.0)

    def angle_to(rot_ref, rot):
        rel = torch.einsum("...ji,...jk->...ik", rot_ref, rot)
        tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
        return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))

    @torch.no_grad()
    def validate(problem: Problem, generator: Optional[torch.Generator] = None):
        problem = problem.to(device)
        result = rollout(problem, generator)
        eff_rot, eff_pos = kinematics.eff_pose(result.final_q)
        target_error = torch.linalg.norm(eff_pos - problem.target_trans, dim=-1)
        # orientation error against the target and the pi-yaw-flipped target
        orient_err = angle_to(problem.target_rot, eff_rot)
        orient_err_flip = angle_to(problem.target_rot @ flip, eff_rot)

        trajs = result.trajectories                       # [B, T+1, 7]
        b, t, _ = trajs.shape
        centers = kinematics.scene_collision_spheres(trajs)
        sdf_vals = sdf.scene_sdf_sequence(centers.reshape(b, t, -1, 3), problem.scene)
        has_collision = torch.any((sdf_vals.reshape(b, t, -1) <= radii).reshape(b, -1), dim=-1)

        # success: within 1 cm and 15 degrees (run_inference.py:176-187);
        # collision-free success also needs a clean rollout (metrics.py:514-519)
        success = (target_error < 0.01) & (orient_err < deg15)
        f = lambda m: m.float().mean()
        return {
            "avg_target_error": target_error.mean(),
            "avg_collision_rate": f(has_collision),
            "avg_orient_error_deg": torch.rad2deg(orient_err).mean(),
            "pct_within_1cm": f(target_error < 0.01),
            "pct_within_5cm": f(target_error < 0.05),
            "pct_flip_orient": f(orient_err_flip < deg15),
            "val_success": f(success),
            "val_success_free": f(success & ~has_collision),
        }

    return validate
