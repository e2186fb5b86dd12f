"""Behavior-cloning and collision losses.

Port of ``mpinets_tpu/train/loss.py`` (reference ``mpinets/loss.py``):

* :func:`point_match_loss` -- MSE + L1 between robot surface clouds at the
  predicted and the supervision configurations (``loss.py:31-44``);
* :func:`collision_loss` -- hinge on the scene SDF of the predicted robot
  points with a 3 cm margin (``loss.py:47-94``); zero-volume padding gives
  +inf SDF and so no loss;
* :func:`bc_losses` -- both, from the fixed 1024-point loss cloud
  (``loss.py:97-166``), plus the share of points inside the margin.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mpinets_torch.kernels import sdf
from mpinets_torch.robot import sampler
from mpinets_torch.utils.normalization import unnormalize_franka_joints

COLLISION_MARGIN = 0.03  # loss.py:92
NUM_LOSS_POINTS = 1024   # loss.py:109


def point_match_loss(input_pc: torch.Tensor, target_pc: torch.Tensor) -> torch.Tensor:
    """MSE + L1, both means over every element ([B, N, 3])."""
    diff = input_pc - target_pc
    return (diff ** 2).mean() + diff.abs().mean()


def collision_loss(input_pc: torch.Tensor, scene) -> torch.Tensor:
    """Hinge-embedding loss on the scene SDF: mean of max(0, margin - sdf)."""
    return torch.relu(COLLISION_MARGIN - sdf.scene_sdf(input_pc, scene)).mean()


def bc_losses(
    y_hat_norm: torch.Tensor, supervision_norm: torch.Tensor, scene
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(collision_loss, point_match_loss, hinge_active_frac) for normalized
    prediction and supervision configurations [B, 7]. ``hinge_active_frac``
    is the share of loss points within the margin of the scene."""
    input_pc = sampler.fixed_robot_points(unnormalize_franka_joints(y_hat_norm), NUM_LOSS_POINTS)
    target_pc = sampler.fixed_robot_points(
        unnormalize_franka_joints(supervision_norm), NUM_LOSS_POINTS)
    sdf_values = sdf.scene_sdf(input_pc, scene)
    coll = torch.relu(COLLISION_MARGIN - sdf_values).mean()
    active = (sdf_values < COLLISION_MARGIN).float().mean()
    return coll, point_match_loss(input_pc, target_pc), active
