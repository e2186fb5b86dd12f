"""Batched robot surface-point sampling under FK.

Port of ``mpinets_tpu/robot/sampler.py`` (``bank_point_cloud``,
``sample_robot_points``, ``fixed_robot_points``, ``sample_end_effector``).
Each bank's points are link-local and grouped by
frame, so one batched FK gives the whole world-frame bank with one small
product per frame; the 2048-point rollout resample is then a gather.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from mpinets_torch.kernels import kinematics
from mpinets_torch.robot import franka, point_banks
from mpinets_torch.utils import trace


def _group_slices(frames: np.ndarray):
    """Contiguous (frame, start, stop) runs of a frame-sorted bank."""
    order = np.argsort(frames, kind="stable")
    sorted_frames = frames[order]
    boundaries = np.flatnonzero(np.diff(sorted_frames)) + 1
    starts = np.concatenate([[0], boundaries])
    stops = np.concatenate([boundaries, [len(frames)]])
    return order, [
        (int(sorted_frames[a]), int(a), int(b)) for a, b in zip(starts, stops)
    ]


@functools.lru_cache(maxsize=None)
def _prepared_bank(bank_key: str, num_points: int, seed: int):
    """Returns (points_sorted [P, 3] float32, groups [(frame, a, b)])."""
    bank = {
        "full": point_banks.full_robot_bank,
        "loss": point_banks.loss_bank,
    }[bank_key](num_points, seed)
    order, groups = _group_slices(bank.frames)
    return bank.points[order], groups


def bank_point_cloud(
    q: torch.Tensor, bank_key: str = "full",
    num_bank_points: int = point_banks.DEFAULT_BANK_SIZE, seed: int = 0,
) -> torch.Tensor:
    """World-frame positions of every point of a bank ("full": the robot
    surface bank; "loss": the fixed loss bank). q: [..., 7] -> [..., P, 3]."""
    points, groups = _prepared_bank(bank_key, num_bank_points, seed)
    rots, transs = kinematics.fk_frames(q)
    with trace.h2d_wait("point_bank", q.device):
        pts = torch.as_tensor(points, dtype=q.dtype, device=q.device)
    chunks = []
    for frame, a, b in groups:
        r = rots[..., frame, :, :]
        t = transs[..., frame, :]
        chunks.append(torch.einsum("...ij,pj->...pi", r, pts[a:b]) + t[..., None, :])
    return torch.cat(chunks, dim=-2)


def sample_robot_points(
    q: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_points: int = 2048,
    indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Random robot surface cloud, resampled per call (rollout semantics of
    ``FrankaSampler.sample(q, n)``, reference ``model.py:180-181``).

    q: [..., 7] -> [..., num_points, 3]. Sampling is with replacement from
    the bank. ``indices`` ([..., num_points] int, into the bank) replaces
    the draw from ``generator``, so a caller can replay given draws.
    """
    world = bank_point_cloud(q, "full")
    if indices is None:
        indices = torch.randint(
            0, world.shape[-2], q.shape[:-1] + (num_points,),
            generator=generator, device=q.device,
        )
    return torch.take_along_dim(world, indices[..., None].long(), dim=-2)


def fixed_robot_points(q: torch.Tensor, num_points: int = 1024) -> torch.Tensor:
    """Deterministic fixed-point cloud for the point-match loss
    (``FrankaSampler(num_fixed_points=1024, use_cache=True,
    with_base_link=False)``, reference ``loss.py:141-147``): the k-th output
    point is always the same link-local point, so the pointwise MSE between
    two configurations is meaningful. q: [..., 7] -> [..., num_points, 3]."""
    return bank_point_cloud(q, "loss", num_points, 1)


@functools.lru_cache(maxsize=None)
def _gripper_bank_eff_local(num_points: int, seed: int) -> np.ndarray:
    """Gripper-surface bank expressed in the right_gripper frame [P, 3]."""
    bank = point_banks.gripper_bank(num_points, seed)
    rg = franka.RIGHT_GRIPPER_OFFSET  # link8 -> right_gripper
    hand = franka.HAND_OFFSET         # link8 -> hand
    rel_hand = np.linalg.inv(rg) @ hand

    def _finger_tip(sign):
        mount = np.eye(4)
        mount[2, 3] = franka.FINGER_MOUNT_Z
        mount[1, 3] = sign * franka.FINGER_OPEN
        tip = np.eye(4)
        tip[2, 3] = franka.FINGERTIP_Z
        return rel_hand @ mount @ tip

    rel = {
        franka.FRAME_INDEX["panda_hand"]: rel_hand,
        franka.FRAME_INDEX["panda_leftfingertip"]: _finger_tip(+1.0),
        franka.FRAME_INDEX["panda_rightfingertip"]: _finger_tip(-1.0),
    }
    out = np.empty_like(bank.points)
    for f, t in rel.items():
        m = bank.frames == f
        out[m] = bank.points[m] @ t[:3, :3].T + t[:3, 3]
    return out.astype(np.float32)


def sample_end_effector(
    eff_rot: torch.Tensor, eff_trans: torch.Tensor, num_points: int = 128,
    seed: int = 2,
) -> torch.Tensor:
    """Gripper surface cloud at a given end-effector pose
    (``FrankaSampler.sample_end_effector``, reference
    ``data_loader.py:158-161``). Deterministic bank.

    eff_rot: [..., 3, 3]; eff_trans: [..., 3] (right_gripper frame pose)
    -> [..., num_points, 3]
    """
    with trace.h2d_wait("gripper_bank", eff_trans.device):
        local = torch.as_tensor(
            _gripper_bank_eff_local(num_points, seed),
            dtype=eff_trans.dtype, device=eff_trans.device,
        )
    return torch.einsum("...ij,pj->...pi", eff_rot, local) + eff_trans[..., None, :]
