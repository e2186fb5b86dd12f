"""Batched forward kinematics for the Franka Panda.

Port of ``mpinets_tpu/kernels/kinematics.py``: ``fk_frames``, ``eff_pose``,
``eff_pose_quat``, the 57-sphere collision model (``collision_spheres``,
``scene_collision_spheres``), ``self_collision`` and ``within_limits``. The
chain is a short unrolled sequence of batched 3x3 products, so
a [B, 7] batch of configurations turns into [B, F, 3, 3] + [B, F, 3] frame
poses. Frames are indexed by :data:`mpinets_torch.robot.franka.FRAMES`.
"""

from __future__ import annotations

import functools

import torch

from mpinets_torch.kernels.rotations import matrix_to_quat
from mpinets_torch.robot import franka
from mpinets_torch.utils.device import host_table


def _rotz_apply(rot: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Right-multiply a batch of rotation matrices by Rz(theta).

    rot: [..., 3, 3]; c, s: [...] -> [..., 3, 3]
    """
    c = c[..., None]
    s = s[..., None]
    col0 = rot[..., 0] * c + rot[..., 1] * s
    col1 = -rot[..., 0] * s + rot[..., 1] * c
    return torch.stack([col0, col1, rot[..., 2]], dim=-1)


@functools.lru_cache(maxsize=None)
def franka_table(name: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``franka.<name>`` as a tensor on a device, made once per (name,
    dtype, device) (:func:`~mpinets_torch.utils.device.host_table`, site
    ``name.lower()``): a copy from the host to a card waits for the card,
    so the callers make none per call. No caller writes it in place."""
    return host_table(name.lower(), getattr(franka, name), dtype, device)


def fk_frames(q: torch.Tensor, finger_open: float = franka.FINGER_OPEN):
    """All Franka frames for a batch of configurations.

    :param q: joint configurations, [..., 7]
    :returns: (rots [..., F, 3, 3], trans [..., F, 3]) where F = NUM_FRAMES.
    """
    kw = dict(dtype=q.dtype, device=q.device)
    origins = franka_table("JOINT_ORIGINS", q.dtype, q.device)
    batch_shape = q.shape[:-1]

    cos = torch.cos(q)
    sin = torch.sin(q)

    rot = torch.eye(3, **kw).expand(batch_shape + (3, 3))
    trans = torch.zeros(batch_shape + (3,), **kw)

    rots = [rot]
    transs = [trans]
    for i in range(franka.DOF):
        o_rot = origins[i, :3, :3]
        o_trans = origins[i, :3, 3]
        trans = trans + torch.einsum("...ij,j->...i", rot, o_trans)
        rot = torch.einsum("...ij,jk->...ik", rot, o_rot)
        rot = _rotz_apply(rot, cos[..., i], sin[..., i])
        rots.append(rot)
        transs.append(trans)

    def _fixed(parent_idx, name):
        offset = franka_table(name, q.dtype, q.device)
        p_rot, p_trans = rots[parent_idx], transs[parent_idx]
        t = p_trans + torch.einsum("...ij,j->...i", p_rot, offset[:3, 3])
        r = torch.einsum("...ij,jk->...ik", p_rot, offset[:3, :3])
        return r, t

    # panda_link8 (idx 8), panda_hand (9)
    r8, t8 = _fixed(7, "LINK8_OFFSET")
    rots.append(r8)
    transs.append(t8)
    rh, th = _fixed(8, "HAND_OFFSET")
    rots.append(rh)
    transs.append(th)

    # Fingers: prismatic along +/- y of the hand, mounted at FINGER_MOUNT_Z
    # along its z axis (rh @ [0, 0, z], whose two zero terms add nothing).
    y_hand = rh[..., :, 1]
    z_hand = rh[..., :, 2]
    base_t = th + z_hand * franka.FINGER_MOUNT_Z
    t_left = base_t + finger_open * y_hand
    t_right = base_t - finger_open * y_hand
    rots.extend([rh, rh])
    transs.extend([t_left, t_right])

    # Fingertips: FINGERTIP_Z along the finger (= hand) z axis.
    tip = franka.FINGERTIP_Z * z_hand
    rots.extend([rh, rh])
    transs.extend([t_left + tip, t_right + tip])

    # right_gripper
    rg, tg = _fixed(8, "RIGHT_GRIPPER_OFFSET")
    rots.append(rg)
    transs.append(tg)

    return torch.stack(rots, dim=-3), torch.stack(transs, dim=-2)


def eff_pose(q: torch.Tensor):
    """End-effector (right_gripper) pose: (rot [..., 3, 3], trans [..., 3])."""
    rots, transs = fk_frames(q)
    return rots[..., franka.EFF_FRAME, :, :], transs[..., franka.EFF_FRAME, :]


def eff_pose_quat(q: torch.Tensor):
    """End-effector pose as (position [..., 3], wxyz quaternion [..., 4])."""
    rot, trans = eff_pose(q)
    return trans, matrix_to_quat(rot)


def _spheres(q: torch.Tensor, frames, centers) -> torch.Tensor:
    rots, transs = fk_frames(q)
    idx = franka_table(frames, torch.long, q.device)
    local = franka_table(centers, q.dtype, q.device)
    s_rot = rots.index_select(-3, idx)      # [..., S, 3, 3]
    s_trans = transs.index_select(-2, idx)  # [..., S, 3]
    return torch.einsum("...sij,sj->...si", s_rot, local) + s_trans


def collision_spheres(q: torch.Tensor) -> torch.Tensor:
    """World-frame centres of the 57-sphere collision model (robofin's
    ``FrankaCollisionSampler.compute_spheres``, used at ``model.py:300-303``).
    q [..., 7] -> [..., 57, 3]; radii are :data:`franka.SPHERE_RADII`."""
    return _spheres(q, "SPHERE_FRAMES", "SPHERE_CENTERS")


def scene_collision_spheres(q: torch.Tensor) -> torch.Tensor:
    """The spheres checked against scene geometry: the 57-sphere table
    without the base link (``with_base_link=False``, ``model.py:270``).
    Radii: :data:`franka.SCENE_SPHERE_RADII`."""
    return _spheres(q, "SCENE_SPHERE_FRAMES", "SCENE_SPHERE_CENTERS")


def self_collision(q: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Sphere-model self-collision (robofin's
    ``FrankaSelfCollisionChecker.has_self_collision``, ``metrics.py:266``):
    True when an allowed sphere pair is closer than the sum of its radii
    (+ margin). q [..., 7] -> bool [...]."""
    centers = collision_spheres(q)
    pairs = franka_table("SELF_COLLISION_PAIRS", torch.long, q.device)
    thresh = franka_table("SELF_COLLISION_THRESH", q.dtype, q.device) + margin
    a = centers.index_select(-2, pairs[:, 0])
    b = centers.index_select(-2, pairs[:, 1])
    d2 = ((a - b) ** 2).sum(dim=-1)
    return torch.any(d2 < thresh ** 2, dim=-1)


def within_limits(q: torch.Tensor, use_real_constraints: bool = False) -> torch.Tensor:
    """Joint-limit predicate (``FrankaRobot.within_limits``,
    ``metrics.py:320``). q [..., 7] -> bool [...]."""
    table = "REAL_JOINT_LIMITS" if use_real_constraints else "JOINT_LIMITS"
    limits = franka_table(table, q.dtype, q.device)
    return torch.all((q >= limits[:, 0]) & (q <= limits[:, 1]), dim=-1)
