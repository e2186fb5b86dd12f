"""Batched forward kinematics for the Franka Panda.

Port of ``mpinets_tpu/kernels/kinematics.py`` (``fk_frames``, ``eff_pose``,
``eff_pose_quat``; the collision-sphere functions come with the train
slice). The chain is a short unrolled sequence of batched 3x3 products, so
a [B, 7] batch of configurations turns into [B, F, 3, 3] + [B, F, 3] frame
poses. Frames are indexed by :data:`mpinets_torch.robot.franka.FRAMES`.
"""

from __future__ import annotations

import torch

from mpinets_torch.kernels.rotations import matrix_to_quat
from mpinets_torch.robot import franka


def _rotz_apply(rot: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Right-multiply a batch of rotation matrices by Rz(theta).

    rot: [..., 3, 3]; c, s: [...] -> [..., 3, 3]
    """
    c = c[..., None]
    s = s[..., None]
    col0 = rot[..., 0] * c + rot[..., 1] * s
    col1 = -rot[..., 0] * s + rot[..., 1] * c
    return torch.stack([col0, col1, rot[..., 2]], dim=-1)


def fk_frames(q: torch.Tensor, finger_open: float = franka.FINGER_OPEN):
    """All Franka frames for a batch of configurations.

    :param q: joint configurations, [..., 7]
    :returns: (rots [..., F, 3, 3], trans [..., F, 3]) where F = NUM_FRAMES.
    """
    kw = dict(dtype=q.dtype, device=q.device)
    origins = torch.as_tensor(franka.JOINT_ORIGINS, **kw)
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

    def _fixed(parent_idx, offset):
        offset = torch.as_tensor(offset, **kw)
        p_rot, p_trans = rots[parent_idx], transs[parent_idx]
        t = p_trans + torch.einsum("...ij,j->...i", p_rot, offset[:3, 3])
        r = torch.einsum("...ij,jk->...ik", p_rot, offset[:3, :3])
        return r, t

    # panda_link8 (idx 8), panda_hand (9)
    r8, t8 = _fixed(7, franka.LINK8_OFFSET)
    rots.append(r8)
    transs.append(t8)
    rh, th = _fixed(8, franka.HAND_OFFSET)
    rots.append(rh)
    transs.append(th)

    # Fingers: prismatic along +/- y of the hand, mounted at FINGER_MOUNT_Z.
    mount = torch.tensor([0.0, 0.0, franka.FINGER_MOUNT_Z], **kw)
    y_hand = rh[..., :, 1]
    base_t = th + torch.einsum("...ij,j->...i", rh, mount)
    t_left = base_t + finger_open * y_hand
    t_right = base_t - finger_open * y_hand
    rots.extend([rh, rh])
    transs.extend([t_left, t_right])

    # Fingertips: FINGERTIP_Z along the finger (= hand) z axis.
    z_hand = rh[..., :, 2]
    tip = franka.FINGERTIP_Z * z_hand
    rots.extend([rh, rh])
    transs.extend([t_left + tip, t_right + tip])

    # right_gripper
    rg, tg = _fixed(8, franka.RIGHT_GRIPPER_OFFSET)
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
