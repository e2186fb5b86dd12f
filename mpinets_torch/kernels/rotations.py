"""Rotation / transform helpers shared by FK, sampling and the success check.

Port of ``mpinets_tpu/kernels/rotations.py``. All functions broadcast over
leading batch dims and use the reference's conventions: quaternions are
scalar-first (w, x, y, z) as in ``motion-policy-networks/mpinets/geometry.py:140-141``.
"""

from __future__ import annotations

import torch


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from a (w, x, y, z) quaternion. q: [..., 4] -> [..., 3, 3].

    The quaternion is normalized first.
    """
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = 2 * x * x, 2 * y * y, 2 * z * z
    wx, wy, wz = 2 * w * x, 2 * w * y, 2 * w * z
    xy, xz, yz = 2 * x * y, 2 * x * z, 2 * y * z
    row0 = torch.stack([1 - yy - zz, xy - wz, xz + wy], dim=-1)
    row1 = torch.stack([xy + wz, 1 - xx - zz, yz - wx], dim=-1)
    row2 = torch.stack([xz - wy, yz + wx, 1 - xx - yy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(r: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion from a rotation matrix. r: [..., 3, 3] -> [..., 4].

    Branch-free Shepperd-style extraction: all four candidate solutions are
    computed and the best-conditioned one is selected; the sign is
    canonicalized to w >= 0.
    """
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(pivot), 4(comp)]
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Absolute rotation angle (radians) between two (w,x,y,z) quaternions
    (``metrics.py:352-362``: |angle(q_final * q_target^-1)|)."""
    d = quat_multiply(a, quat_conjugate(b))
    vec = torch.sqrt(torch.clamp(torch.sum(d[..., 1:] ** 2, dim=-1), min=1e-30))
    return 2.0 * torch.atan2(vec, torch.abs(d[..., 0]))


def transform_points(rot: torch.Tensor, trans: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """rot: [..., 3, 3], trans: [..., 3], points: [..., N, 3] -> [..., N, 3]."""
    return torch.einsum("...ij,...nj->...ni", rot, points) + trans[..., None, :]


def inverse_transform(rot: torch.Tensor, trans: torch.Tensor):
    """Inverse of a rigid transform given as (rot, trans)."""
    inv_rot = torch.swapaxes(rot, -1, -2)
    inv_trans = -torch.einsum("...ij,...j->...i", inv_rot, trans)
    return inv_rot, inv_trans
