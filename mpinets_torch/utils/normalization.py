"""Joint-space normalization: affine map between Franka joint limits and
[-1, 1].

Port of ``mpinets_tpu/utils/normalization.py`` (the reference's
``(un)normalize_franka_joints``, ``motion-policy-networks/mpinets/utils.py:30-244``).
The default range is the empirical "real robot" limits, as there.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mpinets_torch.kernels import kinematics


def _limits(use_real_constraints: bool, like: torch.Tensor) -> torch.Tensor:
    """The [7, 2] limit table in ``like``'s dtype on its device, made once
    per (table, dtype, device) (:func:`kinematics.franka_table`)."""
    table = "REAL_JOINT_LIMITS" if use_real_constraints else "JOINT_LIMITS"
    return kinematics.franka_table(table, like.dtype, like.device)


def normalize_franka_joints(
    q: torch.Tensor,
    limits: Tuple[float, float] = (-1.0, 1.0),
    use_real_constraints: bool = True,
) -> torch.Tensor:
    """[..., 7] joint angles -> [..., 7] normalized to `limits`."""
    jl = _limits(use_real_constraints, q)
    lo, hi = jl[:, 0], jl[:, 1]
    return (q - lo) / (hi - lo) * (limits[1] - limits[0]) + limits[0]


def unnormalize_franka_joints(
    q_norm: torch.Tensor,
    limits: Tuple[float, float] = (-1.0, 1.0),
    use_real_constraints: bool = True,
) -> torch.Tensor:
    """Inverse of :func:`normalize_franka_joints`."""
    jl = _limits(use_real_constraints, q_norm)
    lo, hi = jl[:, 0], jl[:, 1]
    return (q_norm - limits[0]) * (hi - lo) / (limits[1] - limits[0]) + lo


def clamp_to_limits(q: torch.Tensor, use_real_constraints: bool = True) -> torch.Tensor:
    """Clamp joint angles to the limit table."""
    jl = _limits(use_real_constraints, q)
    return torch.clamp(q, jl[:, 0], jl[:, 1])
