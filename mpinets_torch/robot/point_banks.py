"""Per-link surface point banks for the Franka robot.

Port of ``mpinets_tpu/robot/point_banks.py``: the same numpy generator with
the same fixed seeds, so the banks are bit-identical to the JAX package's,
and the same ``MPINETS_TPU_POINT_BANK`` override, so both packages read one
bank when it is set.

The reference's robofin ``FrankaSampler`` draws surface points from cached
samples of the Franka link *meshes* (reference usage:
``mpinets/loss.py:141-147``, ``mpinets/data_loader.py:101``,
``mpinets/model.py:267``). The link meshes are not shipped with this repository, so the
default bank samples the union surface of the 57-sphere collision model
(:mod:`mpinets_torch.robot.franka`), which tracks the robot's true surface to
within the sphere-fit error. The provider is pluggable: drop an ``.npz``
with ``points [P, 3]`` (link-local) and ``frames [P]`` (frame indices) at
:data:`BANK_OVERRIDE_PATH` to substitute real mesh-sampled banks without any
code change (needed for pointwise parity with the published checkpoint).

Banks are deterministic (fixed seed) so the "fixed point cloud" semantics the
loss depends on (``loss.py:123-128``) hold: the k-th bank point always lies
at the same link-local location.

**How much can the missing meshes matter?** (sensitivity study, r3,
``scripts/bank_sensitivity.py``): perturbing every bank point radially by
the sphere-fit error scale — N(0, delta) along the local sphere normal —
bounds the induced error at the low single percents (numbers in the JAX
package's docstring); drop real mesh samples at :data:`BANK_OVERRIDE_PATH`
to remove it entirely.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np

from mpinets_torch.robot import franka

BANK_OVERRIDE_PATH = os.environ.get(
    "MPINETS_TPU_POINT_BANK", os.path.join(os.path.dirname(__file__), "franka_bank.npz")
)

#: Default total bank size. Large enough that a 2048-point resample is a
#: genuine subsample, as with robofin's cached mesh samples.
DEFAULT_BANK_SIZE = 8192

#: Frames that carry surface points for full-robot sampling. ``panda_link0``
#: is excluded from the *loss* bank (the reference passes
#: ``with_base_link=False`` for the loss sampler, ``loss.py:146``) but kept
#: for the rollout bank (the validation/rollout sampler uses the default
#: ``FrankaSampler(device, use_cache=True)``, base link included).
GRIPPER_FRAMES = (
    franka.FRAME_INDEX["panda_hand"],
    franka.FRAME_INDEX["panda_leftfingertip"],
    franka.FRAME_INDEX["panda_rightfingertip"],
)


class PointBank(NamedTuple):
    """A set of link-local surface points. Transform with FK to get a robot
    point cloud: ``world[k] = R[frames[k]] @ points[k] + t[frames[k]]``."""

    points: np.ndarray  # [P, 3] link-local coordinates (float32)
    frames: np.ndarray  # [P] frame index of each point (int32)


def _sphere_union_samples(
    rng: np.random.Generator,
    frame_ids: np.ndarray,
    centers: np.ndarray,
    radii: np.ndarray,
    num_points: int,
) -> PointBank:
    """Sample the union surface of a sphere set, allocating points across
    spheres proportionally to surface area and rejecting points buried inside
    a sibling sphere on the same frame."""
    areas = 4.0 * np.pi * radii**2
    probs = areas / areas.sum()
    bank_pts = np.empty((num_points, 3), np.float64)
    bank_frames = np.empty((num_points,), np.int32)
    filled = 0
    # Oversample + rejection loop; terminates quickly since rejection rates
    # for this sphere model are modest.
    while filled < num_points:
        n = 2 * (num_points - filled) + 256
        which = rng.choice(len(radii), size=n, p=probs)
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts = centers[which] + radii[which, None] * dirs
        # Reject points strictly inside another sphere of the same frame.
        keep = np.ones(n, bool)
        for s in range(len(radii)):
            same = frame_ids[which] == frame_ids[s]
            not_self = which != s
            d = np.linalg.norm(pts - centers[s], axis=1)
            keep &= ~(same & not_self & (d < radii[s] - 1e-9))
        pts, which = pts[keep], which[keep]
        take = min(len(pts), num_points - filled)
        bank_pts[filled : filled + take] = pts[:take]
        bank_frames[filled : filled + take] = frame_ids[which[:take]]
        filled += take
    return PointBank(bank_pts.astype(np.float32), bank_frames)


@functools.lru_cache(maxsize=None)
def full_robot_bank(num_points: int = DEFAULT_BANK_SIZE, seed: int = 0) -> PointBank:
    """Surface bank over the whole robot (all collision-model frames)."""
    if os.path.exists(BANK_OVERRIDE_PATH):
        data = np.load(BANK_OVERRIDE_PATH)
        return PointBank(
            data["points"].astype(np.float32), data["frames"].astype(np.int32)
        )
    rng = np.random.default_rng(seed)
    return _sphere_union_samples(
        rng,
        franka.SPHERE_FRAMES,
        franka.SPHERE_CENTERS,
        franka.SPHERE_RADII,
        num_points,
    )


@functools.lru_cache(maxsize=None)
def loss_bank(num_points: int = 1024, seed: int = 1) -> PointBank:
    """Fixed bank for the point-match loss: ``num_fixed_points=1024`` without
    the base link (``loss.py:141-147``)."""
    mask = franka.SPHERE_FRAMES != franka.FRAME_INDEX["panda_link0"]
    rng = np.random.default_rng(seed)
    return _sphere_union_samples(
        rng,
        franka.SPHERE_FRAMES[mask],
        franka.SPHERE_CENTERS[mask],
        franka.SPHERE_RADII[mask],
        num_points,
    )


@functools.lru_cache(maxsize=None)
def gripper_bank(num_points: int = 128, seed: int = 2) -> PointBank:
    """Bank over the gripper (hand + fingertips) used for target-point
    sampling (``FrankaSampler.sample_end_effector``, reference
    ``data_loader.py:158-161``). Points are expressed in the local frames of
    the hand/fingertip frames; transform with an EE pose chain."""
    mask = np.isin(franka.SPHERE_FRAMES, GRIPPER_FRAMES)
    rng = np.random.default_rng(seed)
    return _sphere_union_samples(
        rng,
        franka.SPHERE_FRAMES[mask],
        franka.SPHERE_CENTERS[mask],
        franka.SPHERE_RADII[mask],
        num_points,
    )
