"""Independent robot-surface proxy for collision-checker calibration.

Port of ``mpinets_tpu/eval/hull_proxy.py`` (numpy, copied; the numbers are
bit for bit the JAX package's). The 57-sphere evaluator checker is
calibrated (:mod:`mpinets_torch.eval.calibration`) against a proxy that
shares NO geometry with the sphere table:

* **Hand + fingers**: surface samples of the reference's
  ``interactive_demo/mpinets_ros/meshes/half_open_gripper.stl`` (binary STL,
  parsed here with numpy, in the ``right_gripper`` frame: z=0 at the
  fingertip pads, hand body in -z, finger spread along y), the Franka Hand
  geometry of the reference's visualizer (``run_inference.py:310-420``).
* **Arm links**: analytic capsules whose AXES come from the kinematic frame
  table (URDF joint origins, :data:`mpinets_torch.robot.franka.JOINT_ORIGINS`
  -- kinematic data, not the sphere fit) and whose radii are nominal Panda
  link thicknesses transcribed below. The radii are estimates, so
  :func:`mpinets_torch.eval.calibration.calibrate` reports the confusion
  matrix at an inflate envelope (0.9/1.0/1.1) rather than a point estimate.

The mesh is read from :data:`GRIPPER_STL` unless a ``path`` is given
(the repository does not hold the mesh yet); a
missing file raises ``FileNotFoundError`` naming it (no other proxy stands
in). :func:`load_gripper_mesh` and :func:`hull_bank` are cached per
argument, so a caller that points :data:`GRIPPER_STL` at another file must
``cache_clear()`` both.

Reference semantics being proxied: PyBullet hd∧ld mesh collision checks
(``mpinets/metrics.py:270-291``).
"""

from __future__ import annotations

import functools
import struct
from pathlib import Path

import numpy as np

from mpinets_torch.robot import franka
from mpinets_torch.robot.point_banks import PointBank

#: The reference's ``interactive_demo/mpinets_ros/meshes/half_open_gripper.stl``,
#: read from ``meshes/`` at the root of this repository.
GRIPPER_STL = str(Path(__file__).resolve().parents[2] / "meshes" / "half_open_gripper.stl")

#: Arm capsules: (frame, p0, p1, radius), points in the frame's local
#: coordinates. Axes follow the URDF joint-origin chain (the segment from a
#: frame's origin to its child joint's constant origin translation rotates
#: rigidly with that frame); radii are nominal Panda link thicknesses.
ARM_CAPSULES = (
    # base pedestal up to the joint-1 axis
    ("panda_link0", (0.0, 0.0, 0.03), (0.0, 0.0, 0.15), 0.09),
    # shoulder column (link1 body hangs below the joint-1 frame)
    ("panda_link1", (0.0, 0.0, -0.27), (0.0, 0.0, 0.0), 0.065),
    # upper arm: joint2 frame origin -> joint3 origin (0, -0.316, 0)
    ("panda_link2", (0.0, 0.0, 0.0), (0.0, -0.316, 0.0), 0.065),
    # elbow offset: joint3 frame -> joint4 origin (0.0825, 0, 0)
    ("panda_link3", (0.0, 0.0, 0.0), (0.0825, 0.0, 0.0), 0.06),
    # forearm: joint4 frame -> joint5 origin (-0.0825, 0.384, 0)
    ("panda_link4", (0.0, 0.0, 0.0), (-0.0825, 0.384, 0.0), 0.06),
    # forearm shell below the wrist (link5 body)
    ("panda_link5", (0.0, 0.04, -0.22), (0.0, 0.0, 0.0), 0.06),
    # wrist: joint6 frame -> joint7 origin (0.088, 0, 0)
    ("panda_link6", (0.0, 0.0, 0.0), (0.088, 0.0, 0.0), 0.055),
    # flange cylinder: joint7 frame -> link8 (0, 0, 0.107)
    ("panda_link7", (0.0, 0.0, 0.0), (0.0, 0.0, 0.107), 0.05),
)


@functools.lru_cache(maxsize=None)
def load_gripper_mesh(path=None) -> np.ndarray:
    """Triangles [T, 3, 3] of the half-open-gripper STL (right_gripper
    frame), read from ``path`` (default :data:`GRIPPER_STL`)."""
    raw = open(GRIPPER_STL if path is None else path, "rb").read()
    n = struct.unpack("<I", raw[80:84])[0]
    rows = np.frombuffer(raw[84 : 84 + n * 50], dtype=np.uint8)
    return rows.reshape(n, 50)[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)


def sample_mesh_surface(
    tri: np.ndarray, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Area-weighted uniform surface samples of a triangle soup [T,3,3]."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    pick = rng.choice(len(tri), size=n, p=area / area.sum())
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (
        a[pick]
        + u[:, None] * (b[pick] - a[pick])
        + v[:, None] * (c[pick] - a[pick])
    ).astype(np.float32)


def sample_capsule_surface(
    p0: np.ndarray, p1: np.ndarray, r: float, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Area-weighted uniform samples on a capsule's surface."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    axis = p1 - p0
    h = np.linalg.norm(axis)
    side_area = 2.0 * np.pi * r * h
    cap_area = 4.0 * np.pi * r * r
    n_side = int(round(n * side_area / (side_area + cap_area)))
    n_cap = n - n_side
    z = axis / h if h > 0 else np.array([0.0, 0.0, 1.0])
    x = np.cross(z, [0.0, 0.0, 1.0])
    if np.linalg.norm(x) < 1e-8:
        x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)

    theta = rng.random(n_side) * 2.0 * np.pi
    t = rng.random(n_side)
    side = (
        p0[None]
        + t[:, None] * axis[None]
        + r * (np.cos(theta)[:, None] * x + np.sin(theta)[:, None] * y)
    )
    # hemispherical end caps: uniform sphere points assigned to the matching
    # end by the sign of their axial component
    v = rng.normal(size=(n_cap, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    on_p1 = v @ z > 0
    caps = np.where(on_p1[:, None], p1[None], p0[None]) + r * v
    return np.concatenate([side, caps]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hull_bank(num_points: int = 8192, seed: int = 0, path=None) -> PointBank:
    """Independent surface bank: arm capsules + real gripper mesh samples
    (the mesh read from ``path``, default :data:`GRIPPER_STL`).

    Points are link-local (capsules in their parent frame, mesh samples in
    ``right_gripper``), so FK poses them as every other bank.
    """
    rng = np.random.default_rng(seed)
    # split points by surface area: mesh triangles vs capsule areas
    tri = load_gripper_mesh(path)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    mesh_area = float(
        (0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)).sum()
    )
    cap_areas = []
    for _, p0, p1, r in ARM_CAPSULES:
        h = float(np.linalg.norm(np.subtract(p1, p0)))
        cap_areas.append(2.0 * np.pi * r * h + 4.0 * np.pi * r * r)
    total = mesh_area + sum(cap_areas)
    pts, frames = [], []
    # The mesh region is the only REAL geometry in the proxy, and the hand is
    # the most collision-critical body; floor its share at 25% rather than
    # the ~6% its raw surface area would allot.
    n_mesh = max(int(round(num_points * mesh_area / total)), num_points // 4)
    pts.append(sample_mesh_surface(tri, n_mesh, rng))
    frames.append(
        np.full(n_mesh, franka.FRAME_INDEX["right_gripper"], np.int32)
    )
    remaining = num_points - n_mesh
    for (frame, p0, p1, r), area in zip(ARM_CAPSULES, cap_areas):
        k = max(int(round(remaining * area / sum(cap_areas))), 32)
        pts.append(sample_capsule_surface(np.array(p0), np.array(p1), r, k, rng))
        frames.append(np.full(k, franka.FRAME_INDEX[frame], np.int32))
    return PointBank(
        np.concatenate(pts).astype(np.float32), np.concatenate(frames)
    )


def inflate_bank(bank: PointBank, inflate: float) -> PointBank:
    """Scale each capsule's cross-section by ``inflate`` (mesh points are
    real geometry and are left untouched)."""
    if inflate == 1.0:
        return bank
    pts = bank.points.copy()
    rg = franka.FRAME_INDEX["right_gripper"]
    for frame, p0, p1, _ in ARM_CAPSULES:
        fi = franka.FRAME_INDEX[frame]
        if fi == rg:
            continue
        m = bank.frames == fi
        p0 = np.asarray(p0, np.float32)
        axis = np.asarray(p1, np.float32) - p0
        h2 = float(axis @ axis)
        if h2 > 0:
            t = np.clip(((pts[m] - p0) @ axis) / h2, 0.0, 1.0)
        else:
            t = np.zeros(int(m.sum()), np.float32)
        foot = p0 + t[:, None] * axis
        pts[m] = foot + (pts[m] - foot) * inflate
    return PointBank(pts, bank.frames)
