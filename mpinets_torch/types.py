"""Problem schema and host-side primitive types.

PyTorch-port copy of ``mpinets_tpu/types.py`` (plain numpy). It is the
replacement for the reference's L0 type layer
(``motion-policy-networks/mpinets/mpinets_types.py:30-48``) plus the parts of the
external ``geometrout`` package the reference leans on (SE3 poses and
Cuboid/Cylinder/Sphere primitives with ``sdf``/surface sampling). These are
plain numpy dataclasses used at the host boundary -- loading problem sets,
building padded :class:`mpinets_torch.geom.scene.SceneSet` batches, and
reporting. All batched math happens on device in ``mpinets_torch.kernels``.

Conventions (identical to the reference): quaternions are scalar-first
(w, x, y, z); cuboid ``dims`` are full extents; cylinders are z-axis aligned
in their local frame; the planning target is the ``right_gripper`` frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion [..., 4] -> rotation matrix [..., 3, 3] (numpy)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    """Rotation matrix [3, 3] -> wxyz quaternion [4] (numpy, single pose)."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = 2.0 * np.sqrt(t + 1.0)
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = 2.0 * np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


@dataclasses.dataclass
class Pose:
    """A rigid transform (the geometrout ``SE3`` stand-in)."""

    position: np.ndarray  # [3]
    quaternion: np.ndarray  # [4] wxyz

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float64).reshape(3)
        self.quaternion = np.asarray(self.quaternion, dtype=np.float64).reshape(4)

    @property
    def matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = quat_to_matrix_np(self.quaternion)
        m[:3, 3] = self.position
        return m

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "Pose":
        return cls(np.asarray(m)[:3, 3], matrix_to_quat_np(np.asarray(m)[:3, :3]))


@dataclasses.dataclass
class Sphere:
    center: np.ndarray  # [3]
    radius: float

    def sdf(self, point: np.ndarray) -> float:
        return float(np.linalg.norm(np.asarray(point) - self.center) - self.radius)

    @property
    def surface_area(self) -> float:
        return 4.0 * np.pi * self.radius**2


@dataclasses.dataclass
class Cuboid:
    center: np.ndarray  # [3]
    dims: np.ndarray  # [3] full extents
    quaternion: np.ndarray  # [4] wxyz

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64).reshape(3)
        self.dims = np.asarray(self.dims, dtype=np.float64).reshape(3)
        self.quaternion = np.asarray(self.quaternion, dtype=np.float64).reshape(4)

    def sdf(self, point: np.ndarray) -> float:
        """Oriented-box SDF (same decomposition as the reference's
        ``TorchCuboids.sdf``, ``mpinets/geometry.py:272-288``)."""
        rot = quat_to_matrix_np(self.quaternion)
        local = rot.T @ (np.asarray(point, dtype=np.float64) - self.center)
        q = np.abs(local) - self.dims / 2
        outside = np.linalg.norm(np.maximum(q, 0.0))
        inside = min(q.max(), 0.0)
        return float(outside + inside)

    @property
    def surface_area(self) -> float:
        d = self.dims
        return float(2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]))

    def is_zero_volume(self) -> bool:
        return bool(np.any(np.isclose(self.dims, 0.0)))


@dataclasses.dataclass
class Cylinder:
    center: np.ndarray  # [3]
    radius: float
    height: float
    quaternion: np.ndarray  # [4] wxyz

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64).reshape(3)
        self.quaternion = np.asarray(self.quaternion, dtype=np.float64).reshape(4)
        self.radius = float(self.radius)
        self.height = float(self.height)

    def sdf(self, point: np.ndarray) -> float:
        """Oriented z-axis cylinder SDF (``TorchCylinders.sdf``,
        ``mpinets/geometry.py:456-507``)."""
        rot = quat_to_matrix_np(self.quaternion)
        local = rot.T @ (np.asarray(point, dtype=np.float64) - self.center)
        dr = np.linalg.norm(local[:2]) - self.radius
        dz = abs(local[2]) - self.height / 2
        q = np.array([dr, dz])
        outside = np.linalg.norm(np.maximum(q, 0.0))
        inside = min(q.max(), 0.0)
        return float(outside + inside)

    @property
    def surface_area(self) -> float:
        return float(2.0 * np.pi * self.radius * (self.height + self.radius))

    def is_zero_volume(self) -> bool:
        return bool(np.isclose(self.radius, 0.0) or np.isclose(self.height, 0.0))


Primitive = Union[Cuboid, Cylinder, Sphere]
Obstacles = List[Primitive]
Trajectory = Sequence[np.ndarray]


@dataclasses.dataclass
class PlanningProblem:
    """One motion-planning problem (``mpinets_types.py:34-45``)."""

    target: Pose  # target pose of the right_gripper frame
    target_volume: Union[Cuboid, Cylinder]
    q0: np.ndarray  # [7] starting configuration
    obstacles: Optional[Obstacles] = None
    obstacle_point_cloud: Optional[np.ndarray] = None
    target_negative_volumes: Obstacles = dataclasses.field(default_factory=list)


#: scene_type -> problem_type -> problems (``mpinets_types.py:48``).
ProblemSet = Dict[str, Dict[str, List[PlanningProblem]]]


def split_obstacles(obstacles: Obstacles):
    """(cuboids, cylinders) lists; spheres are represented as zero-height
    cylinders are NOT supported -- the reference datasets contain only
    cuboids and cylinders (``gen_data.py:734-762``)."""
    cuboids = [o for o in obstacles if isinstance(o, Cuboid)]
    cylinders = [o for o in obstacles if isinstance(o, Cylinder)]
    rest = [o for o in obstacles if not isinstance(o, (Cuboid, Cylinder))]
    if rest:
        raise ValueError(f"unsupported primitive types: {set(map(type, rest))}")
    return cuboids, cylinders


def cuboid_tuple(c: Cuboid):
    return (c.center, c.dims, c.quaternion)


def cylinder_tuple(c: Cylinder):
    return (c.center, c.radius, c.height, c.quaternion)
