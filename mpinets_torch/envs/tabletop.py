"""Procedural tabletop environments.

Port of ``mpinets_tpu/envs/tabletop.py``: its numpy code, copied, so that one
numpy seed draws the same scene in both packages; the candidates' IK runs
through :mod:`mpinets_torch.kernels.ik`.

Behavioral equivalent of the reference's ``TabletopEnvironment``
(``motion-policy-networks/mpinets/data_pipeline/environments/tabletop_environment.py:52-441``),
matching its *parameter distributions* (r3, VERDICT #7), not its code:

* L/l-shaped table layouts (``tabletop_environment.py:215-330``): a front
  table split into a task region (objects + candidates) and a clear region,
  an optional side table with the same split (p=0.5, the "L"), and a mount
  table under the robot base. Table height is 0 w.p. 0.35, else U(0, 0.4);
  slabs are solid blocks from z=-0.02 up to the surface.
* 3-14 objects (``gen_data.py:618``: ``np.random.randint(3, 15)``) placed by
  rejection sampling on the task surfaces with a 0.05 m clearance; object
  footprint is capped by the clearance actually available
  (``tabletop_environment.py:129-153, 404-441``): cylinder w.p. 0.3 (upright,
  radius in [0.05, min(min_sdf, 0.15)], height U(0.05, 0.35)), else cuboid
  with xy dims in the same range, z dim U(0.05, 0.35), yaw U(0, pi/2).
* Candidate poses above the task surfaces (``tabletop_environment.py:354-404``):
  the sampled point is raised to the top of any object it lands on, offset
  0.01-0.12 m with linearly-decreasing density, and oriented rpy with
  roll ~ U(3pi/4, 5pi/4), pitch ~ U(-pi/8, pi/8), yaw ~ U(-pi/2, pi/2).
"""

from __future__ import annotations

from typing import List

import numpy as np

from mpinets_torch.envs.base import Environment
from mpinets_torch import types
from mpinets_torch.types import Cuboid, Cylinder, Pose

#: Candidate offset above the support surface
#: (tabletop_environment.py:386: ``random_linear_decrease() * (0.12 - 0.01)
#: + 0.01``): linearly decreasing density over [0.01, 0.12] m.
CANDIDATE_Z_RANGE = (0.01, 0.12)
#: Object count range (gen_data.py:618, np.random.randint(3, 15)).
NUM_OBJECTS_RANGE = (3, 15)
#: Object footprint minimum / cap (tabletop_environment.py:152, 418).
OBJECT_DIM_MIN = 0.05
OBJECT_XY_CAP = 0.15
OBJECT_Z_RANGE = (0.05, 0.35)


def _height_biased(rng: np.random.Generator, lo: float, hi: float) -> float:
    """Linearly-decreasing density over [lo, hi]: p(h) ∝ (hi - h)
    (``random_linear_decrease``, tabletop_environment.py:43-49)."""
    u = rng.uniform()
    return float(lo + (hi - lo) * (1.0 - np.sqrt(u)))


def _slab(x0, x1, y0, y1, z, dim_z) -> Cuboid:
    return Cuboid(
        center=[(x0 + x1) / 2, (y0 + y1) / 2, z],
        dims=[abs(x1 - x0), abs(y1 - y0), dim_z],
        quaternion=[1.0, 0.0, 0.0, 0.0],
    )


class TabletopEnvironment(Environment):
    """Random L/l-shaped tables + scattered objects."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.task_tables: List[Cuboid] = []   # object/candidate region
        self.clear_tables: List[Cuboid] = []  # object-free slabs

    # -- scene ----------------------------------------------------------------
    def _setup_tables(self, rng: np.random.Generator) -> None:
        """Reference ``setup_tables`` distributions
        (tabletop_environment.py:215-330)."""
        height = 0.0 if rng.uniform() < 0.35 else rng.uniform(0.0, 0.4)
        z = (height - 0.02) / 2
        dim_z = height + 0.02

        front_x_min = rng.uniform(0.275, 0.375)
        front_x_max = rng.uniform(1.275, 1.375)
        front_y_max = rng.uniform(1.5, 1.65)
        has_side = rng.uniform() < 0.5
        front_y_min = (
            rng.uniform(-1.0, -0.75) if has_side else rng.uniform(-0.75, -0.55)
        )
        # task region: fraction U(0.55, 0.65) of the y extent at the y-min end
        frac = rng.uniform(0.55, 0.65)
        split_y = front_y_min + frac * (front_y_max - front_y_min)
        self.task_tables = [_slab(front_x_min, front_x_max,
                                  front_y_min, split_y, z, dim_z)]
        self.clear_tables = [_slab(front_x_min, front_x_max,
                                   split_y, front_y_max, z, dim_z)]

        if has_side:
            side_y_max = rng.uniform(-0.325, -0.275)
            side_y_min = front_y_min
            side_x_max = front_x_min
            side_x_min = side_x_max - rng.uniform(0.0, 1.375)
            # task region: fraction of the x extent at the x-max end
            sfrac = rng.uniform(0.55, 0.65)
            ssplit_x = side_x_max - sfrac * (side_x_max - side_x_min)
            self.task_tables.append(
                _slab(ssplit_x, side_x_max, side_y_min, side_y_max, z, dim_z)
            )
            self.clear_tables.append(
                _slab(side_x_min, ssplit_x, side_y_min, side_y_max, z, dim_z)
            )

        # mount table under the robot base (always at z = -0.01, thin)
        mount_x = rng.uniform(-0.02, 0.02)
        mount_y = rng.uniform(-0.02, 0.02)
        mount_xdim = 2.0 * (front_x_min - mount_x)
        mount_ydim = (
            2.0 * (mount_y - side_y_max) if has_side
            else rng.uniform(0.9, 0.94)
        )
        self.clear_tables.append(
            Cuboid(
                center=[mount_x, mount_y, -0.01],
                dims=[mount_xdim, mount_ydim, 0.02],
                quaternion=[1.0, 0.0, 0.0, 0.0],
            )
        )
        self.obstacles = list(self.task_tables) + list(self.clear_tables)

    def _surface_point(self, rng: np.random.Generator) -> np.ndarray:
        """Uniform point on a random TASK table top (area-weighted;
        ``random_points_on_table``, tabletop_environment.py:179-213)."""
        areas = np.array([t.dims[0] * t.dims[1] for t in self.task_tables])
        t = self.task_tables[
            rng.choice(len(self.task_tables), p=areas / areas.sum())
        ]
        x = t.center[0] + rng.uniform(-0.5, 0.5) * t.dims[0]
        y = t.center[1] + rng.uniform(-0.5, 0.5) * t.dims[1]
        return np.array([x, y, t.center[2] + t.dims[2] / 2])

    def _place_objects(self, rng: np.random.Generator, how_many: int) -> None:
        """Rejection placement on the task surfaces
        (``place_objects`` + ``random_object``,
        tabletop_environment.py:129-153,404-441): candidates whose point is
        within 0.05 m (SDF) of an existing object are rejected; accepted
        objects get their footprint capped by the free clearance."""
        objects: List = []
        for _ in range(10 * how_many):
            if len(objects) >= how_many:
                break
            p = self._surface_point(rng)
            min_sdf = 1000.0
            ok = True
            for o in objects:
                s = float(o.sdf(p))
                min_sdf = min(min_sdf, s)
                if s <= 0.05:
                    ok = False
            if not ok:
                continue
            xy_max = max(min(min_sdf, OBJECT_XY_CAP), OBJECT_DIM_MIN + 1e-4)
            if rng.uniform() < 0.3:
                r = rng.uniform(OBJECT_DIM_MIN, xy_max)
                h = rng.uniform(*OBJECT_Z_RANGE)
                objects.append(
                    Cylinder(
                        center=[p[0], p[1], p[2] + h / 2],
                        radius=r,
                        height=h,
                        quaternion=[1.0, 0.0, 0.0, 0.0],
                    )
                )
            else:
                dims = [
                    rng.uniform(OBJECT_DIM_MIN, xy_max),
                    rng.uniform(OBJECT_DIM_MIN, xy_max),
                    rng.uniform(*OBJECT_Z_RANGE),
                ]
                objects.append(
                    Cuboid(
                        center=[p[0], p[1], p[2] + dims[2] / 2],
                        dims=dims,
                        quaternion=_yaw_quat(rng.uniform(0, np.pi / 2)),
                    )
                )
        self.obstacles.extend(objects)
        self._objects = objects

    # -- candidates -----------------------------------------------------------
    def sample_candidate_poses(
        self, rng: np.random.Generator, how_many: int
    ) -> List[Pose]:
        """Poses above the task surfaces, matching the reference's
        ``gen_candidate`` (tabletop_environment.py:354-404)."""
        poses = []
        for _ in range(how_many):
            p = self._surface_point(rng)
            # Raise onto the top of any object under the sampled xy
            # (reference: o.sdf(p) <= 0.01 -> p.z := object top).
            for o in self._objects:
                if o.sdf(p) <= 0.01:
                    if isinstance(o, Cuboid):
                        p[2] = o.center[2] + o.dims[2] / 2
                    elif isinstance(o, Cylinder):
                        p[2] = o.center[2] + o.height / 2
            p[2] += _height_biased(rng, *CANDIDATE_Z_RANGE)
            roll = rng.uniform(3 * np.pi / 4, 5 * np.pi / 4)
            pitch = rng.uniform(-np.pi / 8, np.pi / 8)
            yaw = rng.uniform(-np.pi / 2, np.pi / 2)
            poses.append(Pose(p, _rpy_quat(roll, pitch, yaw)))
        return poses

    def gen(self, rng: np.random.Generator) -> bool:
        self._invalidate_scene()
        self._setup_tables(rng)
        self._place_objects(rng, int(rng.integers(*NUM_OBJECTS_RANGE)))
        self._invalidate_scene()
        # r5 scene-yield fix (VERDICT r4 #3: 43/100 usable scenes): one
        # 64-pose IK attempt often misses 2 free candidates because the task
        # table extends well past the arm's ~0.85 m reach, so most uniform
        # surface samples are unreachable. The reference retries up to 100
        # pose samples PER candidate (tabletop_environment.py:369); retrying
        # the batched attempt a few times recovers marginal scenes at the
        # cost of extra IK batches only.
        candidates: List = []
        for _ in range(5):
            candidates += self.gen_candidates(rng, 2 - len(candidates))
            if len(candidates) >= 2:
                self.demo_candidates = candidates[:2]
                return True
        return False


def _yaw_quat(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _rpy_quat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """wxyz quaternion from fixed-axis rpy (Rz @ Ry @ Rx, the geometrout
    ``SO3.from_rpy`` convention the reference uses)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return types.matrix_to_quat_np(rz @ ry @ rx)
