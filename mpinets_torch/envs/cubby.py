"""Procedural cubby environments.

Port of ``mpinets_tpu/envs/cubby.py``: its numpy code, copied, so that one
numpy seed draws the same scene in both packages; the candidates' IK runs
through :mod:`mpinets_torch.kernels.ik`.

Behavioral equivalent of the reference's ``CubbyEnvironment`` /
``MergedCubbyEnvironment``
(``motion-policy-networks/mpinets/data_pipeline/environments/cubby_environment.py:45-705``),
matching its parameter distributions (r3, VERDICT #7):

* Geometry (``cubby_environment.py:57-122``, ``radius_sample(c, r)`` =
  U(c-r, c+r)): left U(0.6, 0.8), right U(-0.8, -0.6), bottom U(0.1, 0.3),
  front U(0.45, 0.65), back = front + U(0.15, 0.55), top U(0.6, 0.8),
  middle shelf z U(0.35, 0.55), center wall y U(-0.1, 0.1), thickness
  U(0.01, 0.03), and a yaw of U(-10°, 10°) applied about the CABINET
  CENTER (``rotation_matrix``, ``cubby_environment.py:77-122``).
* Panels (``_unrotated_cuboids``, ``:124-264``): back wall, bottom/top
  shelves, side walls, center wall (dropped when its thickness is zeroed),
  middle shelf (likewise).
* Four pockets indexed so {0,1} share a z level and {0,2} share a y side;
  ``MergedCubbyEnvironment`` zeroes the middle shelf when start/target are
  vertically separated and the center wall when horizontally separated
  (``cubby_environment.py:660-704``), then reassigns supports.
* Candidates (``random_pose_and_config``, ``:505-549``): positions sampled
  in a pocket's support volume; approach axis z = [cosθ, sinθ, 0] with
  θ ~ U(-π/4, π/4) (into the open front), finger axis x = [0, 0, -1];
  solved by the batched collision-free IK.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from mpinets_torch.envs.base import (
    Environment,
    TaskOrientedCandidate,
    pose_from_xz_axes,
)
from mpinets_torch.types import Cuboid, Pose, matrix_to_quat_np

MAX_YAW = np.pi / 18.0  # cubby_environment.py:71


def _u(rng, center, radius):
    """radius_sample (base_environment.py)."""
    return float(rng.uniform(center - radius, center + radius))


@dataclasses.dataclass
class CubbyParams:
    """The reference's native cubby parameters (cubby_environment.py:62-72)."""

    left: float
    right: float
    bottom: float
    front: float
    back: float
    top: float
    mid_h_z: float
    mid_v_y: float
    thickness: float
    rotation: float
    #: zeroed by MergedCubbyEnvironment (cubby_environment.py:682-686)
    middle_shelf_thickness: float = None  # type: ignore[assignment]
    center_wall_thickness: float = None   # type: ignore[assignment]

    def __post_init__(self):
        if self.middle_shelf_thickness is None:
            self.middle_shelf_thickness = self.thickness
        if self.center_wall_thickness is None:
            self.center_wall_thickness = self.thickness

    @classmethod
    def random(cls, rng: np.random.Generator) -> "CubbyParams":
        front = _u(rng, 0.55, 0.1)
        return cls(
            left=_u(rng, 0.7, 0.1),
            right=_u(rng, -0.7, 0.1),
            bottom=_u(rng, 0.2, 0.1),
            front=front,
            back=front + _u(rng, 0.35, 0.2),
            top=_u(rng, 0.7, 0.1),
            mid_h_z=_u(rng, 0.45, 0.1),
            mid_v_y=_u(rng, 0.0, 0.1),
            thickness=_u(rng, 0.02, 0.01),
            rotation=_u(rng, 0.0, MAX_YAW),
        )

    @property
    def center(self) -> np.ndarray:
        return np.array(
            [
                (self.front + self.back) / 2,
                (self.left + self.right) / 2,
                (self.top + self.bottom) / 2,
            ]
        )

    def world_point(self, local: np.ndarray) -> np.ndarray:
        """Rotate a point about the cabinet-center yaw pivot
        (cubby_environment.py:77-122)."""
        c, s = np.cos(self.rotation), np.sin(self.rotation)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        pc = self.center
        return pc + rot @ (np.asarray(local) - pc)

    @property
    def quaternion(self) -> np.ndarray:
        c, s = np.cos(self.rotation), np.sin(self.rotation)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        return matrix_to_quat_np(rot)


class CubbyEnvironment(Environment):
    """2x2 cubby with the reference's randomized geometry."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.params: Optional[CubbyParams] = None

    # -- construction --------------------------------------------------------
    def _build(self) -> None:
        """Reference ``_unrotated_cuboids`` + center-pivot rotation
        (cubby_environment.py:124-264)."""
        p = self.params
        t = p.thickness
        mid_x = (p.front + p.back) / 2
        mid_y = (p.left + p.right) / 2
        mid_z = (p.top + p.bottom) / 2
        panels = [
            # back wall (spans z in [0, top])
            ([p.back, mid_y, p.top / 2], [t, p.left - p.right, p.top]),
            # bottom / top shelves
            ([mid_x, mid_y, p.bottom], [p.back - p.front, p.left - p.right, t]),
            ([mid_x, mid_y, p.top], [p.back - p.front, p.left - p.right, t]),
            # right / left side walls
            ([mid_x, p.right, mid_z],
             [p.back - p.front, t, (p.top - p.bottom) + t]),
            ([mid_x, p.left, mid_z],
             [p.back - p.front, t, (p.top - p.bottom) + t]),
        ]
        if not np.isclose(p.center_wall_thickness, 0.0):
            panels.append(
                ([mid_x, p.mid_v_y, mid_z],
                 [p.back - p.front, p.center_wall_thickness,
                  p.top - p.bottom + t])
            )
        if not np.isclose(p.middle_shelf_thickness, 0.0):
            panels.append(
                ([mid_x, mid_y, p.mid_h_z],
                 [p.back - p.front, p.left - p.right,
                  p.middle_shelf_thickness])
            )
        quat = p.quaternion
        self.obstacles = [
            Cuboid(center=p.world_point(c), dims=d, quaternion=quat)
            for c, d in panels
        ]

    def _pocket_bounds(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Local-frame (lo, hi) interiors. Index layout: {0,1} share a z
        level, {0,2} share a y side (matches the merged-variant tests in
        cubby_environment.py:679-686)."""
        p = self.params
        have_wall = not np.isclose(p.center_wall_thickness, 0.0)
        have_shelf = not np.isclose(p.middle_shelf_thickness, 0.0)
        ys = (
            [(p.right, p.mid_v_y), (p.mid_v_y, p.left)]
            if have_wall else [(p.right, p.left)]
        )
        zs = (
            [(p.bottom, p.mid_h_z), (p.mid_h_z, p.top)]
            if have_shelf else [(p.bottom, p.top)]
        )
        out = []
        for z0, z1 in zs:
            for y0, y1 in ys:
                out.append(
                    (
                        np.array([p.front, y0, z0]),
                        np.array([p.back, y1, z1]),
                    )
                )
        return out

    def support_volumes(self) -> List[Cuboid]:
        """Pocket interiors as world-frame cuboids
        (cubby_environment.py:266-431)."""
        p = self.params
        quat = p.quaternion
        out = []
        for lo, hi in self._pocket_bounds():
            out.append(
                Cuboid(
                    center=p.world_point((lo + hi) / 2),
                    dims=hi - lo,
                    quaternion=quat,
                )
            )
        return out

    # -- candidates ----------------------------------------------------------
    def _pocket_poses(
        self, rng: np.random.Generator, pocket: int, how_many: int,
        margin: float = 0.05,
    ) -> List[Pose]:
        """Horizontal-approach poses inside one pocket (margin-shrunk so the
        conservative sphere IK accepts; reference instead rejection-samples
        against mesh collision, cubby_environment.py:528-546)."""
        lo, hi = self._pocket_bounds()[pocket]
        lo = lo + np.array([margin, 0.02 + self.params.thickness / 2,
                            0.02 + self.params.thickness / 2])
        hi = hi - np.array([margin, 0.02 + self.params.thickness / 2,
                            0.02 + self.params.thickness / 2])
        if np.any(hi <= lo):
            return []
        poses = []
        for _ in range(how_many):
            local = rng.uniform(lo, hi)
            world = self.params.world_point(local)
            # World-frame approach into the cubby (+x), finger axis down:
            # z = [cosθ, sinθ, 0], θ ~ U(-π/4, π/4), x = [0, 0, -1]
            # (cubby_environment.py:528-537; θ is sampled in the world frame
            # regardless of the cabinet yaw, as in the reference).
            theta = rng.uniform(-np.pi / 4, np.pi / 4)
            z = np.array([np.cos(theta), np.sin(theta), 0.0])
            poses.append(pose_from_xz_axes([0.0, 0.0, -1.0], z, world))
        return poses

    def sample_candidate_poses(
        self, rng: np.random.Generator, how_many: int
    ) -> List[Pose]:
        pockets = list(range(len(self._pocket_bounds())))
        poses = []
        for _ in range(how_many):
            poses.extend(self._pocket_poses(rng, int(rng.choice(pockets)), 1))
        return poses

    def _candidate_in_pocket(
        self, rng: np.random.Generator, pocket: int
    ) -> Optional[TaskOrientedCandidate]:
        poses = self._pocket_poses(rng, pocket, 64)
        if not poses:
            return None
        saved = self.sample_candidate_poses
        try:
            self.sample_candidate_poses = lambda r, n: poses[:n]  # type: ignore
            got = self.gen_candidates(rng, 1, oversample=len(poses))
        finally:
            self.sample_candidate_poses = saved  # type: ignore
        return got[0] if got else None

    def gen(self, rng: np.random.Generator) -> bool:
        """Reference ``_gen`` (cubby_environment.py:440-503): shuffle pockets,
        pick start/target candidates from two different pockets, negative
        volumes = the other pockets' supports."""
        self._invalidate_scene()
        self.params = CubbyParams.random(rng)
        self._build()
        self._invalidate_scene()
        supports = self.support_volumes()
        order = list(rng.permutation(len(supports)))
        for ii, i in enumerate(order):
            start = self._candidate_in_pocket(rng, int(i))
            if start is None:
                continue
            for j in order[ii + 1:]:
                target = self._candidate_in_pocket(rng, int(j))
                if target is not None:
                    start.negative_volumes = [
                        s for k, s in enumerate(supports) if k != i
                    ]
                    target.negative_volumes = [
                        s for k, s in enumerate(supports) if k != j
                    ]
                    self.demo_candidates = [start, target]
                    self._pockets_chosen = (int(i), int(j))
                    return True
        return False


class MergedCubbyEnvironment(CubbyEnvironment):
    """Cubby whose internal dividers between the start and target pockets
    are removed after candidate selection (cubby_environment.py:660-704)."""

    def gen(self, rng: np.random.Generator) -> bool:
        if not super().gen(rng):
            return False
        i, j = self._pockets_chosen
        p = self.params
        # {0,1} share a z level; {2,3} the other: vertical separation drops
        # the middle shelf. {0,2} share a y side: horizontal separation drops
        # the center wall.
        if (i in (0, 1)) != (j in (0, 1)):
            p.middle_shelf_thickness = 0.0
        if (i in (0, 2)) != (j in (0, 2)):
            p.center_wall_thickness = 0.0
        self._build()
        self._invalidate_scene()
        # Reassign supports: both candidates must land in the same merged
        # pocket (reference asserts this, cubby_environment.py:688-696).
        supports = self.support_volumes()
        for cand in self.demo_candidates:
            own = [
                k for k, s in enumerate(supports)
                if s.sdf(cand.pose.position) < 0
            ]
            k = own[0] if own else 0
            cand.negative_volumes = [
                s for m, s in enumerate(supports) if m != k
            ]
        return True
