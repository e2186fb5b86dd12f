"""Procedural dresser environments.

Port of ``mpinets_tpu/envs/dresser.py``: its numpy code, copied, so that one
numpy seed draws the same scene in both packages; the candidates' IK runs
through :mod:`mpinets_torch.kernels.ik`.

Behavioral equivalent of the reference's ``DresserEnvironment``
(``motion-policy-networks/mpinets/data_pipeline/environments/dresser_environment.py:78-1436``),
matching its parameter distributions (r3, VERDICT #7):

* Dimensions and placement (``_gen_dresser``, ``:198-223``): width
  U(0.8, 1.2), depth U(0.2, 0.4), height U(0.55, 0.85); world offset
  x U(0.55, 0.75), y U(-0.1, 0.1); facing yaw varies +-60 deg
  (``radius_sample(pi/2, pi/3)`` on their axes convention).
* Recursive front splitting (``_split``, ``:967-1085``): split w.p. 0.7
  decaying x0.8 per level, midpoint splits, direction coin flip forced by
  the 0.3 m minimum size, 0.01 m internal walls; each leaf becomes a
  drawer (frontboard 0.019 m, drawer walls 0.004 m, box depth = 0.9 x
  dresser depth, full-height sides — ``_add_drawer``, ``:1281-1406``).
* Body boards (``_add_body``, ``:1144-1224``): top/bottom/sides/back at
  0.01 m thickness.
* Scene protocol (``_gen``, ``:83-176``): needs >= 2 drawers; the start and
  target drawers are pulled FULLY open (prismatic upper = 0.9 x box depth,
  ``open_drawer``/``:410-421``), all others closed; candidates live inside
  the open drawers' interiors with straight-down approach and horizontal
  finger axis within +-45 deg (``random_pose_and_config``, ``:470-499``).

The reference assembles a URDF with prismatic joints and labels containment
via trimesh ray casting; neither is needed here — parameters are sampled
once, and ``_assemble`` deterministically constructs the cuboid set, with
open drawers translated along the front axis.
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
from mpinets_torch.types import Cuboid, Pose

#: Reference split parameters (dresser_environment.py:632-634, 967-1085).
SPLIT_PROB = 0.7
SPLIT_DECAY = 0.8
MIN_CELL = 0.3
WALL = 0.01
FRONTBOARD = 0.019
DRAWER_WALL = 0.004
#: prismatic travel = 0.9 x drawer box depth (dresser_environment.py:1398).
OPEN_TRAVEL = 0.9


def _yaw_quat(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@dataclasses.dataclass
class Drawer:
    """One drawer leaf in the dresser's local frame (+x = front, z up)."""

    y0: float
    y1: float
    z0: float
    z1: float
    open_frac: float = 0.0  # 0 = closed, 1 = full prismatic travel


class DresserEnvironment(Environment):
    """Recursively-split dresser, start/target drawers pulled open."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.drawers: List[Drawer] = []
        self.walls: List[Tuple[np.ndarray, np.ndarray]] = []  # (center, dims)
        self.width = 1.0
        self.height = 0.7
        self.depth = 0.3
        self.yaw = np.pi
        self.origin = np.zeros(3)

    # -- construction ---------------------------------------------------------
    def _split(self, rng, y0, y1, z0, z1, prob) -> None:
        """Reference recursive midpoint splitting
        (dresser_environment.py:967-1085)."""
        w = y1 - y0
        h = z1 - z0
        do_split = rng.random() < prob
        if w < MIN_CELL and h < MIN_CELL:
            do_split = False
        if not do_split:
            self.drawers.append(Drawer(y0, y1, z0, z1))
            return
        vertical = rng.random() < 0.5
        if w < MIN_CELL:
            vertical = False
        if h < MIN_CELL:
            vertical = True
        p = prob * SPLIT_DECAY
        if vertical:  # wall splits the width at the midpoint
            mid = (y0 + y1) / 2
            self.walls.append(
                (np.array([0.0, mid, (z0 + z1) / 2]),
                 np.array([self.depth, WALL, h]))
            )
            self._split(rng, y0, mid - WALL / 2, z0, z1, p)
            self._split(rng, mid + WALL / 2, y1, z0, z1, p)
        else:  # shelf splits the height at the midpoint
            mid = (z0 + z1) / 2
            self.walls.append(
                (np.array([0.0, (y0 + y1) / 2, mid]),
                 np.array([self.depth, w, WALL]))
            )
            self._split(rng, y0, y1, z0, mid - WALL / 2, p)
            self._split(rng, y0, y1, mid + WALL / 2, z1, p)

    def _sample(self, rng: np.random.Generator) -> None:
        """Reference dimension/placement distributions
        (dresser_environment.py:198-223)."""
        self.width = float(rng.uniform(0.8, 1.2))
        self.depth = float(rng.uniform(0.2, 0.4))
        self.height = float(rng.uniform(0.55, 0.85))
        # Our local frame: +x = front (toward the robot at yaw = pi).
        # Reference: radius_sample(pi/2, pi/3) on its own axes = the facing
        # direction varies +-60 deg around head-on.
        self.yaw = np.pi + float(rng.uniform(-np.pi / 3, np.pi / 3))
        self.origin = np.array(
            [float(rng.uniform(0.55, 0.75)) + self.depth / 2,
             float(rng.uniform(-0.1, 0.1)), 0.0]
        )
        self.drawers = []
        self.walls = []
        self._split(rng, -self.width / 2, self.width / 2,
                    0.0, self.height, SPLIT_PROB)

    def _local_to_world(self, v) -> np.ndarray:
        return self.origin + _rot_z(self.yaw) @ np.asarray(v, dtype=np.float64)

    def _panel(self, center_local, dims) -> Cuboid:
        return Cuboid(
            center=self._local_to_world(center_local),
            dims=np.asarray(dims, dtype=np.float64),
            quaternion=_yaw_quat(self.yaw),
        )

    def _assemble(self) -> None:
        """Build the cuboid set: body boards, internal walls, and per-drawer
        boxes (front/bottom/sides/back), open drawers translated +x."""
        d, w, h = self.depth, self.width, self.height
        t = WALL
        obstacles = [
            self._panel([0.0, 0.0, -t / 2], [d, w, t]),                  # bottom
            self._panel([0.0, 0.0, h + t / 2], [d, w, t]),               # top
            self._panel([0.0, w / 2 + t / 2, h / 2], [d, t, h + 2 * t]),  # side
            self._panel([0.0, -w / 2 - t / 2, h / 2], [d, t, h + 2 * t]),  # side
            self._panel([-d / 2 + t / 2, 0.0, h / 2],
                        [t, w + 2 * t, h + 2 * t]),                       # back
        ]
        for center, dims in self.walls:
            obstacles.append(self._panel(center, dims))

        box_d = d * 0.9
        for dr in self.drawers:
            cy = (dr.y0 + dr.y1) / 2
            cz = (dr.z0 + dr.z1) / 2
            cw = dr.y1 - dr.y0
            ch = dr.z1 - dr.z0
            pull = dr.open_frac * OPEN_TRAVEL * box_d
            # front board sits just outside the front face
            obstacles.append(
                self._panel([d / 2 + pull + FRONTBOARD / 2, cy, cz],
                            [FRONTBOARD, cw, ch])
            )
            if dr.open_frac > 0.0:
                # the drawer box: bottom, two full-height sides, back
                bx = d / 2 + pull - box_d / 2  # box center x when pulled
                obstacles.extend(
                    [
                        self._panel(
                            [bx, cy, dr.z0 + DRAWER_WALL / 2],
                            [box_d, cw - 2 * DRAWER_WALL, DRAWER_WALL],
                        ),
                        self._panel(
                            [bx, dr.y0 + DRAWER_WALL / 2, cz],
                            [box_d, DRAWER_WALL, ch],
                        ),
                        self._panel(
                            [bx, dr.y1 - DRAWER_WALL / 2, cz],
                            [box_d, DRAWER_WALL, ch],
                        ),
                        self._panel(
                            [d / 2 + pull - box_d + DRAWER_WALL / 2, cy, cz],
                            [DRAWER_WALL, cw, ch],
                        ),
                    ]
                )
        self.obstacles = obstacles
        self._invalidate_scene()

    # -- queries ----------------------------------------------------------------
    def open_drawers(self) -> List[Drawer]:
        return [d for d in self.drawers if d.open_frac > 0.0]

    def _drawer_interior(self, dr: Drawer):
        """Local (lo, hi) of the open part of a drawer's interior."""
        d = self.depth
        box_d = d * 0.9
        pull = dr.open_frac * OPEN_TRAVEL * box_d
        lo = np.array(
            [d / 2 + 0.02, dr.y0 + 2 * DRAWER_WALL, dr.z0 + 2 * DRAWER_WALL]
        )
        hi = np.array(
            [d / 2 + pull - 0.02, dr.y1 - 2 * DRAWER_WALL,
             dr.z0 + (dr.z1 - dr.z0)]
        )
        return lo, hi

    def support_volumes(self) -> List[Cuboid]:
        """Interior volumes of the open drawers
        (dresser_environment.py:434-468)."""
        out = []
        for dr in self.open_drawers():
            lo, hi = self._drawer_interior(dr)
            if np.any(hi <= lo):
                continue
            out.append(
                Cuboid(
                    center=self._local_to_world((lo + hi) / 2),
                    dims=hi - lo,
                    quaternion=_yaw_quat(self.yaw),
                )
            )
        return out

    def _drawer_poses(
        self, rng: np.random.Generator, dr: Drawer, how_many: int
    ) -> List[Pose]:
        """Straight-down poses inside one open drawer
        (dresser_environment.py:470-499): approach z = [0, 0, -1], finger
        axis x = [cos t, sin t, 0], t ~ U(-pi/4, pi/4) about the dresser
        facing."""
        lo, hi = self._drawer_interior(dr)
        lo = lo + np.array([0.01, 0.01, 0.04])
        hi = hi - np.array([0.01, 0.01, 0.0])
        hi[2] = dr.z0 + (dr.z1 - dr.z0) * 0.9
        if np.any(hi <= lo):
            return []
        poses = []
        for _ in range(how_many):
            local = rng.uniform(lo, hi)
            # world-frame wrist angle, as in the reference (theta is NOT
            # rotated with the dresser: radius_sample(0, pi/4), :481-491)
            theta = rng.uniform(-np.pi / 4, np.pi / 4)
            x_axis = np.array([np.cos(theta), np.sin(theta), 0.0])
            poses.append(
                pose_from_xz_axes(
                    x_axis, [0.0, 0.0, -1.0], self._local_to_world(local)
                )
            )
        return poses

    def sample_candidate_poses(
        self, rng: np.random.Generator, how_many: int
    ) -> List[Pose]:
        drawers = self.open_drawers()
        if not drawers:
            return []
        poses = []
        for _ in range(how_many):
            poses.extend(
                self._drawer_poses(rng, drawers[rng.integers(len(drawers))], 1)
            )
        return poses

    def _candidate_in_drawer(
        self, rng: np.random.Generator, dr: Drawer
    ) -> Optional[TaskOrientedCandidate]:
        poses = self._drawer_poses(rng, dr, 64)
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
        """Reference ``_gen`` protocol (dresser_environment.py:83-176): pick
        a start and a target drawer (both pulled fully open), candidates
        inside each; other drawers stay closed."""
        self._sample(rng)
        if len(self.drawers) < 2:  # reference rejects single-drawer dressers
            return False
        order = list(rng.permutation(len(self.drawers)))
        for ii, i in enumerate(order):
            self.drawers[i].open_frac = 1.0
            self._assemble()
            start = self._candidate_in_drawer(rng, self.drawers[i])
            if start is None:
                self.drawers[i].open_frac = 0.0
                continue
            for j in order[ii + 1:]:
                self.drawers[j].open_frac = 1.0
                self._assemble()
                target = self._candidate_in_drawer(rng, self.drawers[j])
                if target is None:
                    self.drawers[j].open_frac = 0.0
                    continue
                supports = self.support_volumes()
                start.negative_volumes = supports[1:2]
                target.negative_volumes = supports[0:1]
                self.demo_candidates = [start, target]
                return True
            self.drawers[i].open_frac = 0.0
        return False
