"""Environment-generation protocol: procedural scenes and pose/config
candidate pairs.

Port of ``mpinets_tpu/envs/base.py``, the counterpart of the reference's
``Environment`` ABC
(``motion-policy-networks/mpinets/data_pipeline/environments/base_environment.py:36-205``).
The reference generates candidates one at a time with IKFast and a PyBullet
collision check; here every environment builds its scene with plain numpy
(copied from the JAX package, so one numpy seed draws the same scene) and
then solves *batches* of candidate poses with the multi-seed DLS IK
(:mod:`mpinets_torch.kernels.ik`) on the environment's device, filtered by
the 57-sphere scene/self collision model there.

Protocol (mirrors base_environment.py):

* ``gen(rng)`` -> bool: build a random scene and one demonstration candidate
  pair; on success ``obstacles``/``cuboids``/``cylinders`` and
  ``demo_candidates`` (2 task-oriented candidates) are set.
* ``gen_additional_candidate_sets(n, rng)`` -> list of candidate lists.
* ``gen_neutral_candidates(n, rng)`` -> collision-free neutral-pose
  candidates sampled in free configuration space.

``Environment(device=None)`` runs on ``cuda`` and raises without a card;
``device="cpu"`` runs the same code on the CPU. Each candidate batch is read
back to the host once.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import List, Optional, Sequence

import numpy as np
import torch

from mpinets_torch import types
from mpinets_torch.geom.scene import SceneSet, pack_scenes
from mpinets_torch.kernels import ik, kinematics
from mpinets_torch.robot import franka
from mpinets_torch.types import Cuboid, Cylinder, Pose
from mpinets_torch.utils.device import resolve_device


@dataclasses.dataclass
class Candidate:
    """A pose/config pair (base_environment.py:46-58)."""

    pose: Pose
    config: np.ndarray  # [7]
    negative_volumes: List[types.Primitive] = dataclasses.field(
        default_factory=list
    )


class TaskOrientedCandidate(Candidate):
    """Candidate attached to a task surface/volume (base_environment.py:62)."""


@dataclasses.dataclass
class NeutralCandidate(Candidate):
    """Candidate drawn from free configuration space
    (base_environment.py:68-75)."""


def radius_sample(rng: np.random.Generator, center: float, radius: float) -> float:
    """Uniform sample in [center - radius, center + radius]
    (base_environment.py ``radius_sample``)."""
    return float(rng.uniform(center - radius, center + radius))


def pose_from_z_axis(
    z_axis: np.ndarray, position: np.ndarray, yaw: float = 0.0
) -> Pose:
    """Build an EE pose whose approach (+z) axis is ``z_axis``, rotated by
    ``yaw`` about that axis: the down/horizontal-pointing gripper poses the
    environments need without any URDF machinery."""
    z = np.asarray(z_axis, dtype=np.float64)
    z = z / np.linalg.norm(z)
    helper = np.array([1.0, 0.0, 0.0]) if abs(z[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = np.cross(helper, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z], axis=-1)
    c, s = np.cos(yaw), np.sin(yaw)
    rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return Pose(position, types.matrix_to_quat_np(rot @ rz))


def pose_from_xz_axes(
    x_axis: np.ndarray, z_axis: np.ndarray, position: np.ndarray
) -> Pose:
    """Build a pose from fully-specified gripper x (finger) and z (approach)
    axes, with y = z × x — the frame construction the reference's cubby/
    dresser candidate samplers use (``SE3.from_unit_axes``,
    ``cubby_environment.py:532-541``)."""
    x = np.asarray(x_axis, dtype=np.float64)
    z = np.asarray(z_axis, dtype=np.float64)
    x = x / np.linalg.norm(x)
    z = z / np.linalg.norm(z)
    y = np.cross(z, x)
    rot = np.stack([x, y, z], axis=-1)
    return Pose(position, types.matrix_to_quat_np(rot))


class Environment(ABC):
    """Procedural scene + candidate generator on one device."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.obstacles: List[types.Primitive] = []
        self.demo_candidates: List[TaskOrientedCandidate] = []
        self._scene_cache: Optional[SceneSet] = None
        #: candidate-IK rejection funnel (scene-yield diagnostics): pose
        #: proposals -> accurate IK solves -> collision-free solves ->
        #: candidates kept (capped by the request size).
        self.funnel = {"poses": 0, "ik_solved": 0, "free": 0, "kept": 0}

    # -- scene access (base_environment.py obstacle properties) -------------
    @property
    def cuboids(self) -> List[Cuboid]:
        return [o for o in self.obstacles if isinstance(o, Cuboid)]

    @property
    def cylinders(self) -> List[Cylinder]:
        return [o for o in self.obstacles if isinstance(o, Cylinder)]

    #: Optional fixed (max_cuboids, max_cylinders) padding for this family,
    #: so that every scene of the family has one padded shape. None keeps
    #: the per-scene multiple-of-8 bucketing.
    SCENE_PAD: Optional[tuple] = None

    def scene_set(self) -> SceneSet:
        """The padded SceneSet of this scene on the environment's device,
        batch 1 (cached)."""
        if self._scene_cache is None:
            pad = self.SCENE_PAD or (None, None)
            self._scene_cache = pack_scenes(
                [[types.cuboid_tuple(c) for c in self.cuboids]],
                [[types.cylinder_tuple(c) for c in self.cylinders]],
                max_cuboids=pad[0],
                max_cylinders=pad[1],
                device=self.device,
            )
        return self._scene_cache

    def _unbatched_scene(self) -> SceneSet:
        # the SDF broadcasts an unbatched scene over the pose batch
        return SceneSet(*(t[0] for t in self.scene_set()))

    def _invalidate_scene(self) -> None:
        self._scene_cache = None

    # -- generation protocol -------------------------------------------------
    @abstractmethod
    def gen(self, rng: np.random.Generator) -> bool:
        """Generate a scene + a demonstration candidate pair."""

    @abstractmethod
    def sample_candidate_poses(
        self, rng: np.random.Generator, how_many: int
    ) -> List[Pose]:
        """Propose task-oriented EE poses for this scene (pre-IK)."""

    def gen_candidates(
        self, rng: np.random.Generator, how_many: int,
        negative_volumes: Optional[Sequence[types.Primitive]] = None,
        oversample: int = 32,
    ) -> List[TaskOrientedCandidate]:
        """Batched IK over proposed poses; keep the collision-free solves.

        Proposes ``oversample * how_many`` poses, solves them in one batch,
        and returns up to ``how_many`` feasible candidates. The oversample is
        generous because the 57-sphere collision model is conservative
        against the reference's mesh checks (the reference tries up to 100
        samples per candidate, ``tabletop_environment.py:369``).
        """
        poses = self.sample_candidate_poses(rng, oversample * how_many)
        if not poses:
            return []
        rot = np.stack([p.matrix[:3, :3] for p in poses])
        trans = np.stack([p.position for p in poses])
        seed = int(rng.integers(0, 2**31 - 1))
        res = ik.collision_free_ik(
            seed,
            torch.as_tensor(rot.astype(np.float32), device=self.device),
            torch.as_tensor(trans.astype(np.float32), device=self.device),
            self._unbatched_scene(),
        )
        # one copy to the host: q, ok, pos_err, ori_err
        host = torch.cat([res.q, res.converged[:, None].to(res.q.dtype),
                          res.pos_err[:, None], res.ori_err[:, None]], dim=1).cpu().numpy()
        qs, ok = host[:, :7], host[:, 7] > 0.5
        # funnel accounting: IK accuracy vs collision acceptance split.
        # `converged` requires accurate AND free; an accurate-but-colliding
        # best solution shows up in the accuracy tally only.
        accurate = (host[:, 8] < ik.POS_TOL) & (host[:, 9] < ik.ORI_TOL)
        self.funnel["poses"] += len(poses)
        self.funnel["ik_solved"] += int(accurate.sum())
        self.funnel["free"] += int(ok.sum())
        self.funnel["kept"] += int(min(ok.sum(), how_many))
        out: List[TaskOrientedCandidate] = []
        for i in np.nonzero(ok)[0]:
            if len(out) >= how_many:
                break
            out.append(
                TaskOrientedCandidate(
                    pose=poses[i],
                    config=qs[i].astype(np.float64),
                    negative_volumes=list(negative_volumes or []),
                )
            )
        return out

    def gen_additional_candidate_sets(
        self, how_many: int, rng: np.random.Generator
    ) -> List[List[TaskOrientedCandidate]]:
        """``how_many`` independent candidate sets (base_environment.py
        ``gen_additional_candidate_sets``)."""
        return [self.gen_candidates(rng, 10) for _ in range(how_many)]

    def gen_neutral_candidates(
        self, how_many: int, rng: np.random.Generator
    ) -> List[NeutralCandidate]:
        """Collision-free samples around the neutral pose
        (base_environment.py ``gen_neutral_candidates``): random
        configurations biased toward the neutral posture, accepted when the
        sphere model clears the scene by 1 cm."""
        n_try = 8 * how_many
        limits = franka.REAL_JOINT_LIMITS
        span = limits[:, 1] - limits[:, 0]
        qs = franka.NEUTRAL_Q + rng.normal(0.0, 0.25, size=(n_try, 7)) * span / 4
        qs = np.clip(qs, limits[:, 0], limits[:, 1]).astype(np.float32)

        q = torch.as_tensor(qs, device=self.device)
        free = ik.franka_free_space(q, self._unbatched_scene(), margin=0.01)
        rots, transs = kinematics.eff_pose(q)
        # one copy to the host: free, rotation, translation
        host = torch.cat([free[:, None].to(rots.dtype), rots.reshape(n_try, 9), transs],
                         dim=1).cpu().numpy()
        out: List[NeutralCandidate] = []
        for i in np.nonzero(host[:, 0] > 0.5)[0]:
            if len(out) >= how_many:
                break
            out.append(
                NeutralCandidate(
                    pose=Pose(
                        host[i, 10:13].astype(np.float64),
                        types.matrix_to_quat_np(host[i, 1:10].reshape(3, 3).astype(np.float64)),
                    ),
                    config=qs[i].astype(np.float64),
                )
            )
        return out
