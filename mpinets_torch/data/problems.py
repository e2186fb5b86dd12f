"""Problem-set (``.pkl``) loading and batching.

Port of ``mpinets_tpu/data/problems.py``. The reference evaluates on
pickled ``ProblemSet`` dictionaries (scene_type -> problem_type ->
[PlanningProblem]) whose leaves are ``geometrout`` SE3/Cuboid/Cylinder
objects and ``mpinets.mpinets_types.PlanningProblem`` dataclasses
(``run_inference.py:460-468``). Neither package is installed, so
:func:`load_problems` reads them with an unpickler whose ``find_class``
maps those classes to minimal shims (stub classes that capture the pickled
``__dict__``), and the JAX package's own ``mpinets_tpu.types`` objects to
:mod:`mpinets_torch.types`, without importing either package and without
touching ``sys.modules``. Everything is converted to
:mod:`mpinets_torch.types` objects at load time, and
:func:`problems_to_batch` packs a list of problems into padded batches for
the lockstep rollout engine and the evaluator.

A pickle of :mod:`mpinets_torch.types` objects (:func:`save_problems`)
names this package's classes, so the JAX package cannot read it: the
mapping goes one way.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mpinets_torch import types as T
from mpinets_torch.data.synthetic import Problem
from mpinets_torch.geom.scene import SceneSet, pack_scenes


# ---------------------------------------------------------------------------
# Unpickling shims
# ---------------------------------------------------------------------------

class _ShimBase:
    """Captures pickled state; attribute access falls through to the raw
    dict with and without a leading underscore."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (dict-state, slots-state)
            merged = {}
            for part in state:
                if part:
                    merged.update(part)
            state = merged
        self.__dict__.update(state or {})

    def _get(self, *names):
        for n in names:
            if n in self.__dict__:
                return self.__dict__[n]
            if "_" + n in self.__dict__:
                return self.__dict__["_" + n]
        raise AttributeError(f"{type(self).__name__} has none of {names}: "
                             f"{sorted(self.__dict__)}")


class _ShimQuaternion(_ShimBase):
    """pyquaternion.Quaternion stand-in (geometrout's SO3 stores one)."""

    @property
    def elements(self):
        return np.asarray(self._get("q", "elements", "wxyz"), np.float64).reshape(4)


class _ShimSO3(_ShimBase):
    @property
    def wxyz(self):
        q = self._get("quat", "quaternion", "wxyz", "q")
        return np.asarray(getattr(q, "elements", q), np.float64).reshape(4)


class _ShimSE3(_ShimBase):
    @property
    def xyz(self):
        return np.asarray(self._get("xyz", "position", "pos"), np.float64).reshape(3)

    @property
    def so3(self):
        rot = self._get("so3", "rotation", "quat", "quaternion")
        if isinstance(rot, _ShimSO3):
            return rot
        shim = _ShimSO3()
        shim.__dict__["quat"] = rot
        return shim


class _ShimCuboid(_ShimBase):
    pass


class _ShimCylinder(_ShimBase):
    pass


class _ShimSphere(_ShimBase):
    pass


class _ShimPlanningProblem(_ShimBase):
    pass


#: (module, class) of the reference's pickles -> the shim that reads it.
_SHIMS = {
    ("geometrout.transform", "SE3"): _ShimSE3,
    ("geometrout.transform", "SO3"): _ShimSO3,
    ("geometrout.primitive", "Cuboid"): _ShimCuboid,
    ("geometrout.primitive", "Cylinder"): _ShimCylinder,
    ("geometrout.primitive", "Sphere"): _ShimSphere,
    ("mpinets.mpinets_types", "PlanningProblem"): _ShimPlanningProblem,
    ("pyquaternion", "Quaternion"): _ShimQuaternion,
    ("pyquaternion.quaternion", "Quaternion"): _ShimQuaternion,
}
#: The JAX package's problem types (its ``save_problems`` pickles), read as
#: the port's classes of the same names.
_JAX_TYPES = "mpinets_tpu.types"


class _ProblemUnpickler(pickle.Unpickler):
    """Reads reference and JAX-package problem pickles into shims and
    :mod:`mpinets_torch.types` classes; every other class as pickle does."""

    def find_class(self, module, name):
        if (module, name) in _SHIMS:
            return _SHIMS[module, name]
        if module == _JAX_TYPES:
            return getattr(T, name)
        if module.split(".")[0] in ("geometrout", "pyquaternion", "mpinets"):
            raise pickle.UnpicklingError(f"no shim for {module}.{name}")
        return super().find_class(module, name)


def _pose_of(obj) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz, wxyz) of a shim or real SE3."""
    if isinstance(obj, _ShimSE3):
        return obj.xyz, obj.so3.wxyz
    if hasattr(obj, "xyz") and hasattr(obj, "so3"):
        so3 = obj.so3
        q = getattr(so3, "wxyz", None)
        if q is None:
            q = np.asarray(so3._quat.elements)
        return np.asarray(obj.xyz, np.float64), np.asarray(q, np.float64)
    raise TypeError(f"cannot extract a pose from {type(obj)}")


def _primitive_pose(shim: _ShimBase) -> Tuple[np.ndarray, np.ndarray]:
    d = shim.__dict__
    if "pose" in d or "_pose" in d:
        return _pose_of(shim._get("pose"))
    center = np.asarray(shim._get("center", "xyz"), np.float64).reshape(3)
    try:
        quat = np.asarray(shim._get("quaternion", "wxyz", "quat"), np.float64)
    except AttributeError:
        quat = np.array([1.0, 0.0, 0.0, 0.0])
    return center, quat.reshape(4)


def _convert_primitive(obj):
    if isinstance(obj, (T.Cuboid, T.Cylinder, T.Sphere)):
        return obj
    if isinstance(obj, _ShimCuboid):
        center, quat = _primitive_pose(obj)
        return T.Cuboid(center, np.asarray(obj._get("dims"), np.float64), quat)
    if isinstance(obj, _ShimCylinder):
        center, quat = _primitive_pose(obj)
        return T.Cylinder(center, float(obj._get("radius")), float(obj._get("height")), quat)
    if isinstance(obj, _ShimSphere):
        center, _ = _primitive_pose(obj)
        return T.Sphere(center, float(obj._get("radius")))
    raise TypeError(f"unknown primitive {type(obj)}")


def _convert_problem(obj) -> T.PlanningProblem:
    if isinstance(obj, T.PlanningProblem):
        return obj
    d = obj.__dict__
    xyz, wxyz = _pose_of(d["target"])
    return T.PlanningProblem(
        target=T.Pose(xyz, wxyz),
        target_volume=_convert_primitive(d["target_volume"]),
        q0=np.asarray(d["q0"], np.float64).reshape(-1),
        obstacles=(
            [_convert_primitive(o) for o in d["obstacles"]]
            if d.get("obstacles") is not None
            else None
        ),
        obstacle_point_cloud=d.get("obstacle_point_cloud"),
        target_negative_volumes=[
            _convert_primitive(o) for o in d.get("target_negative_volumes", [])
        ],
    )


def load_problems(path) -> T.ProblemSet:
    """Load a problem-set pickle -- the reference's, the JAX package's or
    this package's -- into :mod:`mpinets_torch.types` objects."""
    with open(path, "rb") as f:
        raw = _ProblemUnpickler(f).load()
    return {
        scene_type: {
            problem_type: [_convert_problem(p) for p in problems]
            for problem_type, problems in by_type.items()
        }
        for scene_type, by_type in raw.items()
    }


def save_problems(path, problem_set: T.ProblemSet) -> None:
    with open(path, "wb") as f:
        pickle.dump(problem_set, f)


# ---------------------------------------------------------------------------
# Batching for the rollout engine / evaluator
# ---------------------------------------------------------------------------

def _volume_scene(volumes_per_problem: Sequence[Sequence[T.Primitive]],
                  device=None) -> SceneSet:
    cuboids, cylinders = [], []
    for vols in volumes_per_problem:
        cubs, cyls = T.split_obstacles(list(vols))
        cuboids.append([T.cuboid_tuple(c) for c in cubs])
        cylinders.append([T.cylinder_tuple(c) for c in cyls])
    return pack_scenes(cuboids, cylinders, device=device)


def problems_to_batch(problems: List[T.PlanningProblem], device=None) -> Dict[str, object]:
    """Pack problems into padded batches on ``device``: the rollout
    ``Problem`` plus target / negative volume SceneSets for an evaluator.

    Raw-point-cloud problems (the reference's depth mode,
    ``run_inference.py:58-134``) get their sensed clouds packed to one size
    by resampling with replacement (numpy, seed 0, as the JAX package); all
    problems of a batch must agree on whether they carry a cloud.
    """
    q0 = np.stack([p.q0 for p in problems]).astype(np.float32)
    target_trans = np.stack([p.target.position for p in problems])
    target_rot = T.quat_to_matrix_np(np.stack([p.target.quaternion for p in problems]))
    scene = _volume_scene([p.obstacles or [] for p in problems], device)
    target_volumes = _volume_scene([[p.target_volume] for p in problems], device)
    negative_volumes = _volume_scene([p.target_negative_volumes for p in problems], device)
    has_pc = [p.obstacle_point_cloud is not None for p in problems]
    obstacle_points = None
    if any(has_pc):
        if not all(has_pc):
            raise ValueError("mixed primitive/point-cloud problems in one batch; "
                             "filter the problem set by mode first")
        rng = np.random.default_rng(0)
        width = max(int(np.asarray(p.obstacle_point_cloud).shape[0]) for p in problems)
        packed = np.zeros((len(problems), width, 3), np.float32)
        for i, p in enumerate(problems):
            pc = np.asarray(p.obstacle_point_cloud, np.float32)[:, :3]
            if pc.shape[0] < width:
                extra = rng.integers(0, pc.shape[0], width - pc.shape[0])
                pc = np.concatenate([pc, pc[extra]], axis=0)
            packed[i] = pc
        obstacle_points = torch.as_tensor(packed, device=device)
    problem = Problem(
        q0=torch.as_tensor(q0, device=device),
        target_rot=torch.as_tensor(target_rot, dtype=torch.float32, device=device),
        target_trans=torch.as_tensor(target_trans, dtype=torch.float32, device=device),
        scene=scene,
        obstacle_points=obstacle_points,
    )
    return {
        "problem": problem,
        "target_volumes": target_volumes,
        "negative_volumes": negative_volumes,
    }
