"""Batching planning problems for the rollout engine.

Port of ``problems_to_batch`` from ``mpinets_tpu/data/problems.py`` (the
``.pkl`` problem-set loader comes with the eval slice).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from mpinets_torch import types as T
from mpinets_torch.data.synthetic import Problem
from mpinets_torch.geom.scene import SceneSet, pack_scenes


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
