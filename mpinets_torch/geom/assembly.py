"""Assembly of the policy's input point cloud.

Port of ``mpinets_tpu/geom/assembly.py``. The policy consumes
``xyz [B, 6272, 4]``: 2048 robot points (label 0), 4096 obstacle points
(label 1), 128 target-gripper points (label 2), stacked in that order --
reference layout at ``mpinets/data_loader.py:261-278``. The port's functions
take batched inputs directly (the JAX package vmaps unbatched ones).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpinets_torch.geom.scene import SceneSet, sample_obstacle_points
from mpinets_torch.robot import sampler

NUM_ROBOT_POINTS = 2048
NUM_OBSTACLE_POINTS = 4096
NUM_TARGET_POINTS = 128
NUM_POINTS = NUM_ROBOT_POINTS + NUM_OBSTACLE_POINTS + NUM_TARGET_POINTS


class PointCloudSizes(NamedTuple):
    robot: int = NUM_ROBOT_POINTS
    obstacle: int = NUM_OBSTACLE_POINTS
    target: int = NUM_TARGET_POINTS

    @property
    def total(self) -> int:
        return self.robot + self.obstacle + self.target


def segmentation_labels(sizes: PointCloudSizes = PointCloudSizes(),
                        dtype=torch.float32, device=None) -> torch.Tensor:
    """The static label column: 0=robot, 1=obstacle, 2=target."""
    return torch.cat(
        [
            torch.zeros((sizes.robot,), dtype=dtype, device=device),
            torch.ones((sizes.obstacle,), dtype=dtype, device=device),
            torch.full((sizes.target,), 2.0, dtype=dtype, device=device),
        ]
    )


def _stack_cloud(robot, obstacles, target, sizes):
    xyz = torch.cat([robot, obstacles, target], dim=-2)
    labels = segmentation_labels(sizes, xyz.dtype, xyz.device)
    labels = labels.expand(xyz.shape[:-1])[..., None]
    return torch.cat([xyz, labels], dim=-1)


def assemble_point_cloud(
    q0: torch.Tensor,
    target_rot: torch.Tensor,
    target_trans: torch.Tensor,
    scene: SceneSet,
    sizes: PointCloudSizes = PointCloudSizes(),
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Build the [..., N, 4] input cloud for a batch of problems.

    :param q0: starting configurations [..., 7]
    :param target_rot/target_trans: target EE poses (right_gripper frame)
    :param scene: SceneSet batched like ``q0``
    """
    robot = sampler.sample_robot_points(q0, generator, sizes.robot)
    obstacles = sample_obstacle_points(scene, sizes.obstacle, generator)[..., :3]
    target = sampler.sample_end_effector(target_rot, target_trans, sizes.target)
    return _stack_cloud(robot, obstacles, target, sizes)


def assemble_point_cloud_with_obstacles(
    q0: torch.Tensor,
    target_rot: torch.Tensor,
    target_trans: torch.Tensor,
    obstacle_xyz: torch.Tensor,
    sizes: PointCloudSizes = PointCloudSizes(),
    generator: Optional[torch.Generator] = None,
    robot_indices: Optional[torch.Tensor] = None,
    obstacle_indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Build the [..., N, 4] input cloud from RAW obstacle clouds (the
    reference's depth / ``obstacle_point_cloud`` mode,
    ``run_inference.py:58-134``): the obstacle segment is resampled to
    ``sizes.obstacle`` points with replacement unless it already has that
    many.

    obstacle_xyz: [..., No, 3]. ``robot_indices`` / ``obstacle_indices``
    replace the draws from ``generator``.
    """
    robot = sampler.sample_robot_points(
        q0, generator, sizes.robot, indices=robot_indices
    )
    no = obstacle_xyz.shape[-2]
    if no == sizes.obstacle:
        obstacles = obstacle_xyz
    else:
        if obstacle_indices is None:
            obstacle_indices = torch.randint(
                0, no, obstacle_xyz.shape[:-2] + (sizes.obstacle,),
                generator=generator, device=obstacle_xyz.device,
            )
        obstacles = torch.take_along_dim(
            obstacle_xyz, obstacle_indices[..., None].long(), dim=-2
        )
    target = sampler.sample_end_effector(target_rot, target_trans, sizes.target)
    return _stack_cloud(robot, obstacles, target, sizes)


def update_robot_points(xyz: torch.Tensor, robot_points: torch.Tensor) -> torch.Tensor:
    """Replace the robot segment of the cloud (rollout step semantics:
    ``xyz[:, :2048, :3] = samples``, reference ``model.py:180-181``).

    Writes into ``xyz`` in place (the JAX package returns a new array) and
    returns it. xyz: [..., N, 4]; robot_points: [..., R, 3]
    """
    xyz[..., : robot_points.shape[-2], :3] = robot_points
    return xyz
