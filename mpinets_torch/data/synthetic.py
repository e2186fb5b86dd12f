"""Synthetic planning problems and training batches.

Port of ``mpinets_tpu/data/synthetic.py``: ``Problem``,
``random_configuration``, ``random_scene``, ``random_problem(_batch)``,
``min_jerk_trajectory`` and ``training_batch``. Draws come from a
``torch.Generator``; they follow the same distributions as the JAX
package's, not its numbers. ``training_batch`` takes its draws split from
the construction (:class:`TrainingDraws`), so a test can hand it the draws
the JAX package made.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from mpinets_torch.geom.assembly import PointCloudSizes, assemble_point_cloud
from mpinets_torch.geom.scene import ObstacleDraws, SceneSet, draw_obstacle_samples
from mpinets_torch.kernels import kinematics
from mpinets_torch.robot import franka, point_banks
from mpinets_torch.utils import trace
from mpinets_torch.utils.normalization import clamp_to_limits, normalize_franka_joints

SEQUENCE_LENGTH = 50  # gen_data.py:77


class Problem(NamedTuple):
    """A batch of planning problems (the ``PlanningProblem`` equivalent,
    reference ``mpinets_types.py:34-45``).

    ``obstacle_points`` carries raw sensed obstacle clouds for problems
    given without primitive scenes (the reference's depth /
    ``obstacle_point_cloud`` mode); when set, the rollout uses it instead of
    sampling ``scene``.
    """

    q0: torch.Tensor            # [..., 7]
    target_rot: torch.Tensor    # [..., 3, 3] right_gripper frame
    target_trans: torch.Tensor  # [..., 3]
    scene: SceneSet             # batched to [...]
    obstacle_points: Optional[torch.Tensor] = None  # [..., No, 3] or None

    def to(self, device) -> "Problem":
        return Problem(
            self.q0.to(device), self.target_rot.to(device),
            self.target_trans.to(device), self.scene.to(device),
            None if self.obstacle_points is None else self.obstacle_points.to(device),
        )


def _uniform(generator, shape, lo, hi, device):
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return lo + u * (hi - lo)


def random_configuration(generator: Optional[torch.Generator] = None, shape=(),
                         device=None) -> torch.Tensor:
    """Uniform sample inside the real joint limits, [*shape, 7]."""
    with trace.h2d_wait("random_configuration", device):
        limits = torch.as_tensor(franka.REAL_JOINT_LIMITS, dtype=torch.float32,
                                 device=device)
    u = torch.rand(tuple(shape) + (franka.DOF,), generator=generator, device=device)
    return limits[:, 0] + u * (limits[:, 1] - limits[:, 0])


def random_scene(generator: Optional[torch.Generator] = None, batch_size: int = 1,
                 max_cuboids: int = 8, max_cylinders: int = 8,
                 device=None) -> SceneSet:
    """A batch of random tabletop-like scenes: a table slab plus a random
    number of boxes and cylinders on it (the JAX package's ``random_scene``,
    after the reference's TabletopEnvironment,
    ``environments/tabletop_environment.py:129-153,223-324``). Unused slots
    are zero-volume padding."""
    b = batch_size
    g = generator
    kw = dict(device=device)

    def vec(*v):
        with trace.h2d_wait("random_scene", device):
            return torch.tensor(v, dtype=torch.float32, **kw)

    table_center = vec(0.6, 0.0, 0.18) + _uniform(g, (b, 3), -0.05, 0.05, device) * vec(1.0, 2.0, 1.0)
    table_dims = vec(0.7, 1.2, 0.04) + _uniform(g, (b, 3), 0.0, 0.2, device)
    table_top = table_center[:, 2] + table_dims[:, 2] / 2

    n_cub = torch.randint(1, max_cuboids, (b,), generator=g, **kw)
    n_cyl = torch.randint(0, max_cylinders + 1, (b,), generator=g, **kw)

    m = max_cuboids - 1
    cub_xy = _uniform(g, (b, m, 2), vec(0.3, -0.5), vec(0.85, 0.5), device)
    live = (torch.arange(m, **kw) < n_cub[:, None]).float()
    cub_dims = _uniform(g, (b, m, 3), 0.04, 0.25, device) * live[..., None]
    cub_centers = torch.cat(
        [cub_xy, (table_top[:, None] + cub_dims[..., 2] / 2)[..., None]], dim=-1
    )
    ident = torch.zeros((b, max_cuboids, 4), **kw)
    ident[..., 0] = 1.0

    cyl_xy = _uniform(g, (b, max_cylinders, 2), vec(0.3, -0.5), vec(0.85, 0.5), device)
    cyl_live = (torch.arange(max_cylinders, **kw) < n_cyl[:, None]).float()[..., None]
    cyl_r = _uniform(g, (b, max_cylinders, 1), 0.02, 0.1, device) * cyl_live
    cyl_h = _uniform(g, (b, max_cylinders, 1), 0.05, 0.3, device) * cyl_live
    cyl_centers = torch.cat([cyl_xy, table_top[:, None, None] + cyl_h / 2], dim=-1)
    ident_y = torch.zeros((b, max_cylinders, 4), **kw)
    ident_y[..., 0] = 1.0

    return SceneSet(
        cuboid_centers=torch.cat([table_center[:, None], cub_centers], dim=1),
        cuboid_dims=torch.cat([table_dims[:, None], cub_dims], dim=1),
        cuboid_quats=ident,
        cylinder_centers=cyl_centers,
        cylinder_radii=cyl_r,
        cylinder_heights=cyl_h,
        cylinder_quats=ident_y,
    )


def random_problem_batch(generator: Optional[torch.Generator] = None,
                         batch_size: int = 1, device=None) -> Problem:
    """A batch of problems: random scenes, uniform start configurations and
    targets at the FK pose of uniform goal configurations."""
    scene = random_scene(generator, batch_size, device=device)
    q0 = random_configuration(generator, (batch_size,), device)
    q_goal = random_configuration(generator, (batch_size,), device)
    rot, trans = kinematics.eff_pose(q_goal)
    return Problem(q0=q0, target_rot=rot, target_trans=trans, scene=scene)


def random_problem(generator: Optional[torch.Generator] = None, device=None) -> Problem:
    """One problem (unbatched fields)."""
    batch = random_problem_batch(generator, 1, device)
    return Problem(
        batch.q0[0], batch.target_rot[0], batch.target_trans[0],
        SceneSet(*(t[0] for t in batch.scene)),
    )


def min_jerk_trajectory(q_start: torch.Tensor, q_goal: torch.Tensor,
                        length: int = SEQUENCE_LENGTH) -> torch.Tensor:
    """Smooth pseudo-expert trajectory [..., length, 7]: minimum-jerk time
    scaling of the straight configuration-space segment."""
    # written as jnp.linspace and XLA's integer powers compute it, so the
    # values match the JAX package's bit for bit
    step = 1.0 / max(length - 1, 1)
    s = torch.arange(length, dtype=q_start.dtype, device=q_start.device) * step
    s2 = s * s
    s4 = s2 * s2
    s = 10 * (s2 * s) - 15 * s4 + 6 * (s4 * s)
    return q_start[..., None, :] + s[:, None] * (q_goal - q_start)[..., None, :]


class TrainingDraws(NamedTuple):
    """The random numbers behind one :func:`training_batch`."""

    scene: SceneSet              # [B, ...]
    q0: torch.Tensor             # [B, 7] trajectory starts
    q_goal: torch.Tensor         # [B, 7] trajectory goals
    t: torch.Tensor              # [B] int timestep in [0, SEQUENCE_LENGTH)
    noise: torch.Tensor          # [B, 7] standard normal (scaled by random_scale)
    robot_indices: torch.Tensor  # [B, sizes.robot] robot-bank indices
    obstacle: ObstacleDraws      # [B, sizes.obstacle] per point


def draw_training_batch(generator: Optional[torch.Generator], batch_size: int,
                        sizes: PointCloudSizes = PointCloudSizes(),
                        device=None) -> TrainingDraws:
    """Draws for :func:`training_batch`, from ``generator``."""
    scene = random_scene(generator, batch_size, device=device)
    q0 = random_configuration(generator, (batch_size,), device)
    q_goal = random_configuration(generator, (batch_size,), device)
    t = torch.randint(0, SEQUENCE_LENGTH, (batch_size,), generator=generator, device=device)
    noise = torch.randn((batch_size, franka.DOF), generator=generator, device=device)
    robot_indices = torch.randint(0, point_banks.DEFAULT_BANK_SIZE, (batch_size, sizes.robot),
                                  generator=generator, device=device)
    obstacle = draw_obstacle_samples(scene, sizes.obstacle, generator)
    return TrainingDraws(scene, q0, q_goal, t, noise, robot_indices, obstacle)


def training_batch(
    generator: Optional[torch.Generator] = None,
    batch_size: int = 1,
    sizes: PointCloudSizes = PointCloudSizes(),
    random_scale: float = 0.015,
    device=None,
    draws: Optional[TrainingDraws] = None,
) -> Dict[str, torch.Tensor]:
    """A training batch with the reference's key layout
    (``data_loader.py:141-280``), built on ``device``: timesteps uniform
    along pseudo-expert trajectories, the target pose at the FK of the
    trajectory's goal (``data_loader.py:155-157``), joint noise of sigma
    ``random_scale`` clamped to the limits (``data_loader.py:167-179``), and
    the supervision the next configuration. ``draws`` replaces the draws
    from ``generator``.
    """
    with trace.span("train.batch"):
        if draws is None:
            draws = draw_training_batch(generator, batch_size, sizes, device)
        scene = draws.scene
        traj = min_jerk_trajectory(draws.q0, draws.q_goal)       # [B, T, 7]
        t = draws.t.long()
        rows = torch.arange(traj.shape[0], device=traj.device)
        q_t = traj[rows, t]
        q_next = traj[rows, torch.clamp(t + 1, 0, SEQUENCE_LENGTH - 1)]
        rot_goal, trans_goal = kinematics.eff_pose(draws.q_goal)
        q_noisy = clamp_to_limits(q_t + random_scale * draws.noise)
        xyz = assemble_point_cloud(q_noisy, rot_goal, trans_goal, scene, sizes,
                                   robot_indices=draws.robot_indices,
                                   obstacle_draws=draws.obstacle)
        return {
            "xyz": xyz,
            "configuration": normalize_franka_joints(q_noisy),
            "supervision": normalize_franka_joints(q_next),
            "target_position": trans_goal,
            "cuboid_centers": scene.cuboid_centers,
            "cuboid_dims": scene.cuboid_dims,
            "cuboid_quats": scene.cuboid_quats,
            "cylinder_centers": scene.cylinder_centers,
            "cylinder_radii": scene.cylinder_radii,
            "cylinder_heights": scene.cylinder_heights,
            "cylinder_quats": scene.cylinder_quats,
        }
