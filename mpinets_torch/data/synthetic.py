"""Synthetic planning problems.

Port of the problem half of ``mpinets_tpu/data/synthetic.py``
(``Problem``, ``random_configuration``, ``random_scene``,
``random_problem``, ``random_problem_batch``; ``training_batch`` comes with
the train slice). Draws come from a ``torch.Generator``; they follow the
same distributions as the JAX package's, not its numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpinets_torch.geom.scene import SceneSet
from mpinets_torch.kernels import kinematics
from mpinets_torch.robot import franka


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
