"""Static-shape scene containers and the obstacle point-cloud sampler.

Port of ``mpinets_tpu/geom/scene.py``. A scene batch is a padded SoA tuple
of tensors (the reference's zero-volume padding convention,
``data_loader.py:204-235``). Sampling is split in two: the random draws
(:class:`ObstacleDraws`, made from a ``torch.Generator``) and the
deterministic placement of each point on its primitive's surface, so a test
can hand the port the draws the JAX package made and compare placements.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mpinets_torch.kernels.rotations import quat_to_matrix


class SceneSet(NamedTuple):
    """A batch of primitive scenes, padded to M1 cuboids / M2 cylinders.

    Zero-volume padding entries (all-zero dims, or zero radius/height) are
    ignored by the area-weighted sampler. Quaternions are wxyz; padding
    entries carry identity quaternions.
    """

    cuboid_centers: torch.Tensor   # [..., M1, 3]
    cuboid_dims: torch.Tensor      # [..., M1, 3]
    cuboid_quats: torch.Tensor     # [..., M1, 4]
    cylinder_centers: torch.Tensor  # [..., M2, 3]
    cylinder_radii: torch.Tensor    # [..., M2, 1]
    cylinder_heights: torch.Tensor  # [..., M2, 1]
    cylinder_quats: torch.Tensor    # [..., M2, 4]

    @property
    def batch_shape(self):
        return self.cuboid_centers.shape[:-2]

    @property
    def num_cuboids(self):
        return self.cuboid_centers.shape[-2]

    @property
    def num_cylinders(self):
        return self.cylinder_centers.shape[-2]

    def to(self, device) -> "SceneSet":
        return SceneSet(*(t.to(device) for t in self))


def empty_scene(batch_shape=(), m_cuboids: int = 1, m_cylinders: int = 1,
                dtype=torch.float32, device=None) -> SceneSet:
    """An all-padding scene."""
    def z(*tail):
        return torch.zeros(tuple(batch_shape) + tail, dtype=dtype, device=device)

    ident_c = z(m_cuboids, 4)
    ident_c[..., 0] = 1.0
    ident_y = z(m_cylinders, 4)
    ident_y[..., 0] = 1.0
    return SceneSet(
        cuboid_centers=z(m_cuboids, 3),
        cuboid_dims=z(m_cuboids, 3),
        cuboid_quats=ident_c,
        cylinder_centers=z(m_cylinders, 3),
        cylinder_radii=z(m_cylinders, 1),
        cylinder_heights=z(m_cylinders, 1),
        cylinder_quats=ident_y,
    )


def cuboid_surface_areas(dims: torch.Tensor) -> torch.Tensor:
    """[..., M, 3] -> [..., M]; zero for zero-volume padding."""
    a = 2.0 * (
        dims[..., 0] * dims[..., 1]
        + dims[..., 0] * dims[..., 2]
        + dims[..., 1] * dims[..., 2]
    )
    nonzero = torch.all(torch.abs(dims) > 1e-8, dim=-1)
    return torch.where(nonzero, a, torch.zeros_like(a))


def cylinder_surface_areas(radii: torch.Tensor, heights: torch.Tensor) -> torch.Tensor:
    """[..., M, 1] x2 -> [..., M]; zero for zero-volume padding."""
    r = radii[..., 0]
    h = heights[..., 0]
    a = 2.0 * math.pi * r * h + 2.0 * math.pi * r * r
    nonzero = (torch.abs(r) > 1e-8) & (torch.abs(h) > 1e-8)
    return torch.where(nonzero, a, torch.zeros_like(a))


class ObstacleDraws(NamedTuple):
    """The random numbers behind one obstacle cloud, one entry per point.

    The JAX package draws the same quantities from ``jax.random``
    (``mpinets_tpu/geom/scene.py:74-168``); placement given the draws is
    deterministic.
    """

    which: torch.Tensor             # [..., N] int: obstacle, cuboids first
    cuboid_face: torch.Tensor       # [..., N] int in {0, 1, 2}: face-pair axis
    cuboid_positive: torch.Tensor   # [..., N] bool: + or - face of the pair
    cuboid_uv: torch.Tensor         # [..., N, 3] uniform in [-1, 1)
    cylinder_on_cap: torch.Tensor   # [..., N] bool
    cylinder_theta: torch.Tensor    # [..., N] uniform in [0, 2 pi)
    cylinder_z: torch.Tensor        # [..., N] uniform in [-0.5, 0.5)
    cylinder_r: torch.Tensor        # [..., N] uniform in [0, 1)
    cylinder_top: torch.Tensor      # [..., N] bool: top or bottom cap


def _categorical(weights: torch.Tensor, num: int, generator) -> torch.Tensor:
    """``num`` draws per row of [..., K] non-negative weights (inverse CDF)
    -> [..., num]."""
    # scan along the leading dim: an innermost-dim cumsum over millions of
    # 2- or 3-wide rows is a slow CUDA scan
    cdf = torch.cumsum(weights.movedim(-1, 0), dim=0).movedim(0, -1)
    u = torch.rand(weights.shape[:-1] + (num,), generator=generator,
                   dtype=weights.dtype, device=weights.device)
    pick = torch.searchsorted(cdf.contiguous(), (u * cdf[..., -1:]).contiguous(), right=True)
    return torch.clamp(pick, max=weights.shape[-1] - 1)


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [..., M, C], idx [..., N] -> [..., N, C]."""
    return torch.take_along_dim(table, idx[..., None], dim=-2)


def draw_obstacle_samples(
    scene: SceneSet, num_points: int, generator: Optional[torch.Generator] = None
) -> ObstacleDraws:
    """Draws for :func:`place_obstacle_points`: each point picks an obstacle
    with probability proportional to its surface area, then a face (or cap
    versus side) in proportion to area, then uniform surface coordinates."""
    m1 = scene.num_cuboids
    dev = scene.cuboid_dims.device
    dt = scene.cuboid_dims.dtype
    batch = tuple(scene.batch_shape)
    areas = torch.cat(
        [
            cuboid_surface_areas(scene.cuboid_dims),
            cylinder_surface_areas(scene.cylinder_radii, scene.cylinder_heights),
        ],
        dim=-1,
    )
    which = _categorical(areas + 1e-12, num_points, generator)

    dims = _pick(scene.cuboid_dims, torch.clamp(which, 0, m1 - 1))
    face_areas = torch.stack(
        [dims[..., 1] * dims[..., 2], dims[..., 0] * dims[..., 2],
         dims[..., 0] * dims[..., 1]], dim=-1,
    )
    cyl = torch.clamp(which - m1, 0, scene.num_cylinders - 1)
    r = _pick(scene.cylinder_radii, cyl)[..., 0]
    h = _pick(scene.cylinder_heights, cyl)[..., 0]
    region = torch.stack([2.0 * math.pi * r * h, 2.0 * math.pi * r * r], dim=-1)

    def rand(*tail):
        return torch.rand(batch + (num_points,) + tail, generator=generator,
                          dtype=dt, device=dev)

    return ObstacleDraws(
        which=which,
        cuboid_face=_categorical(face_areas + 1e-12, 1, generator)[..., 0],
        cuboid_positive=rand() < 0.5,
        cuboid_uv=rand(3) * 2.0 - 1.0,
        cylinder_on_cap=_categorical(region + 1e-12, 1, generator)[..., 0] == 1,
        cylinder_theta=rand() * (2.0 * math.pi),
        cylinder_z=rand() - 0.5,
        cylinder_r=rand(),
        cylinder_top=rand() < 0.5,
    )


def place_obstacle_points(scene: SceneSet, draws: ObstacleDraws) -> torch.Tensor:
    """Points on the scene's primitive surfaces given the draws.

    :returns: [..., N, 4]; column 3 is the obstacle index (the reference's
        per-obstacle label, which the policy input discards).
    """
    m1 = scene.num_cuboids
    which = draws.which
    is_cuboid = which < m1
    cub_idx = torch.clamp(which, 0, m1 - 1)
    cyl_idx = torch.clamp(which - m1, 0, scene.num_cylinders - 1)

    half = _pick(scene.cuboid_dims, cub_idx) / 2.0
    uv = draws.cuboid_uv * half
    onehot = torch.nn.functional.one_hot(draws.cuboid_face, 3).to(half.dtype)
    sign = torch.where(draws.cuboid_positive, 1.0, -1.0)[..., None]
    cub_local = uv * (1.0 - onehot) + (sign * half) * onehot
    cub_rot = quat_to_matrix(_pick(scene.cuboid_quats, cub_idx))
    cub_world = (
        torch.einsum("...nij,...nj->...ni", cub_rot, cub_local)
        + _pick(scene.cuboid_centers, cub_idx)
    )

    radii = _pick(scene.cylinder_radii, cyl_idx)[..., 0]
    heights = _pick(scene.cylinder_heights, cyl_idx)[..., 0]
    theta = draws.cylinder_theta
    side = torch.stack(
        [radii * torch.cos(theta), radii * torch.sin(theta),
         draws.cylinder_z * heights], dim=-1,
    )
    r_cap = radii * torch.sqrt(draws.cylinder_r)
    z_cap = torch.where(draws.cylinder_top, 0.5, -0.5) * heights
    cap = torch.stack(
        [r_cap * torch.cos(theta), r_cap * torch.sin(theta), z_cap], dim=-1
    )
    cyl_local = torch.where(draws.cylinder_on_cap[..., None], cap, side)
    cyl_rot = quat_to_matrix(_pick(scene.cylinder_quats, cyl_idx))
    cyl_world = (
        torch.einsum("...nij,...nj->...ni", cyl_rot, cyl_local)
        + _pick(scene.cylinder_centers, cyl_idx)
    )

    pts = torch.where(is_cuboid[..., None], cub_world, cyl_world)
    return torch.cat([pts, which[..., None].to(pts.dtype)], dim=-1)


def sample_obstacle_points(
    scene: SceneSet, num_points: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[ObstacleDraws] = None,
) -> torch.Tensor:
    """Surface-area-proportional point cloud over a (batched) scene
    (``construct_mixed_point_cloud``, ``mpinets/geometry.py:571-608``).

    :returns: [..., num_points, 4]
    """
    if draws is None:
        draws = draw_obstacle_samples(scene, num_points, generator)
    return place_obstacle_points(scene, draws)


# ---------------------------------------------------------------------------
# Host-side constructor: padded SoA batches from ragged per-scene lists.
# ---------------------------------------------------------------------------

def pack_scenes(
    cuboids_per_scene: Sequence[Sequence],
    cylinders_per_scene: Sequence[Sequence],
    max_cuboids: Optional[int] = None,
    max_cylinders: Optional[int] = None,
    dtype=np.float32,
    device=None,
) -> SceneSet:
    """Pack ragged scene lists into a padded SceneSet batch.

    Each cuboid is (center[3], dims[3], wxyz_quat[4]); each cylinder is
    (center[3], radius, height, wxyz_quat[4]). Padding uses zero volume +
    identity quaternion. Unless given, the padded sizes are rounded up to
    multiples of 8, as in the JAX package.
    """
    b = len(cuboids_per_scene)
    if len(cylinders_per_scene) != b:
        raise ValueError("cuboid and cylinder lists differ in scene count")
    m1 = max(1, max_cuboids or max((len(c) for c in cuboids_per_scene), default=1))
    m2 = max(1, max_cylinders or max((len(c) for c in cylinders_per_scene), default=1))
    if max_cuboids is None:
        m1 = -(-m1 // 8) * 8
    if max_cylinders is None:
        m2 = -(-m2 // 8) * 8

    cc = np.zeros((b, m1, 3), dtype)
    cd = np.zeros((b, m1, 3), dtype)
    cq = np.zeros((b, m1, 4), dtype)
    cq[..., 0] = 1.0
    yc = np.zeros((b, m2, 3), dtype)
    yr = np.zeros((b, m2, 1), dtype)
    yh = np.zeros((b, m2, 1), dtype)
    yq = np.zeros((b, m2, 4), dtype)
    yq[..., 0] = 1.0

    for i, cubs in enumerate(cuboids_per_scene):
        if len(cubs) > m1 or len(cylinders_per_scene[i]) > m2:
            raise ValueError(
                f"scene {i} has {len(cubs)} cuboids / "
                f"{len(cylinders_per_scene[i])} cylinders > {m1} / {m2}"
            )
        for j, (center, dims, quat) in enumerate(cubs):
            cc[i, j] = center
            cd[i, j] = dims
            cq[i, j] = quat
    for i, cyls in enumerate(cylinders_per_scene):
        for j, (center, radius, height, quat) in enumerate(cyls):
            yc[i, j] = center
            yr[i, j, 0] = radius
            yh[i, j, 0] = height
            yq[i, j] = quat

    return SceneSet(*(torch.as_tensor(a, device=device)
                      for a in (cc, cd, cq, yc, yr, yh, yq)))
