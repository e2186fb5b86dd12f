"""Depth camera: sphere-traced rendering of primitive scenes.

Port of ``mpinets_tpu/geom/depth.py``. The reference's ``--use-depth`` mode
re-renders each primitive scene to a depth image with a PyBullet camera and
backprojects it into the problem's ``obstacle_point_cloud``
(``run_inference.py:194-257``). Here the scene SDF is ray-marched (sphere
tracing) on the scenes' device, a batch of scenes at once: one [H, W] ray
grid per scene, a fixed number of steps.

The sampling is split from the construction, as ``ObstacleDraws`` does for
the obstacle sampler: :func:`draw_depth_samples` draws hit-ray indices from
a ``torch.Generator``, and :func:`depth_cloud` turns given indices into the
cloud, so a test can hand the port the JAX package's categorical draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mpinets_torch.geom.scene import SceneSet
from mpinets_torch.kernels.sdf import scene_sdf


class Camera(NamedTuple):
    """Pinhole camera: position, look-at target, intrinsics."""

    position: tuple = (1.6, -1.2, 1.2)
    look_at: tuple = (0.55, 0.0, 0.3)
    up: tuple = (0.0, 0.0, 1.0)
    fov_deg: float = 55.0
    width: int = 160
    height: int = 120
    max_depth: float = 4.0


def _camera_rays(cam: Camera, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit ray directions [H*W, 3] and origin [3] in the world frame, f32."""
    kw = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(cam.position, **kw)
    fwd = torch.tensor(cam.look_at, **kw) - pos
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, torch.tensor(cam.up, **kw))
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, fwd)

    tan = math.tan(math.radians(cam.fov_deg) / 2.0)
    xs = torch.linspace(-1.0, 1.0, cam.width, **kw) * tan
    ys = torch.linspace(-1.0, 1.0, cam.height, **kw) * tan * (cam.height / cam.width)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dirs = (fwd + gx[..., None] * right - gy[..., None] * up).reshape(-1, 3)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True), pos


@torch.no_grad()
def render_depth_points(scene: SceneSet, cam: Camera = Camera(),
                        iters: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere-trace a batch of scenes (``scene`` batched to [B]). Returns
    (points [B, H*W, 3], hit_mask [B, H*W]). A ray that hits nothing within
    ``cam.max_depth`` has hit_mask False (its point is at the far plane)."""
    dirs, origin = _camera_rays(cam, scene.cuboid_centers.device)
    b = scene.cuboid_centers.shape[0]
    t = torch.full((b, dirs.shape[0]), 0.05, dtype=torch.float32, device=dirs.device)
    for _ in range(iters):
        p = origin + t[..., None] * dirs                 # [B, N, 3]
        d = scene_sdf(p, scene)                          # [B, N]
        t = torch.clamp(t + torch.clamp(d, min=1e-4), max=cam.max_depth)
    p = origin + t[..., None] * dirs
    d_final = scene_sdf(p, scene)
    hit = (d_final < 5e-3) & (t < cam.max_depth - 1e-3)
    return p, hit


def draw_depth_samples(hit: torch.Tensor, num_points: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``num_points`` hit-ray indices per scene, uniform over the hit rays
    with replacement. hit [B, R] -> int64 [B, num_points] (0 for a scene
    with no hit)."""
    any_hit = hit.any(dim=-1, keepdim=True)
    weights = torch.where(any_hit, hit.float(), torch.ones_like(hit, dtype=torch.float32))
    return torch.multinomial(weights, num_points, replacement=True, generator=generator)


def depth_cloud(points: torch.Tensor, hit: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The cloud of the drawn rays: points [B, R, 3], hit [B, R], idx
    [B, num_points] -> [B, num_points, 3]; all zeros for a scene with no
    hit."""
    out = torch.take_along_dim(points, idx[..., None], dim=1)
    return torch.where(hit.any(dim=-1)[:, None, None], out, torch.zeros_like(out))


def scene_to_point_cloud(scene: SceneSet, num_points: int,
                         generator: Optional[torch.Generator] = None,
                         cam: Camera = Camera()) -> torch.Tensor:
    """Depth-rendered obstacle clouds of a batch of scenes with exactly
    ``num_points`` points each (hit points resampled with replacement;
    all-miss scenes give zeros): the ``run_inference.py:194-257`` conversion.
    -> [B, num_points, 3]."""
    points, hit = render_depth_points(scene, cam)
    return depth_cloud(points, hit, draw_depth_samples(hit, num_points, generator))
