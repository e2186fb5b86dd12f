"""Batched signed-distance functions for primitive scenes (spheres, cuboids,
cylinders) with zero-volume masking.

Port of ``mpinets_tpu/kernels/sdf.py`` (after the reference's
``TorchSpheres`` / ``TorchCuboids`` / ``TorchCylinders``,
``mpinets/geometry.py:30-568``). Zero-volume primitives give +inf, so the
min over primitives ignores them (``geometry.py:97-102,286-288``).

Shapes: primitives are SoA tensors with a batch prefix ``[...]`` and a
primitive axis ``M``; query points are ``[..., N, 3]`` with the same batch
prefix. The training loss differentiates through these functions, so every
norm keeps a finite gradient at 0 (:func:`_safe_norm`), and ties take the
JAX package's subgradients: 1 for ``|x|`` at 0 (:func:`_abs`), a half each
for ``maximum``/``minimum`` against 0.
"""

from __future__ import annotations

import torch

from mpinets_torch.kernels.rotations import quat_to_matrix

# torch.isclose defaults, used by the reference's zero-volume masks
# (geometry.py:56,154-157,384-388).
_RTOL = 1e-5
_ATOL = 1e-8


def _is_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.abs(x) <= (_ATOL + _RTOL * torch.abs(x))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s gradient at 0 (1; ``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


def _neg_part(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(x, torch.zeros_like(x))


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm whose gradient is finite (0) at the origin, as the JAX
    package's (``sdf.py:34-40``): points inside a cuboid have a zero
    outside-vector."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim), min=1e-30))


def _points_in_primitive_frames(points, centers, quats) -> torch.Tensor:
    """World points into each primitive's frame.

    points [..., N, 3]; centers [..., M, 3]; quats [..., M, 4] (wxyz)
    -> [..., M, N, 3]
    """
    rot = quat_to_matrix(quats)  # [..., M, 3, 3] world <- local
    delta = points[..., None, :, :] - centers[..., :, None, :]
    return torch.einsum("...mji,...mnj->...mni", rot, delta)


def _masked_min(sdf: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    sdf = torch.where(mask[..., None], sdf, torch.full_like(sdf, torch.inf))
    return sdf.amin(dim=-2)


def _cuboid_values(points, centers, dims, quats) -> torch.Tensor:
    """Per-cuboid SDF [..., M, N], unmasked."""
    local = _points_in_primitive_frames(points, centers, quats)
    q = _abs(local) - dims[..., :, None, :] / 2
    return _safe_norm(_relu(q)) + _neg_part(q.amax(dim=-1))


def _cylinder_values(points, centers, radii, heights, quats) -> torch.Tensor:
    """Per-cylinder SDF [..., M, N], unmasked: a 2D rounded box in
    (radial, z) about the local z axis."""
    local = _points_in_primitive_frames(points, centers, quats)
    radial = _safe_norm(local[..., :2])
    dz = _abs(local[..., 2]) - heights[..., :, None, 0] / 2
    dr = radial - radii[..., :, None, 0]
    q = torch.stack([dr, dz], dim=-1)
    return _safe_norm(_relu(q)) + _neg_part(q.amax(dim=-1))


def _cuboid_mask(dims):
    return ~torch.any(_is_zero(dims), dim=-1)


def _cylinder_mask(radii, heights):
    return ~(_is_zero(radii[..., 0]) | _is_zero(heights[..., 0]))


def sphere_sdf(points, centers, radii) -> torch.Tensor:
    """Scene SDF of a sphere set (min over M); zero-radius spheres are +inf
    (``TorchSpheres.sdf``, geometry.py:87-102).

    points [..., N, 3]; centers [..., M, 3]; radii [..., M, 1] -> [..., N]
    """
    d = _safe_norm(points[..., None, :, :] - centers[..., :, None, :])  # [..., M, N]
    return _masked_min(d - radii, ~_is_zero(radii[..., 0]))


def cuboid_sdf(points, centers, dims, quats) -> torch.Tensor:
    """Scene SDF of an oriented-cuboid set (min over M), the inside/outside
    decomposition of ``TorchCuboids.sdf`` (geometry.py:272-288); a cuboid
    with a zero dim is +inf.

    points [..., N, 3]; centers/dims [..., M, 3]; quats [..., M, 4] -> [..., N]
    """
    return _masked_min(_cuboid_values(points, centers, dims, quats), _cuboid_mask(dims))


def cylinder_sdf(points, centers, radii, heights, quats) -> torch.Tensor:
    """Scene SDF of an oriented-cylinder set (min over M), axis = local z
    (``TorchCylinders.sdf``, geometry.py:456-507); zero radius or height is
    +inf.

    points [..., N, 3]; centers [..., M, 3]; radii/heights [..., M, 1];
    quats [..., M, 4] -> [..., N]
    """
    return _masked_min(_cylinder_values(points, centers, radii, heights, quats),
                       _cylinder_mask(radii, heights))


def scene_sdf_per_primitive(points, scene) -> torch.Tensor:
    """Per-primitive SDF values, cuboids first then cylinders, without the
    min (padding gives +inf): the evaluator's per-volume sign check
    (``metrics.py:364-384,508-512``). points [..., N, 3] -> [..., M1 + M2, N]."""
    cub = _cuboid_values(points, scene.cuboid_centers, scene.cuboid_dims, scene.cuboid_quats)
    cub = torch.where(_cuboid_mask(scene.cuboid_dims)[..., None], cub,
                      torch.full_like(cub, torch.inf))
    cyl = _cylinder_values(points, scene.cylinder_centers, scene.cylinder_radii,
                           scene.cylinder_heights, scene.cylinder_quats)
    cyl = torch.where(_cylinder_mask(scene.cylinder_radii, scene.cylinder_heights)[..., None],
                      cyl, torch.full_like(cyl, torch.inf))
    return torch.cat([cub, cyl], dim=-2)


def scene_sdf(points, scene) -> torch.Tensor:
    """Min of the cuboid and cylinder scene SDFs (the reference composes
    them with ``torch.minimum`` in the loss, ``loss.py:88``, and in
    validation, ``model.py:304-307``). ``scene``: a
    :class:`mpinets_torch.geom.scene.SceneSet` or any object with its
    fields."""
    cub = cuboid_sdf(points, scene.cuboid_centers, scene.cuboid_dims, scene.cuboid_quats)
    cyl = cylinder_sdf(points, scene.cylinder_centers, scene.cylinder_radii,
                       scene.cylinder_heights, scene.cylinder_quats)
    return torch.minimum(cub, cyl)


def scene_sdf_sequence(points, scene) -> torch.Tensor:
    """Sequence variant (``sdf_sequence``, geometry.py:104,290,509):
    points [B, T, N, 3] with scene batch prefix [B] -> [B, T, N]."""
    b, t, n, _ = points.shape
    return scene_sdf(points.reshape(b, t * n, 3), scene).reshape(b, t, n)
