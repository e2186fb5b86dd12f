"""Port parity: signed distances, the collision-sphere model, joint limits
and the loss bank of ``mpinets_torch`` against ``mpinets_tpu``.

Inputs come from numpy seeds and go through both packages. Tolerances: SDF
values and their gradients 1e-6 (+inf where padding is all that is left);
sphere centres and the loss cloud 1e-5 (f32 FK chains); predicates equal
away from their thresholds.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.geom import scene as tsc  # noqa: E402
from mpinets_torch.kernels import kinematics as tkin  # noqa: E402
from mpinets_torch.kernels import sdf as tsdf  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_torch.robot import sampler as tsm  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.kernels import sdf as jsdf  # noqa: E402
from mpinets_tpu.robot import sampler as jsm  # noqa: E402

torch.set_float32_matmul_precision("highest")


def _np(x):
    return np.asarray(x)


def _configs(n=16, seed=0):
    rng = np.random.default_rng(seed)
    lim = franka.JOINT_LIMITS
    return rng.uniform(lim[:, 0], lim[:, 1], (n, 7)).astype(np.float32)


def _scenes(seed=0):
    """Three scenes, padded: 0-9 cuboids and 0-2 cylinders each, so some
    scenes are all padding on one side (their SDF there is +inf)."""
    rng = np.random.default_rng(seed)
    quat = lambda: (lambda q: q / np.linalg.norm(q))(rng.normal(size=4))
    cubs, cyls = [], []
    for n_cub, n_cyl in ((3, 1), (0, 2), (9, 0)):
        cubs.append([(rng.uniform(-0.5, 0.5, 3), rng.uniform(0.05, 0.4, 3), quat())
                     for _ in range(n_cub)])
        cyls.append([(rng.uniform(-0.5, 0.5, 3), rng.uniform(0.02, 0.2), rng.uniform(0.05, 0.3),
                      quat()) for _ in range(n_cyl)])
    return tsc.pack_scenes(cubs, cyls), jsc.pack_scenes(cubs, cyls)


def _points(seed=1, b=3, n=200):
    return np.random.default_rng(seed).uniform(-0.7, 0.7, (b, n, 3)).astype(np.float32)


def test_scene_sdf_functions_match():
    tscene, jscene = _scenes()
    pts = _points()
    tp, jp = torch.from_numpy(pts), jnp.asarray(pts)
    pairs = [
        (tsdf.cuboid_sdf(tp, tscene.cuboid_centers, tscene.cuboid_dims, tscene.cuboid_quats),
         jsdf.cuboid_sdf(jp, jscene.cuboid_centers, jscene.cuboid_dims, jscene.cuboid_quats)),
        (tsdf.cylinder_sdf(tp, tscene.cylinder_centers, tscene.cylinder_radii,
                           tscene.cylinder_heights, tscene.cylinder_quats),
         jsdf.cylinder_sdf(jp, jscene.cylinder_centers, jscene.cylinder_radii,
                           jscene.cylinder_heights, jscene.cylinder_quats)),
        (tsdf.scene_sdf(tp, tscene), jsdf.scene_sdf(jp, jscene)),
        (tsdf.scene_sdf_per_primitive(tp, tscene), jsdf.scene_sdf_per_primitive(jp, jscene)),
        (tsdf.scene_sdf_sequence(tp.reshape(3, 4, 50, 3), tscene),
         jsdf.scene_sdf_sequence(jp.reshape(3, 4, 50, 3), jscene)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), _np(ref), atol=1e-6, rtol=1e-6)
    # scene 1 has no cuboid, scene 2 no cylinder: padding alone is +inf
    assert torch.isinf(pairs[0][0][1]).all() and torch.isinf(pairs[1][0][2]).all()
    assert torch.isfinite(pairs[2][0]).all()


def test_sphere_sdf_matches_and_masks_zero_radius():
    rng = np.random.default_rng(2)
    centers = rng.uniform(-0.5, 0.5, (3, 5, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.2, (3, 5, 1)).astype(np.float32)
    radii[1] = 0.0
    pts = _points(3)
    ours = tsdf.sphere_sdf(*map(torch.from_numpy, (pts, centers, radii)))
    ref = jsdf.sphere_sdf(*map(jnp.asarray, (pts, centers, radii)))
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=1e-6, rtol=1e-6)
    assert torch.isinf(ours[1]).all()


def test_scene_sdf_gradient_is_finite_and_matches():
    """Points inside cuboids (zero outside-vector) and on cylinder axes (zero
    radial vector) keep a finite gradient, equal to the JAX package's."""
    tscene, jscene = _scenes()
    pts = _points(4, n=64)
    pts[0, :3] = tscene.cuboid_centers[0, :3].numpy() + np.float32(1e-3)  # inside
    pts[0, 3] = tscene.cylinder_centers[0, 0].numpy()                     # on the axis
    tp = torch.from_numpy(pts).requires_grad_()
    tsdf.scene_sdf(tp, tscene).sum().backward()
    ref = jax.grad(lambda p: jsdf.scene_sdf(p, jscene).sum())(jnp.asarray(pts))
    assert torch.isfinite(tp.grad).all()
    np.testing.assert_allclose(tp.grad.numpy(), _np(ref), atol=1e-6, rtol=1e-6)


def test_collision_spheres_match():
    q = _configs()
    for ours, ref in ((tkin.collision_spheres, jkin.collision_spheres),
                      (tkin.scene_collision_spheres, jkin.scene_collision_spheres)):
        out = ours(torch.from_numpy(q))
        np.testing.assert_allclose(out.numpy(), _np(ref(jnp.asarray(q))), atol=1e-5)
    assert tkin.collision_spheres(torch.from_numpy(q)).shape == (16, 57, 3)
    assert tkin.scene_collision_spheres(torch.from_numpy(q)).shape[-2] == len(
        franka.SCENE_SPHERE_RADII)


@pytest.mark.parametrize("margin", [0.0, 0.02])
def test_self_collision_matches_away_from_the_threshold(margin):
    q = _configs(400, seed=5)
    centers = _np(jkin.collision_spheres(jnp.asarray(q))).astype(np.float64)
    pairs = franka.SELF_COLLISION_PAIRS
    d = np.linalg.norm(centers[:, pairs[:, 0]] - centers[:, pairs[:, 1]], axis=-1)
    gap = np.abs(d - (franka.SELF_COLLISION_THRESH + margin)).min(-1)
    keep = gap > 1e-4
    assert keep.sum() > 350
    ours = tkin.self_collision(torch.from_numpy(q[keep]), margin).numpy()
    ref = _np(jkin.self_collision(jnp.asarray(q[keep]), margin))
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours.sum() < len(ours)


@pytest.mark.parametrize("real", [False, True])
def test_within_limits_matches(real):
    rng = np.random.default_rng(6)
    lim = franka.JOINT_LIMITS
    q = rng.uniform(lim[:, 0] - 0.3, lim[:, 1] + 0.3, (300, 7)).astype(np.float32)
    ours = tkin.within_limits(torch.from_numpy(q), real).numpy()
    np.testing.assert_array_equal(ours, _np(jkin.within_limits(jnp.asarray(q), real)))
    assert 0 < ours.sum() < len(ours)


def test_fixed_robot_points_match():
    q = _configs(6, seed=7)
    ours = tsm.fixed_robot_points(torch.from_numpy(q))
    np.testing.assert_allclose(ours.numpy(), _np(jsm.fixed_robot_points(jnp.asarray(q))),
                               atol=1e-5)
    assert ours.shape == (6, 1024, 3)
    # the full bank is unchanged by the bank key
    np.testing.assert_allclose(tsm.bank_point_cloud(torch.from_numpy(q), "full").numpy(),
                               _np(jsm.bank_point_cloud(jnp.asarray(q), "full")), atol=1e-5)
