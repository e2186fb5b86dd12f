"""Port parity: forward kinematics, robot sampling, scenes, cloud assembly
and problem batching of ``mpinets_torch`` against ``mpinets_tpu``.

Inputs come from numpy seeds; where the JAX package draws random numbers,
the test makes the same draws with ``jax.random`` and hands them to the
port. Tolerances: FK 1e-5 (f32 chains of products); deterministic
placements 1e-6; packing and indices exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch import types as tt  # noqa: E402
from mpinets_torch.data.problems import problems_to_batch  # noqa: E402
from mpinets_torch.geom import assembly as tas  # noqa: E402
from mpinets_torch.geom import scene as tsc  # noqa: E402
from mpinets_torch.kernels import kinematics as tkin  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_torch.robot import sampler as tsm  # noqa: E402
from mpinets_tpu import types as jt  # noqa: E402
from mpinets_tpu.data.problems import problems_to_batch as j_problems_to_batch  # noqa: E402
from mpinets_tpu.geom import assembly as jas  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.robot import sampler as jsm  # noqa: E402

torch.set_float32_matmul_precision("highest")


def _configs(n=12, seed=0, corners=False):
    """n random configurations, f32, plus the two limit corners if asked."""
    rng = np.random.default_rng(seed)
    lim = franka.JOINT_LIMITS
    q = rng.uniform(lim[:, 0], lim[:, 1], (n, 7))
    if corners:
        q = np.concatenate([q, lim[:, 0][None], lim[:, 1][None]])
    return q.astype(np.float32)


def _np(x):
    return np.asarray(x)


def test_fk_frames_match():
    q = _configs(corners=True)
    rots, trans = tkin.fk_frames(torch.from_numpy(q))
    jrots, jtrans = jkin.fk_frames(jnp.asarray(q))
    np.testing.assert_allclose(rots.numpy(), _np(jrots), atol=1e-5)
    np.testing.assert_allclose(trans.numpy(), _np(jtrans), atol=1e-5)


def test_eff_pose_match():
    q = _configs(seed=1, corners=True)
    rot, trans = tkin.eff_pose(torch.from_numpy(q))
    jrot, jtrans = jkin.eff_pose(jnp.asarray(q))
    np.testing.assert_allclose(rot.numpy(), _np(jrot), atol=1e-5)
    np.testing.assert_allclose(trans.numpy(), _np(jtrans), atol=1e-5)
    pos, quat = tkin.eff_pose_quat(torch.from_numpy(q))
    jpos, jquat = jkin.eff_pose_quat(jnp.asarray(q))
    np.testing.assert_allclose(pos.numpy(), _np(jpos), atol=1e-5)
    np.testing.assert_allclose(quat.numpy(), _np(jquat), atol=1e-5)


def test_bank_point_cloud_and_end_effector_match():
    q = _configs(4, seed=2)
    ours = tsm.bank_point_cloud(torch.from_numpy(q))
    np.testing.assert_allclose(ours.numpy(), _np(jsm.bank_point_cloud(jnp.asarray(q))),
                               atol=1e-6)
    rot, trans = jkin.eff_pose(jnp.asarray(q))
    ours = tsm.sample_end_effector(torch.from_numpy(_np(rot)), torch.from_numpy(_np(trans)))
    np.testing.assert_allclose(ours.numpy(), _np(jsm.sample_end_effector(rot, trans)),
                               atol=1e-6)


def test_sample_robot_points_given_indices():
    q = _configs(3, seed=3)
    key = jax.random.PRNGKey(7)
    ref = jsm.sample_robot_points(jnp.asarray(q), key, 256)
    idx = jax.random.randint(key, (q.shape[0], 256), 0, 8192)
    tq = torch.from_numpy(q)
    ours = tsm.sample_robot_points(tq, num_points=256, indices=torch.from_numpy(_np(idx)))
    # the gather is exact; the bank coordinates carry FK's rounding
    world = tsm.bank_point_cloud(tq)
    np.testing.assert_array_equal(
        ours.numpy(), np.take_along_axis(world.numpy(), _np(idx)[..., None], 1))
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=1e-6)
    drawn = tsm.sample_robot_points(tq, torch.Generator().manual_seed(0), 256)
    assert drawn.shape == (3, 256, 3)


def _ragged_scenes(seed=4):
    rng = np.random.default_rng(seed)
    cubs, cyls = [], []
    for n_cub, n_cyl in ((3, 1), (1, 0), (9, 2)):
        cubs.append([(rng.normal(size=3), rng.uniform(0.05, 0.4, 3), rng.normal(size=4))
                     for _ in range(n_cub)])
        cyls.append([(rng.normal(size=3), rng.uniform(0.02, 0.1), rng.uniform(0.05, 0.3),
                      rng.normal(size=4)) for _ in range(n_cyl)])
    return cubs, cyls


@pytest.mark.parametrize("max_sizes", [(None, None), (12, 3)])
def test_pack_scenes_and_areas_match(max_sizes):
    cubs, cyls = _ragged_scenes()
    ours = tsc.pack_scenes(cubs, cyls, *max_sizes)
    ref = jsc.pack_scenes(cubs, cyls, *max_sizes)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_allclose(tsc.cuboid_surface_areas(ours.cuboid_dims).numpy(),
                               _np(jsc.cuboid_surface_areas(ref.cuboid_dims)), atol=1e-6)
    np.testing.assert_allclose(
        tsc.cylinder_surface_areas(ours.cylinder_radii, ours.cylinder_heights).numpy(),
        _np(jsc.cylinder_surface_areas(ref.cylinder_radii, ref.cylinder_heights)), atol=1e-6)
    empty, jempty = tsc.empty_scene((2,), 3, 2), jsc.empty_scene((2,), 3, 2)
    for a, b in zip(empty, jempty):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def _jax_obstacle_draws(key, scene, n):
    """The draws ``mpinets_tpu.geom.scene.sample_obstacle_points`` makes,
    repeated step by step with jax.random."""
    m1, m2 = scene.num_cuboids, scene.num_cylinders
    k_which, k_cub, k_cyl = jax.random.split(key, 3)
    areas = jnp.concatenate([
        jsc.cuboid_surface_areas(scene.cuboid_dims),
        jsc.cylinder_surface_areas(scene.cylinder_radii, scene.cylinder_heights),
    ])
    which = jax.random.categorical(k_which, jnp.log(areas + 1e-12), shape=(n,))
    dims = scene.cuboid_dims[jnp.clip(which, 0, m1 - 1)]
    k_face, k_uv, k_sign = jax.random.split(k_cub, 3)
    face_areas = jnp.stack([dims[:, 1] * dims[:, 2], dims[:, 0] * dims[:, 2],
                            dims[:, 0] * dims[:, 1]], -1)
    cyl = jnp.clip(which - m1, 0, m2 - 1)
    r, h = scene.cylinder_radii[cyl, 0], scene.cylinder_heights[cyl, 0]
    k_region, k_theta, k_z, k_r, k_cap = jax.random.split(k_cyl, 5)
    region = jnp.log(jnp.stack([2 * jnp.pi * r * h, 2 * jnp.pi * r * r], -1) + 1e-12)
    t = lambda a: torch.from_numpy(np.array(a))
    return tsc.ObstacleDraws(
        which=t(which).long(),
        cuboid_face=t(jax.random.categorical(k_face, jnp.log(face_areas + 1e-12), axis=-1)).long(),
        cuboid_positive=t(jax.random.bernoulli(k_sign, 0.5, (n,))),
        cuboid_uv=t(jax.random.uniform(k_uv, (n, 3), minval=-1.0, maxval=1.0)),
        cylinder_on_cap=t(jax.random.categorical(k_region, region, axis=-1) == 1),
        cylinder_theta=t(jax.random.uniform(k_theta, (n,), minval=0.0, maxval=2 * jnp.pi)),
        cylinder_z=t(jax.random.uniform(k_z, (n,), minval=-0.5, maxval=0.5)),
        cylinder_r=t(jax.random.uniform(k_r, (n,))),
        cylinder_top=t(jax.random.bernoulli(k_cap, 0.5, (n,))),
    )


def test_sample_obstacle_points_given_draws():
    cubs, cyls = _ragged_scenes(5)
    jscene = jsc.pack_scenes(cubs, cyls)
    tscene = tsc.pack_scenes(cubs, cyls)
    for i in range(len(cubs)):
        key = jax.random.PRNGKey(10 + i)
        one = jsc.SceneSet(*(f[i] for f in jscene))
        ref = jsc.sample_obstacle_points(key, one, 512)
        draws = _jax_obstacle_draws(key, one, 512)
        ours = tsc.place_obstacle_points(tsc.SceneSet(*(f[i] for f in tscene)), draws)
        np.testing.assert_allclose(ours.numpy(), _np(ref), atol=1e-6)


def test_sampled_obstacle_points_lie_on_surfaces():
    """Property: each drawn point lies on the surface of the primitive it
    names, and only primitives with area are drawn."""
    cubs, cyls = _ragged_scenes(6)
    scene = tsc.pack_scenes(cubs, cyls)
    pts = tsc.sample_obstacle_points(scene, 2048, torch.Generator().manual_seed(1))
    rot_c = tt.quat_to_matrix_np(scene.cuboid_quats.numpy())
    rot_y = tt.quat_to_matrix_np(scene.cylinder_quats.numpy())
    m1 = scene.num_cuboids
    seen = set()
    for b in range(pts.shape[0]):
        for p in pts[b].numpy().astype(np.float64):
            w = int(p[3])
            seen.add((b, w))
            if w < m1:
                half = scene.cuboid_dims[b, w].numpy() / 2
                assert (half > 0).all()
                local = rot_c[b, w].T @ (p[:3] - scene.cuboid_centers[b, w].numpy())
                assert np.all(np.abs(local) <= half + 1e-5)
                assert np.min(np.abs(np.abs(local) - half)) < 1e-5
            else:
                j = w - m1
                r = float(scene.cylinder_radii[b, j, 0])
                h = float(scene.cylinder_heights[b, j, 0])
                assert r > 0 and h > 0
                local = rot_y[b, j].T @ (p[:3] - scene.cylinder_centers[b, j].numpy())
                rho = np.hypot(local[0], local[1])
                on_side = abs(rho - r) < 1e-5 and abs(local[2]) <= h / 2 + 1e-5
                on_cap = abs(abs(local[2]) - h / 2) < 1e-5 and rho <= r + 1e-5
                assert on_side or on_cap
    assert len(seen) > 8


def test_assemble_with_obstacles_given_draws():
    q = _configs(2, seed=7)
    rot, trans = jkin.eff_pose(jnp.asarray(q))
    rng = np.random.default_rng(8)
    obs = rng.normal(size=(2, 300, 3)).astype(np.float32)
    sizes = jas.PointCloudSizes(robot=64, obstacle=96, target=16)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    ref = jax.vmap(lambda k, q_, r, t, o: jas.assemble_point_cloud_with_obstacles(
        k, q_, r, t, o, sizes))(keys, jnp.asarray(q), rot, trans, jnp.asarray(obs))
    robot_idx, obs_idx = [], []
    for k in keys:
        k_robot, k_obs = jax.random.split(k)
        robot_idx.append(_np(jax.random.randint(k_robot, (64,), 0, 8192)))
        obs_idx.append(_np(jax.random.randint(k_obs, (96,), 0, 300)))
    ours = tas.assemble_point_cloud_with_obstacles(
        torch.from_numpy(q), torch.from_numpy(_np(rot)), torch.from_numpy(_np(trans)),
        torch.from_numpy(obs), tas.PointCloudSizes(64, 96, 16),
        robot_indices=torch.from_numpy(np.stack(robot_idx)),
        obstacle_indices=torch.from_numpy(np.stack(obs_idx)),
    )
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=1e-6)
    # the obstacle segment and the labels are gathered / written exactly
    np.testing.assert_array_equal(ours[:, 64:160].numpy(), _np(ref)[:, 64:160])
    np.testing.assert_array_equal(ours[..., 3].numpy(), _np(ref)[..., 3])


def test_assemble_point_cloud_layout():
    q = torch.from_numpy(_configs(2, seed=9))
    rot, trans = tkin.eff_pose(q)
    cubs, cyls = _ragged_scenes(10)
    scene = tsc.SceneSet(*(f[:2] for f in tsc.pack_scenes(cubs, cyls)))
    sizes = tas.PointCloudSizes(32, 64, 16)
    pc = tas.assemble_point_cloud(q, rot, trans, scene, sizes, torch.Generator().manual_seed(0))
    assert pc.shape == (2, 112, 4)
    np.testing.assert_array_equal(pc[0, :, 3].numpy(), _np(jas.segmentation_labels(sizes)))
    np.testing.assert_allclose(pc[:, -16:, :3].numpy(),
                               tsm.sample_end_effector(rot, trans, 16).numpy())
    new = torch.zeros(2, 32, 3)
    out = tas.update_robot_points(pc.clone(), new)
    ref = jas.update_robot_points(jnp.asarray(pc.numpy()), jnp.zeros((2, 32, 3)))
    np.testing.assert_array_equal(out.numpy(), _np(ref))


def _problems(point_cloud: bool, mod):
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        obstacles = None if point_cloud else [
            mod.Cuboid(rng.normal(size=3), rng.uniform(0.1, 0.3, 3), rng.normal(size=4)),
            mod.Cylinder(rng.normal(size=3), 0.05, 0.2, rng.normal(size=4)),
        ][: 1 + i % 2]
        out.append(mod.PlanningProblem(
            target=mod.Pose(rng.normal(size=3), rng.normal(size=4)),
            target_volume=mod.Cuboid(rng.normal(size=3), (0.2, 0.2, 0.2), (1, 0, 0, 0)),
            q0=rng.uniform(-1, 1, 7),
            obstacles=obstacles,
            obstacle_point_cloud=rng.normal(size=(50 + 10 * i, 3)) if point_cloud else None,
            target_negative_volumes=[mod.Cuboid(rng.normal(size=3), (0.1, 0.1, 0.1),
                                                (1, 0, 0, 0))],
        ))
    return out


@pytest.mark.parametrize("point_cloud", [False, True])
def test_problems_to_batch_matches(point_cloud):
    ours = problems_to_batch(_problems(point_cloud, tt), device="cpu")
    ref = j_problems_to_batch(_problems(point_cloud, jt))
    op, rp = ours["problem"], ref["problem"]
    for name in ("q0", "target_rot", "target_trans"):
        np.testing.assert_allclose(getattr(op, name).numpy(), _np(getattr(rp, name)),
                                   atol=1e-6)
    for a, b in zip(op.scene, rp.scene):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for vol in ("target_volumes", "negative_volumes"):
        for a, b in zip(ours[vol], ref[vol]):
            np.testing.assert_array_equal(a.numpy(), _np(b))
    if point_cloud:
        np.testing.assert_array_equal(op.obstacle_points.numpy(), _np(rp.obstacle_points))
    else:
        assert op.obstacle_points is None and rp.obstacle_points is None
