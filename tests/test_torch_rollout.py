"""Port parity: the lockstep rollout engine.

The JAX package's ``make_rollout_fn`` (with ``model.apply``) and the
port's run the same weights on the same problems for 3 steps; the port is
handed JAX's own draws -- the initial cloud and each step's robot-bank
indices (``mpinets_tpu/rollout/engine.py:110,129,165``) -- so the
trajectories must agree to atol 1e-4 and ``num_steps`` exactly
(``tests/test_pallas_sa.py:161-167``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.data.synthetic import Problem, random_problem, random_problem_batch  # noqa: E402
from mpinets_torch.geom.assembly import PointCloudSizes  # noqa: E402
from mpinets_torch.geom.scene import SceneSet  # noqa: E402
from mpinets_torch.model import checkpoint  # noqa: E402
from mpinets_torch.model.fused import make_fused_apply  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_torch.rollout import engine as teng  # noqa: E402
from mpinets_tpu.data import synthetic as jsyn  # noqa: E402
from mpinets_tpu.geom import assembly as jas  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402
from mpinets_tpu.rollout import engine as jeng  # noqa: E402

torch.set_float32_matmul_precision("highest")

NPOINTS = (16, 8)
SIZES = (64, 48, 16)
STEPS = 3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    sizes = jas.PointCloudSizes(*SIZES)
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, sizes.total, 4)),
                                     jnp.zeros((1, 7)))
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu")
    model.load_state_dict(checkpoint.params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    prob = jax.jit(jsyn.random_problem_batch, static_argnums=1)(jax.random.PRNGKey(2), 3)
    # problem 0 starts at its target, so stop_on_success freezes it at t=0
    rot0, trans0 = jkin.eff_pose(prob.q0[0])
    prob = prob._replace(target_rot=prob.target_rot.at[0].set(rot0),
                         target_trans=prob.target_trans.at[0].set(trans0))
    obstacles = jax.random.uniform(jax.random.PRNGKey(3), (3, 70, 3), minval=-0.5, maxval=0.9)
    return jmodel, variables, model.eval(), prob, obstacles, sizes


def _jax_draws(key, prob, sizes, with_points):
    """The initial cloud and per-step bank indices JAX's rollout draws."""
    b = prob.q0.shape[0]
    k_init, k_steps = jax.random.split(key)
    keys = jax.random.split(k_init, b)
    if with_points:
        xyz0 = jax.vmap(lambda k, q, r, t, o: jas.assemble_point_cloud_with_obstacles(
            k, q, r, t, o, sizes))(keys, prob.q0, prob.target_rot, prob.target_trans,
                                   prob.obstacle_points)
    else:
        xyz0 = jax.vmap(lambda k, q, r, t, s: jas.assemble_point_cloud(k, q, r, t, s, sizes))(
            keys, prob.q0, prob.target_rot, prob.target_trans, prob.scene)
    idx = jnp.stack([jax.random.randint(k, (b, sizes.robot), 0, 8192)
                     for k in jax.random.split(k_steps, STEPS)])
    return _t(xyz0), _t(idx)


def _torch_problem(prob):
    return Problem(_t(prob.q0), _t(prob.target_rot), _t(prob.target_trans),
                   SceneSet(*map(_t, prob.scene)),
                   None if prob.obstacle_points is None else _t(prob.obstacle_points))


@pytest.mark.parametrize("stop_on_success,mode,path", [
    (True, "scene", "plain"),
    (False, "scene", "plain"),
    (True, "points", "fused"),
])
def test_rollout_matches_jax(setup, stop_on_success, mode, path):
    jmodel, variables, model, prob, obstacles, sizes = setup
    if mode == "points":
        prob = prob._replace(obstacle_points=obstacles)
    key = jax.random.PRNGKey(4)
    ref = jeng.make_rollout_fn(jmodel, max_steps=STEPS, sizes=sizes,
                               stop_on_success=stop_on_success)(variables, prob, key)
    xyz0, idx = _jax_draws(key, prob, sizes, mode == "points")
    apply_fn = make_fused_apply(torch.float32) if path == "fused" else None
    ours = teng.make_rollout_fn(model, max_steps=STEPS, sizes=PointCloudSizes(*SIZES),
                                stop_on_success=stop_on_success, apply_fn=apply_fn,
                                device="cpu")(_torch_problem(prob), init_cloud=xyz0,
                                              robot_indices=idx)
    np.testing.assert_allclose(ours.trajectories.numpy(), np.asarray(ref.trajectories),
                               atol=1e-4)
    np.testing.assert_array_equal(ours.num_steps.numpy(), np.asarray(ref.num_steps))
    np.testing.assert_array_equal(ours.success.numpy(), np.asarray(ref.success))
    np.testing.assert_allclose(ours.final_q.numpy(), np.asarray(ref.final_q), atol=1e-4)
    np.testing.assert_array_equal(teng.frozen_trajectory_mask(ours).numpy(),
                                  np.asarray(jeng.frozen_trajectory_mask(ref)))
    if stop_on_success:  # problem 0 froze at its start (q0 up to normalization's rounding)
        assert ours.num_steps[0] == 0 and ours.success[0]
        frozen = ours.trajectories[0, 1:].numpy()
        np.testing.assert_array_equal(frozen, np.broadcast_to(frozen[:1], (STEPS, 7)))
        np.testing.assert_allclose(frozen[0], ours.trajectories[0, 0].numpy(), atol=1e-6)


def test_rollout_draws_its_own_cloud(setup):
    *_, model, _, _, _ = setup
    g = torch.Generator().manual_seed(0)
    prob = random_problem_batch(g, 2, device="cpu")
    run = teng.make_rollout_fn(model, max_steps=2, sizes=PointCloudSizes(*SIZES),
                               stop_on_success=False, record_trajectory=False, device="cpu")
    a = run(prob, torch.Generator().manual_seed(5))
    b = run(prob, torch.Generator().manual_seed(5))
    assert a.trajectories.shape == (2, 1, 7) and a.num_steps.tolist() == [2, 2]
    assert torch.equal(a.final_q, b.final_q)
    lim = torch.as_tensor(franka.REAL_JOINT_LIMITS, dtype=torch.float32)
    assert ((a.final_q >= lim[:, 0] - 1e-5) & (a.final_q <= lim[:, 1] + 1e-5)).all()
    one = random_problem(g, device="cpu")
    assert one.q0.shape == (7,) and one.target_rot.shape == (3, 3)
    assert one.scene.cuboid_dims.shape == (8, 3) and one.scene.cylinder_radii.shape == (8, 1)


def test_success_predicate_and_orientation_error_match():
    rng = np.random.default_rng(6)
    q = rng.uniform(-1, 1, (8, 7)).astype(np.float32)
    rot, trans = jkin.eff_pose(jnp.asarray(q))
    q2 = q + rng.normal(0, 0.02, q.shape).astype(np.float32)
    rot2, trans2 = jkin.eff_pose(jnp.asarray(q2))
    np.testing.assert_allclose(
        teng.orientation_error_deg(_t(rot), _t(rot2)).numpy(),
        np.asarray(jeng.orientation_error_deg(rot, rot2)), atol=1e-3)
    np.testing.assert_array_equal(
        teng.success_predicate(_t(q2), _t(rot), _t(trans)).numpy(),
        np.asarray(jeng.success_predicate(jnp.asarray(q2), rot, trans)))
