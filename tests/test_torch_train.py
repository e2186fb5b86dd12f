"""Port parity: the training path of ``mpinets_torch`` against
``mpinets_tpu`` -- synthetic batches, losses, the optimizer and one train
step (the config, checkpoints and the trainer: ``test_torch_trainer.py``).

Inputs come from numpy seeds; where the JAX package draws random numbers
(``training_batch``), the test makes the same draws with ``jax.random`` and
hands them to the port. Tolerances: ``min_jerk_trajectory`` 1e-6;
``training_batch`` 1e-5 (f32 FK chains); ``bc_losses`` and its gradient
1e-5 relative; the optimizer's parameters 1e-6 relative after 5 steps
(optax computes its learning-rate schedule in f32, the port in double);
one train step's metrics and parameters 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mpinets_torch.data import synthetic as tsyn  # noqa: E402
from mpinets_torch.geom import assembly as tas  # noqa: E402
from mpinets_torch.geom import scene as tsc  # noqa: E402
from mpinets_torch.model import checkpoint as tckpt  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.train import learner as tlearner  # noqa: E402
from mpinets_torch.train import loss as tloss  # noqa: E402
from mpinets_tpu.data import synthetic as jsyn  # noqa: E402
from mpinets_tpu.geom import assembly as jas  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402
from mpinets_tpu.robot import point_banks  # noqa: E402
from mpinets_tpu.train import learner as jlearner  # noqa: E402
from mpinets_tpu.train import loss as jloss  # noqa: E402

torch.set_float32_matmul_precision("highest")

NPOINTS = (16, 8)
SIZES = (64, 96, 32)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Synthetic training batches
# ---------------------------------------------------------------------------

def test_min_jerk_trajectory_matches():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-2, 2, (4, 7)).astype(np.float32) for _ in range(2))
    ours = tsyn.min_jerk_trajectory(_t(a), _t(b))
    ref = jsyn.min_jerk_trajectory(jnp.asarray(a), jnp.asarray(b))
    assert ours.shape == (4, tsyn.SEQUENCE_LENGTH, 7)
    np.testing.assert_allclose(ours.numpy(), _np(ref), atol=1e-6)


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
    return (  # the fields of ObstacleDraws, in order
        which,
        jax.random.categorical(k_face, jnp.log(face_areas + 1e-12), axis=-1),
        jax.random.bernoulli(k_sign, 0.5, (n,)),
        jax.random.uniform(k_uv, (n, 3), minval=-1.0, maxval=1.0),
        jax.random.categorical(k_region, region, axis=-1) == 1,
        jax.random.uniform(k_theta, (n,), minval=0.0, maxval=2 * jnp.pi),
        jax.random.uniform(k_z, (n,), minval=-0.5, maxval=0.5),
        jax.random.uniform(k_r, (n,)),
        jax.random.bernoulli(k_cap, 0.5, (n,)),
    )


def _jax_training_draws(key, b, sizes):
    """The draws ``mpinets_tpu.data.synthetic.training_batch`` makes."""

    @jax.jit
    def draws(key):
        keys = jax.random.split(key, 6)
        scene = jax.vmap(jsyn.random_scene)(jax.random.split(keys[0], b))
        robot, obstacle = [], []
        for i, k in enumerate(jax.random.split(keys[4], b)):
            k_robot, k_obs = jax.random.split(k)
            robot.append(jax.random.randint(k_robot, (sizes.robot,), 0,
                                            point_banks.DEFAULT_BANK_SIZE))
            obstacle.append(_jax_obstacle_draws(k_obs, jsc.SceneSet(*(f[i] for f in scene)),
                                                sizes.obstacle))
        return (scene,
                jsyn.random_configuration(jax.random.fold_in(keys[1], 0), (b,)),
                jsyn.random_configuration(jax.random.fold_in(keys[1], 1), (b,)),
                jax.random.randint(keys[2], (b,), 0, jsyn.SEQUENCE_LENGTH),
                jax.random.normal(keys[3], (b, 7)), jnp.stack(robot),
                [jnp.stack(f) for f in zip(*obstacle)])

    scene, q0, q_goal, t, noise, robot, obstacle = draws(key)
    return tsyn.TrainingDraws(
        scene=tsc.SceneSet(*map(_t, scene)), q0=_t(q0), q_goal=_t(q_goal), t=_t(t),
        noise=_t(noise), robot_indices=_t(robot),
        obstacle=tsc.ObstacleDraws(*map(_t, obstacle))._replace(
            which=_t(obstacle[0]).long(), cuboid_face=_t(obstacle[1]).long()),
    )


@pytest.fixture(scope="module")
def jax_batch():
    key = jax.random.PRNGKey(3)
    return key, jsyn.training_batch(key, 3, sizes=jas.PointCloudSizes(*SIZES))


def test_training_batch_given_draws_matches(jax_batch):
    key, ref = jax_batch
    sizes = tas.PointCloudSizes(*SIZES)
    ours = tsyn.training_batch(sizes=sizes, draws=_jax_training_draws(key, 3, sizes))
    assert sorted(ours) == sorted(ref)  # (a jitted dict comes back with its keys sorted)
    for k, v in ref.items():
        assert ours[k].shape == v.shape and ours[k].dtype == torch.float32, k
        np.testing.assert_allclose(ours[k].numpy(), _np(v), atol=1e-5, err_msg=k)
    drawn = tsyn.training_batch(torch.Generator().manual_seed(0), 2, sizes)
    assert {k: v.shape[1:] for k, v in drawn.items()} == {k: v.shape[1:] for k, v in ours.items()}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def test_bc_losses_and_gradient_match(jax_batch):
    _, batch = jax_batch
    batch = {k: np.array(v) for k, v in batch.items()}
    # a box around the supervision pose's loss points, so the hinge is live
    pts = tloss.sampler.fixed_robot_points(
        tloss.unnormalize_franka_joints(_t(batch["supervision"])), 1024).numpy()
    batch["cuboid_centers"][:, 1] = pts[:, 500]
    batch["cuboid_dims"][:, 1] = 0.15
    rng = np.random.default_rng(4)
    y_hat = (batch["supervision"] + rng.normal(0, 0.05, (3, 7))).astype(np.float32)
    jscene = jlearner.scene_from_batch({k: jnp.asarray(v) for k, v in batch.items()})
    tscene = tlearner.scene_from_batch({k: _t(v) for k, v in batch.items()})

    def jtotal(y):
        coll, pm, _ = jloss.bc_losses(y, jnp.asarray(batch["supervision"]), jscene)
        return pm + 5.0 * coll

    ref = jax.jit(jloss.bc_losses)(jnp.asarray(y_hat), jnp.asarray(batch["supervision"]), jscene)
    y = _t(y_hat).requires_grad_()
    ours = tloss.bc_losses(y, _t(batch["supervision"]), tscene)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    assert 0 < float(ours[0].detach()) and 0 < float(ours[2]) < 1
    (ours[1] + 5.0 * ours[0]).backward()
    g_ref = _np(jax.jit(jax.grad(jtotal))(jnp.asarray(y_hat)))
    np.testing.assert_allclose(y.grad.numpy(), g_ref, rtol=1e-5, atol=1e-5 * np.abs(g_ref).max())


# ---------------------------------------------------------------------------
# Optimizer and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup, decay", [(0, 0), (2, 6), (0, 4)])
def test_optimizer_matches_optax(warmup, decay):
    rng = np.random.default_rng(5)
    shapes = [(5, 3), (7,), (2, 4, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # steps 0, 2 and 4 have a global norm above the clip, 1 and 3 below it
    grads = [[(rng.normal(size=s) * (3.0 if k % 2 == 0 else 0.05)).astype(np.float32)
              for s in shapes] for k in range(5)]
    opt = jlearner.make_optimizer(1e-2, 1.0, warmup_steps=warmup, decay_steps=decay)
    jparams = [jnp.asarray(p) for p in params]
    jstate = opt.init(jparams)
    ours = [torch.nn.Parameter(_t(p)) for p in params]
    topt = tlearner.make_optimizer(ours, 1e-2, 1.0, warmup_steps=warmup, decay_steps=decay)
    for g in grads:
        updates, jstate = opt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(ours, g):
            p.grad = _t(x)
        topt.step()
    for a, b in zip(ours, jparams):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), rtol=1e-6, atol=1e-7)
    if decay:
        sched = optax.warmup_cosine_decay_schedule(
            1e-2 * 0.05 if warmup else 1e-2, 1e-2, warmup, decay, 1e-3)
        for count in range(decay + 3):
            np.testing.assert_allclose(
                tlearner.ClippedAdam.learning_rate(topt.param_groups[0], count),
                float(sched(count)), rtol=1e-6)


def _perturbed_flax(seed=0):
    rng = np.random.default_rng(seed)
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, sum(SIZES), 4)),
                                     jnp.zeros((1, 7)))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.normal(size=a.shape).astype(np.float32),
        variables)
    return jmodel, variables


def test_train_step_matches_jax(jax_batch):
    _, batch = jax_batch
    jmodel, variables = _perturbed_flax(6)
    opt = jlearner.make_optimizer()
    state = jlearner.TrainState(variables, opt.init(variables), jnp.zeros((), jnp.int32))
    state, jmetrics = jlearner.make_train_step(jmodel, opt)(state, batch)

    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu")
    model.load_state_dict(tckpt.params_from_flax(variables))
    tstate = tlearner.init_state(model)
    tstate, metrics = tlearner.make_train_step()(tstate, {k: _t(v) for k, v in batch.items()})
    assert tstate.step == 1 and set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    ref = tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5, err_msg=k)
