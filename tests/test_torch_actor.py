"""Port parity: the DAgger collectors, ``mpinets_torch.train.actor``
against ``mpinets_tpu.train.actor``, and the trainer's actor-learner mode.

Both collectors run the same weights (JAX's, converted) at tiny widths.
The port is handed the JAX package's draws, made in the test with the same
``jax.random`` calls (the problems, the rollout's first cloud and per-step
robot-bank indices, the visited step, the fallback step, the relabelled
cloud's robot and obstacle draws), so every returned key must agree to the
rollout's tolerance, atol 1e-4 (``tests/test_torch_rollout.py``), and
``dagger_accept_frac`` exactly. The real collector runs on per-row scenes
where some relabels are refused (the goal inside a box) and fall back to
the stored expert step. Then the trainer's actor modes run on the CPU, the
synthetic one and the hdf5 one (real-scene collects on a dataset): 10
steps with collects at steps 3, 6 and 9 (the counterpart of
``tests/test_trainer_cli.py::test_trainer_actor_learner_mode``).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_train import _jax_obstacle_draws  # noqa: E402  (tests dir is on sys.path)

from mpinets_torch.cli import config as tconfig  # noqa: E402
from mpinets_torch.geom.assembly import PointCloudSizes  # noqa: E402
from mpinets_torch.geom.scene import ObstacleDraws, SceneSet  # noqa: E402
from mpinets_torch.model import checkpoint  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_torch.train import actor as tactor  # noqa: E402
from mpinets_torch.train.trainer import Trainer  # noqa: E402
from mpinets_tpu.data import synthetic as jsyn  # noqa: E402
from mpinets_tpu.geom import assembly as jas  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402
from mpinets_tpu.robot import point_banks  # noqa: E402
from mpinets_tpu.train import actor as jactor  # noqa: E402

torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs files in
    parallel workers, where more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

NPOINTS = (16, 8)
SIZES = (64, 48, 16)
STEPS = 3
B = 4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def models():
    sizes = jas.PointCloudSizes(*SIZES)
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, sizes.total, 4)),
                                     jnp.zeros((1, 7)))
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu")
    model.load_state_dict(checkpoint.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return jmodel, variables, model.eval(), sizes


def _cloud_draws(key, scene, b, sizes):
    """The robot and obstacle draws of ``vmap(assemble_point_cloud)`` over
    ``split(key, b)``."""
    robot, obstacle = [], []
    for i, k in enumerate(jax.random.split(key, b)):
        k_robot, k_obs = jax.random.split(k)
        robot.append(jax.random.randint(k_robot, (sizes.robot,), 0, point_banks.DEFAULT_BANK_SIZE))
        obstacle.append(_jax_obstacle_draws(k_obs, jsc.SceneSet(*(f[i] for f in scene)),
                                            sizes.obstacle))
    return jnp.stack(robot), [jnp.stack(f) for f in zip(*obstacle)]


def _rollout_draws(key, q0, rot, trans, scene, b, sizes):
    """The first cloud and per-step bank indices JAX's rollout draws."""
    k_init, k_steps = jax.random.split(key)
    xyz0 = jax.vmap(lambda k, q, r, t, s: jas.assemble_point_cloud(k, q, r, t, s, sizes))(
        jax.random.split(k_init, b), q0, rot, trans, scene)
    idx = jnp.stack([jax.random.randint(k, (b, sizes.robot), 0, 8192)
                     for k in jax.random.split(k_steps, STEPS)])
    return xyz0, idx


def _obstacle(obstacle):
    return ObstacleDraws(*map(_t, obstacle))._replace(
        which=_t(obstacle[0]).long(), cuboid_face=_t(obstacle[1]).long())


def _assert_batches_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape and ours[k].dtype == torch.float32, k
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), atol=1e-4, err_msg=k)


def test_synthetic_collector_on_jaxs_draws(models):
    jmodel, variables, model, sizes = models
    key = jax.random.PRNGKey(5)
    ref = jactor.make_dagger_collector(jmodel, STEPS, sizes)(variables, key, B)

    @jax.jit
    def draws(key):
        keys = jax.random.split(key, 6)
        scene = jax.vmap(jsyn.random_scene)(jax.random.split(keys[0], B))
        q0 = jsyn.random_configuration(jax.random.fold_in(keys[1], 0), (B,))
        q_goal = jsyn.random_configuration(jax.random.fold_in(keys[1], 1), (B,))
        rot, trans = jkin.eff_pose(q_goal)
        xyz0, idx = _rollout_draws(keys[2], q0, rot, trans, scene, B, sizes)
        t = jax.random.randint(keys[3], (B,), 0, STEPS + 1)
        robot, obstacle = _cloud_draws(keys[4], scene, B, sizes)
        return scene, q0, q_goal, xyz0, idx, t, robot, obstacle

    scene, q0, q_goal, xyz0, idx, t, robot, obstacle = draws(key)
    d = tactor.DaggerDraws(_t(t), _t(robot), _obstacle(obstacle), SceneSet(*map(_t, scene)),
                           _t(q0), _t(q_goal), rollout_cloud=_t(xyz0), rollout_indices=_t(idx))
    collect = tactor.make_dagger_collector(model, STEPS, PointCloudSizes(*SIZES), device="cpu")
    _assert_batches_close(collect(B, draws=d), ref)
    # its own draws: the same layout, and the same batch again from the same seed
    a = collect(3, torch.Generator().manual_seed(1))
    b = collect(3, torch.Generator().manual_seed(1))
    assert {k: v.shape[1:] for k, v in a.items()} == {k: v.shape[1:] for k, v in ref.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)


def _problem_batch(sizes):
    """B rows near the neutral pose (expert min-jerk paths of 10 steps),
    each with its own scene: a far box for rows 0-1, a box around the
    goal's end effector for rows 2-3 (their relabels collide)."""
    rng = np.random.default_rng(7)
    neutral = np.asarray(franka.NEUTRAL_Q, np.float32)
    q0 = np.clip(neutral + rng.normal(0, 0.1, (B, 7)), franka.REAL_JOINT_LIMITS[:, 0],
                 franka.REAL_JOINT_LIMITS[:, 1]).astype(np.float32)
    qg = np.clip(neutral + rng.normal(0, 0.2, (B, 7)), franka.REAL_JOINT_LIMITS[:, 0],
                 franka.REAL_JOINT_LIMITS[:, 1]).astype(np.float32)
    expert = np.asarray(jsyn.min_jerk_trajectory(jnp.asarray(q0), jnp.asarray(qg), 10))
    _, ee = jkin.eff_pose(jnp.asarray(qg))
    cubs = [[([1.5, 1.5, 1.5], [0.1, 0.1, 0.1], [1, 0, 0, 0])]] * 2 + [
        [(np.asarray(ee[i]), [0.15, 0.15, 0.15], [1, 0, 0, 0])] for i in (2, 3)]
    scene = jsc.pack_scenes(cubs, [[([0.0, 0.9, 0.2], 0.05, 0.2, [1, 0, 0, 0])]] * B)
    return {"expert": expert, "raw_configuration": q0, "raw_goal": qg,
            **{f: np.asarray(getattr(scene, f)) for f in jsc.SceneSet._fields}}


def test_real_collector_on_jaxs_draws(models):
    jmodel, variables, model, sizes = models
    pb = _problem_batch(sizes)
    key = jax.random.PRNGKey(9)
    ref, ref_info = jactor.make_real_dagger_collector(jmodel, STEPS, sizes, opt_steps=10)(
        variables, key, {k: jnp.asarray(v) for k, v in pb.items()})

    @jax.jit
    def draws(key, q0, q_goal, scene):
        keys = jax.random.split(key, 4)
        rot, trans = jkin.eff_pose(q_goal)
        xyz0, idx = _rollout_draws(keys[0], q0, rot, trans, scene, B, sizes)
        t = jax.random.randint(keys[1], (B,), 1, STEPS + 1)
        t_exp = jax.random.randint(keys[2], (B,), 0, pb["expert"].shape[1] - 1)
        robot, obstacle = _cloud_draws(keys[3], scene, B, sizes)
        return xyz0, idx, t, t_exp, robot, obstacle

    jscene = jsc.SceneSet(*(jnp.asarray(pb[f]) for f in jsc.SceneSet._fields))
    xyz0, idx, t, t_exp, robot, obstacle = draws(key, pb["raw_configuration"], pb["raw_goal"],
                                                 jscene)
    d = tactor.DaggerDraws(_t(t), _t(robot), _obstacle(obstacle), t_expert=_t(t_exp),
                           rollout_cloud=_t(xyz0), rollout_indices=_t(idx))
    collect = tactor.make_real_dagger_collector(model, STEPS, PointCloudSizes(*SIZES),
                                                opt_steps=10, device="cpu")
    ours, info = collect({k: _t(v) for k, v in pb.items()}, draws=d)
    _assert_batches_close(ours, ref)
    assert float(info["dagger_accept_frac"]) == float(ref_info["dagger_accept_frac"])
    assert 0.0 < float(ref_info["dagger_accept_frac"]) < 1.0
    assert ours["supervision"].abs().max() <= 1.0 + 1e-5
    again, _ = collect({k: np.array(v) for k, v in pb.items()},   # its own draws, numpy
                       torch.Generator().manual_seed(2))
    assert again["xyz"].shape == ours["xyz"].shape


def test_trainer_actor_learner_mode(tmp_path):
    cfg = tconfig.load_config(None, {
        "data": {"num_robot_points": 64, "num_obstacle_points": 96, "num_target_points": 32},
        "model": {"sa_npoints": [16, 8], "sa_nsamples": [8, 8]},
        "optim": {"batch_size": 2, "bf16": False},
        "rollout": {"val_rollout_length": 3, "actor_interval": 3, "actor_rollout_steps": 2},
        "max_val_problems": 4, "save_checkpoint_dir": str(tmp_path)})
    cfg.data.synthetic = True
    trainer = Trainer(cfg, test=True, should_checkpoint=False, device="cpu")
    state = trainer.run()
    assert state.step == 13          # 10 offline steps + 3 actor steps (at steps 3, 6, 9)
    rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
    actor = [r for r in rows if "actor_val_loss" in r]
    assert [r["step"] for r in actor] == [3, 6, 9]
    keys = {"actor_val_loss", "actor_point_match_loss", "actor_collision_loss",
            "actor_hinge_active_frac", "actor_env_steps_per_s", "actor_learner_samples_per_s"}
    for r in actor:
        assert keys <= set(r) and all(np.isfinite(r[k]) for k in keys)


def test_hdf5_actor_mode_names_the_data_tools(tmp_path):
    """The hdf5 actor mode runs (the counterpart of the JAX trainer's real
    actor, ``mpinets_tpu/train/trainer.py:298-362``): 10 steps on a
    dataset the JAX package's writer wrote, real-scene collects on training
    trajectories at steps 3, 6 and 9, each logging ``dagger_accept_frac``
    with the actor keys."""
    from mpinets_tpu.data import writer as jwriter

    jwriter.write_synthetic_dataset(tmp_path / "data", "train", num_trajectories=6, seed=0)
    jwriter.write_synthetic_dataset(tmp_path / "data", "val", num_trajectories=4, seed=1)
    cfg = tconfig.load_config(None, {
        "data": {"num_robot_points": 64, "num_obstacle_points": 96, "num_target_points": 32,
                 "data_dir": str(tmp_path / "data")},
        "model": {"sa_npoints": [16, 8], "sa_nsamples": [8, 8]},
        "optim": {"batch_size": 2, "bf16": False},
        "rollout": {"val_rollout_length": 3, "actor_interval": 3, "actor_rollout_steps": 2,
                    "dagger_opt_steps": 5},
        "max_val_problems": 4, "save_checkpoint_dir": str(tmp_path)})
    trainer = Trainer(cfg, test=True, should_checkpoint=False, device="cpu")
    state = trainer.run()
    assert state.step == 13          # 10 offline steps + 3 actor steps (at steps 3, 6, 9)
    rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
    actor = [r for r in rows if "actor_val_loss" in r]
    assert [r["step"] for r in actor] == [3, 6, 9]
    keys = {"actor_val_loss", "actor_point_match_loss", "actor_collision_loss",
            "actor_hinge_active_frac", "actor_env_steps_per_s", "actor_learner_samples_per_s",
            "dagger_accept_frac"}
    for r in actor:
        assert keys <= set(r) and all(np.isfinite(r[k]) for k in keys)
        assert 0.0 <= r["dagger_accept_frac"] <= 1.0


def test_collectors_need_a_card_or_cpu(models, monkeypatch):
    *_, model, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tactor.make_dagger_collector, tactor.make_real_dagger_collector):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(model)
