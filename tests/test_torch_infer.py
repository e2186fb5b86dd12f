"""Port parity: the evaluation path end to end (``cli.infer``).

``evaluate_problem_set`` runs in both packages on one problem set at small
widths (SA 16/8 centroids, 8 neighbours), f32, 3 steps, batch 2 (a group of
four problems runs as two chunks): the JAX package with ``fused=False``,
the port on the CPU (its plain policy), handed the JAX package's draws for
each chunk -- the initial cloud and each step's robot-bank indices from
``fold_in(PRNGKey(0), lo)`` (``mpinets_tpu/cli/infer.py:221``), replayed as
``tests/test_torch_rollout.py`` does. Tolerances: trajectories within 1e-5
(absolute), ``num_steps`` equal, ``metrics()`` as in
``tests/test_torch_eval.py`` (floats 1e-5, orientation 0.05 deg, ``time``
left out). The port reads the set from the JAX package's own pickle.

``main`` and ``--use-depth`` run end to end on the CPU at small widths;
the fused path's composition runs there too, on its kernels' plain versions.
"""

import functools
import io
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.cli import infer, rollout_demo  # noqa: E402
from mpinets_torch.data import problems as P  # noqa: E402
from mpinets_torch.geom.assembly import PointCloudSizes  # noqa: E402
from mpinets_torch.model import checkpoint as C  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.rollout import engine  # noqa: E402
from mpinets_tpu import types as JT  # noqa: E402
from mpinets_tpu.cli import infer as jinfer  # noqa: E402
from mpinets_tpu.data import problems as JP  # noqa: E402
from mpinets_tpu.data.synthetic import Problem as JProblem  # noqa: E402
from mpinets_tpu.geom import assembly as jas  # noqa: E402
from mpinets_tpu.geom.scene import SceneSet as JSceneSet  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402
from mpinets_tpu.robot import franka  # noqa: E402

from test_torch_eval import assert_metrics_match  # noqa: E402

torch.set_float32_matmul_precision("highest")

WIDTHS = dict(sa_npoints=(16, 8), sa_nsamples=(8, 8), sa_radii=(0.05, 0.3))
STEPS = 3
TRAJ_TOL = 1e-5
SMALL = PointCloudSizes(64, 96, 32)


def _jax_problem_set(points: bool):
    """Two groups (4 and 2 problems): start near the neutral pose, target
    at the FK pose of a nearby configuration inside a target cuboid; a
    table and a box, or (``points``) a sensed cloud of 500-700 points; a
    negative volume above the target. Every chunk has the same shapes, so
    the JAX package compiles its rollout once."""
    rng = np.random.default_rng(11 + points)
    groups = {}
    for scene_type, problem_type, n in (("tabletop", "task-oriented", 4),
                                        ("cubby", "neutral-start", 2)):
        probs = []
        for _ in range(n):
            q0 = np.asarray(franka.NEUTRAL_Q) + rng.uniform(-0.2, 0.2, 7)
            rot, pos = jkin.eff_pose(jnp.asarray(q0 + rng.uniform(-0.1, 0.1, 7)))
            pos = np.asarray(pos, np.float64)
            quat = JT.matrix_to_quat_np(np.asarray(rot, np.float64))
            kw = {}
            if points:
                kw["obstacle_point_cloud"] = rng.uniform(
                    [0.3, -0.5, 0.0], [1.0, 0.5, 0.6], (int(rng.integers(500, 700)), 3)
                ).astype(np.float32)
            else:
                kw["obstacles"] = [
                    JT.Cuboid([0.6, 0.0, -0.02], [1.0, 1.2, 0.04], [1, 0, 0, 0]),
                    JT.Cuboid(rng.uniform([0.4, -0.4, 0.1], [0.8, 0.4, 0.3]),
                              rng.uniform(0.05, 0.15, 3), [1, 0, 0, 0]),
                ]
            kw["target_negative_volumes"] = [
                JT.Cuboid(pos + [0.0, 0.0, 0.3], [0.1, 0.1, 0.1], [1, 0, 0, 0])]
            probs.append(JT.PlanningProblem(
                target=JT.Pose(pos, quat),
                target_volume=JT.Cuboid(pos, [0.3, 0.3, 0.3], [1, 0, 0, 0]),
                q0=q0, **kw))
        groups.setdefault(scene_type, {})[problem_type] = probs
    return groups


@pytest.fixture(scope="module")
def weights():
    jmodel = JaxPolicy(**WIDTHS)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 6272, 4)), jnp.zeros((1, 7))))
    return jmodel, variables, C.params_from_flax(variables)


def _jax_draws(lo, problem, sizes=jas.PointCloudSizes()):
    """The JAX rollout's draws for the chunk at ``lo`` (its key
    ``fold_in(PRNGKey(0), lo)``), for the port's ``problem``."""
    t = lambda x: None if x is None else jnp.asarray(x.numpy())
    jprob = JProblem(t(problem.q0), t(problem.target_rot), t(problem.target_trans),
                     JSceneSet(*map(t, problem.scene)), t(problem.obstacle_points))
    key = jax.random.fold_in(jax.random.PRNGKey(0), lo)
    b = jprob.q0.shape[0]
    k_init, k_steps = jax.random.split(key)
    keys = jax.random.split(k_init, b)
    if jprob.obstacle_points is not None:
        xyz0 = jax.vmap(lambda k, q, r, tr, o: jas.assemble_point_cloud_with_obstacles(
            k, q, r, tr, o, sizes))(keys, jprob.q0, jprob.target_rot, jprob.target_trans,
                                    jprob.obstacle_points)
    else:
        xyz0 = jax.vmap(lambda k, q, r, tr, s: jas.assemble_point_cloud(k, q, r, tr, s, sizes))(
            keys, jprob.q0, jprob.target_rot, jprob.target_trans, jprob.scene)
    idx = jnp.stack([jax.random.randint(k, (b, sizes.robot), 0, 8192)
                     for k in jax.random.split(k_steps, STEPS)])
    return torch.from_numpy(np.array(xyz0)), torch.from_numpy(np.array(idx))


def _recording(module, store):
    """``module.make_rollout_fn``, recording every rollout's result."""
    orig = module.make_rollout_fn

    def make(*args, **kwargs):
        fn = orig(*args, **kwargs)

        def run(*a, **k):
            store.append(fn(*a, **k))
            return store[-1]
        return run
    return make


@pytest.mark.parametrize("points", [False, True], ids=["primitives", "point_clouds"])
def test_evaluate_problem_set_matches_jax(weights, points, tmp_path, monkeypatch):
    jmodel, variables, params = weights
    jset = _jax_problem_set(points)
    JP.save_problems(tmp_path / "problems.pkl", jset)
    ours_set = P.load_problems(tmp_path / "problems.pkl")

    jresults, results = [], []
    monkeypatch.setattr(jinfer, "make_rollout_fn", _recording(jinfer, jresults))
    monkeypatch.setattr(infer, "make_rollout_fn", _recording(infer, results))
    jev = jinfer.evaluate_problem_set(variables, jset, batch_size=2, max_steps=STEPS,
                                      model=jmodel, fused=False)
    ev = infer.evaluate_problem_set(
        params, ours_set, batch_size=2, max_steps=STEPS, device="cpu",
        model=MotionPolicyNetwork(compute_dtype=torch.float32, device="cpu", **WIDTHS),
        draws=_jax_draws)

    assert len(results) == len(jresults) == 3   # chunks of 2 + 2, then 2
    for ours, ref in zip(results, jresults):
        np.testing.assert_allclose(ours.trajectories.numpy(), np.asarray(ref.trajectories),
                                   atol=TRAJ_TOL, rtol=0)
        np.testing.assert_array_equal(ours.num_steps.numpy(), np.asarray(ref.num_steps))
    assert ev.groups.keys() == jev.groups.keys() == {"tabletop_task-oriented",
                                                     "cubby_neutral-start"}
    for key in ev.groups:
        m, jm = ev.metrics(ev.groups[key]), jev.metrics(jev.groups[key])
        assert m["total"] == len(jset[key.split("_")[0]][key.split("_")[1]])
        assert_metrics_match(m, jm)
        for field in ("success", "collision", "self_collision", "joint_limit_violation",
                      "physical_violations", "num_steps"):
            assert ev.groups[key][field] == jev.groups[key][field], (key, field)


def _small_model(compute_dtype=torch.bfloat16, device="cpu", **kw):
    return MotionPolicyNetwork(compute_dtype=compute_dtype, device=device, sa_npoints=(16, 8))


def _short_rollouts(model, max_steps=engine.MAX_ROLLOUT_LENGTH, **kw):
    return engine.make_rollout_fn(model, max_steps=min(max_steps, STEPS), sizes=SMALL, **kw)


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """cli.infer's main at small widths, 3 steps, a 64 + 96 + 32-point
    cloud; a .npz of seeded weights and a problem set on disk."""
    monkeypatch.setattr(infer, "MotionPolicyNetwork", _small_model)
    monkeypatch.setattr(infer, "make_rollout_fn", _short_rollouts)
    model = MotionPolicyNetwork(device="cpu", sa_npoints=(16, 8),
                                generator=torch.Generator().manual_seed(0))
    C.save_flax_npz(tmp_path / "w.npz", C.flax_from_params(model.state_dict()))
    P.save_problems(tmp_path / "problems.pkl", _port_set_from(_jax_problem_set(False)))
    return tmp_path


@pytest.mark.parametrize("flags", [
    ["--use-depth", "--batch-size", "2"],
    ["--fp32", "--max-problems", "2", "--b1-timing"],
    ["--fast-grouping", "4", "--no-fused", "--use-ema", "--max-problems", "1"],
], ids=["depth", "fp32_b1", "fast_nofused"])
def test_main_runs_end_to_end_on_the_cpu(small_cli, flags, capsys):
    out_dir = small_cli / "metrics"
    ev = infer.main([str(small_cli / "w.npz"), str(small_cli / "problems.pkl"), "all", "all",
                     "--device", "cpu", "--save-metrics", str(out_dir), *flags])
    with open(out_dir / "mpinets_torch_eval_metrics.pkl", "rb") as f:
        saved = pickle.load(f)
    assert saved.keys() == ev.groups.keys() == {"tabletop_task-oriented", "cubby_neutral-start"}
    cap = int(flags[flags.index("--max-problems") + 1]) if "--max-problems" in flags else 4
    for key, total in (("tabletop_task-oriented", 4), ("cubby_neutral-start", 2)):
        assert ev.metrics(saved[key])["total"] == min(total, cap)
    text = capsys.readouterr().out
    assert "# rollout path: plain" in text and "== overall ==" in text
    assert ("# batch-1 per-step time" in text) == ("--b1-timing" in flags)
    assert ("(float32)" in text) == ("--fp32" in flags)


def test_use_depth_policy_sees_the_sensed_cloud(small_cli, monkeypatch):
    """Under --use-depth each chunk's obstacle points are its scenes' depth
    clouds (on the surfaces of the primitives), made from the seed 7000 + lo."""
    from mpinets_torch.geom import depth
    from mpinets_torch.kernels.sdf import scene_sdf

    seen = []
    orig = depth.scene_to_point_cloud

    def spy(scene, n, generator=None, cam=depth.Camera()):
        cloud = orig(scene, n, generator, cam)
        seen.append((scene, cloud))
        return cloud
    monkeypatch.setattr(depth, "scene_to_point_cloud", spy)
    infer.main([str(small_cli / "w.npz"), str(small_cli / "problems.pkl"), "tabletop", "all",
                "--device", "cpu", "--use-depth", "--batch-size", "2"])
    assert [c.shape for _, c in seen] == [(2, 4096, 3), (2, 4096, 3)]
    for scene, cloud in seen:
        assert scene_sdf(cloud, scene).abs().max() < 5e-3


def test_fused_path_on_the_cpu_matches_the_plain_policy(weights):
    """``fused=True`` composes the kernel wrappers (their plain versions on
    the CPU) at 128 neighbours; it must match the plain policy to 1e-4."""
    problem_set = _port_set_from(_jax_problem_set(False))
    tmp = {}
    for fused in (False, True):
        model = MotionPolicyNetwork(compute_dtype=torch.float32, device="cpu",
                                    sa_npoints=(16, 8), generator=torch.Generator().manual_seed(2))
        results = []
        make = _recording(engine, results)
        run = functools.partial(infer.evaluate_problem_set, None, problem_set,
                                batch_size=4, max_steps=2, model=model, fused=fused,
                                device="cpu", scene_filter="tabletop")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(infer, "make_rollout_fn", make)
            ev = run()
        tmp[fused] = (results[0], ev)
    (a, _), (b, ev) = tmp[False], tmp[True]
    np.testing.assert_allclose(b.trajectories.numpy(), a.trajectories.numpy(), atol=1e-4)
    assert ev.metrics(ev.groups["tabletop_task-oriented"])["total"] == 4


def _port_set_from(jset):
    """The JAX package's problem set as the port's types (its pickle, read
    through the port's unpickler)."""
    raw = P._ProblemUnpickler(io.BytesIO(pickle.dumps(jset))).load()
    return {s: {t: [P._convert_problem(p) for p in v] for t, v in by.items()}
            for s, by in raw.items()}


def test_rollout_demo_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(rollout_demo, "MotionPolicyNetwork", _small_model)
    monkeypatch.setattr(rollout_demo, "make_rollout_fn",
                        lambda model, max_steps, **kw: engine.make_rollout_fn(
                            model, max_steps=max_steps, sizes=SMALL, **kw))
    rollout_demo.main(["--batch", "2", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "batch 2 x 2 steps (plain on cpu)" in out and "final_q finite: True" in out
