"""Port parity: the evaluation modules.

The same numpy-made inputs go through the JAX package's functions and the
port's, on the CPU. Tolerances:

* SPARC: the scalar ``sparc`` bit-equal (the same numpy code on the same
  f64 profile); ``sparc_batched`` (f32) within 1e-6 relative (arc lengths
  of about -5, where one f32 ulp is 4.8e-7 and the two FFTs and sums round
  differently), and both within 1e-4 of the f64 scalar.
* ``check_trajectories`` on ``tests/test_eval.py``'s cases: booleans equal;
  floats within 1e-5 (absolute, + 1e-5 relative); orientation errors within
  0.05 deg absolute (``arccos`` near 0: one f32 ulp of the trace is about
  0.02 deg), and the orientation path within 0.05 deg a segment. Inputs sit
  away from the thresholds (1 cm, 15 deg, sdf <= r, region signs).
* ``Evaluator.metrics()``: the same keys, equal rates and counts, floats as
  above, ``time`` left out (wall clock).
* Problem sets: field for field equal (numpy arrays exactly), in one process
  in both orders of the two loaders; ``problems_to_batch`` tensors equal.
* The Lightning importer: arrays bit-equal to the JAX importer's.
* Depth: points within 1e-4 where both packages hit; hit masks equal except
  at rays within 1e-5 of the 5e-3 threshold; the cloud from JAX's
  categorical indices equal (1e-4).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch import types as T  # noqa: E402
from mpinets_torch.cli import infer, serve  # noqa: E402
from mpinets_torch.data import problems as P  # noqa: E402
from mpinets_torch.eval import metrics as M  # noqa: E402
from mpinets_torch.eval.sparc import sparc, sparc_batched  # noqa: E402
from mpinets_torch.geom import depth as D  # noqa: E402
from mpinets_torch.geom.scene import SceneSet, pack_scenes  # noqa: E402
from mpinets_torch.model import checkpoint as C  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_torch.train import learner  # noqa: E402
from mpinets_tpu import types as JT  # noqa: E402
from mpinets_tpu.data import problems as JP  # noqa: E402
from mpinets_tpu.eval import metrics as JM  # noqa: E402
from mpinets_tpu.eval import sparc as JS  # noqa: E402
from mpinets_tpu.geom import depth as JD  # noqa: E402
from mpinets_tpu.geom.scene import pack_scenes as jpack  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.model import checkpoint as JC  # noqa: E402

import torch_oracle  # noqa: E402  (tests dir is on sys.path under pytest)

REPO = Path(__file__).resolve().parent.parent
FLOAT_TOL = 1e-5
ORI_TOL_DEG = 0.05


def _t(x):
    return torch.from_numpy(np.array(x))


def _tscene(jscene):
    return SceneSet(*map(_t, jscene))


# ---------------------------------------------------------------------------
# SPARC
# ---------------------------------------------------------------------------

def _profiles():
    rng = np.random.default_rng(0)
    t = np.arange(-1, 1, 0.01)
    return [np.exp(-5 * t ** 2), np.zeros(50), rng.uniform(0, 1, 49),
            np.abs(np.sin(np.linspace(0, 3, 150))), rng.uniform(0, 1e-3, 7)]


@pytest.mark.parametrize("i", range(5))
def test_sparc_scalar_bit_equal(i):
    move = _profiles()[i]
    for fs in (100.0, 12.5):
        assert sparc(move, fs) == JS.sparc(move, fs)


def test_sparc_batched_matches_jax():
    rng = np.random.default_rng(1)
    profiles = rng.uniform(0.0, 1.0, (6, 49)).astype(np.float32)
    profiles[2] = 0.0
    ours = sparc_batched(torch.from_numpy(profiles), fs=12.5).numpy()
    ref = np.asarray(JS.sparc_batched(jnp.asarray(profiles), fs=12.5))
    np.testing.assert_allclose(ours, ref, atol=0, rtol=1e-6)
    assert ours[2] == 0.0
    scalar = [sparc(p, 12.5) for p in profiles]
    np.testing.assert_allclose(ours, scalar, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# check_trajectories and the Evaluator (tests/test_eval.py's cases)
# ---------------------------------------------------------------------------

def _line(q_start, q_end, t):
    alphas = np.linspace(0.0, 1.0, t)[:, None]
    return ((1 - alphas) * q_start[None] + alphas * q_end[None]).astype(np.float32)


def _volumes(points, dims):
    return [[(p, (dims, dims, dims), (1.0, 0, 0, 0))] for p in points]


def _case(name):
    """(trajs, num_steps, scene, target_volumes, negative_volumes) as lists
    of primitive tuples, and an optional skip mask."""
    q_start = np.asarray(franka.NEUTRAL_Q)
    line = _line(q_start, q_start + np.array([0.3, 0.1, -0.2, 0.2, 0.1, -0.1, 0.2]), 20)
    trajs = np.stack([line, line])
    num_steps = np.full((2,), 19, np.int32)
    final = np.asarray(jkin.eff_pose(jnp.asarray(trajs[:, -1]))[1])
    scene, tv, neg = [[], []], _volumes(final, 2.0), [[], []]
    if name == "collision":
        scene = [[((0.0, 0.0, 0.5), (3.0, 3.0, 3.0), (1.0, 0, 0, 0))]] * 2
    elif name == "negative_volume":
        neg = _volumes(final, 2.0)                        # holds the target: dropped
        neg[1] = _volumes(final, 0.2)[1]
        tv[1] = _volumes(final + np.array([5.0, 0, 0]), 0.5)[1]  # ... and here kept
    elif name in ("joint_limit", "frozen_tail"):
        bad = np.tile(np.asarray(franka.NEUTRAL_Q, np.float32), (20, 1))
        if name == "joint_limit":
            bad[:, 0] = 3.5
        else:
            bad[10:, 0] = 3.5
            num_steps = np.array([5, 5], np.int32)
        trajs = np.stack([bad, bad])
    elif name == "partial_success":
        # one trajectory stops 0.05 rad short of the target config
        short = _line(q_start, q_start + 0.2, 20)
        trajs = np.stack([short, short])
        num_steps = np.array([19, 12], np.int32)
        final = np.asarray(jkin.eff_pose(jnp.asarray(trajs[:, -1]))[1])
        tv = _volumes(final, 2.0)
    return trajs, num_steps, scene, tv, neg


CASES = ("success", "collision", "negative_volume", "joint_limit", "frozen_tail",
         "partial_success")


def _both_checks(name):
    trajs, num_steps, scene, tv, neg = _case(name)
    rot, pos = jkin.eff_pose(jnp.asarray(trajs[:, -1]))
    js, jtv, jneg = (jpack(c, [[] for _ in c]) for c in (scene, tv, neg))
    ref = jax.device_get(JM.check_trajectories(jnp.asarray(trajs), jnp.asarray(num_steps),
                                               rot, pos, js, jtv, jneg))
    ours = M.to_host(M.check_trajectories(_t(trajs), _t(num_steps), _t(rot), _t(pos),
                                          *map(_tscene, (js, jtv, jneg))))
    return ours, ref


def assert_checks_match(ours, ref, nsteps=None):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        v = np.asarray(v)
        if v.dtype == bool:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        elif k == "orientation_error":
            np.testing.assert_allclose(ours[k], v, atol=ORI_TOL_DEG, rtol=0, err_msg=k)
        elif k == "eff_orientation_path_length":
            np.testing.assert_allclose(ours[k], v, atol=ORI_TOL_DEG * (nsteps or 1), rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(ours[k], v, atol=FLOAT_TOL, rtol=FLOAT_TOL, err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_check_trajectories_matches_jax(name):
    ours, ref = _both_checks(name)
    assert_checks_match(ours, ref, nsteps=19)
    expect = {"success": [True, True], "collision": [False, False],
              "negative_volume": [True, False], "joint_limit": [False, False],
              "frozen_tail": [False, False], "partial_success": [True, False]}[name]
    assert ours["success"].tolist() == expect
    if name == "collision":
        assert ours["collision"].all() and (ours["collision_depths"] > 0).any()
    if name == "joint_limit":
        assert ours["joint_limit_violation"].all()
    if name == "frozen_tail":
        assert not ours["joint_limit_violation"].any()


def assert_metrics_match(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if k == "time":
            continue
        tol = ORI_TOL_DEG if "orientation" in k else FLOAT_TOL
        np.testing.assert_allclose(np.asarray(ours[k], float), np.asarray(v, float),
                                   atol=tol, rtol=FLOAT_TOL, equal_nan=True, err_msg=k)


def _evaluate_both(cases, skip_mask=None):
    ev, jev = M.Evaluator(), JM.Evaluator()
    for name in cases:
        for e in (ev, jev):
            e.create_new_group(name)
        trajs, num_steps, scene, tv, neg = _case(name)
        rot, pos = jkin.eff_pose(jnp.asarray(trajs[:, -1]))
        js, jtv, jneg = (jpack(c, [[] for _ in c]) for c in (scene, tv, neg))
        times = np.full((2,), 0.5)
        jev.evaluate_batch(trajs, num_steps, np.asarray(rot), np.asarray(pos), js, jtv, jneg,
                           times=times, skip_mask=skip_mask)
        ev.evaluate_batch(_t(trajs), num_steps, _t(rot), _t(pos), *map(_tscene, (js, jtv, jneg)),
                          times=times, skip_mask=skip_mask)
    return ev, jev


def test_evaluator_groups_match_jax(tmp_path, capsys):
    ev, jev = _evaluate_both(CASES)
    assert ev.groups.keys() == jev.groups.keys()
    for key in CASES:
        assert ev.groups[key].keys() == jev.groups[key].keys()
        for field in ("success", "collision", "self_collision", "joint_limit_violation",
                      "physical_violations", "num_steps"):
            assert ev.groups[key][field] == jev.groups[key][field], (key, field)
        assert_metrics_match(ev.metrics(ev.groups[key]), jev.metrics(jev.groups[key]))
    m = ev.metrics(ev.groups["success"])
    assert m["total"] == 2 and m["success"] == 100.0 and m["time"][0] == pytest.approx(0.5)
    ev.print_overall_metrics()
    jev.print_overall_metrics()
    ours, ref = capsys.readouterr().out.split("Total problems")[1:]
    assert ours.splitlines()[0] == ref.splitlines()[0] == ": 12"
    ev.save(tmp_path, "t")
    ev.save_group(tmp_path, "t")
    with open(tmp_path / "t_metrics.pkl", "rb") as f:
        assert pickle.load(f).keys() == ev.groups.keys()
    assert (tmp_path / "t_partial_success.pkl").exists()


def test_evaluator_skips_match_jax():
    ev, jev = _evaluate_both(["success"], skip_mask=np.array([False, True]))
    assert ev.groups["success"]["skips"] == jev.groups["success"]["skips"] == [True]
    m, jm = ev.metrics(ev.groups["success"]), jev.metrics(jev.groups["success"])
    assert m["skips"] == jm["skips"] == 1 and m["total"] == jm["total"] == 2
    assert_metrics_match(m, jm)


def test_to_host_is_one_copy_and_exact():
    rng = np.random.default_rng(3)
    out = {"a": torch.from_numpy(rng.normal(size=(3, 4, 5)).astype(np.float32)),
           "b": torch.from_numpy(rng.uniform(size=(3,)) < 0.5),
           "c": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}
    host = M.to_host(out)
    for k, v in out.items():
        assert host[k].dtype == v.numpy().dtype and np.array_equal(host[k], v.numpy())


# ---------------------------------------------------------------------------
# Problem sets
# ---------------------------------------------------------------------------

def _fake_reference_pickle():
    from test_data import _fake_geometrout_problem_pickle

    return _fake_geometrout_problem_pickle()


def _jax_problem_set():
    rng = np.random.default_rng(4)
    probs = []
    for i in range(3):
        probs.append(JT.PlanningProblem(
            target=JT.Pose(rng.uniform(0.2, 0.6, 3), [0.0, 1.0, 0.0, 0.0]),
            target_volume=JT.Cuboid(rng.uniform(0.2, 0.6, 3), [0.1, 0.2, 0.3], [1, 0, 0, 0]),
            q0=rng.uniform(-1, 1, 7),
            obstacles=[JT.Cuboid(rng.uniform(0, 1, 3), rng.uniform(0.1, 0.3, 3),
                                 [0.9238795, 0, 0, 0.3826834]),
                       JT.Cylinder(rng.uniform(0, 1, 3), 0.05 + 0.01 * i, 0.2, [1, 0, 0, 0])],
            target_negative_volumes=[JT.Cuboid([0.4, 0.0, 0.3], [0.1, 0.1, 0.1], [1, 0, 0, 0])],
        ))
    return {"cubby": {"neutral-start": probs}, "tabletop": {"task-oriented": probs[:1]}}


def _fields(obj):
    """A problem or primitive as a comparable tree (class name, fields)."""
    if hasattr(obj, "__dataclass_fields__"):
        return (type(obj).__name__,
                {k: _fields(getattr(obj, k)) for k in obj.__dataclass_fields__})
    if isinstance(obj, list):
        return [_fields(o) for o in obj]
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def _problem_set_fields(ps):
    return {s: {t: _fields(v) for t, v in by.items()} for s, by in ps.items()}


def test_load_problems_matches_jax_on_both_pickles(tmp_path):
    ref_path = tmp_path / "reference.pkl"
    ref_path.write_bytes(_fake_reference_pickle())
    jax_path = tmp_path / "jax.pkl"
    JP.save_problems(jax_path, _jax_problem_set())
    for path in (ref_path, jax_path):
        modules = set(sys.modules)
        ours = P.load_problems(path)
        assert set(sys.modules) == modules, "load_problems changed sys.modules"
        ref = JP.load_problems(path)
        assert _problem_set_fields(ours) == _problem_set_fields(ref)
        p = next(iter(next(iter(ours.values())).values()))[0]
        assert isinstance(p, T.PlanningProblem) and isinstance(p.target_volume, T.Cuboid)
        for by_type, jby_type in zip(ours.values(), ref.values()):
            for probs, jprobs in zip(by_type.values(), jby_type.values()):
                batch = P.problems_to_batch(probs, device="cpu")
                jbatch = JP.problems_to_batch(jprobs)
                for a, b in zip(batch["problem"][:3], jbatch["problem"][:3]):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                for key in ("target_volumes", "negative_volumes"):
                    for a, b in zip(batch[key], jbatch[key]):
                        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                for a, b in zip(batch["problem"].scene, jbatch["problem"].scene):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's own pickle reads back equal
    P.save_problems(tmp_path / "ours.pkl", ours)
    assert _problem_set_fields(P.load_problems(tmp_path / "ours.pkl")) == \
        _problem_set_fields(ours)


def test_both_loaders_in_one_process_in_both_orders(tmp_path):
    """A fresh interpreter loads with the port, then with the JAX package
    (which installs its shims in sys.modules), then with the port again."""
    (tmp_path / "reference.pkl").write_bytes(_fake_reference_pickle())
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from mpinets_torch.data import problems as P
        before = set(sys.modules)
        a = P.load_problems({str(tmp_path / 'reference.pkl')!r})
        assert not [m for m in set(sys.modules) - before if m.split('.')[0] in
                    ('geometrout', 'pyquaternion', 'mpinets', 'mpinets_tpu')]
        from mpinets_tpu.data import problems as JP
        j = JP.load_problems({str(tmp_path / 'reference.pkl')!r})
        assert 'geometrout' in sys.modules
        b = P.load_problems({str(tmp_path / 'reference.pkl')!r})
        for ps in (a, b):
            p = ps['tabletop']['task-oriented'][0]
            assert type(p).__module__ == 'mpinets_torch.types'
            assert type(p.obstacles[1]).__name__ == 'Cylinder' and p.obstacles[1].radius == 0.05
            assert (p.target.position == j['tabletop']['task-oriented'][0].target.position).all()
        print('ok')
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


# ---------------------------------------------------------------------------
# The Lightning importer and the checkpoint sources of cli.infer
# ---------------------------------------------------------------------------

def _oracle_state_dict():
    torch.manual_seed(0)
    return torch_oracle.MotionPolicyNetwork().state_dict()


def test_convert_torch_state_dict_bit_equal_to_jax():
    sd = _oracle_state_dict()
    ours, ref = C.convert_torch_state_dict(sd), JC.convert_torch_state_dict(sd)
    la, lb = (jax.tree_util.tree_leaves_with_path(t) for t in (ours, ref))
    assert [p for p, _ in la] == [p for p, _ in lb] and len(la) == 46
    for (path, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_lightning_ckpt_loads_through_infer_and_serve(tmp_path, monkeypatch):
    sd = _oracle_state_dict()
    path = tmp_path / "expert.ckpt"
    torch.save({"state_dict": {f"mdl.{k}": v for k, v in sd.items()}, "epoch": 3}, path)
    params = infer.load_params(path)
    expect = C.params_from_flax(JC.load_torch_checkpoint(path))
    assert params.keys() == expect.keys()
    for k in params:
        assert torch.equal(params[k], expect[k]), k
    # bare state dict .pt
    torch.save(sd, tmp_path / "bare.pt")
    assert all(torch.equal(a, b) for a, b in
               zip(infer.load_params(tmp_path / "bare.pt").values(), params.values()))
    # serve --checkpoint: the planner gets the checkpoint's weights
    seen = {}
    monkeypatch.setattr(serve, "Planner", lambda model, scan, **kw: seen.setdefault("m", model))
    monkeypatch.setattr(serve, "serve", lambda *a, **k: None)
    np.save(tmp_path / "scan.npy", np.zeros((10, 3), np.float32))
    serve.main(["--checkpoint", str(path), str(tmp_path / "scan.npy"), "--device", "cpu"])
    for k, v in seen["m"].state_dict().items():
        assert torch.equal(v, params[k]), k
    with pytest.raises(SystemExit):  # the sources exclude one another
        serve.main(["--checkpoint", str(path), "--random-init", "0", "x.npy"])


def test_load_params_npz_and_trainer_directories(tmp_path):
    model = MotionPolicyNetwork(sa_npoints=(16, 8), device="cpu",
                                generator=torch.Generator().manual_seed(1))
    C.save_flax_npz(tmp_path / "w.npz", C.flax_from_params(model.state_dict()))
    for k, v in infer.load_params(tmp_path / "w.npz").items():
        assert torch.equal(v, model.state_dict()[k]), k
    state = learner.init_state(model, ema=True)
    with torch.no_grad():
        for p in state.ema.parameters():
            p.add_(1.0)
    C.save_checkpoint(tmp_path / "run", 4, state)
    C.save_named_checkpoint(tmp_path / "run", "best", 4, state)
    for src in (tmp_path / "run", tmp_path / "run" / "best", tmp_path / "run" / "step_00000004"):
        plain, ema = infer.load_params(src), infer.load_params(src, use_ema=True)
        for k, v in model.state_dict().items():
            assert torch.equal(plain[k], v) and torch.equal(ema[k], state.ema.state_dict()[k]), k


def test_load_params_refuses_orbax_naming_the_npz_route(tmp_path):
    """An orbax directory without an OCDBT manifest (which the port reads,
    ``tests/test_torch_checkpoint.py``) is refused, naming the ``.npz``
    route."""
    (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match=r"orbax.*\.npz"):
        infer.load_params(tmp_path)


# ---------------------------------------------------------------------------
# Depth camera
# ---------------------------------------------------------------------------

DEPTH_THRESHOLD = 5e-3


def _depth_scene():
    cubs = [[((0.6, 0.0, 0.15), (1.0, 1.2, 0.3), (1, 0, 0, 0)),
             ((0.5, 0.2, 0.4), (0.15, 0.2, 0.2), (0.9238795, 0, 0, 0.3826834)),
             ((0.7, -0.25, 0.45), (0.1, 0.1, 0.3), (1, 0, 0, 0))]]
    cyls = [[((0.45, -0.1, 0.4), 0.05, 0.2, (1, 0, 0, 0))]]
    return jpack(cubs, cyls)


def test_render_depth_points_matches_jax():
    jscene = _depth_scene()
    one = jax.tree_util.tree_map(lambda x: x[0], jscene)
    jp, jh = (np.asarray(a) for a in JD.render_depth_points(one))
    tp, th = (a[0].numpy() for a in D.render_depth_points(_tscene(jscene)))
    both = jh & th
    assert both.sum() > 5000
    np.testing.assert_allclose(tp[both], jp[both], atol=1e-4, rtol=0)
    # hit masks may differ only where the final SDF sits within 1e-5 of the
    # threshold (0 such rays on this scene)
    from mpinets_tpu.kernels.sdf import scene_sdf as jsdf

    d_final = np.asarray(jsdf(jnp.asarray(jp)[None], one)[0])
    near = np.abs(d_final - DEPTH_THRESHOLD) <= 1e-5
    differ = jh != th
    assert not (differ & ~near).any() and int(differ.sum()) == 0

    # the cloud from JAX's categorical draws (scene_to_point_cloud's)
    key = jax.random.PRNGKey(7)
    probs = jh.astype(np.float32) / jh.sum()
    idx = np.asarray(jax.random.categorical(key, jnp.log(jnp.maximum(probs, 1e-20)),
                                            shape=(512,)))
    jcloud = np.asarray(JD.scene_to_point_cloud(one, key, 512))
    ours = D.depth_cloud(torch.from_numpy(tp)[None], torch.from_numpy(th)[None],
                         torch.from_numpy(idx).long()[None])[0].numpy()
    np.testing.assert_allclose(ours, jcloud, atol=1e-4, rtol=0)


def test_scene_to_point_cloud_on_the_surface_and_seeded():
    from mpinets_torch.kernels.sdf import scene_sdf

    scene = pack_scenes([[((0.6, 0.0, 0.3), (0.4, 0.4, 0.6), (1.0, 0.0, 0.0, 0.0))], []],
                        [[], []], device="cpu")
    cam = D.Camera(width=64, height=48)
    a = D.scene_to_point_cloud(scene, 256, torch.Generator().manual_seed(0), cam)
    b = D.scene_to_point_cloud(scene, 256, torch.Generator().manual_seed(0), cam)
    assert a.shape == (2, 256, 3) and torch.equal(a, b)
    sd = scene_sdf(a[:1], SceneSet(*(t[:1] for t in scene)))
    assert sd.abs().max() < DEPTH_THRESHOLD
    assert float(a[0, :, 0].max()) <= 0.6 + 0.21
    assert not a[1].any(), "an empty scene gives zeros"
    hit = torch.tensor([[False, True, False, True, False]])
    idx = D.draw_depth_samples(hit, 64, torch.Generator().manual_seed(0))
    assert set(idx[0].tolist()) == {1, 3}
