"""The port's planning server against ``mpinets_tpu.cli.serve``.

Both planners run random weights at small centroid counts on the CPU and
answer the same JSON lines: two requests and two malformed lines. Their
draws differ (``torch.Generator`` against ``jax.random``), so the test
holds the protocol -- response keys, trajectory length and spacing, the
answer to a malformed request word for word -- and the scan cleaning,
which is numpy in both and must be identical.
"""

import io
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.cli import serve as tserve  # noqa: E402
from mpinets_torch.model import checkpoint  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_tpu.cli import serve as jserve  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402

NPOINTS = (16, 8)
STEPS = 2


def _scan():
    rng = np.random.default_rng(0)
    return rng.uniform(-0.4, 1.2, (20000, 3)).astype(np.float32)


def _lines():
    return "\n".join([
        json.dumps({"q0": franka.NEUTRAL_Q.tolist(), "target_position": [0.5, 0.1, 0.4],
                    "target_quaternion": [0.0, 1.0, 0.0, 0.0]}),
        json.dumps({"q0": (franka.NEUTRAL_Q + 0.1).tolist(),
                    "target_position": [0.4, -0.2, 0.3],
                    "target_quaternion": [0.0, 0.0, 1.0, 0.0]}),
        "{not json",
        json.dumps({"q0": franka.NEUTRAL_Q.tolist()}),
    ]) + "\n"


def _answers(planner, module):
    out = io.StringIO()
    module.serve(planner, io.StringIO(_lines()), out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_clean_point_cloud_identical():
    np.testing.assert_array_equal(tserve.clean_point_cloud(_scan()),
                                  jserve.clean_point_cloud(_scan()))


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX server's answers to :func:`_lines` (plain XLA path)."""
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 6272, 4)),
                                     jnp.zeros((1, 7)))
    return _answers(jserve.Planner(variables, _scan(), max_steps=STEPS, model=jmodel,
                                   fused=False), jserve)


def _small_model(seed=0):
    return MotionPolicyNetwork(compute_dtype=torch.float32, sa_npoints=NPOINTS, device="cpu",
                               generator=torch.Generator().manual_seed(seed))


def test_serve_answers_like_the_jax_server(jax_answers):
    ours = _answers(tserve.Planner(_small_model(), _scan(), max_steps=STEPS, device="cpu"),
                    tserve)
    ref = jax_answers

    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
    for resp in ours[:2]:
        traj = np.asarray(resp["trajectory"])
        assert resp["num_steps"] == STEPS and traj.shape == (STEPS + 1, 7)
        np.testing.assert_allclose(resp["times"], [0.0, 0.12, 0.24])
        lim = franka.JOINT_LIMITS
        assert ((traj >= lim[:, 0] - 1e-4) & (traj <= lim[:, 1] + 1e-4)).all()
    np.testing.assert_allclose(ours[0]["trajectory"][0], franka.NEUTRAL_Q, atol=1e-6)
    # malformed requests: the same answer, error text included
    for bad_ours, bad_ref in zip(ours[2:], ref[2:]):
        assert bad_ours["success"] is False and bad_ours["error"]
        assert bad_ours == bad_ref


def test_main_with_random_init(tmp_path, monkeypatch, capsys):
    scan = tmp_path / "scan.npy"
    np.save(scan, _scan())
    monkeypatch.setattr("sys.stdin", io.StringIO(_lines()))
    tserve.main(["--random-init", "3", str(scan), "--max-steps", "1", "--device", "cpu"])
    answers = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [a.get("num_steps") for a in answers] == [1, 1, None, None]
    assert "error" in answers[2] and "error" in answers[3]


def _write_checkpoint(kind, tmp_path, model):
    """``model``'s weights as the JAX server's positional CHECKPOINT: a
    flax-layout ``.npz`` or a trainer directory (``state.pt``)."""
    if kind == "npz":
        path = tmp_path / "weights.npz"
        checkpoint.save_flax_npz(path, checkpoint.flax_from_params(model.state_dict()))
    else:
        path = tmp_path / "run"
        (path / "last").mkdir(parents=True)
        torch.save({"params": model.state_dict()}, path / "last" / "state.pt")
    return path


@pytest.mark.parametrize("kind", ["npz", "trainer_dir"])
def test_main_takes_the_jax_servers_argv(kind, tmp_path, monkeypatch, capsys, jax_answers):
    """``serve CHECKPOINT SCAN [--max-steps N] [--no-fused]``, the JAX
    server's command line (``mpinets_tpu/cli/serve.py:149-166``), with the
    port's ``--device``; the options may stand between the positionals."""
    model = MotionPolicyNetwork(compute_dtype=torch.bfloat16, device="cpu",
                                generator=torch.Generator().manual_seed(5))
    ckpt = _write_checkpoint(kind, tmp_path, model)
    scan = tmp_path / "scan.npy"
    np.save(scan, _scan())
    monkeypatch.setattr("sys.stdin", io.StringIO(_lines()))
    tserve.main([str(ckpt), "--max-steps", "1", str(scan), "--no-fused", "--device", "cpu"])
    out, err = capsys.readouterr()
    answers = [json.loads(line) for line in out.splitlines()]
    assert "# rollout path: plain on cpu" in err
    assert [a.get("num_steps") for a in answers] == [1, 1, None, None]
    for a, b in zip(answers, jax_answers):
        assert set(a) == set(b)
    # the weights were the checkpoint's: the first plan is the policy's own (bf16,
    # as the server loads it)
    planner = tserve.Planner(model, _scan(), max_steps=1, device="cpu", fused=False)
    ref = planner.plan(franka.NEUTRAL_Q.tolist(), [0.5, 0.1, 0.4], [0.0, 1.0, 0.0, 0.0])
    np.testing.assert_array_equal(answers[0]["trajectory"], ref["trajectory"])


def test_main_refuses_two_weight_sources(tmp_path):
    with pytest.raises(SystemExit):
        tserve.main(["w.npz", "--random-init", "0", str(tmp_path / "scan.npy")])
    with pytest.raises(SystemExit):
        tserve.main([str(tmp_path / "scan.npy")])


def test_planner_fused_flag(capsys):
    """``fused`` as the JAX planner takes it: None is the plain policy on
    the CPU, True the kernel path (its plain versions here), False the
    plain policy. In f32 the two paths plan the same trajectory within the
    f32 forward's tolerance (atol 2e-5 a step, 2 steps: 1e-4)."""
    plans = {}
    for fused in (None, True, False):
        planner = tserve.Planner(_small_model(), _scan(), max_steps=STEPS, device="cpu",
                                 fused=fused)
        plans[fused] = _answers(planner, tserve)[:2]
    err = capsys.readouterr().err
    assert err.count("# rollout path: plain on cpu") == 2
    assert err.count("# rollout path: fused-cuda on cpu") == 1
    assert plans[None] == plans[False]
    for a, b in zip(plans[True], plans[False]):
        assert a["num_steps"] == b["num_steps"]
        np.testing.assert_allclose(a["trajectory"], b["trajectory"], atol=1e-4, rtol=0)
