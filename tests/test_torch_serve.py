"""The port's planning server against ``mpinets_tpu.cli.serve``.

Both planners run random weights at small centroid counts on the CPU and
answer the same JSON lines: two requests and one malformed line. Their
draws differ (``torch.Generator`` against ``jax.random``), so the test
holds the protocol -- response keys, trajectory length and spacing --
and the scan cleaning, which is numpy in both and must be identical.
"""

import io
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.cli import serve as tserve  # noqa: E402
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
    ]) + "\n"


def _answers(planner, module):
    out = io.StringIO()
    module.serve(planner, io.StringIO(_lines()), out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_clean_point_cloud_identical():
    np.testing.assert_array_equal(tserve.clean_point_cloud(_scan()),
                                  jserve.clean_point_cloud(_scan()))


def test_serve_answers_like_the_jax_server():
    model = MotionPolicyNetwork(compute_dtype=torch.float32, sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    ours = _answers(tserve.Planner(model, _scan(), max_steps=STEPS, device="cpu"), tserve)

    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 6272, 4)),
                                     jnp.zeros((1, 7)))
    ref = _answers(jserve.Planner(variables, _scan(), max_steps=STEPS, model=jmodel,
                                  fused=False), jserve)

    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
    for resp in ours[:2]:
        traj = np.asarray(resp["trajectory"])
        assert resp["num_steps"] == STEPS and traj.shape == (STEPS + 1, 7)
        np.testing.assert_allclose(resp["times"], [0.0, 0.12, 0.24])
        lim = franka.JOINT_LIMITS
        assert ((traj >= lim[:, 0] - 1e-4) & (traj <= lim[:, 1] + 1e-4)).all()
    np.testing.assert_allclose(ours[0]["trajectory"][0], franka.NEUTRAL_Q, atol=1e-6)
    assert ours[2]["success"] is False and "error" in ours[2]


def test_main_with_random_init(tmp_path, monkeypatch, capsys):
    scan = tmp_path / "scan.npy"
    np.save(scan, _scan())
    monkeypatch.setattr("sys.stdin", io.StringIO(_lines()))
    tserve.main(["--random-init", "3", str(scan), "--max-steps", "1", "--device", "cpu"])
    answers = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [a.get("num_steps") for a in answers] == [1, 1, None]
    assert "error" in answers[2]
