"""The port's trainer: EMA, the config loader (against the JAX
package's), train checkpoints on the JAX package's directory layout, and
the trainer on the CPU at ``tests/test_trainer_cli.py``'s tiny sizes: the
synthetic and the hdf5 data modes (a dataset the JAX package's writer
wrote; validation problems held equal to the val split's, targets within
1e-6 of JAX's FK), and both on two gloo ranks, whose parameters must end
equal.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpinets_torch.cli import config as tconfig  # noqa: E402
from mpinets_torch.data import synthetic as tsyn  # noqa: E402
from mpinets_torch.geom.assembly import PointCloudSizes  # noqa: E402
from mpinets_torch.model import checkpoint as tckpt  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.train import learner as tlearner  # noqa: E402
from mpinets_torch.train.trainer import Trainer  # noqa: E402
from mpinets_tpu.cli import config as jconfig  # noqa: E402
from mpinets_tpu.data import writer as jwriter  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs files in
    parallel workers, where more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NPOINTS = (16, 8)
TINY = dict(
    data=dict(num_robot_points=64, num_obstacle_points=96, num_target_points=32),
    model=dict(sa_npoints=[16, 8], sa_nsamples=[8, 8], sa_radii=[0.05, 0.3]),
    optim=dict(batch_size=1, bf16=False),
    rollout=dict(val_rollout_length=3),
    max_val_problems=8,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A train and a val split written by the JAX package's writer (as
    ``tests/test_trainer_cli.py::test_trainer_hdf5_smoke``)."""
    root = tmp_path_factory.mktemp("data")
    jwriter.write_synthetic_dataset(root, "train", num_trajectories=8, seed=0)
    jwriter.write_synthetic_dataset(root, "val", num_trajectories=8, seed=1)
    return root


@pytest.fixture(scope="module", autouse=True)
def two_rank_runs(tmp_path_factory, dataset):
    """Both data modes on two gloo ranks each (``tests/torch_dist_worker.py``),
    started with the module so that they run beside its other tests:
    mode -> (workdir, wait)."""
    from torch_dist_worker import launch

    runs = {}
    for mode in ("synthetic", "hdf5"):
        work = tmp_path_factory.mktemp(f"ranks_{mode}")
        overrides = {**TINY, "optim": dict(TINY["optim"], batch_size=2),
                     "save_checkpoint_dir": str(work / "ckpt"), "synthetic": mode == "synthetic"}
        if mode == "hdf5":
            overrides["data"] = {**TINY["data"], "data_dir": str(dataset)}
        (work / "config.json").write_text(json.dumps(overrides))
        runs[mode] = (work, launch("trainer", work))
    return runs


def test_ema_update():
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    state = tlearner.init_state(model, ema=True)
    before = {k: v.clone() for k, v in state.ema.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    tlearner._update_ema(state.ema, model, 0.9)
    for k, v in state.ema.state_dict().items():
        np.testing.assert_allclose(v.numpy(), (0.9 * before[k] + 0.1 * (before[k] + 1)).numpy(),
                                   atol=1e-6)
    assert not any(p.requires_grad for p in state.ema.parameters())


# ---------------------------------------------------------------------------
# Config, checkpoints, trainer
# ---------------------------------------------------------------------------

REFERENCE_LAYOUT = """\
training_model_parameters:
  point_match_loss_weight: 1
  collision_loss_weight: 5
data_module_parameters:
  data_dir: /data/pretrain
  trajectory_key: global_solutions
  num_obstacle_points: 4096
  num_target_points: 128
  random_scale: 0.015
shared_parameters:
  num_robot_points: 2048
checkpoint_interval: 20
validation_interval: 3000
gpus: 8
batch_size: 10
save_checkpoint_dir: /tmp/checkpoints
experiment_name: mpinets
description: reference layout
"""


def test_load_config_matches_jax(tmp_path):
    path = tmp_path / "jobconfig.yaml"
    path.write_text(REFERENCE_LAYOUT)
    assert tconfig.to_dict(tconfig.load_config(str(path))) == jconfig.to_dict(
        jconfig.load_config(str(path)))
    nested = dict(TINY, seed=3, experiment_name="x")
    assert tconfig.to_dict(tconfig.load_config(None, nested)) == jconfig.to_dict(
        jconfig.load_config(None, nested))
    for bad in ({"not_a_key": 1}, {"optim": {"not_a_key": 1}},
                {"data_module_parameters": {"not_a_key": 1}}):
        with pytest.raises(KeyError):
            tconfig.load_config(None, bad)
    cfg = tconfig.load_config(None, {"save_checkpoint_dir": str(tmp_path)})
    assert tconfig.experiment_dir(cfg, "e1") == tmp_path.resolve() / "e1"


def _tiny_state(seed, ema=True):
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
    return tlearner.init_state(model, ema=ema)


def test_checkpoint_roundtrip_and_layout(tmp_path):
    batch = tsyn.training_batch(torch.Generator().manual_seed(0), 2, PointCloudSizes(64, 96, 32))
    state = _tiny_state(0)
    state, _ = tlearner.make_train_step(ema_decay=0.5)(state, batch)
    assert tckpt.latest_checkpoint(tmp_path) is None
    tckpt.save_checkpoint(tmp_path, 7, state)
    tckpt.save_checkpoint(tmp_path, 12, state)
    assert tckpt.latest_checkpoint(tmp_path) == (tmp_path / "step_00000012").absolute()
    tckpt.save_named_checkpoint(tmp_path, "last", 9, state)
    tckpt.save_named_checkpoint(tmp_path, "last", 9, state)  # overwrites
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "last", "last.step", "step_00000007", "step_00000012"]
    assert tckpt.latest_checkpoint(tmp_path) == (tmp_path / "last").absolute()
    assert tckpt.named_checkpoint_step(tmp_path, "last") == 9
    assert tckpt.named_checkpoint_step(tmp_path, "best") is None
    assert tckpt.checkpoint_step(tmp_path / "step_00000007") == 7
    assert tckpt.checkpoint_step(tmp_path / "last") == 9

    fresh = _tiny_state(1)
    restored = tckpt.restore_checkpoint(tmp_path / "last", fresh)
    assert restored.step == 1
    for a, b in ((restored.model, state.model), (restored.ema, state.ema)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    for p, q in zip(restored.model.parameters(), state.model.parameters()):
        for key in ("mu", "nu"):
            assert torch.equal(restored.optimizer.state[p][key], state.optimizer.state[q][key])
    assert restored.optimizer.param_groups[0]["count"] == 1
    with pytest.raises(ValueError, match="EMA"):
        tckpt.restore_checkpoint(tmp_path / "last", _tiny_state(1, ema=False))


def _tiny_config(tmp_path, **extra):
    cfg = tconfig.load_config(None, {**TINY, "save_checkpoint_dir": str(tmp_path), **extra})
    cfg.data.synthetic = True
    return cfg


@pytest.mark.parametrize("fused", [False, True])
def test_trainer_synthetic_smoke_and_resume(tmp_path, fused):
    # the kernel-backed forward keeps 128 neighbours
    stages = {"model": dict(TINY["model"], sa_nsamples=[128, 128])} if fused else {}
    trainer = Trainer(_tiny_config(tmp_path, **stages), test=True, fused=fused, device="cpu")
    state = trainer.run()
    assert state.step == 10
    rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
    assert any("val_loss" in r for r in rows) and any("avg_target_error" in r for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert (trainer.ckpt_dir / "last").exists() and (trainer.ckpt_dir / "best").exists()
    assert tckpt.checkpoint_step(trainer.ckpt_dir / "last") == 10
    assert 0 < tckpt.checkpoint_step(trainer.ckpt_dir / "best") <= 10
    assert json.loads((trainer.ckpt_dir / "config.json").read_text())["optim"]["batch_size"] == 1

    cfg2 = _tiny_config(tmp_path, resume_from=str(trainer.ckpt_dir), **stages)
    trainer2 = Trainer(cfg2, test=True, should_log=False, fused=fused, device="cpu")
    state2 = trainer2.run()
    assert state2.step == 20
    assert tckpt.checkpoint_step(trainer2.ckpt_dir / "last") == 20


def test_kernel_forward_refuses_a_model_it_cannot_compute(tmp_path):
    """The kernel-backed forward takes each stage's radius and nsample from
    the model; the kernels keep 128 neighbours, so nsample 8 is refused
    rather than computed as another function."""
    with pytest.raises(ValueError, match="128 neighbours"):
        Trainer(_tiny_config(tmp_path), test=True, fused=True, device="cpu").run()


def test_trainer_stops_at_its_time_budget(tmp_path, capsys):
    trainer = Trainer(_tiny_config(tmp_path), time_budget_s=0.0, device="cpu")
    assert trainer.run().step == 0
    assert "wall-clock budget reached at step 0" in capsys.readouterr().out
    assert tckpt.checkpoint_step(trainer.ckpt_dir / "last") == 0


def test_trainer_refuses_unported_modes(tmp_path, dataset):
    """Every data mode is ported: the hdf5 mode and the hdf5 actor mode
    build (they run in the tests below and in ``test_torch_actor.py``).
    What the trainer still refuses: a card that is absent (device='cpu'
    names the plain path), and the plain policy on ``cuda``."""
    for actor_interval in (0, 3):
        cfg = _tiny_config(tmp_path, data={**TINY["data"], "data_dir": str(dataset)})
        cfg.data.synthetic = False
        cfg.rollout.actor_interval = actor_interval
        trainer = Trainer(cfg, device="cpu", should_log=False)
        assert (trainer.world, trainer.global_batch, trainer.host_batch) == (1, 1, 1)
        assert trainer.mesh is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(_tiny_config(tmp_path))
    else:
        with pytest.raises(ValueError, match="fused=False"):
            Trainer(_tiny_config(tmp_path), fused=False)




def test_trainer_hdf5_mode_validates_on_the_val_split(tmp_path, dataset):
    """The counterpart of ``tests/test_trainer_cli.py::test_trainer_hdf5_smoke``:
    10 steps on the train split, validation problems from the val split
    (the JAX package's FK of each trajectory's last configuration), best and
    last checkpoints, and a resume."""
    from mpinets_tpu.data import hdf5 as jhdf5
    from mpinets_tpu.kernels import kinematics as jkin

    data = dataset
    cfg = _tiny_config(tmp_path, data={**TINY["data"], "data_dir": str(data)})
    cfg.data.synthetic = False
    trainer = Trainer(cfg, test=True, device="cpu")
    problems = trainer._val_problems()
    ref = jhdf5.TrajectoryDataset(data, dataset_type=jhdf5.DatasetType.VAL).read_trajectory_batch(
        np.arange(3))
    np.testing.assert_array_equal(problems.q0.numpy(), ref["raw_configuration"])
    np.testing.assert_array_equal(problems.scene.cuboid_quats.numpy(), ref["cuboid_quats"])
    np.testing.assert_allclose(problems.target_trans.numpy(),
                               np.asarray(jkin.eff_pose(ref["raw_goal"])[1]), atol=1e-6)
    state = trainer.run()
    assert state.step == 10
    rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
    assert [r["step"] for r in rows if "avg_target_error" in r] == [2, 4, 6, 8, 10]
    assert any("val_loss" in r for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert tckpt.checkpoint_step(trainer.ckpt_dir / "last") == 10
    assert 0 < tckpt.checkpoint_step(trainer.ckpt_dir / "best") <= 10
    cfg2 = _tiny_config(tmp_path, data={**TINY["data"], "data_dir": str(data)},
                        resume_from=str(trainer.ckpt_dir))
    cfg2.data.synthetic = False
    resumed = Trainer(cfg2, test=True, should_log=False, device="cpu")
    assert resumed.run().step == 20
    for exp in (trainer.ckpt_dir, resumed.ckpt_dir):   # two runs' checkpoints, ~0.9 GB
        shutil.rmtree(exp)


@pytest.mark.parametrize("mode", ["synthetic", "hdf5"])
def test_trainer_on_two_ranks(two_rank_runs, mode):
    """Two gloo ranks, 10 steps and a resume from rank 0's ``last``: both
    ranks end each run with equal parameters, and only rank 0 writes."""
    tmp_path, wait = two_rank_runs[mode]
    ranks = wait()
    for run, step in ((0, 10), (1, 20)):
        a, b = (r[run] for r in ranks)
        assert a["step"] == b["step"] == step and a["global_batch"] == 4
        assert a["ckpt_dir"] == b["ckpt_dir"]
        for k, v in a["params"].items():
            assert torch.equal(v, b["params"][k]), (run, k)
        exp = Path(a["ckpt_dir"])
        assert tckpt.checkpoint_step(exp / "last") == step
        rows = [json.loads(line) for line in open(exp / "metrics.jsonl")]
        assert sum("avg_target_error" in r for r in rows) == 5   # one writer, not two
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == sorted(
        Path(r["ckpt_dir"]).name for r in ranks[0])
    assert not any(ranks[0][0]["params"][k].equal(v) for k, v in ranks[0][1]["params"].items()
                   if v.dim() > 1)   # the resumed run went on training
    for r in range(2):   # the checkpoints and the ranks' parameters: ~1 GB
        (tmp_path / f"out_{r}.pt").unlink()
    shutil.rmtree(tmp_path / "ckpt")


def test_validation_metrics_match_jax_on_a_standing_policy():
    """A policy whose output is zero stays at q0; with each target at q0's
    pose and no obstacle both packages report a hit on every problem (the
    rollout's draws, which differ between the packages, cannot move q)."""
    import jax.numpy as jnp

    from mpinets_torch.data.synthetic import Problem
    from mpinets_torch.geom.scene import empty_scene
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.model import checkpoint as tck
    from mpinets_torch.train.validate import make_validation_fn
    from mpinets_tpu.data.synthetic import Problem as JaxProblem
    from mpinets_tpu.geom.assembly import PointCloudSizes as JaxSizes
    from mpinets_tpu.geom.scene import empty_scene as jax_empty_scene
    from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy
    from mpinets_tpu.train.validate import make_validation_fn as jax_validation_fn

    sizes = PointCloudSizes(64, 96, 32)
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.decoder_3.weight.zero_()
        model.decoder_3.bias.zero_()
    q0 = tsyn.random_configuration(torch.Generator().manual_seed(3), (3,))
    rot, trans = kinematics.eff_pose(q0)
    problem = Problem(q0, rot, trans, empty_scene((3,)))
    ours = make_validation_fn(model, 4, sizes, device="cpu")(
        problem, torch.Generator().manual_seed(0))

    jsizes = JaxSizes(64, 96, 32)
    jproblem = JaxProblem(jnp.asarray(q0.numpy()), jnp.asarray(rot.numpy()),
                          jnp.asarray(trans.numpy()), jax_empty_scene((3,)))
    params = tck.flax_from_params(model.state_dict())
    ref = jax_validation_fn(JaxPolicy(sa_npoints=NPOINTS), 4, jsizes)(
        params, jproblem, jax.random.PRNGKey(0))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), atol=1e-4, err_msg=k)
    assert float(ours["val_success_free"]) == 1.0 and float(ours["avg_collision_rate"]) == 0.0
    assert float(ours["avg_target_error"]) < 1e-5
