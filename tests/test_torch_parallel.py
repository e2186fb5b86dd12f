"""Port parity: data parallelism across two ranks, ``mpinets_torch.parallel``
and ``learner.make_data_parallel_step`` against ``mpinets_tpu``'s on a
two-device mesh.

Two gloo processes on the CPU (``tests/torch_dist_worker.py``, which
imports only the port, started once for the module, meeting through a
``file://`` rendezvous in the test's own directory) run the port; the JAX
side runs here on ``make_mesh(2)`` of ``tests/conftest.py``'s 8 virtual
CPU devices. Both start from the same weights (JAX's, perturbed,
converted) at tiny widths (cloud 32 + 48 + 16, SA 16/8, 8 neighbours), and
each rank is handed JAX's draws for its device where JAX draws (the
prepared batch, the success statistics' rollouts). Each rank's block of the
sharded rollout must equal the plain rollout on that block with the rank's
generator (``tests/test_parallel.py:42-86``). Tolerances, as
``tests/test_torch_train.py::test_train_step_matches_jax``: metrics rtol
1e-5, parameters atol 1e-5, against JAX and against the port's
single-process step on the whole batch; the two ranks' parameters equal;
success statistics atol 1e-4 (the rollout's, ``tests/test_torch_rollout.py``).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_actor import _cloud_draws, _obstacle  # noqa: E402  (tests dir is on sys.path)
from torch_dist_worker import launch  # noqa: E402

from mpinets_torch.data.hdf5 import PrepareDraws  # noqa: E402
from mpinets_torch.geom.assembly import PointCloudSizes  # noqa: E402
from mpinets_torch.model import checkpoint as tckpt  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_torch.parallel import mesh as tmesh  # noqa: E402
from mpinets_torch.train import learner as tlearner  # noqa: E402
from mpinets_tpu.data import hdf5 as jhdf5  # noqa: E402
from mpinets_tpu.data import synthetic as jsyn  # noqa: E402
from mpinets_tpu.data import writer as jwriter  # noqa: E402
from mpinets_tpu.geom import assembly as jas  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402
from mpinets_tpu.parallel import (  # noqa: E402
    make_mesh,
    make_sharded_success_stats,
    pad_to_multiple,
)
from mpinets_tpu.train import learner as jlearner  # noqa: E402

torch.set_float32_matmul_precision("highest")

MODEL = dict(sa_npoints=(16, 8), sa_nsamples=(8, 8), sa_radii=(0.05, 0.3))
SIZES = (32, 48, 16)
B = 4                # the global batch: 2 rows a rank
ROLLOUT_STEPS = 3
STATS_STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs files in
    parallel workers, where more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _block(tree, d):
    return jax.tree_util.tree_map(lambda x: x[d * (B // 2):(d + 1) * (B // 2)], tree)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _rollout_draws(keys, problems, sizes, steps):
    """The first cloud and per-step bank indices of JAX's rollout on each
    device's block, for each device's key (``rollout/engine.py``: split,
    then ``split(k_init, b)`` and ``split(k_steps, max_steps)``)."""
    out = []
    for d, key in enumerate(keys):
        blk = _block(problems, d)
        b = blk.q0.shape[0]
        k_init, k_steps = jax.random.split(key)
        xyz0 = jax.vmap(lambda k, q, r, t, s: jas.assemble_point_cloud(k, q, r, t, s, sizes))(
            jax.random.split(k_init, b), blk.q0, blk.target_rot, blk.target_trans, blk.scene)
        idx = jnp.stack([jax.random.randint(k, (b, sizes.robot), 0, 8192)
                         for k in jax.random.split(k_steps, steps)])
        out.append((xyz0, idx))
    return out


@functools.partial(jax.jit, static_argnums=2)
def _prepare_draws(key, raw, sizes):
    """The draws of ``prepare_train_batch`` on each device's block under
    ``fold_in(key, d)``: the noise, then the clouds of ``split(k_cloud, b)``."""
    out = []
    for d in range(2):
        k_noise, k_cloud = jax.random.split(jax.random.fold_in(key, d))
        blk = _block(raw, d)
        robot, obstacle = _cloud_draws(k_cloud, jsc.SceneSet(*(blk[k] for k in jhdf5.SCENE_KEYS)),
                                       B // 2, sizes)
        out.append((jax.random.normal(k_noise, (B // 2, 7)), robot, obstacle))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results on make_mesh(2), the port's single-process step, and
    the two ranks' outputs."""
    work = tmp_path_factory.mktemp("dp")
    sizes = jas.PointCloudSizes(*SIZES)
    mesh = make_mesh(2)
    jmodel = JaxPolicy(**MODEL)
    rng = np.random.default_rng(0)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, sum(SIZES), 4)),
                                     jnp.zeros((1, 7)))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.normal(size=a.shape).astype(np.float32), variables)
    opt = jlearner.make_optimizer()
    state0 = jlearner.TrainState(variables, opt.init(variables), jnp.zeros((), jnp.int32))
    state_dict = tckpt.params_from_flax(variables)

    batch = _np_tree(jsyn.training_batch(jax.random.PRNGKey(7), B, sizes=sizes))
    jwriter.write_synthetic_dataset(work / "data", "train", num_trajectories=6, seed=0)
    raw = jhdf5.TrajectoryDataset(work / "data").read_instance_batch(
        np.array([0, 3, 5, 1]), np.array([0, 10, 49, 20]))
    key = jax.random.PRNGKey(5)
    prepare_draws = [PrepareDraws(_t(noise), _t(robot), _obstacle(obstacle))
                     for noise, robot, obstacle in _prepare_draws(key, raw, sizes)]
    problems = jsyn.random_problem_batch(jax.random.PRNGKey(3), B)
    s_key = jax.random.PRNGKey(6)
    stats_draws = [(_t(xyz0), _t(idx)) for xyz0, idx in _rollout_draws(
        [jax.random.fold_in(s_key, d) for d in range(2)], problems, sizes, STATS_STEPS)]
    torch.save({
        "state_dict": state_dict, "model": MODEL, "sizes": PointCloudSizes(*SIZES),
        "batch": {k: _t(v) for k, v in batch.items()},
        "raw": {k: _t(v) for k, v in raw.items()}, "prepare_draws": prepare_draws,
        "problems": {"q0": _t(problems.q0), "target_rot": _t(problems.target_rot),
                     "target_trans": _t(problems.target_trans),
                     "scene": [_t(f) for f in problems.scene]},
        "rollout_steps": ROLLOUT_STEPS, "stats_steps": STATS_STEPS,
        "stats_draws": stats_draws,
    }, work / "inputs.pt")
    wait = launch("parity", work)   # the ranks run while JAX compiles

    jstate, jmetrics = jlearner.make_data_parallel_step(jmodel, mesh, opt)(
        state0, jlearner.shard_batch(batch, mesh))
    jstate_p, jmetrics_p = jlearner.make_data_parallel_step(
        jmodel, mesh, opt, prepare_fn=lambda r, k: jhdf5.prepare_train_batch(r, k, sizes=sizes))(
        state0, jlearner.shard_batch(raw, mesh), key)
    jstats = make_sharded_success_stats(jmodel, mesh, sizes=sizes, max_steps=STATS_STEPS)(
        variables, problems, s_key)
    model = MotionPolicyNetwork(device="cpu", **MODEL)
    model.load_state_dict(state_dict)
    tstate, tmetrics = tlearner.make_train_step()(tlearner.init_state(model),
                                                  {k: _t(v) for k, v in batch.items()})
    outs = wait()
    return {
        "jax": (tckpt.params_from_flax(_np_tree(jstate.params)), _np_tree(jmetrics)),
        "jax_prepare": (tckpt.params_from_flax(_np_tree(jstate_p.params)), _np_tree(jmetrics_p)),
        "single": ({k: v.clone() for k, v in model.state_dict().items()},
                   {k: float(v) for k, v in tmetrics.items()}),
        "jax_stats": _np_tree(jstats), "ranks": outs,
    }


def _assert_step_close(ours, ref):
    params, metrics = ours
    ref_params, ref_metrics = ref
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert set(params) == set(ref_params)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_step_matches_jax(runs, rank):
    _assert_step_close(runs["ranks"][rank]["plain"], runs["jax"])


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_step_matches_the_single_process_step(runs, rank):
    _assert_step_close(runs["ranks"][rank]["plain"], runs["single"])


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_step_with_prepare_matches_jax(runs, rank):
    _assert_step_close(runs["ranks"][rank]["prepare"], runs["jax_prepare"])


@pytest.mark.parametrize("variant", ["plain", "prepare"])
def test_ranks_end_with_equal_parameters(runs, variant):
    a, b = (r[variant] for r in runs["ranks"])
    assert a[1] == b[1]
    for k, v in a[0].items():
        assert torch.equal(v, b[0][k]), k


def test_sharded_rollout_block_is_the_plain_rollout_on_it(runs):
    for rank, out in enumerate(runs["ranks"]):
        got, ref = out["rollout"], out["rollout_plain"]
        assert got.trajectories.shape == (B // 2, ROLLOUT_STEPS + 1, 7)
        for field in got._fields:
            assert torch.equal(getattr(got, field), getattr(ref, field)), (rank, field)


def test_sharded_success_stats_match_jax(runs):
    ref = runs["jax_stats"]
    for out in runs["ranks"]:
        assert set(out["stats"]) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(out["stats"][k], float(v), atol=1e-4, err_msg=k)
    assert runs["ranks"][0]["stats"] == runs["ranks"][1]["stats"]


def test_pad_to_multiple_and_process_local_slice_at_two_ranks(runs):
    for k in (1, 2, 7, 8):
        for n in (1, 7, 8, 13, 16):
            assert tmesh.pad_to_multiple(n, k) == pad_to_multiple(n, k)
    for rank, out in enumerate(runs["ranks"]):
        assert out["local_slice"] == slice(4 * rank, 4 * rank + 4)
        assert out["local_slice_error"] == "global batch 7 not divisible by 2 hosts"
        assert out["data_sharding"] == (rank, 2)


def test_single_process_step_is_the_train_step_and_makes_no_collective(monkeypatch):
    """Without a mesh the DP step is make_train_step's and calls no
    collective; the block of the whole batch is the batch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective was called")

    monkeypatch.setattr(torch.distributed, "all_reduce", refuse)
    monkeypatch.setattr(torch.distributed, "broadcast", refuse)
    sizes = PointCloudSizes(*SIZES)
    from mpinets_torch.data import synthetic as tsyn

    batch = tsyn.training_batch(torch.Generator().manual_seed(0), 3, sizes)
    out = []
    for make in (tlearner.make_train_step, tlearner.make_data_parallel_step):
        model = MotionPolicyNetwork(device="cpu", generator=torch.Generator().manual_seed(1),
                                    **MODEL)
        state = tlearner.init_state(model, ema=True)
        tlearner.broadcast_state(state)
        state, metrics = make(ema_decay=0.5)(state, tlearner.shard_batch(batch))
        out.append((state, metrics))
    (a, ma), (b, mb) = out
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    for m, n in ((a.model, b.model), (a.ema, b.ema)):
        for (k, v), w in zip(m.state_dict().items(), n.state_dict().values()):
            assert torch.equal(v, w), k
    assert tmesh.data_sharding() == tmesh.replicated_sharding() == tmesh.Sharding(0, 1)


def test_multihost_init_is_a_noop_without_a_coordinator(monkeypatch):
    for var in ("MPINETS_COORDINATOR", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.multihost_init(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    assert tmesh.process_local_slice(6) == slice(0, 6)
    with pytest.raises(RuntimeError, match="multihost_init"):
        tmesh.make_mesh()
    with pytest.raises(ValueError, match="number of processes"):
        tmesh.multihost_init("localhost:1", device="cpu")
    monkeypatch.setenv("MPINETS_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="number of processes"):
        tmesh.multihost_init(device="cpu")
    assert tmesh.Sharding(1, 2).block(8) == slice(4, 8)
    tree = {"a": torch.arange(6), "b": (torch.zeros(6, 2), None)}
    assert torch.equal(tmesh.shard_leading_axis(tree)["a"], tree["a"])
