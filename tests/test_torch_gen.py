"""Port parity: expert generation, ``mpinets_torch.pipeline.gen``
against ``mpinets_tpu.pipeline.gen``, and the two pieces of the data tools
it writes with (``data.writer.write_dataset``, ``data.process.merge_files``).

Both packages' environments run on the JAX package's IK (patched in as
``tests/test_torch_envs.py`` does, with its memo, so that each solve runs
once), and the port's ``gen`` plans with the JAX package's planner patched
in, called exactly as the JAX package's ``gen`` calls it (so it compiles
once). Then the two ``gen`` s must write the same HDF5 file, key by key and bit for bit,
return the same stats, and pickle the same problems: start configurations
and obstacles equal, targets (each package's own FK) within 1e-6. The
port's own planner then runs ``gen`` on the CPU: the scene-level eval
split writes no HDF5, every pickled target is the FK pose of its
trajectory's last configuration (1e-6), and ``pair_bucket`` padding is
masked out of the results.
"""

import functools
import pickle

import h5py
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_envs import _jax_ik, memo  # noqa: E402,F401  (tests dir is on sys.path)

from mpinets_torch.data import problems as tproblems  # noqa: E402
from mpinets_torch.data import process as tprocess  # noqa: E402
from mpinets_torch.data import writer as twriter  # noqa: E402
from mpinets_torch.envs import base as tbase  # noqa: E402
from mpinets_torch.kernels import kinematics as tkin  # noqa: E402
from mpinets_torch.pipeline import expert as te  # noqa: E402
from mpinets_torch.pipeline import gen as tgen  # noqa: E402
from mpinets_tpu.data import process as jprocess  # noqa: E402
from mpinets_tpu.data import writer as jwriter  # noqa: E402
from mpinets_tpu.envs import base as jbase  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.pipeline import expert as je  # noqa: E402
from mpinets_tpu.pipeline import gen as jgen  # noqa: E402

SCENE_PAD = (48, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs files in
    parallel workers, where more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
PLAN = dict(opt_steps=2, n_vias=1)
RUN = dict(num_scenes=2, candidates_per_scene=2, seed=3, pair_bucket=12, plan_kwargs=PLAN)


@pytest.fixture
def jax_ik(memo, monkeypatch):  # noqa: F811
    port, ref = _jax_ik(memo)
    monkeypatch.setattr(tbase, "ik", port)
    monkeypatch.setattr(jbase, "ik", ref)
    monkeypatch.setattr(tbase.Environment, "SCENE_PAD", SCENE_PAD)
    monkeypatch.setattr(jbase.Environment, "SCENE_PAD", SCENE_PAD)


def _jax_planner(q_start, q_goal, rot, trans, scene, **kwargs):
    """The JAX package's planner on the port's tensors, called as
    ``mpinets_tpu.pipeline.gen.plan_scene`` calls it."""
    plan = jax.vmap(functools.partial(je.plan_pair_optimized, **kwargs),
                    in_axes=(0, 0, 0, 0, None))
    res = plan(*(jnp.asarray(x.numpy()) for x in (q_start, q_goal, rot, trans)),
               jsc.SceneSet(*(jnp.asarray(t.numpy()) for t in scene)))
    return te.PlanResult(*(torch.from_numpy(np.array(x)) for x in res))


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


def _problems_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.q0, b.q0)
        np.testing.assert_allclose(a.target.position, b.target.position, atol=1e-6)
        np.testing.assert_allclose(a.target.quaternion, b.target.quaternion, atol=1e-6)
        np.testing.assert_allclose(a.target_volume.center, b.target_volume.center, atol=1e-6)
        np.testing.assert_array_equal(a.target_volume.dims, b.target_volume.dims)
        assert [type(o).__name__ for o in a.obstacles] == [type(o).__name__ for o in b.obstacles]
        for x, y in zip(a.obstacles, b.obstacles):
            for k, v in vars(x).items():
                np.testing.assert_array_equal(v, vars(y)[k], err_msg=k)


def test_gen_writes_what_the_jax_package_writes(jax_ik, tmp_path, monkeypatch):
    monkeypatch.setattr(te, "plan_pair_optimized", _jax_planner)
    ref = jgen.gen("tabletop", tmp_path / "jax", inference_pkl=tmp_path / "jax.pkl",
                   clear_every=0, **RUN)
    ours = tgen.gen("tabletop", tmp_path / "port", inference_pkl=tmp_path / "port.pkl",
                    device="cpu", **RUN)
    assert ours == ref and ours["valid"] > 0
    a, b = _h5(tmp_path / "port" / "all_data.hdf5"), _h5(tmp_path / "jax" / "all_data.hdf5")
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not list((tmp_path / "port").glob("scene_*.hdf5"))
    # the pickles: the port reads both; the JAX package's names its own types
    with open(tmp_path / "port.pkl", "rb") as f:
        raw = pickle.load(f)
    assert type(raw["tabletop"]["task-oriented"][0]).__module__ == "mpinets_torch.types"
    ours_p = tproblems.load_problems(tmp_path / "port.pkl")["tabletop"]["task-oriented"]
    ref_p = tproblems.load_problems(tmp_path / "jax.pkl")["tabletop"]["task-oriented"]
    _problems_equal(ours_p, ref_p)
    assert len(ours_p) == ours["valid"]


def test_gen_eval_split_on_the_ports_planner(jax_ik, tmp_path, monkeypatch):
    """``eval_every=1``: every kept scene is held out for the problem pickle
    and no HDF5 is written (how ``gen`` runs where there is no h5py)."""
    seen = []
    hindsight = tgen.hindsight_problems

    def spy(trajs, env):
        seen.append(trajs)
        return hindsight(trajs, env)

    monkeypatch.setattr(tgen, "hindsight_problems", spy)
    stats = tgen.gen("tabletop", tmp_path, eval_every=1, inference_pkl=tmp_path / "p.pkl",
                     device="cpu", **RUN)
    assert not list(tmp_path.glob("*.hdf5"))
    assert stats["eval_scenes"] == len(seen) > 0
    trajs = np.concatenate(seen)
    assert stats["eval_problems"] == len(trajs) == stats["valid"]
    problems = tproblems.load_problems(tmp_path / "p.pkl")["tabletop"]["task-oriented"]
    _, trans = tkin.eff_pose(torch.as_tensor(trajs[:, -1]))
    for p, q, t in zip(problems, trajs, trans.numpy()):
        np.testing.assert_array_equal(p.q0, q[0])
        np.testing.assert_allclose(p.target.position, t, atol=1e-6)


def test_plan_scene_masks_the_padding(jax_ik):
    """A bucket wider than the scene's pairs: the padded rows leave the
    results and the tallies, which equal an unpadded plan's."""
    runs = []
    for bucket in (None, 16):
        rng = np.random.default_rng(5)
        env = tgen.ENVS["tabletop"](device="cpu")
        while not env.gen(rng):
            pass
        runs.append(tgen.plan_scene(env, rng, 2, False, pair_bucket=bucket, plan_kwargs=PLAN))
    (t0, a0, s0), (t1, a1, s1) = runs
    assert s0 == s1 and s0["pairs"] < 16 and len(t0) == s0["valid"]
    np.testing.assert_array_equal(t0, t1)
    assert t0.dtype == np.float32 and t0.shape[1:] == (te.SEQUENCE_LENGTH, 7)
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k])
    assert sum(v for k, v in s0.items() if k not in ("pairs", "valid")) >= s0["pairs"] - s0["valid"]


def test_candidate_pairs_and_scene_arrays_match(jax_ik):
    cands = list("abcd")
    assert tgen._candidate_pairs(cands, cands) == jgen._candidate_pairs(cands, cands)
    assert len(tgen._candidate_pairs(cands, cands)) == 12
    for name in ("tabletop", "cubby", "dresser"):
        rj, rt = np.random.default_rng(1), np.random.default_rng(1)
        je_, te_ = jgen.ENVS[name](), tgen.ENVS[name](device="cpu")
        assert je_.gen(rj) == te_.gen(rt)
        a, b = tgen._scene_arrays(te_, 3), jgen._scene_arrays(je_, 3)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")


def test_writer_and_merge_match(tmp_path):
    rng = np.random.default_rng(0)
    files = []
    for i, (n, mc, my) in enumerate(((3, 2, 1), (4, 5, 2))):
        arrays = {"global_solutions": rng.normal(size=(n, 50, 7)).astype(np.float32),
                  "hybrid_solutions": rng.normal(size=(n, 50, 7)).astype(np.float32),
                  "cuboid_dims": rng.uniform(size=(n, mc, 3)),
                  "cuboid_centers": rng.uniform(size=(n, mc, 3)),
                  "cylinder_centers": rng.uniform(size=(n, my, 3)),
                  "cuboid_quats": rng.uniform(size=(n, mc, 4)),
                  "cylinder_radii": rng.uniform(size=(n, my, 1))}
        for pkg, w in (("t", twriter), ("j", jwriter)):
            w.write_dataset(tmp_path / f"{pkg}{i}.hdf5", arrays)
        assert _h5(tmp_path / f"t{i}.hdf5").keys() == _h5(tmp_path / f"j{i}.hdf5").keys()
        files.append(i)
    assert twriter.DISK_KEYS == jwriter.DISK_KEYS
    nt = tprocess.merge_files([tmp_path / f"t{i}.hdf5" for i in files], tmp_path / "t.hdf5")
    nj = jprocess.merge_files([tmp_path / f"j{i}.hdf5" for i in files], tmp_path / "j.hdf5")
    assert nt == nj == 7
    a, b = _h5(tmp_path / "t.hdf5"), _h5(tmp_path / "j.hdf5")
    assert sorted(a) == sorted(b) and a["cuboid_quaternions"].shape == (7, 5, 4)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(OSError):
        tprocess.merge_files([tmp_path / "t0.hdf5"], tmp_path / "t.hdf5")


def test_entry_point_needs_a_card_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.gen("tabletop", tmp_path, num_scenes=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["tabletop", "--output", str(tmp_path), "--visualize-scene", "x.html"])
    assert list(tgen.ENVS) == list(jgen.ENVS)
