"""Port parity: the HDF5 dataset layer and the synthetic dataset writer,
``mpinets_torch.data.hdf5``/``writer`` against ``mpinets_tpu``'s.

Datasets are written by the JAX package's ``write_synthetic_dataset`` (and
its ``write_dataset`` for the edge cases: a file with no cylinders, 2-D
cylinder radii) with ``h5py``. The host half is numpy in both packages, so
the reader, the loader's index stream and batches (two epochs) and the
padded trajectory stream must be **equal**, as must the file the port's
writer makes from JAX's problems and goals. ``prepare_train_batch`` runs
on JAX's draws (the same ``split(key)`` and ``split(k_cloud, B)``): ``xyz``
within 1e-5 (f32 FK chains, as ``training_batch``), ``configuration``,
``supervision`` and ``target_position`` within 1e-6.
"""

import functools
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

from test_torch_actor import _cloud_draws, _obstacle  # noqa: E402  (tests dir is on sys.path)

from mpinets_torch.data import hdf5 as thdf5  # noqa: E402
from mpinets_torch.data import synthetic as tsyn  # noqa: E402
from mpinets_torch.data import writer as twriter  # noqa: E402
from mpinets_torch.geom.assembly import PointCloudSizes  # noqa: E402
from mpinets_torch.geom.scene import SceneSet  # noqa: E402
from mpinets_tpu.data import hdf5 as jhdf5  # noqa: E402
from mpinets_tpu.data import synthetic as jsyn  # noqa: E402
from mpinets_tpu.data import writer as jwriter  # noqa: E402
from mpinets_tpu.geom import assembly as jas  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402

SIZES = (64, 96, 32)


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


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    jwriter.write_synthetic_dataset(root, "train", num_trajectories=6, seed=0)
    jwriter.write_synthetic_dataset(root, "val", num_trajectories=5, seed=1)
    # the edge cases: no cylinder keys at all (test split), 2-D radii (other)
    rng = np.random.default_rng(3)
    arrays = {
        "hybrid_solutions": rng.normal(size=(4, 50, 7)),
        "global_solutions": rng.normal(size=(4, 50, 7)),
        "cuboid_dims": rng.uniform(size=(4, 3, 3)),
        "cuboid_centers": rng.uniform(size=(4, 3, 3)),
        "cuboid_quats": np.where(rng.uniform(size=(4, 3, 1)) < 0.5, 0.0,
                                 rng.uniform(size=(4, 3, 4))),
    }
    jwriter.write_dataset(root / "test" / "test.hdf5", arrays)
    arrays.update(cylinder_radii=rng.uniform(size=(4, 2)),
                  cylinder_heights=rng.uniform(size=(4, 2)),
                  cylinder_centers=rng.uniform(size=(4, 2, 3)),
                  cylinder_quats=np.zeros((4, 2, 4)))
    jwriter.write_dataset(root / "flat" / "train" / "train.hdf5", arrays)
    return root


def _assert_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


CASES = [("", "TRAIN"), ("", "VAL"), ("", "TEST"), ("flat", "TRAIN")]


@pytest.mark.parametrize("in_memory", [False, True])
@pytest.mark.parametrize("sub, split", CASES)
def test_reader_equals_jax(dataset_dir, sub, split, in_memory):
    """Repeated and unsorted indices, both stores, a file with no cylinders
    (the dummy cylinder) and one with 2-D radii (lifted to [..., 1])."""
    ours = thdf5.TrajectoryDataset(dataset_dir / sub, "hybrid_solutions",
                                   thdf5.DatasetType[split], in_memory=in_memory)
    ref = jhdf5.TrajectoryDataset(dataset_dir / sub, "hybrid_solutions",
                                  jhdf5.DatasetType[split], in_memory=in_memory)
    for attr in ("num_trajectories", "expert_length", "has_cylinders", "max_cuboids",
                 "max_cylinders", "num_instances"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert len(ours) == len(ref)
    idx = np.array([3, 0, 3, 1, 0])[: ours.num_trajectories + 1] % ours.num_trajectories
    t = np.array([49, 0, 10, 48, 3])[: len(idx)]
    _assert_equal(ours.read_scenes(idx), ref.read_scenes(idx))
    _assert_equal(ours.read_instance_batch(idx, t), ref.read_instance_batch(idx, t))
    _assert_equal(ours.read_trajectory_batch(idx), ref.read_trajectory_batch(idx))
    scenes = ours.read_scenes(idx)
    assert (np.linalg.norm(scenes["cuboid_quats"], axis=-1) > 0.0).all()


def test_arrays_seam_reads_as_the_file(dataset_dir):
    """A dataset over the disk schema's arrays reads as the file does."""
    with h5py.File(dataset_dir / "val" / "val.hdf5", "r") as f:
        arrays = {k: np.asarray(f[k]) for k in f.keys()}
    seam = thdf5.TrajectoryDataset._from_arrays(arrays, "global_solutions",
                                                thdf5.DatasetType.VAL)
    ref = jhdf5.TrajectoryDataset(dataset_dir, "global_solutions", jhdf5.DatasetType.VAL)
    assert seam.path is None and seam.num_trajectories == 5 and seam.dataset_type.name == "VAL"
    idx = np.array([4, 2, 2])
    _assert_equal(seam.read_trajectory_batch(idx), ref.read_trajectory_batch(idx))
    _assert_equal(seam.read_instance_batch(idx, np.array([1, 49, 7])),
                  ref.read_instance_batch(idx, np.array([1, 49, 7])))


def test_reader_wants_exactly_one_file(tmp_path, dataset_dir):
    (tmp_path / "train").mkdir()
    with pytest.raises(AssertionError, match="exactly one hdf5"):
        thdf5.TrajectoryDataset(tmp_path)


def test_instance_loader_equals_jax_for_two_epochs(dataset_dir):
    ours = thdf5.InstanceLoader(thdf5.TrajectoryDataset(dataset_dir), batch_size=64, seed=7919)
    ref = jhdf5.InstanceLoader(jhdf5.TrajectoryDataset(dataset_dir), batch_size=64, seed=7919)
    assert ours.batches_per_epoch() == ref.batches_per_epoch() == 4     # 300 // 64, drop-last
    for epoch in (0, 1):
        np.testing.assert_array_equal(ours._epoch_indices(epoch), ref._epoch_indices(epoch))
    a, b = iter(ours), iter(ref)
    for _ in range(2 * ours.batches_per_epoch() + 1):
        _assert_equal(next(a), next(b))
    a.close()   # the producer thread stops and the queue drains
    b.close()


def test_trajectory_batches_equal_jax(dataset_dir):
    ours = list(thdf5.trajectory_batches(
        thdf5.TrajectoryDataset(dataset_dir, dataset_type=thdf5.DatasetType.VAL), 3))
    ref = list(jhdf5.trajectory_batches(
        jhdf5.TrajectoryDataset(dataset_dir, dataset_type=jhdf5.DatasetType.VAL), 3))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        _assert_equal(a, b)
    assert ours[1]["valid"].tolist() == [True, True, False]


@functools.partial(jax.jit, static_argnums=2)
def _jax_prepare_draws(key, raw, sizes):
    """The draws of ``mpinets_tpu.data.hdf5.prepare_train_batch``."""
    b = raw["raw_configuration"].shape[0]
    k_noise, k_cloud = jax.random.split(key)
    robot, obstacle = _cloud_draws(k_cloud, jsc.SceneSet(*(raw[k] for k in jhdf5.SCENE_KEYS)),
                                   b, sizes)
    return jax.random.normal(k_noise, (b, 7)), robot, obstacle


@pytest.mark.parametrize("train", [True, False])
def test_prepare_train_batch_on_jaxs_draws(dataset_dir, train):
    ds = jhdf5.TrajectoryDataset(dataset_dir)
    raw = ds.read_instance_batch(np.array([0, 1, 2, 5]), np.array([0, 10, 49, 30]))
    sizes = jas.PointCloudSizes(*SIZES)
    key = jax.random.PRNGKey(4)
    ref = jax.device_get(jhdf5.prepare_train_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}, key, sizes=sizes, train=train))
    noise, robot, obstacle = _jax_prepare_draws(key, raw, sizes)
    draws = thdf5.PrepareDraws(_t(noise), _t(robot), _obstacle(obstacle))
    ours = thdf5.prepare_train_batch({k: _t(v) for k, v in raw.items()},
                                     sizes=PointCloudSizes(*SIZES), train=train, draws=draws)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape and ours[k].dtype == torch.float32, k
        np.testing.assert_allclose(ours[k].numpy(), v, atol=1e-5 if k == "xyz" else 1e-6,
                                   err_msg=k)
    assert not any(v.requires_grad for v in ours.values())
    # its own draws, from a generator: the same layout, the labels in place
    drawn = thdf5.prepare_train_batch(thdf5.to_device(raw, "cpu"), torch.Generator().manual_seed(0),
                                      sizes=PointCloudSizes(*SIZES), train=train)
    assert {k: v.shape for k, v in drawn.items()} == {k: v.shape for k, v in ours.items()}
    assert torch.equal(drawn["xyz"][..., 3], ours["xyz"][..., 3])


def test_write_synthetic_dataset_equals_jax_given_its_problems(tmp_path):
    key = jax.random.PRNGKey(2)
    problems = jsyn.random_problem_batch(key, 5)
    goals = jsyn.random_configuration(jax.random.fold_in(key, 1), (5,))
    ref_path = jwriter.write_synthetic_dataset(tmp_path / "jax", "val", num_trajectories=5, seed=2)
    tproblems = tsyn.Problem(_t(problems.q0), _t(problems.target_rot), _t(problems.target_trans),
                             SceneSet(*map(_t, problems.scene)))
    path = twriter.write_synthetic_dataset(tmp_path / "torch", "val", num_trajectories=5,
                                           problems=tproblems, goals=_t(goals))
    assert path.relative_to(tmp_path / "torch").as_posix() == "val/val.hdf5"
    with h5py.File(path, "r") as f, h5py.File(ref_path, "r") as g:
        assert sorted(f.keys()) == sorted(g.keys())
        for k in g.keys():
            assert f[k].dtype == g[k].dtype and f[k].shape == g[k].shape, k
            np.testing.assert_array_equal(f[k][:], g[k][:], err_msg=k)
        assert (f["cuboid_quaternions"][:] == 0).all(-1).any()   # padding quats zeroed


def test_write_synthetic_dataset_from_its_seed_reads_in_both_packages(tmp_path):
    path = twriter.write_synthetic_dataset(tmp_path, "train", num_trajectories=4, seed=3,
                                           filename="x.hdf5")
    again = twriter.write_synthetic_dataset(tmp_path / "again", "train", num_trajectories=4,
                                            seed=3)
    with h5py.File(path, "r") as f, h5py.File(again, "r") as g:
        assert all(np.array_equal(f[k][:], g[k][:]) for k in f.keys())
    ours, ref = thdf5.TrajectoryDataset(tmp_path), jhdf5.TrajectoryDataset(tmp_path)
    idx = np.arange(4)
    _assert_equal(ours.read_trajectory_batch(idx), ref.read_trajectory_batch(idx))
    traj = ours.read_trajectory_batch(idx)["expert"]
    assert traj.shape == (4, 50, 7) and np.isfinite(traj).all()


def test_reader_without_h5py(dataset_dir, monkeypatch):
    """Where h5py does not import, opening a file raises ImportError and
    the arrays seam still reads."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        thdf5.TrajectoryDataset(dataset_dir)
    rng = np.random.default_rng(0)
    seam = thdf5.TrajectoryDataset._from_arrays({
        "hybrid_solutions": rng.normal(size=(2, 50, 7)),
        "cuboid_dims": np.ones((2, 1, 3)), "cuboid_centers": np.zeros((2, 1, 3)),
        "cuboid_quaternions": np.zeros((2, 1, 4))})
    batch = next(iter(thdf5.InstanceLoader(seam, 8, seed=0)))
    assert batch["raw_configuration"].shape == (8, 7)
    np.testing.assert_array_equal(batch["cuboid_quats"][:, 0], np.tile([1.0, 0, 0, 0], (8, 1)))
    assert batch["cylinder_radii"].shape == (8, 1, 1)
