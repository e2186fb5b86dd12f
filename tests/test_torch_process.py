"""Port parity: the dataset post-processing tools,
``mpinets_torch.data.process`` against ``mpinets_tpu.data.process``
(mirroring ``tests/test_process.py``).

Both packages run on the same input files (written by the JAX package's
``write_dataset``), each into its own directory, and every output file must
be **equal** key by key (numpy IO on both sides), the command line's
included.
"""

from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")

from mpinets_torch.data import hdf5 as thdf5  # noqa: E402
from mpinets_torch.data import process as tprocess  # noqa: E402
from mpinets_tpu.data import process as jprocess  # noqa: E402
from mpinets_tpu.data import writer as jwriter  # noqa: E402


def _make_file(path, n, mc, my, seed, zero_hybrid_rows=()):
    rng = np.random.default_rng(seed)
    hybrid = rng.normal(size=(n, 50, 7))
    for r in zero_hybrid_rows:
        hybrid[r] = 0.0
    jwriter.write_dataset(path, {
        "global_solutions": rng.normal(size=(n, 50, 7)),
        "hybrid_solutions": hybrid,
        "cuboid_dims": rng.uniform(size=(n, mc, 3)),
        "cuboid_centers": rng.uniform(size=(n, mc, 3)),
        "cuboid_quats": rng.uniform(size=(n, mc, 4)),
        "cylinder_radii": rng.uniform(size=(n, my, 1)),
        "cylinder_heights": rng.uniform(size=(n, my, 1)),
        "cylinder_centers": rng.uniform(size=(n, my, 3)),
        "cylinder_quats": rng.uniform(size=(n, my, 4)),
    })
    return path


def _assert_files_equal(a, b):
    with h5py.File(a, "r") as f, h5py.File(b, "r") as g:
        assert sorted(f.keys()) == sorted(g.keys())
        for k in g.keys():
            assert f[k].dtype == g[k].dtype and f[k].shape == g[k].shape, k
            np.testing.assert_array_equal(f[k][:], g[k][:], err_msg=k)


def _assert_trees_equal(a: Path, b: Path):
    files = sorted(p.relative_to(b) for p in b.rglob("*.hdf5"))
    assert files and files == sorted(p.relative_to(a) for p in a.rglob("*.hdf5"))
    for rel in files:
        _assert_files_equal(a / rel, b / rel)


def test_extract_hybrid_equals_jax(tmp_path):
    src = _make_file(tmp_path / "a.hdf5", 8, 2, 2, 2, zero_hybrid_rows=(1, 4))
    n = tprocess.extract_hybrid(src, tmp_path / "t.hdf5")
    assert n == jprocess.extract_hybrid(src, tmp_path / "j.hdf5") == 6
    _assert_files_equal(tmp_path / "t.hdf5", tmp_path / "j.hdf5")
    with pytest.raises(FileExistsError):   # "w-": never overwrites
        tprocess.extract_hybrid(src, tmp_path / "t.hdf5")


def test_downsize_split_and_merge_scenes_equal_jax(tmp_path):
    a = _make_file(tmp_path / "a.hdf5", 20, 2, 2, 3)
    b = _make_file(tmp_path / "b.hdf5", 15, 4, 1, 4)
    for pkg, name in ((tprocess, "t"), (jprocess, "j")):
        pkg.downsize_and_split(a, tmp_path / name / "scenes" / "tabletop", 6, 2, 3, seed=0)
        pkg.downsize_and_split(b, tmp_path / name / "scenes" / "cubby", 5, 1, 0, seed=1)
        pkg.merge_scenes(tmp_path / name / "scenes", tmp_path / name / "final")
    _assert_trees_equal(tmp_path / "t", tmp_path / "j")
    assert not (tmp_path / "t" / "scenes" / "cubby" / "test").exists()   # a size of 0 skips
    with h5py.File(tmp_path / "t" / "final" / "train" / "train.hdf5", "r") as f:
        assert f["global_solutions"].shape[0] == 11
        assert f["cuboid_centers"].shape[1] == 4   # max-padded
    # the merged output is what the training reader reads
    ds = thdf5.TrajectoryDataset(tmp_path / "t" / "final")
    assert len(ds) == 11
    assert ds.read_trajectory_batch(np.array([0, 5, 10]))["expert"].shape == (3, 50, 7)


def test_splits_are_disjoint(tmp_path):
    src = _make_file(tmp_path / "a.hdf5", 30, 2, 2, 5)
    tprocess.downsize_and_split(src, tmp_path / "split", 10, 5, 5, seed=7)
    rows = []
    for split in ("train", "val", "test"):
        with h5py.File(tmp_path / "split" / split / f"{split}.hdf5", "r") as f:
            rows.append(f["global_solutions"][:])
    assert len(np.unique(np.concatenate(rows).reshape(20, -1), axis=0)) == 20
    with pytest.raises(AssertionError):
        tprocess.downsize_and_split(src, tmp_path / "big", 20, 10, 5, seed=7)


def test_command_line_equals_jax(tmp_path, capsys):
    a = _make_file(tmp_path / "a.hdf5", 12, 3, 2, 6, zero_hybrid_rows=(2,))
    b = _make_file(tmp_path / "b.hdf5", 7, 5, 1, 7)
    printed = {}
    for pkg, name in ((tprocess, "t"), (jprocess, "j")):
        out = tmp_path / name
        out.mkdir()
        for argv in (
            ["merge-files", str(out / "merged.hdf5"), str(a), str(b)],
            ["extract-hybrid", str(out / "merged.hdf5"), str(out / "hybrid.hdf5")],
            ["downsize-and-split", str(out / "hybrid.hdf5"), str(out / "scenes" / "s"),
             "--train-size", "9", "--val-size", "5", "--test-size", "4", "--seed", "3"],
            ["merge-scenes", str(out / "scenes"), str(out / "final")],
        ):
            pkg.main(argv)
        printed[name] = capsys.readouterr().out.replace(str(out), "OUT")
    assert printed["t"] == printed["j"]
    assert "merged 19 trajectories" in printed["t"] and "kept 18 hybrid" in printed["t"]
    _assert_trees_equal(tmp_path / "t", tmp_path / "j")
    with pytest.raises(SystemExit):
        tprocess.main(["no-such-mode"])
