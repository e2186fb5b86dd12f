"""Dataset post-processing tools: merge, filter, split.

Port of ``mpinets_tpu/data/process.py`` (the reference's
``process_data.py:32-417``), vectorized chunked numpy IO instead of
per-row copy loops:

* :func:`merge_files` -- merge many schema HDF5 files into one, padding the
  ragged cuboid/cylinder axes to the global maximum (zero rows =
  zero-volume primitives, the canonical padding convention).
* :func:`extract_hybrid` -- keep only trajectories with a (non-all-zero)
  hybrid-expert solution (``process_data.py:121-144``).
* :func:`downsize_and_split` -- random disjoint train/val/test subsets into
  ``out/{train,val,test}/{split}.hdf5`` (``process_data.py:147-208``).
* :func:`merge_scenes` -- recursively merge per-scene splits into the final
  three training files (``process_data.py:211-253``).

CLI: ``python -m mpinets_torch.data.process {merge-files|extract-hybrid|
downsize-and-split|merge-scenes} ...``, the JAX package's command line
(``process_data.py:256-417``). ``h5py`` is imported by the functions that
read and write, so the module imports where it is not installed.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

CHUNK = 10_000  # rows copied per IO chunk (process_data.py:65)

#: keys whose second axis is the ragged primitive axis
_CUBOID = "cuboid"
_CYLINDER = "cylinder"


def _prim_axis(key: str) -> str | None:
    if _CUBOID in key:
        return _CUBOID
    if _CYLINDER in key:
        return _CYLINDER
    return None


def _scan(files: Sequence[Path]) -> Dict[str, int]:
    """Total rows + max cuboid/cylinder counts across files."""
    import h5py

    n = 0
    max_c = 0
    max_y = 0
    for fn in files:
        with h5py.File(str(fn), "r") as f:
            n += f["global_solutions"].shape[0]
            if "cuboid_centers" in f:
                max_c = max(max_c, f["cuboid_centers"].shape[1])
            if "cylinder_centers" in f:
                max_y = max(max_y, f["cylinder_centers"].shape[1])
    return {"n": n, "cuboids": max_c, "cylinders": max_y}


def merge_files(files: Sequence[Path], output_file, overwrite: bool = False) -> int:
    """Merge schema HDF5 files into ``output_file`` with max-padding on the
    primitive axes. Returns the merged row count."""
    import h5py

    files = [Path(f) for f in files]
    info = _scan(files)
    n, max_c, max_y = info["n"], info["cuboids"], info["cylinders"]
    with h5py.File(str(output_file), "w" if overwrite else "w-") as g:
        with h5py.File(str(files[0]), "r") as f:
            for k in f.keys():
                prim = _prim_axis(k)
                if prim == _CUBOID:
                    shape = (n, max_c) + f[k].shape[2:]
                elif prim == _CYLINDER:
                    shape = (n, max_y) + f[k].shape[2:]
                else:
                    shape = (n,) + f[k].shape[1:]
                g.create_dataset(k, shape, dtype=f[k].dtype)
        row = 0
        for fn in files:
            with h5py.File(str(fn), "r") as f:
                m = f["global_solutions"].shape[0]
                for lo in range(0, m, CHUNK):
                    hi = min(lo + CHUNK, m)
                    for k in f.keys():
                        block = f[k][lo:hi]
                        prim = _prim_axis(k)
                        if prim is not None:
                            width = max_c if prim == _CUBOID else max_y
                            if block.shape[1] < width:
                                pad = [(0, 0)] * block.ndim
                                pad[1] = (0, width - block.shape[1])
                                block = np.pad(block, pad)
                        g[k][row + lo : row + hi] = block
                row += m
    return n


def extract_hybrid(input_file, output_file) -> int:
    """Drop trajectories whose hybrid solution is all-zero (failed fabric
    runs are stored as zeros, ``gen_data.py:688-691``). Returns kept count."""
    import h5py

    with h5py.File(str(input_file), "r") as f:
        keep: List[np.ndarray] = []
        hs = f["hybrid_solutions"]
        for lo in range(0, hs.shape[0], CHUNK):
            block = hs[lo : lo + CHUNK]
            keep.append(np.any(block != 0.0, axis=(1, 2)))
        mask = np.concatenate(keep)
        idx = np.nonzero(mask)[0]
        with h5py.File(str(output_file), "w-") as g:
            for k in f.keys():
                g.create_dataset(k, (len(idx),) + f[k].shape[1:], dtype=f[k].dtype)
            row = 0
            for lo in range(0, hs.shape[0], CHUNK):
                sel = idx[(idx >= lo) & (idx < lo + CHUNK)]
                if len(sel) == 0:
                    continue
                for k in f.keys():
                    g[k][row : row + len(sel)] = f[k][lo : lo + CHUNK][sel - lo]
                row += len(sel)
    return len(idx)


def _copy_rows(src, dst_path: Path, idx: np.ndarray) -> None:
    """Rows ``idx`` (sorted) of the open file ``src`` into a new file."""
    import h5py

    dst_path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(dst_path), "w-") as g:
        for k in src.keys():
            g.create_dataset(k, (len(idx),) + src[k].shape[1:], dtype=src[k].dtype)
        n = src["global_solutions"].shape[0]
        row = 0
        for lo in range(0, n, CHUNK):
            sel = idx[(idx >= lo) & (idx < lo + CHUNK)]
            if len(sel) == 0:
                continue
            for k in src.keys():
                g[k][row : row + len(sel)] = src[k][lo : lo + CHUNK][sel - lo]
            row += len(sel)


def downsize_and_split(
    input_file,
    output_dir,
    train_size: int,
    val_size: int,
    test_size: int,
    seed: int | None = None,
) -> None:
    """Random disjoint train/val/test subsets (``process_data.py:147-208``;
    sizes of 0 skip that split). Indices are sorted per split so HDF5 reads
    stay sequential."""
    import h5py

    rng = np.random.default_rng(seed)
    out = Path(output_dir)
    with h5py.File(str(input_file), "r") as f:
        n = f["global_solutions"].shape[0]
        want = train_size + val_size + test_size
        assert want <= n, (want, n)
        perm = rng.choice(n, size=want, replace=False)
        splits = {
            "train": np.sort(perm[:train_size]),
            "val": np.sort(perm[train_size : train_size + val_size]),
            "test": np.sort(perm[train_size + val_size :]),
        }
        for split, idx in splits.items():
            if len(idx) == 0:
                continue
            _copy_rows(f, out / split / f"{split}.hdf5", idx)


def merge_scenes(input_dir, output_dir) -> None:
    """Merge every ``*/{split}/{split}.hdf5`` under ``input_dir`` into
    ``output_dir/{split}/{split}.hdf5`` (``process_data.py:211-253``)."""
    for split in ("train", "val", "test"):
        files = sorted(Path(input_dir).rglob(f"{split}/{split}.hdf5"))
        if not files:
            continue
        dst = Path(output_dir) / split / f"{split}.hdf5"
        dst.parent.mkdir(parents=True, exist_ok=True)
        merge_files(files, dst)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("merge-files")
    p.add_argument("output")
    p.add_argument("inputs", nargs="+")

    p = sub.add_parser("extract-hybrid")
    p.add_argument("input")
    p.add_argument("output")

    p = sub.add_parser("downsize-and-split")
    p.add_argument("input")
    p.add_argument("output_dir")
    p.add_argument("--train-size", type=int, required=True)
    p.add_argument("--val-size", type=int, required=True)
    p.add_argument("--test-size", type=int, required=True)
    p.add_argument("--seed", type=int, default=None)

    p = sub.add_parser("merge-scenes")
    p.add_argument("input_dir")
    p.add_argument("output_dir")

    args = ap.parse_args(argv)
    if args.cmd == "merge-files":
        n = merge_files([Path(f) for f in args.inputs], args.output)
        print(f"merged {n} trajectories -> {args.output}")
    elif args.cmd == "extract-hybrid":
        n = extract_hybrid(args.input, args.output)
        print(f"kept {n} hybrid trajectories -> {args.output}")
    elif args.cmd == "downsize-and-split":
        downsize_and_split(
            args.input, args.output_dir,
            args.train_size, args.val_size, args.test_size, args.seed,
        )
        print(f"split -> {args.output_dir}")
    elif args.cmd == "merge-scenes":
        merge_scenes(args.input_dir, args.output_dir)
        print(f"merged scenes -> {args.output_dir}")


if __name__ == "__main__":
    main()
