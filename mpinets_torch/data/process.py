"""Dataset post-processing: merging schema HDF5 files.

Port of ``merge_files`` from ``mpinets_tpu/data/process.py`` (the
reference's ``process_data.py:32-118``): many schema HDF5 files merge into
one, the ragged cuboid and cylinder axes padded to the largest (zero rows
are zero-volume primitives). ``h5py`` is imported by the functions that
read and write. The other modes (``extract_hybrid``,
``downsize_and_split``, ``merge_scenes``) and the command line are not
ported yet (``ROADMAP.md`` A11).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

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
