"""HDF5 dataset writing in the reference's exact schema.

Port of ``write_dataset`` from ``mpinets_tpu/data/writer.py`` (schema:
the reference's ``mpinets/data_pipeline/gen_data.py:734-762``): keys
``hybrid_solutions`` / ``global_solutions`` ``[N, 50, 7]``,
``cuboid_dims/centers/quaternions`` ``[N, Mc, 3|3|4]``,
``cylinder_radii/heights/centers/quaternions`` ``[N, My, 1|1|3|4]``.
``h5py`` is imported by the function that writes, so the module imports
where it is not installed. ``write_synthetic_dataset`` is not ported yet
(``ROADMAP.md`` A11).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

SEQUENCE_LENGTH = 50  # gen_data.py:77

#: our-loader key -> on-disk key (the reference stores quats as *_quaternions)
DISK_KEYS = {
    "cuboid_dims": "cuboid_dims",
    "cuboid_centers": "cuboid_centers",
    "cuboid_quats": "cuboid_quaternions",
    "cylinder_radii": "cylinder_radii",
    "cylinder_heights": "cylinder_heights",
    "cylinder_centers": "cylinder_centers",
    "cylinder_quats": "cylinder_quaternions",
}


def write_dataset(path, arrays: Dict[str, np.ndarray], mode: str = "w") -> None:
    """Write a dict of schema arrays (our key names) to ``path``."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, mode) as f:
        for key, value in arrays.items():
            f.create_dataset(DISK_KEYS.get(key, key), data=np.asarray(value))
