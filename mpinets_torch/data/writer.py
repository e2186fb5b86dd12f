"""HDF5 dataset writing in the reference's exact schema.

Port of ``mpinets_tpu/data/writer.py`` (schema:
the reference's ``mpinets/data_pipeline/gen_data.py:734-762``): keys
``hybrid_solutions`` / ``global_solutions`` ``[N, 50, 7]``,
``cuboid_dims/centers/quaternions`` ``[N, Mc, 3|3|4]``,
``cylinder_radii/heights/centers/quaternions`` ``[N, My, 1|1|3|4]``.
Padding rows are all-zero (zero-volume primitives, all-zero quaternions);
failed hybrid solutions are stored as all-zero trajectories
(``gen_data.py:688-691``). Used for test fixtures, for materializing
synthetic pseudo-expert datasets (:func:`write_synthetic_dataset`), and by
the post-processing tools (:mod:`mpinets_torch.data.process`). ``h5py`` is
imported by the function that writes, so the module imports where it is
not installed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

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


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_synthetic_dataset(
    directory,
    split: str = "train",
    num_trajectories: int = 32,
    seed: int = 0,
    filename: Optional[str] = None,
    problems=None,
    goals=None,
) -> Path:
    """Materialize a schema-compatible pseudo-expert dataset under
    ``directory/{split}/`` from the synthetic scene/trajectory generator
    (:mod:`mpinets_torch.data.synthetic`, on the CPU, from a generator
    seeded with ``seed``). Stand-in for the published Zenodo tarball where
    it is absent. ``problems`` (a ``Problem`` batch) and ``goals`` [N, 7]
    replace the draws."""
    from mpinets_torch.data import synthetic

    generator = torch.Generator().manual_seed(seed)
    if problems is None:
        problems = synthetic.random_problem_batch(generator, num_trajectories)
    if goals is None:
        goals = synthetic.random_configuration(generator, (num_trajectories,))
    q0 = torch.as_tensor(_numpy(problems.q0))
    trajs = synthetic.min_jerk_trajectory(q0, torch.as_tensor(_numpy(goals)))
    trajs = np.asarray(trajs.numpy(), np.float64)

    scene = problems.scene
    arrays = {
        "hybrid_solutions": trajs,
        "global_solutions": trajs,
        "cuboid_dims": _numpy(scene.cuboid_dims),
        "cuboid_centers": _numpy(scene.cuboid_centers),
        "cuboid_quats": _numpy(scene.cuboid_quats),
        "cylinder_radii": _numpy(scene.cylinder_radii),
        "cylinder_heights": _numpy(scene.cylinder_heights),
        "cylinder_centers": _numpy(scene.cylinder_centers),
        "cylinder_quats": _numpy(scene.cylinder_quats),
    }
    # the reference stores padding quats as all-zero; exercise the loader's
    # patching by zeroing them here
    pad = np.all(arrays["cuboid_dims"] == 0.0, axis=-1)
    arrays["cuboid_quats"] = np.where(pad[..., None], 0.0, arrays["cuboid_quats"])
    out = Path(directory) / split / (filename or f"{split}.hdf5")
    write_dataset(out, arrays)
    return out
