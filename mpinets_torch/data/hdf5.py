"""HDF5-backed dataset layer for the published MPiNets expert data.

Port of ``mpinets_tpu/data/hdf5.py`` (the reference's
``PointCloudBase`` / ``PointCloudInstanceDataset`` /
``PointCloudTrajectoryDataset`` / ``DataModule``,
``mpinets/data_loader.py:42-527``), split the same way:

* **Host** (numpy, bit for bit as the JAX package): raw reads of expert
  trajectories ``[N, 50, 7]`` and padded scene primitive arrays (schema of
  ``gen_data.py:734-762``). All-zero padding quaternions are patched to
  identity (``data_loader.py:198-202, 229-230``) and a dummy cylinder is
  injected when the file has none (``data_loader.py:211-218``).
* **Device** (:func:`prepare_train_batch`, no autograd): the goal FK for
  the target pose, the train-time joint noise clamped to the limits
  (``data_loader.py:167-179``) and the [B, 6272, 4] cloud of each row's own
  scene, batched over the rows. Its draws are split from the construction
  (:class:`PrepareDraws`), so a test can hand it the JAX package's.

:class:`InstanceLoader` overlaps the host reads with device compute in one
background thread; with ``pin_memory`` it hands over pinned tensors that
:func:`to_device` copies to the card with ``non_blocking=True`` (the
``h5py -> pinned host memory -> device`` stream).

``h5py`` is imported by the functions that open a file, so the module
imports where it is not installed. :meth:`TrajectoryDataset._from_arrays`
is a private seam: it builds a dataset from a mapping of arrays in the disk
schema (the same mapping an ``in_memory`` dataset reads through), so code
without ``h5py`` runs everything behind the file reader.
"""

from __future__ import annotations

import enum
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, Mapping, NamedTuple, Optional

import numpy as np
import torch

from mpinets_torch.geom.assembly import PointCloudSizes, assemble_point_cloud
from mpinets_torch.geom.scene import ObstacleDraws, SceneSet, draw_obstacle_samples
from mpinets_torch.kernels import kinematics
from mpinets_torch.robot import franka, point_banks
from mpinets_torch.utils.normalization import clamp_to_limits, normalize_franka_joints


class DatasetType(enum.Enum):
    """Split selector (``data_loader.py:42-49``)."""

    TRAIN = 0
    VAL = 1
    TEST = 2


_SPLIT_DIR = {
    DatasetType.TRAIN: "train",
    DatasetType.VAL: "val",
    DatasetType.TEST: "test",
}

SCENE_KEYS = (
    "cuboid_centers",
    "cuboid_dims",
    "cuboid_quats",
    "cylinder_centers",
    "cylinder_radii",
    "cylinder_heights",
    "cylinder_quats",
)


def _patch_quats(quats: np.ndarray) -> np.ndarray:
    """All-zero (padding) quaternions -> identity (``data_loader.py:202``)."""
    bad = np.all(np.isclose(quats, 0.0), axis=-1)
    quats = quats.copy()
    quats[bad, 0] = 1.0
    return quats


def _sorted_gather(dset, idx: np.ndarray) -> np.ndarray:
    """Fancy-index an h5py dataset with arbitrary (possibly repeated,
    unsorted) row indices. h5py requires sorted unique indices; read those
    once and scatter back. In-memory numpy arrays gather directly."""
    if isinstance(dset, np.ndarray):
        return dset[idx]
    uniq, inverse = np.unique(idx, return_inverse=True)
    return np.asarray(dset[uniq.tolist()])[inverse]


class TrajectoryDataset:
    """One split's HDF5 file: ``directory/{train,val,test}/*.hdf5``
    (layout contract of ``data_loader.py:52-67,103-123``)."""

    def __init__(
        self,
        directory,
        trajectory_key: str = "hybrid_solutions",
        dataset_type: DatasetType = DatasetType.TRAIN,
        in_memory: bool = False,
    ):
        import h5py

        split_dir = Path(directory) / _SPLIT_DIR[dataset_type]
        databases = sorted(split_dir.glob("**/*.hdf5"))
        assert len(databases) == 1, (
            f"expected exactly one hdf5 under {split_dir}, found {databases}"
        )
        self.path = databases[0]
        self._file = None
        self._arrays: Optional[Dict[str, np.ndarray]] = None
        with h5py.File(self.path, "r") as f:
            self._describe(f, trajectory_key, dataset_type)
            if in_memory:
                # the random-row gathers of h5py set the trainer's rate; a
                # 40k-trajectory split is ~130 MB, so cache it in RAM once
                self._arrays = {k: np.asarray(f[k]) for k in f.keys()}

    @classmethod
    def _from_arrays(
        cls,
        arrays: Mapping[str, np.ndarray],
        trajectory_key: str = "hybrid_solutions",
        dataset_type: DatasetType = DatasetType.TRAIN,
    ) -> "TrajectoryDataset":
        """A dataset over ``arrays``, keyed as on disk (``cuboid_quaternions``,
        ...): the store of an ``in_memory`` dataset, without a file."""
        self = cls.__new__(cls)
        self.path = None
        self._file = None
        self._arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._describe(self._arrays, trajectory_key, dataset_type)
        return self

    def _describe(self, f, trajectory_key: str, dataset_type: DatasetType) -> None:
        shape = f[trajectory_key].shape
        self.trajectory_key = trajectory_key
        self.dataset_type = dataset_type
        self.num_trajectories = int(shape[0])
        self.expert_length = int(shape[1])
        self.has_cylinders = "cylinder_radii" in f.keys()
        self.max_cuboids = int(f["cuboid_dims"].shape[1])
        self.max_cylinders = int(f["cylinder_radii"].shape[1]) if self.has_cylinders else 1

    @property
    def file(self):
        """The backing store: a dict of RAM arrays when ``in_memory``, else
        a lazily (per-process) opened h5py file."""
        if self._arrays is not None:
            return self._arrays
        if self._file is None:
            import h5py

            self._file = h5py.File(self.path, "r")
        return self._file

    def __len__(self) -> int:
        return self.num_trajectories

    @property
    def num_instances(self) -> int:
        """(trajectory, timestep) count -- the training dataset length
        (``data_loader.py:385-391``)."""
        return self.num_trajectories * self.expert_length

    def read_scenes(self, traj_idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Padded scene arrays for a batch of trajectory indices, with
        quaternion patching and the dummy-cylinder fallback."""
        f = self.file
        b = len(traj_idx)
        out = {
            "cuboid_centers": _sorted_gather(f["cuboid_centers"], traj_idx),
            "cuboid_dims": _sorted_gather(f["cuboid_dims"], traj_idx),
            "cuboid_quats": _patch_quats(_sorted_gather(f["cuboid_quaternions"], traj_idx)),
        }
        if self.has_cylinders:
            radii = _sorted_gather(f["cylinder_radii"], traj_idx)
            heights = _sorted_gather(f["cylinder_heights"], traj_idx)
            if radii.ndim == 2:
                radii = radii[..., None]
                heights = heights[..., None]
            out.update(
                cylinder_centers=_sorted_gather(f["cylinder_centers"], traj_idx),
                cylinder_radii=radii,
                cylinder_heights=heights,
                cylinder_quats=_patch_quats(_sorted_gather(f["cylinder_quaternions"], traj_idx)),
            )
        else:  # data_loader.py:211-218
            out.update(
                cylinder_centers=np.zeros((b, 1, 3), np.float32),
                cylinder_radii=np.zeros((b, 1, 1), np.float32),
                cylinder_heights=np.zeros((b, 1, 1), np.float32),
                cylinder_quats=np.tile(np.array([1.0, 0, 0, 0], np.float32), (b, 1, 1)),
            )
        return {k: np.asarray(v, np.float32) for k, v in out.items()}

    def read_instance_batch(self, traj_idx: np.ndarray, timesteps: np.ndarray
                            ) -> Dict[str, np.ndarray]:
        """Raw (un-assembled) training instances: configuration at t,
        supervision at min(t+1, T-1) (``data_loader.py:403-416``), goal
        config (for the FK target pose, ``data_loader.py:155-157``), and the
        scene arrays."""
        trajs = _sorted_gather(self.file[self.trajectory_key], traj_idx)
        t_next = np.clip(timesteps + 1, 0, self.expert_length - 1)
        rows = np.arange(len(traj_idx))
        batch = {
            "raw_configuration": trajs[rows, timesteps].astype(np.float32),
            "raw_supervision": trajs[rows, t_next].astype(np.float32),
            "raw_goal": trajs[:, -1].astype(np.float32),
        }
        batch.update(self.read_scenes(traj_idx))
        return batch

    def read_trajectory_batch(self, traj_idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Whole expert trajectories + scenes (validation/eval stream,
        ``PointCloudTrajectoryDataset`` equivalent)."""
        trajs = _sorted_gather(self.file[self.trajectory_key], traj_idx)
        batch = {
            "expert": trajs.astype(np.float32),
            "raw_configuration": trajs[:, 0].astype(np.float32),
            "raw_goal": trajs[:, -1].astype(np.float32),
        }
        batch.update(self.read_scenes(traj_idx))
        return batch


def scene_from_arrays(batch: Mapping[str, object], device=None) -> SceneSet:
    """The scene keys of a batch (numpy or tensors) as a SceneSet on ``device``."""
    return SceneSet(*(torch.as_tensor(batch[k], device=device) for k in SCENE_KEYS))


def to_device(batch: Mapping[str, object], device) -> Dict[str, torch.Tensor]:
    """Every array of a batch as a tensor on ``device``; pinned host tensors
    (``InstanceLoader(pin_memory=True)``) are copied without blocking."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


class PrepareDraws(NamedTuple):
    """The random numbers behind one :func:`prepare_train_batch`."""

    noise: torch.Tensor           # [B, 7] standard normal (scaled by random_scale)
    robot_indices: torch.Tensor   # [B, sizes.robot] robot-bank indices
    obstacle: ObstacleDraws       # [B, sizes.obstacle] per row, from the row's scene


def draw_prepare(generator: Optional[torch.Generator], raw: Mapping[str, torch.Tensor],
                 sizes: PointCloudSizes = PointCloudSizes()) -> PrepareDraws:
    """Draws for :func:`prepare_train_batch` on the batch ``raw``, from
    ``generator`` (on the batch's device)."""
    q = raw["raw_configuration"]
    b, device = q.shape[0], q.device
    noise = torch.randn((b, franka.DOF), generator=generator, device=device)
    robot = torch.randint(0, point_banks.DEFAULT_BANK_SIZE, (b, sizes.robot),
                          generator=generator, device=device)
    obstacle = draw_obstacle_samples(scene_from_arrays(raw, device), sizes.obstacle, generator)
    return PrepareDraws(noise, robot, obstacle)


@torch.no_grad()
def prepare_train_batch(
    raw: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    sizes: PointCloudSizes = PointCloudSizes(),
    random_scale: float = 0.015,
    train: bool = True,
    draws: Optional[PrepareDraws] = None,
) -> Dict[str, torch.Tensor]:
    """Device-side per-item construction (``get_inputs``,
    ``data_loader.py:141-280``) on the device of ``raw``: goal FK -> target
    pose; train-time joint noise clamped to limits; robot/obstacle/target
    sampling; [B, N, 4] assembly. ``draws`` replaces the draws from
    ``generator``."""
    q_t = raw["raw_configuration"]
    device = q_t.device
    if draws is None:
        draws = draw_prepare(generator, raw, sizes)
    rot_goal, trans_goal = kinematics.eff_pose(raw["raw_goal"])
    if train:
        q_t = clamp_to_limits(q_t + random_scale * draws.noise.to(device))
    xyz = assemble_point_cloud(
        q_t, rot_goal, trans_goal, scene_from_arrays(raw, device), sizes,
        robot_indices=draws.robot_indices.to(device),
        obstacle_draws=ObstacleDraws(*(x.to(device) for x in draws.obstacle)),
    )
    out = {
        "xyz": xyz,
        "configuration": normalize_franka_joints(q_t),
        "target_position": trans_goal,
    }
    if "raw_supervision" in raw:
        out["supervision"] = normalize_franka_joints(raw["raw_supervision"])
    for k in SCENE_KEYS:
        out[k] = raw[k]
    return out


class InstanceLoader:
    """Shuffled, prefetched stream of raw training-instance batches.

    The reference fans ``get_inputs`` out over ``os.cpu_count()`` worker
    processes (``data_loader.py:490-501``); here the host work is a single
    HDF5 gather per batch, overlapped with device compute by one background
    thread. Drop-last semantics; reshuffles every epoch with
    ``np.random.default_rng((seed, epoch))``, so the index stream is the
    JAX package's. ``pin_memory`` makes the thread hand over pinned torch
    tensors (for :func:`to_device`) instead of numpy arrays.
    """

    def __init__(self, dataset: TrajectoryDataset, batch_size: int, seed: int = 0,
                 prefetch: int = 4, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory

    def batches_per_epoch(self) -> int:
        return self.dataset.num_instances // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.dataset.num_instances)

    def __iter__(self) -> Iterator[Dict[str, object]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            epoch = 0
            while not stop.is_set():
                order = self._epoch_indices(epoch)
                n = self.batches_per_epoch() * self.batch_size
                for lo in range(0, n, self.batch_size):
                    if stop.is_set():
                        return
                    idx = order[lo : lo + self.batch_size]
                    traj_idx, t = np.divmod(idx, self.dataset.expert_length)
                    batch = self.dataset.read_instance_batch(traj_idx, t)
                    if self.pin_memory:
                        batch = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
                    q.put(batch)
                epoch += 1

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            # unblock the producer if it waits on a full queue
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def trajectory_batches(dataset: TrajectoryDataset, batch_size: int
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential full-trajectory batches (validation stream). The last
    ragged batch is padded by repeating the final row; consumers can trim
    with the returned ``valid`` mask."""
    n = dataset.num_trajectories
    for lo in range(0, n, batch_size):
        idx = np.arange(lo, min(lo + batch_size, n))
        valid = np.ones(batch_size, bool)
        if len(idx) < batch_size:
            valid[len(idx):] = False
            idx = np.concatenate([idx, np.full(batch_size - len(idx), idx[-1])])
        batch = dataset.read_trajectory_batch(idx)
        batch["valid"] = valid
        yield batch
