"""Process group, device mesh and this rank's block of a batch.

Port of ``mpinets_tpu/parallel/mesh.py``. The reference distributes with
NCCL DDP through PyTorch Lightning (``run_training.py:71-77``); the JAX
package with a named device mesh. Here one process drives one card (rank r
on ``cuda:LOCAL_RANK``), the processes join one ``torch.distributed``
group (NCCL on ``cuda``, gloo on the CPU, chosen from the device) and a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks names
the ``data`` axis. A sharded array of the JAX package becomes each rank's
contiguous block of the leading axis (:class:`Sharding`); a replicated one
is the whole array on every rank.

The model is ~20 M parameters with a fixed 6272-point input, so data
parallelism is the only sharding the workload needs.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from mpinets_torch.utils.device import resolve_device

DATA_AXIS = "data"


def fold_seed(*parts: int) -> int:
    """One generator seed from several integers (the counterpart of
    ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0] >> 1)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device=None) -> torch.device:
    """The device this process drives: ``device`` (None = ``cuda``), and on
    ``cuda`` without an index the card ``LOCAL_RANK`` (0 when unset)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def multihost_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join a ``torch.distributed`` process group; True if this call made it.

    The rendezvous is ``coordinator_address`` (``host:port`` for TCP, or a
    URL such as ``file:///path``), else ``MPINETS_COORDINATOR`` (the JAX
    package's variable), else ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``.
    The world size and rank are the arguments, else ``WORLD_SIZE`` and
    ``RANK``. No-op when neither an address nor a world size is given
    (single-process runs, unit tests), or when a group exists already. The
    backend is NCCL on ``cuda`` (the process's card, :func:`local_device`,
    becomes the current one) and gloo on the CPU.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    addr = coordinator_address or env.get("MPINETS_COORDINATOR")
    if addr is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if addr is None and num_processes is None:
        return False
    if addr is None or num_processes is None or process_id is None:
        raise ValueError(
            "multihost_init needs a coordinator address, the number of processes and this "
            f"process's id; got {addr!r}, {num_processes!r}, {process_id!r}")
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id,
    )
    return True


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    axis_sizes: Optional[Sequence[int]] = None,
):
    """A :class:`DeviceMesh` over the first ``n_devices`` ranks (default:
    all) of the process group, one card (or CPU process) a rank.

    With the default single ``data`` axis this is the production DP layout;
    pass several ``axis_names``/``axis_sizes`` to reshape the same ranks.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call multihost_init first")
    ranks = list(range(dist.get_world_size()))
    if n_devices is not None:
        ranks = ranks[:n_devices]
        if len(ranks) != n_devices:
            raise ValueError(f"requested {n_devices} devices, only {len(ranks)} available")
    if axis_sizes is None:
        axis_sizes = (len(ranks),) if len(axis_names) == 1 else None
    if axis_sizes is None:
        raise ValueError("axis_sizes required for multi-axis meshes")
    grid = torch.tensor(ranks, dtype=torch.int).reshape(tuple(axis_sizes))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def axis_group(mesh, axis: str = DATA_AXIS) -> Tuple[Optional[object], int, int]:
    """(process group, this rank's index, size) of ``axis``; ``(None, 0,
    1)`` without a mesh, where no collective is made."""
    if mesh is None:
        return None, 0, 1
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(
        mesh.mesh_dim_names.index(axis))


class Sharding(NamedTuple):
    """A rank's share of the leading axis: block ``index`` of ``count``
    contiguous, equal blocks (``count`` 1: the whole, replicated)."""

    index: int = 0
    count: int = 1

    def block(self, n: int) -> slice:
        per = n // self.count
        if per * self.count != n:
            raise ValueError(f"global batch {n} not divisible by {self.count} hosts")
        return slice(per * self.index, per * (self.index + 1))


def data_sharding(mesh=None, axis: str = DATA_AXIS) -> Sharding:
    """The sharding that splits the leading (batch) dimension across ``axis``."""
    _, index, count = axis_group(mesh, axis)
    return Sharding(index, count)


def replicated_sharding(mesh=None) -> Sharding:
    """The whole array on every rank."""
    return Sharding(0, 1)


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` >= ``n`` (for padding batches to shard
    evenly; padded tail entries are masked out by consumers)."""
    return ((n + k - 1) // k) * k


def shard_leading_axis(tree, mesh=None, axis: str = DATA_AXIS):
    """This rank's block of the leading axis of every array in a pytree
    (dicts, tuples, NamedTuples; None leaves stay None)."""
    block = data_sharding(mesh, axis).block
    return pytree.tree_map(lambda x: x if x is None else x[block(x.shape[0])], tree)


def process_local_slice(n_global: int) -> slice:
    """The half-open [start, stop) range of a length-``n_global`` global
    batch owned by this process (contiguous block partitioning), for
    building per-process input pipelines under data parallelism."""
    count = process_count()
    per = n_global // count
    if per * count != n_global:
        raise ValueError(f"global batch {n_global} not divisible by {count} hosts")
    start = per * process_index()
    return slice(start, start + per)


def rank_generator(generator_or_seed, index: int, device) -> torch.Generator:
    """A generator for rank ``index``: an integer seed is folded with the
    index (``fold_in(key, axis_index)``); a generator is used as it is."""
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    return torch.Generator(device).manual_seed(fold_seed(int(generator_or_seed), index))
