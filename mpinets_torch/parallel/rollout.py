"""Sharded lockstep rollout: the actor side of the actor/learner layout.

Port of ``mpinets_tpu/parallel/rollout.py``. The reference evaluates
problems one at a time (``run_inference.py:137-191``) and averages
validation metrics over DDP ranks (``model.py:320-333``). Here every rank
holds the whole problem batch, rolls out its contiguous block with the
lockstep engine (:mod:`mpinets_torch.rollout.engine`) and a generator
folded with its rank, and scalar statistics are all-reduce-meaned over the
mesh's data axis. On ``cuda`` the rollout takes the kernel-backed
inference forward (:func:`mpinets_torch.model.fused.make_fused_apply`),
as validation does.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from mpinets_torch.data.synthetic import Problem
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.kernels import kinematics
from mpinets_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    local_device,
    rank_generator,
    shard_leading_axis,
)
from mpinets_torch.rollout.engine import RolloutResult, make_rollout_fn

STAT_KEYS = ("success_rate", "mean_steps", "mean_final_pos_err")


def make_sharded_rollout(
    model,
    mesh=None,
    data_axis: str = DATA_AXIS,
    device=None,
    **rollout_kwargs,
) -> Callable[..., RolloutResult]:
    """Build ``(problems, generator_or_seed=0, init_cloud=None,
    robot_indices=None) -> RolloutResult`` for this rank's block of the
    problem batch (``out_specs=P(data)``: the result stays distributed).

    An integer seed is folded with the rank, so the ranks' resampling
    streams are independent; ``init_cloud``/``robot_indices`` are this
    block's draws (:func:`mpinets_torch.rollout.engine.make_rollout_fn`).
    ``device`` defaults to this process's card.
    """
    device = local_device(device)
    if rollout_kwargs.get("apply_fn") is None and device.type == "cuda":
        from mpinets_torch.model.fused import make_fused_apply

        rollout_kwargs["apply_fn"] = make_fused_apply(model.compute_dtype)
    rollout = make_rollout_fn(model, device=device, **rollout_kwargs)
    _, index, _ = axis_group(mesh, data_axis)

    def sharded(problems: Problem, generator_or_seed=0, init_cloud=None, robot_indices=None):
        block = shard_leading_axis(problems, mesh, data_axis)
        return rollout(block, rank_generator(generator_or_seed, index, device),
                       init_cloud=init_cloud, robot_indices=robot_indices)

    return sharded


def make_sharded_success_stats(
    model,
    mesh=None,
    data_axis: str = DATA_AXIS,
    sizes: PointCloudSizes = PointCloudSizes(),
    max_steps: int = 150,
    device=None,
    apply_fn=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Rollout statistics averaged over the ranks: success rate, mean steps
    to success and mean final position error, each a scalar on every rank
    (the reference's validation aggregation, ``model.py:320-352``).
    Arguments of the returned function as :func:`make_sharded_rollout`'s."""
    rollout = make_sharded_rollout(
        model, mesh, data_axis, device, max_steps=max_steps, sizes=sizes,
        stop_on_success=True, record_trajectory=False, apply_fn=apply_fn)
    group, _, count = axis_group(mesh, data_axis)

    def stats(problems: Problem, generator_or_seed=0, init_cloud=None, robot_indices=None):
        result = rollout(problems, generator_or_seed, init_cloud, robot_indices)
        target = shard_leading_axis(problems.target_trans, mesh, data_axis)
        _, trans = kinematics.eff_pose(result.final_q)
        pos_err = torch.linalg.norm(trans - target.to(trans.device), dim=-1)
        vals = torch.stack([result.success.float().mean(), result.num_steps.float().mean(),
                            pos_err.mean()])
        if group is not None:
            dist.all_reduce(vals, group=group)
            vals = vals / count
        return dict(zip(STAT_KEYS, vals))

    return stats
