"""The behavior-cloning learner: optimizer, loss, train step and the
data-parallel (DP) step.

Port of ``mpinets_tpu/train/learner.py`` (reference
``mpinets/run_training.py:71-115``, ``mpinets/model.py:185-240``). The JAX
package's optax chain becomes one torch optimizer, :class:`ClippedAdam`,
that repeats it: global-norm clip, then Adam, with the learning rate of
``optax.warmup_cosine_decay_schedule`` evaluated at the step count before
the update. The parameters live in the model and are updated in place.
The DP step (:func:`make_data_parallel_step`) replaces Lightning's DDP: each
rank computes the gradient of its block of the batch, one flat f32
all-reduce a step averages the gradients (and the metrics) over the mesh's
data axis, and only then does the optimizer clip and step, as the JAX
package's ``pmean`` precedes ``optimizer.update``.

Reference hyperparameters: Adam lr 1e-4 (``model.py:72``), grad clip 1.0
(``run_training.py:110``), loss weights point-match 1 : collision 5
(``jobconfig.yaml:23-25``).
"""

from __future__ import annotations

import copy
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from mpinets_torch.geom.scene import SceneSet
from mpinets_torch.parallel.mesh import DATA_AXIS, axis_group, rank_generator, shard_leading_axis
from mpinets_torch.train import loss as losses

LEARNING_RATE = 1e-4
GRAD_CLIP = 1.0
POINT_MATCH_WEIGHT = 1.0
COLLISION_WEIGHT = 5.0


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax computes it (in double it
    differs by up to 1e-5 relative at decay 0.999)."""
    f32 = torch.float32
    return float(1 - torch.tensor(decay, dtype=f32) ** torch.tensor(float(count), dtype=f32))


class ClippedAdam(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))`` as a torch
    optimizer (``learner.py:45-69``).

    * The clip scales every gradient by optax's ``min(1, grad_clip / norm)``
      over the global norm of all of them, before Adam.
    * Adam: b1 0.9, b2 0.999, eps 1e-8 added after the square root, bias
      correction of both moments at count + 1.
    * With ``decay_steps`` > 0 the learning rate follows
      ``warmup_cosine_decay_schedule`` (start 0.05 lr when warmup > 0, peak
      lr, end ``end_value_scale`` lr); else it is the constant lr. Step k
      uses the schedule's value at k (optax's count before the update).
    """

    def __init__(self, params, learning_rate: float = LEARNING_RATE,
                 grad_clip: float = GRAD_CLIP, warmup_steps: int = 0, decay_steps: int = 0,
                 end_value_scale: float = 0.1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if decay_steps and decay_steps - warmup_steps <= 0:
            raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps "
                             f"({warmup_steps}), as optax's cosine decay requires")
        super().__init__(params, dict(lr=learning_rate, grad_clip=grad_clip,
                                      warmup_steps=warmup_steps, decay_steps=decay_steps,
                                      end_value_scale=end_value_scale, b1=b1, b2=b2, eps=eps,
                                      count=0))

    @staticmethod
    def learning_rate(group, count: int) -> float:
        """The schedule's value at ``count`` for a parameter group."""
        lr, warmup, decay = group["lr"], group["warmup_steps"], group["decay_steps"]
        if not decay:
            return lr
        if count < warmup:
            init = 0.05 * lr
            return (init - lr) * (1.0 - count / warmup) + lr
        alpha = group["end_value_scale"]
        t = min(count - warmup, decay - warmup)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay - warmup)))
        return lr * ((1.0 - alpha) * cosine + alpha)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedAdam takes no closure")
        groups = [(g, [p for p in g["params"] if p.grad is not None]) for g in self.param_groups]
        grads = [p.grad for _, ps in groups for p in ps]
        if not grads:
            return None
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        for group, params in groups:
            if not params:
                continue
            g = [p.grad for p in params]
            clip = group["grad_clip"]
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            g = torch._foreach_mul(g, scale)
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            lr = self.learning_rate(group, group["count"])
            count = group["count"] + 1
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, _bias_correction(b2, count)))
            torch._foreach_add_(denom, eps)
            torch._foreach_add_(params, torch._foreach_div(mu_hat, denom), alpha=-lr)
            group["count"] = count
        return None


def make_optimizer(params, learning_rate: float = LEARNING_RATE, grad_clip: float = GRAD_CLIP,
                   warmup_steps: int = 0, decay_steps: int = 0,
                   end_value_scale: float = 0.1) -> ClippedAdam:
    """Adam + global-norm clip over ``params``; with ``decay_steps`` > 0 a
    linear-warmup + cosine-decay schedule replaces the constant lr."""
    return ClippedAdam(params, learning_rate, grad_clip, warmup_steps, decay_steps,
                       end_value_scale)


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: ClippedAdam
    step: int
    #: moving average of the parameters, for validation and checkpoints
    #: (None = off)
    ema: Optional[torch.nn.Module] = None


def init_state(model: torch.nn.Module, optimizer: Optional[ClippedAdam] = None,
               ema: bool = False) -> TrainState:
    """Step 0 of training ``model`` (its parameters as they are)."""
    optimizer = optimizer or make_optimizer(model.parameters())
    average = copy.deepcopy(model).requires_grad_(False) if ema else None
    return TrainState(model, optimizer, 0, average)


@torch.no_grad()
def _update_ema(ema: Optional[torch.nn.Module], model: torch.nn.Module,
                ema_decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, in place."""
    if not ema_decay or ema is None:
        return
    avg = list(ema.parameters())
    torch._foreach_mul_(avg, ema_decay)
    torch._foreach_add_(avg, list(model.parameters()), alpha=1.0 - ema_decay)


def scene_from_batch(batch: Dict[str, torch.Tensor]) -> SceneSet:
    return SceneSet(*(batch[f] for f in SceneSet._fields))


def loss_fn(
    model: torch.nn.Module,
    batch: Dict[str, torch.Tensor],
    point_match_weight: float = POINT_MATCH_WEIGHT,
    collision_weight: float = COLLISION_WEIGHT,
    apply_fn=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + weighted loss (``model.py:185-240`` training_step).

    ``apply_fn(model, xyz, q_norm)`` replaces ``model(xyz, q_norm)``: pass
    :func:`mpinets_torch.model.fused_train.make_fused_train_apply` to run the
    kernels inside the train step."""
    q = batch["configuration"]
    delta = model(batch["xyz"], q) if apply_fn is None else apply_fn(model, batch["xyz"], q)
    y_hat = torch.clamp(q + delta, -1.0, 1.0)  # model.py:202
    collision, point_match, hinge_active = losses.bc_losses(
        y_hat, batch["supervision"], scene_from_batch(batch))
    total = point_match_weight * point_match + collision_weight * collision
    return total, {
        "point_match_loss": point_match,
        "collision_loss": collision,
        "hinge_active_frac": hinge_active,
        "val_loss": total,  # the reference's (misnamed) training loss log key
    }


def make_train_step(
    point_match_weight: float = POINT_MATCH_WEIGHT,
    collision_weight: float = COLLISION_WEIGHT,
    apply_fn=None,
    ema_decay: float = 0.0,
):
    """-> ``train_step(state, batch) -> (state, metrics)`` on one device:
    the loss's gradient, one optimizer update of ``state.model`` in place,
    the EMA, and the step count. Metrics stay on the device, detached."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.model, batch, point_match_weight, collision_weight,
                                 apply_fn)
        total.backward()
        state.optimizer.step()
        _update_ema(state.ema, state.model, ema_decay)
        return state._replace(step=state.step + 1), {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_data_parallel_step(
    mesh=None,
    data_axis: str = DATA_AXIS,
    point_match_weight: float = POINT_MATCH_WEIGHT,
    collision_weight: float = COLLISION_WEIGHT,
    prepare_fn=None,
    apply_fn=None,
    ema_decay: float = 0.0,
):
    """-> the DP step over ``mesh``'s ``data_axis``: ``step(state, batch)``
    on this rank's block of the global batch, parameters replicated. In the
    order of the JAX package's ``_core``: the local loss and its gradient;
    the mean of the gradients and metrics over the ranks (one all-reduce of
    a flat f32 buffer); the optimizer (global-norm clip, then Adam); the
    EMA. Without a mesh no collective is made, and the step is
    :func:`make_train_step`'s.

    ``prepare_fn(raw, generator=None, draws=None) -> batch`` (e.g.
    :func:`mpinets_torch.data.hdf5.prepare_train_batch`) builds the batch
    on the device inside the step, which then takes
    ``step(state, raw, generator_or_draws)``: an integer seed is folded
    with the rank (``fold_in(key, axis_index)``), a generator is used as it
    is, anything else is handed to ``prepare_fn`` as its draws.
    ``apply_fn`` overrides the forward (e.g. the kernel-backed
    :func:`mpinets_torch.model.fused_train.make_fused_train_apply`).
    """
    group, index, count = axis_group(mesh, data_axis)

    def core(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.model, batch, point_match_weight, collision_weight,
                                 apply_fn)
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            params = [p for p in state.model.parameters() if p.grad is not None]
            flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                             + [torch.stack([v.float() for v in metrics.values()])])
            dist.all_reduce(flat, group=group)
            flat = flat / count
            grads = flat.split([p.numel() for p in params] + [len(metrics)])
            torch._foreach_copy_([p.grad for p in params],
                                 [g.view_as(p) for p, g in zip(params, grads)])
            metrics = dict(zip(metrics, grads[-1].unbind()))
        state.optimizer.step()
        _update_ema(state.ema, state.model, ema_decay)
        return state._replace(step=state.step + 1), metrics

    if prepare_fn is None:
        return core

    def step(state: TrainState, raw: Dict[str, torch.Tensor], generator_or_draws):
        if isinstance(generator_or_draws, (int, torch.Generator)):
            device = next(iter(raw.values())).device
            batch = prepare_fn(raw, rank_generator(generator_or_draws, index, device))
        else:
            batch = prepare_fn(raw, draws=generator_or_draws)
        return core(state, batch)

    return step


def shard_batch(batch: Dict[str, torch.Tensor], mesh=None, data_axis: str = DATA_AXIS
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of every array of a global batch, as tensors."""
    block = shard_leading_axis(dict(batch), mesh, data_axis)
    return {k: torch.as_tensor(v) for k, v in block.items()}


@torch.no_grad()
def broadcast_state(state: TrainState, mesh=None, data_axis: str = DATA_AXIS) -> None:
    """Rank 0's parameters (and EMA) to every rank of ``data_axis``, in
    place; once after init or restore. No-op without a mesh."""
    group, _, _ = axis_group(mesh, data_axis)
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for module in (state.model, state.ema):
        if module is not None:
            for t in module.state_dict().values():
                dist.broadcast(t, src=src, group=group)
