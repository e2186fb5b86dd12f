"""The behavior-cloning learner: optimizer, loss and train step.

Port of ``mpinets_tpu/train/learner.py`` (reference
``mpinets/run_training.py:71-115``, ``mpinets/model.py:185-240``). The JAX
package's optax chain becomes one torch optimizer, :class:`ClippedAdam`,
that repeats it: global-norm clip, then Adam, with the learning rate of
``optax.warmup_cosine_decay_schedule`` evaluated at the step count before
the update. The parameters live in the model and are updated in place.
``make_data_parallel_step`` and ``shard_batch`` wait for the multi-GPU
slice (``ROADMAP.md`` A13).

Reference hyperparameters: Adam lr 1e-4 (``model.py:72``), grad clip 1.0
(``run_training.py:110``), loss weights point-match 1 : collision 5
(``jobconfig.yaml:23-25``).
"""

from __future__ import annotations

import copy
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mpinets_torch.geom.scene import SceneSet
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
