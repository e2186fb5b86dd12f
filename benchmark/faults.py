"""Faults planted under a run, to show that ``correct`` catches them: each
breaks the timed path underneath the harness (the system's modules are
patched in this process only, and restored on exit).

* ``frozen_state``: each rollout step returns its state unchanged (the
  engine is handed a zero Delta-q; the policy's own output is what was
  recorded);
* ``half_batch``: the policy computes half of the batch and gives the other
  half the mean of its Delta-q;
* ``altered_answer``: one Delta-q entry is changed where it is produced;
* ``stale_resample``: the robot segment of the cloud is never resampled.

A train step's faults: ``frozen_state`` (the optimizer's step leaves the
parameters as they were), ``half_batch`` (the step, forward and loss, takes
half of the batch), ``half_loss`` (the forward takes the whole batch, the
loss's mean only half of its rows), ``altered_answer`` (one Delta-q entry of
the train forward is changed where it is produced) and ``altered_cloud``
(the batch's robot points are built 1 mm off).
"""

from __future__ import annotations

import contextlib

FAULTS = {"rollout": ("frozen_state", "half_batch", "altered_answer", "stale_resample"),
          "train": ("frozen_state", "half_batch", "half_loss", "altered_answer",
                    "altered_cloud")}


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def plant(fault, driver=None, kind="rollout"):
    """A context manager that plants ``fault`` under a ``kind`` driver; the
    rollout's ``frozen_state`` needs the rollout ``Driver``, whose engine-facing
    Delta-q it zeroes."""
    import torch

    if kind == "train":
        return _plant_train(fault)
    from mpinets_torch.model import fused
    from mpinets_torch.rollout import engine

    if fault == "frozen_state":
        @contextlib.contextmanager
        def frozen():
            driver.to_engine = torch.zeros_like
            try:
                yield
            finally:
                driver.to_engine = None
        return frozen()
    if fault == "half_batch":
        def make(orig):
            def half(model, cloud, q_norm, **kw):
                h = cloud.shape[0] // 2
                out = orig(model, cloud[:h].contiguous(), q_norm[:h], **kw)
                return torch.cat([out, out.mean(0, keepdim=True).expand(cloud.shape[0] - h, -1)])
            return half
        return _patched(fused, "fused_policy_apply", make)
    if fault == "altered_answer":
        def make(orig):
            def altered(*args, **kw):
                out = orig(*args, **kw).clone()
                out[0, 0] += 0.05
                return out
            return altered
        return _patched(fused, "fused_policy_apply", make)
    if fault == "stale_resample":
        return _patched(engine, "update_robot_points", lambda orig: (lambda xyz, robot: xyz))
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")


def _plant_train(fault):
    import torch

    from mpinets_torch.data import synthetic
    from mpinets_torch.geom.scene import SceneSet
    from mpinets_torch.model import fused_train
    from mpinets_torch.train import learner, loss

    if fault == "frozen_state":
        return _patched(learner.ClippedAdam, "step", lambda orig: (lambda self, closure=None: None))
    if fault == "half_batch":
        def make(orig):
            def half(model, batch, *args, **kw):
                h = batch["xyz"].shape[0] // 2
                return orig(model, {k: v[:h] for k, v in batch.items()}, *args, **kw)
            return half
        return _patched(learner, "loss_fn", make)
    if fault == "half_loss":
        def make(orig):
            def half(y_hat, supervision, scene):
                h = y_hat.shape[0] // 2
                return orig(y_hat[:h], supervision[:h], SceneSet(*(f[:h] for f in scene)))
            return half
        return _patched(loss, "bc_losses", make)
    if fault == "altered_answer":
        def make(orig):
            def altered(*args, **kw):
                out = orig(*args, **kw)
                bump = torch.zeros_like(out)
                bump[0, 0] = 0.05
                return out + bump
            return altered
        return _patched(fused_train, "fused_policy_apply_train", make)
    if fault == "altered_cloud":
        def make(orig):
            def altered(q, rot, trans, scene, sizes, *args, **kw):
                xyz = orig(q, rot, trans, scene, sizes, *args, **kw).clone()
                xyz[..., : sizes.robot, 0] += 1e-3
                return xyz
            return altered
        return _patched(synthetic, "assemble_point_cloud", make)
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
