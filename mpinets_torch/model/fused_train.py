"""Differentiable kernel-backed policy forward for training.

Port of ``mpinets_tpu/model/fused_train.py``. FPS and the ball query are
piecewise constant in the parameters and the point features, so the
gradient flows only through the gather -> shared MLP -> max-pool chain:

* forward: the fused SA kernel (:func:`mpinets_torch.kernels.ops.sa_stage`),
  which also returns the selected indices and, for ``sa_impl="v8"``, the
  gathered raw block [B, S, 128, 3 + C];
* backward, in a ``torch.autograd.Function``: for v8, the stage's backward
  over the valid rows of the saved raw block in the forward kernel's
  arithmetic: under bf16 the kernels of
  :func:`mpinets_torch.kernels.ops.sa_stage_backward` (their plain version
  on CPU tensors), under f32 that plain version,
  :func:`~mpinets_torch.kernels.ops.sa_stage_backward_plain`, on either
  device. v3/v5, whose count==0 rule is another function, replay the stage
  in plain torch, gathered again by the saved indices
  (``fused_train.py:99-114,167-184``). The JAX package's VJP is plain XLA:
  the backward kernel replaces none of its kernels.

FPS centroids are detached: they depend on the input cloud only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpinets_torch.kernels import ops
from mpinets_torch.model.fused import mlp_tensors, stage_sizes, tail


class _Stage(NamedTuple):
    radius: float
    nsample: int
    compute_dtype: torch.dtype
    sa_impl: str
    features_grad: bool


def _recompute(features, w1, b1, w2, b2, w3, b3, xyz, centroids, idx, cdt):
    """Stage value from the saved indices, fills included (duplicates never
    change a max): the v3/v5 backward's replay (``fused_train.py:99-114``)."""
    b = xyz.shape[0]
    flat = idx.long().reshape(b, -1, 1)                   # [B, S*ns, 1]
    gx = torch.take_along_dim(xyz, flat, dim=1).reshape(idx.shape + (3,))
    gx = gx - centroids[:, :, None, :]
    gf = torch.take_along_dim(features, flat, dim=1).reshape(idx.shape + (features.shape[-1],))
    h = torch.cat([gx, gf], dim=-1)                       # [B, S, ns, 3 + C]
    for w, bias in ((w1, b1), (w2, b2), (w3, b3)):
        h = torch.relu((h.to(cdt) @ w.to(cdt)).float() + bias)
    return h.amax(dim=2)


class SAStageTrain(torch.autograd.Function):
    """One SA stage: the kernel forward; for v8 the backward over the saved
    raw block (the kernels under bf16, their plain version under f32), for
    v3/v5 the plain-torch replay (:func:`_recompute`).

    Inputs: ``stage`` (a :class:`_Stage`), xyz [B, N, 3], features [B, N, C],
    centroids [B, S, 3] and the six f32 MLP tensors (Dense ``[in, out]``).
    Gradients: features (when ``stage.features_grad``) and the MLP; none for
    xyz and centroids.
    """

    @staticmethod
    def forward(ctx, stage: _Stage, xyz, features, centroids, w1, b1, w2, b2, w3, b3):
        weights = ops.prepare_sa_weights(w1, b1, w2, b2, w3, b3, stage.compute_dtype)
        use_raw = stage.sa_impl == "v8"
        out = ops.sa_stage(xyz, features, centroids, weights, stage.radius, stage.nsample,
                           impl=stage.sa_impl, centroids_in_cloud=True, return_raw=use_raw)
        raw = out[2] if use_raw else None
        ctx.stage = stage
        ctx.weights = weights
        ctx.save_for_backward(xyz, features, centroids, w1, b1, w2, b2, w3, b3, out[1], raw)
        return out[0]

    @staticmethod
    def backward(ctx, g):
        stage = ctx.stage
        cdt = stage.compute_dtype
        xyz, features, centroids, *mlp, idx, raw = ctx.saved_tensors
        if raw is not None:
            n_points = features.shape[1] if stage.features_grad else None
            backward = (ops.sa_stage_backward if cdt == torch.bfloat16
                        else ops.sa_stage_backward_plain)
            gf, *grads = backward(raw, idx, centroids, ctx.weights, g.contiguous(), n_points)
            return (None, None, gf, None, *grads)
        mlp = [t.detach().requires_grad_() for t in mlp]
        feats = features.detach().requires_grad_(stage.features_grad)
        with torch.enable_grad():
            out = _recompute(feats, *mlp, xyz, centroids, idx, cdt)
        inputs = ([feats] if stage.features_grad else []) + mlp
        grads = list(torch.autograd.grad(out, inputs, g))
        gf = grads.pop(0) if stage.features_grad else None
        return (None, None, gf, None, *grads)


def make_sa_stage_train(radius: float, nsample: int = 128, compute_dtype=torch.bfloat16,
                        sa_impl: str = "v8", features_grad: bool = True):
    """-> ``sa(xyz, features, centroids, w1, b1, w2, b2, w3, b3)``, the
    differentiable stage (:class:`SAStageTrain`). ``features_grad=False``
    skips the feature cotangent: right where the features are data, as at
    SA0 (the segmentation labels)."""
    stage = _Stage(radius, nsample, compute_dtype, sa_impl, features_grad)

    def sa(xyz, features, centroids, w1, b1, w2, b2, w3, b3):
        return SAStageTrain.apply(stage, xyz, features, centroids, w1, b1, w2, b2, w3, b3)

    return sa


def fused_policy_apply_train(
    model,
    point_cloud: torch.Tensor,  # [B, N, 4]
    q_norm: torch.Tensor,       # [B, 7]
    compute_dtype=torch.bfloat16,
    sa_impl: str = "v8",
) -> torch.Tensor:
    """Differentiable twin of :func:`mpinets_torch.model.fused.fused_policy_apply`:
    the same value through the kernels, exact parameter gradients through
    the saved indices (``mpinets_tpu/model/fused_train.py:201-247``)."""
    cdt = compute_dtype
    enc = model.point_cloud_encoder
    xyz = point_cloud[..., :3].contiguous()
    feat = point_cloud[..., 3:].contiguous()
    size0, size1 = stage_sizes(model)
    # SA0's features are the segmentation labels (data): no cotangent
    sa0 = make_sa_stage_train(size0["radius"], size0["nsample"], cdt, sa_impl,
                              features_grad=False)
    sa1 = make_sa_stage_train(size1["radius"], size1["nsample"], cdt, sa_impl)

    _, cent0 = ops.furthest_point_sample_with_coords(xyz.detach(), size0["npoint"])
    f0 = sa0(xyz, feat, cent0, *mlp_tensors(enc.sa0))
    _, cent1 = ops.furthest_point_sample_with_coords(cent0, size1["npoint"])
    f1 = sa1(cent0, f0, cent1, *mlp_tensors(enc.sa1))
    return tail(model, cent1, f1, q_norm, cdt)


def make_fused_train_apply(compute_dtype=torch.bfloat16, sa_impl: str = "v8"):
    """(model, point_cloud, q_norm) -> dq with exact parameter gradients,
    the ``apply_fn`` of :func:`mpinets_torch.train.learner.loss_fn`."""

    def apply(model, point_cloud, q_norm):
        return fused_policy_apply_train(model, point_cloud, q_norm, compute_dtype=compute_dtype,
                                        sa_impl=sa_impl)

    return apply
