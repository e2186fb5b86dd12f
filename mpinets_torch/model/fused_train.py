"""Differentiable kernel-backed policy forward for training.

Port of ``mpinets_tpu/model/fused_train.py``. FPS and the ball query are
piecewise constant in the parameters and the point features, so the
gradient flows only through the gather -> shared MLP -> max-pool chain:

* forward: the fused SA kernel (:func:`mpinets_torch.kernels.ops.sa_stage`),
  which also returns the selected indices and, for ``sa_impl="v8"``, the
  gathered raw block [B, S, 128, 3 + C];
* backward, in a ``torch.autograd.Function``: for v8 under bf16, the
  kernels of :func:`mpinets_torch.kernels.ops.sa_stage_backward`, which run
  the stage's backward over the valid rows of the saved raw block in the
  forward kernel's arithmetic (their plain version on CPU tensors). The
  other stages replay in plain torch: v8 under f32 repeats the dense MLP
  over all 128 slots of the raw block, recentred first
  (``fused_train.py:81-97,128-164``), with the valid mask rebuilt from the
  fill convention; v3/v5 gather again by the saved indices
  (``fused_train.py:99-114,167-184``). The JAX package's VJP is plain XLA:
  the backward kernel replaces none of its kernels.

FPS centroids are detached: they depend on the input cloud only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpinets_torch.kernels import ops
from mpinets_torch.model.fused import stage_sizes, tail


class _Stage(NamedTuple):
    radius: float
    nsample: int
    compute_dtype: torch.dtype
    sa_impl: str
    features_grad: bool


def _mlp_max(raw, centroids, valid, w1, b1, w2, b2, w3, b3, cdt):
    """Dense MLP + masked max over slots, the train backward's replay of the
    stage (``fused_train.py:81-97``). raw [B, S, ns, 3 + C] (not recentred;
    invalid slots are zero rows, masked out); activations stored in ``cdt``
    as the kernel stores them."""
    h = torch.cat([raw[..., :3] - centroids[:, :, None, :], raw[..., 3:]], dim=-1).to(cdt)
    for w, b in ((w1, b1), (w2, b2)):
        h = torch.relu((h @ w.to(cdt)).float() + b).to(cdt)
    h = torch.relu((h @ w3.to(cdt)).float() + b3)
    h = torch.where(valid[..., None], h, torch.full_like(h, -torch.inf))
    return h.amax(dim=2)                                  # [B, S, C3]


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
    """One SA stage: the kernel forward; the backward kernels for v8 under
    bf16, else the plain-torch replay.

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
        if raw is not None and cdt == torch.bfloat16:
            n_points = features.shape[1] if stage.features_grad else None
            gf, *grads = ops.sa_stage_backward(raw, idx, centroids, ctx.weights,
                                               g.contiguous(), n_points)
            return (None, None, gf, None, *grads)
        mlp = [t.detach().requires_grad_() for t in mlp]
        gf = None
        with torch.enable_grad():
            if raw is not None:
                # fills repeat slot 0; every centroid is a cloud member, so
                # slot 0 is always a real neighbour (fused_train.py:131-138)
                valid = ops.valid_slots(idx)
                raw_ = raw.detach().requires_grad_(stage.features_grad)
                out = _mlp_max(raw_, centroids, valid, *mlp, cdt)
                inputs = ([raw_] if stage.features_grad else []) + mlp
                grads = list(torch.autograd.grad(out, inputs, g))
                if stage.features_grad:
                    # the raw block's cotangent, rounded to cdt per addend,
                    # summed into its points in f32 (fused_train.py:146-164)
                    draw = grads.pop(0)
                    b, n, c = features.shape
                    delta = (draw[..., 3:] * valid[..., None]).to(cdt).float().reshape(-1, c)
                    rows = (idx.long() + n * torch.arange(b, device=idx.device)[:, None, None])
                    gf = torch.zeros((b * n, c), dtype=torch.float32, device=features.device)
                    gf.index_add_(0, rows.reshape(-1), delta)
                    gf = gf.reshape(b, n, c)
            else:
                feats = features.detach().requires_grad_(stage.features_grad)
                out = _recompute(feats, *mlp, xyz, centroids, idx, cdt)
                inputs = ([feats] if stage.features_grad else []) + mlp
                grads = list(torch.autograd.grad(out, inputs, g))
                if stage.features_grad:
                    gf = grads.pop(0)
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


def _mlp_tensors(sa_module):
    """The stage's MLP as Dense [in, out] views of the module's parameters."""
    convs = (getattr(sa_module.mlp, f"conv{i}") for i in range(3))
    return [t for conv in convs for t in (conv.weight.t(), conv.bias)]


def fused_policy_apply_train(
    model,
    point_cloud: torch.Tensor,  # [B, N, 4]
    q_norm: torch.Tensor,       # [B, 7]
    compute_dtype=torch.bfloat16,
    sa_npoints: tuple = (512, 128),
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

    _, cent0 = ops.furthest_point_sample_with_coords(xyz.detach(), sa_npoints[0])
    f0 = sa0(xyz, feat, cent0, *_mlp_tensors(enc.sa0))
    _, cent1 = ops.furthest_point_sample_with_coords(cent0, sa_npoints[1])
    f1 = sa1(cent0, f0, cent1, *_mlp_tensors(enc.sa1))
    return tail(model, cent1, f1, q_norm, cdt)


def make_fused_train_apply(compute_dtype=torch.bfloat16, sa_npoints: tuple = (512, 128),
                           sa_impl: str = "v8"):
    """(model, point_cloud, q_norm) -> dq with exact parameter gradients,
    the ``apply_fn`` of :func:`mpinets_torch.train.learner.loss_fn`."""

    def apply(model, point_cloud, q_norm):
        return fused_policy_apply_train(model, point_cloud, q_norm, compute_dtype=compute_dtype,
                                        sa_npoints=sa_npoints, sa_impl=sa_impl)

    return apply
