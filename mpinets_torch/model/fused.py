"""Kernel-backed policy forward: the GPU performance path.

Port of ``mpinets_tpu/model/fused.py``. It computes
:class:`mpinets_torch.model.policy.MotionPolicyNetwork`'s function from the
same module's weights:

* SA0 / SA1: the FPS kernel (with the picked coordinates) and the fused
  ball-query / group / MLP / max-pool kernel -- exact (``sa_impl`` "v8",
  or "v3"/"v5", which name the TPU's other layouts of the same stage), or
  the relaxed chunk-window kernel for SA0 when ``fast_grouping=W > 0``
  (:mod:`mpinets_torch.kernels.ops`);
* global SA (group-all), FC head with GroupNorm, q-encoder and decoder:
  plain dense products (:func:`tail`), as the JAX package leaves them to
  XLA.

On CPU tensors the kernel wrappers run their plain versions, so this path
runs (slowly) in the CPU tests.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from mpinets_torch.kernels import ops


def stage_sizes(model):
    """(SA0, SA1) radius and nsample of ``model``'s encoder, as the kernel
    paths take them: the model's own function, whatever its config. The
    kernels keep 128 neighbours, so :func:`ops.sa_stage` refuses another
    nsample rather than compute another function."""
    enc = model.point_cloud_encoder
    return tuple(dict(radius=sa.radius, nsample=sa.nsample) for sa in (enc.sa0, enc.sa1))


def _dense(lin, x, cdt):
    """``(x.cdt @ W.cdt).f32 + b``, the JAX fused path's dense form."""
    return (x.to(cdt) @ lin.weight.t().to(cdt)).float() + lin.bias


def _group_norm(gn, x, num_groups=16, eps=1e-5):
    b, c = x.shape
    g = x.reshape(b, num_groups, c // num_groups)
    mean = g.mean(dim=-1, keepdim=True)
    var = g.var(dim=-1, unbiased=False, keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(b, c) * gn.weight + gn.bias


def sa_weights(model, compute_dtype):
    """(SA0, SA1) MLPs as the SA kernels take them (:func:`ops.prepare_sa_weights`)."""
    enc = model.point_cloud_encoder
    out = []
    for sa in (enc.sa0, enc.sa1):
        convs = (getattr(sa.mlp, f"conv{i}") for i in range(3))
        dense = [t for conv in convs for t in (conv.weight.t(), conv.bias)]  # [in, out]
        out.append(ops.prepare_sa_weights(*dense, compute_dtype))
    return tuple(out)


def tail(model, cent1, f1, q_norm, cdt):
    """Global SA (group all, xyz NOT recentred) + FC head + q encoder +
    decoder: the dense back half of the policy.

    It repeats the layer order of ``MotionPolicyNetwork.forward`` because its
    Dense form differs: the product runs in ``cdt`` and the bias is added in
    f32 (:func:`_dense`, as ``xla_tail`` in the JAX package's fused path),
    where the plain policy adds the bias in ``cdt`` as flax's
    ``Dense(dtype=...)`` does. A change to the head's layers changes both.
    """
    enc = model.point_cloud_encoder
    g = torch.cat([cent1, f1], dim=-1)                   # [B, 128, 259]
    mlp = enc.sa2.mlp
    h = torch.relu(_dense(mlp.conv0, g, cdt))
    h = torch.relu(_dense(mlp.conv1, h, cdt))
    h = torch.relu(_dense(mlp.conv2, h, cdt))
    emb = h.amax(dim=1)                                  # [B, 1024]

    x = F.leaky_relu(_group_norm(enc.gn0, _dense(enc.fc0, emb, cdt)), 0.01)
    x = F.leaky_relu(_group_norm(enc.gn1, _dense(enc.fc1, x, cdt)), 0.01)
    pc_encoding = _dense(enc.fc2, x, cdt)                # [B, 2048]

    x = q_norm
    for i in range(4):
        x = F.leaky_relu(_dense(getattr(model, f"feature_encoder_{i}"), x, cdt), 0.01)
    feature_encoding = _dense(model.feature_encoder_4, x, cdt)

    x = torch.cat([pc_encoding, feature_encoding], dim=-1)
    for i in range(3):
        x = F.leaky_relu(_dense(getattr(model, f"decoder_{i}"), x, cdt), 0.01)
    return _dense(model.decoder_3, x, cdt).float()


@torch.no_grad()
def fused_policy_apply(
    model,
    point_cloud: torch.Tensor,  # [B, N, 4]
    q_norm: torch.Tensor,       # [B, 7]
    compute_dtype=torch.bfloat16,
    sa_npoints: tuple = (512, 128),
    fast_grouping: int = 0,
    sa_impl: str = "v8",
    bf16_cloud: bool = False,
    weights=None,
    fps_impl: str = "v1",
) -> torch.Tensor:
    """Delta-q prediction, numerically equivalent to ``model(xyz, q)``.

    ``fast_grouping=W`` (nonzero) switches SA0 to the relaxed chunk-window
    kernel: each centroid searches only its W nearest chunks of 128 points.
    ``weights`` is ``sa_weights(model, compute_dtype)``, made here when not
    given. ``sa_impl="v3"`` runs both exact stages with the count==0 rule of
    centroids off the cloud (point 0's row), "v5" and "v8" with that of
    cloud members, as ``mpinets_tpu/model/fused.py:119-139`` does; FPS
    centroids are cloud members, so all three give the same value.
    ``bf16_cloud`` rounds the coordinates to bf16 for FPS (which then picks
    and returns bf16 coordinates) and for the fast SA0's window choice, as
    ``mpinets_tpu/model/fused.py:100-103`` does; the SA stages and the tail
    read those rounded coordinates as f32, as the TPU kernels' f32 planes
    and centroid tables do (``pallas_ops.py:1263,1409,1444``). ``fps_impl``
    ("v1" or "v2") names the TPU FPS kernel both FPS calls stand for, as
    ``mpinets_tpu/model/fused.py:109,132`` pass it; both launch the same
    CUDA kernel and give the same picks.
    """
    cdt = compute_dtype
    w0, w1 = sa_weights(model, cdt) if weights is None else weights
    xyz = point_cloud[..., :3].contiguous()
    if bf16_cloud:
        xyz = xyz.to(torch.bfloat16)
    feat = point_cloud[..., 3:].contiguous()

    exact = dict(impl=sa_impl, centroids_in_cloud=sa_impl in ("v5", "v8"))
    sa0, sa1 = stage_sizes(model)

    _, cent0 = ops.furthest_point_sample_with_coords(xyz, sa_npoints[0], impl=fps_impl)
    if fast_grouping:
        f0, _ = ops.sa_stage_fast(xyz, feat, cent0, w0, **sa0, window=fast_grouping)
    else:
        f0, _ = ops.sa_stage(xyz.float(), feat, cent0.float(), w0, **sa0, **exact)

    _, cent1 = ops.furthest_point_sample_with_coords(cent0, sa_npoints[1], impl=fps_impl)
    f1, _ = ops.sa_stage(cent0.float(), f0, cent1.float(), w1, **sa1, **exact)
    return tail(model, cent1.float(), f1, q_norm, cdt)


def make_fused_apply(compute_dtype=torch.bfloat16, sa_npoints: tuple = (512, 128),
                     fast_grouping: int = 0, sa_impl: str = "v8",
                     bf16_cloud: bool = False, fps_impl: str = "v1"):
    """(model, xyz, q) -> dq with the knobs bound, for the rollout engine.
    The SA weights are made once per model (:func:`sa_weights`) and made
    again only when the model's SA parameters change."""
    made = {}

    def apply(model, point_cloud, q_norm):
        enc = model.point_cloud_encoder
        key = tuple((p.data_ptr(), p._version)
                    for sa in (enc.sa0, enc.sa1) for p in sa.parameters())
        if made.get("key") != key:
            made["key"], made["weights"] = key, sa_weights(model, compute_dtype)
        return fused_policy_apply(
            model, point_cloud, q_norm, compute_dtype=compute_dtype,
            sa_npoints=sa_npoints, fast_grouping=fast_grouping, sa_impl=sa_impl,
            bf16_cloud=bf16_cloud, weights=made["weights"], fps_impl=fps_impl,
        )

    return apply
