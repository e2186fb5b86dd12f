"""The plain reference of the Motion Policy Network's forward pass.

MPiNets (Fishman et al., CoRL 2022; NVlabs/motion-policy-networks
``mpinets/model.py:35-91,355-426``): a PointNet++ encoder of the
[B, N, 4] cloud (xyz and a segmentation label) -- two set-abstraction
stages (furthest-point sampling from index 0, the first ``nsample`` points
in index order inside the radius, the first one repeated to fill, a shared
ReLU MLP on the recentred xyz and the features, a max over the group), a
group-all stage on the un-recentred xyz, an FC head with GroupNorm and
LeakyReLU -- a configuration encoder and a decoder to a Delta-q.

Written from the paper and the published code, in plain PyTorch, float32
with TF32 off, in blocks of batch rows so that it fits beside what a run
keeps. ``precision`` computes every product in a lower type instead, for
the control: ``"tf32"`` (factors rounded to TF32's 10-bit mantissa) or
``"fp8"`` (factors scaled per tensor and rounded to float8 e4m3), sums in
float32, the backward's products rounded alike.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

NSAMPLE = 128


def _tf32(t):
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"tf32": _tf32, "fp8": _fp8}


class _RoundedProduct(torch.autograd.Function):
    """x @ w^T with both factors rounded by ``rnd``, and in the backward the
    incoming gradient too, as products in that type compute it; the sums
    in float32."""

    @staticmethod
    def forward(ctx, x, w, rnd):
        xr, wr = rnd(x), rnd(w)
        ctx.save_for_backward(xr, wr)
        ctx.rnd = rnd
        return xr @ wr.t()

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.rnd(g.contiguous())
        gw = gr.reshape(-1, gr.shape[-1]).t() @ xr.reshape(-1, xr.shape[-1])
        return gr @ wr, gw, None


def dense(x, w, b, precision="f32"):
    """x [..., in] @ w[out, in]^T + b; the product in ``precision``."""
    if precision == "f32":
        return x.float() @ w.float().t() + b.float()
    return _RoundedProduct.apply(x.float(), w.float(), ROUND[precision]) + b.float()


def sq_dist(a, b):
    """(dx*dx + dy*dy) + dz*dz in float32, each operation rounded (no FMA)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def fps(xyz, npoint):
    """Furthest-point sampling from index 0, the lowest index winning ties.
    xyz [B, N, 3] f32 -> int64 [B, npoint]."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    picks = torch.zeros((b, npoint), dtype=torch.long, device=xyz.device)
    mind = torch.full((b, n), float("inf"), device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        mind = torch.minimum(mind, sq_dist(xyz, xyz[rows, last][:, None, :]))
        last = torch.argmax(mind, dim=1)
        picks[:, i] = last
    return picks


def ball_query(xyz, centroids, radius, nsample=NSAMPLE):
    """Per centroid the first ``nsample`` points by index with d^2 < r^2 (f32),
    the first repeated into the empty slots, point 0 where none.
    -> (idx int64 [B, S, nsample], count int64 [B, S] of points inside the
    ball, tests int64 [B, S]: the distance tests a scan that stops at the
    ``nsample``-th hit makes)."""
    n = xyz.shape[1]
    inside = sq_dist(centroids[:, :, None, :], xyz[:, None, :, :]) < radius * radius
    rank = inside.cumsum(-1) - 1
    slot = torch.where(inside & (rank < nsample), rank, torch.full_like(rank, nsample))
    b, s = inside.shape[:2]
    idx = torch.full((b, s, nsample + 1), -1, dtype=torch.long, device=xyz.device)
    points = torch.arange(n, device=xyz.device).expand(b, s, n)
    idx.scatter_(-1, slot, points)
    idx = idx[..., :nsample]
    count = inside.sum(-1)
    first = torch.where(count > 0, idx[..., 0], torch.zeros_like(idx[..., 0]))
    idx = torch.where(idx >= 0, idx, first[..., None])
    tests = torch.where(count >= nsample, idx[..., nsample - 1] + 1, torch.full_like(count, n))
    return idx, count, tests


def gather(points, idx):
    """points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    b = points.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.take_along_dim(points, flat[..., None], dim=1)
    return out.reshape(tuple(idx.shape) + (points.shape[-1],))


def shared_mlp(h, layers, precision):
    for w, b in layers:
        h = torch.relu(dense(h, w, b, precision))
    return h


def set_abstraction(xyz, features, centroids, idx, layers, precision):
    """Group, recentre, shared MLP, max over the group. -> [B, S, C_out]."""
    grouped = torch.cat([gather(xyz, idx) - centroids[:, :, None, :], gather(features, idx)], -1)
    return shared_mlp(grouped, layers, precision).amax(-2)


def _layers(w, prefix, count):
    return [(w[f"{prefix}{i}.weight"], w[f"{prefix}{i}.bias"]) for i in range(count)]


def _group_norm(x, weight, bias, groups, eps=1e-5):
    b, c = x.shape
    g = x.reshape(b, groups, c // groups)
    g = (g - g.mean(-1, keepdim=True)) / torch.sqrt(g.var(-1, unbiased=False, keepdim=True) + eps)
    return g.reshape(b, c) * weight + bias


def forward(w, cfg, cloud, q_norm, precision="f32", block=32):
    """The policy on a [B, N, 4] cloud and [B, 7] normalized configurations,
    with weights ``w`` (``state_dict`` names, nn.Linear [out, in] layout) and
    the widths of ``cfg`` (a configuration file's dict). -> a dict of every
    stage's result: ``fps0`` [B, S0] and ``fps1`` [B, S1] (picked indices),
    ``sel0``/``sel1`` (ball-query indices), ``count0``/``count1`` and
    ``tests0``/``tests1`` (per centroid), ``f0``, ``f1`` (stage features) and
    ``dq`` [B, 7]."""
    enc = "point_cloud_encoder."
    sa0, sa1 = cfg["sa0"], cfg["sa1"]
    slope = cfg["leaky_relu_slope"]
    out = {k: [] for k in ("fps0", "fps1", "sel0", "sel1", "count0", "count1", "tests0",
                           "tests1", "f0", "f1", "dq")}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xyz_all = cloud[..., :3].float().contiguous()
        p0_all = fps(xyz_all, sa0["npoint"])
        p1_all = fps(gather(xyz_all, p0_all), sa1["npoint"])
        for lo in range(0, cloud.shape[0], block):
            c = cloud[lo:lo + block].float()
            xyz, feat = c[..., :3].contiguous(), c[..., 3:]
            p0, p1 = p0_all[lo:lo + block], p1_all[lo:lo + block]
            cent0 = gather(xyz, p0)
            sel0, count0, tests0 = ball_query(xyz, cent0, sa0["radius"], sa0["nsample"])
            f0 = set_abstraction(xyz, feat, cent0, sel0,
                                 _layers(w, enc + "sa0.mlp.conv", len(sa0["mlp"])), precision)
            cent1 = gather(cent0, p1)
            sel1, count1, tests1 = ball_query(cent0, cent1, sa1["radius"], sa1["nsample"])
            f1 = set_abstraction(cent0, f0, cent1, sel1,
                                 _layers(w, enc + "sa1.mlp.conv", len(sa1["mlp"])), precision)
            g = shared_mlp(torch.cat([cent1, f1], -1),
                           _layers(w, enc + "sa2.mlp.conv", len(cfg["sa2"]["mlp"])), precision)
            x = g.amax(1)
            for i in range(len(cfg["fc"]) - 1):
                x = dense(x, w[f"{enc}fc{i}.weight"], w[f"{enc}fc{i}.bias"], precision)
                x = _group_norm(x, w[f"{enc}gn{i}.weight"], w[f"{enc}gn{i}.bias"],
                                cfg["group_norm_groups"])
                x = F.leaky_relu(x, slope)
            last = len(cfg["fc"]) - 1
            pc = dense(x, w[f"{enc}fc{last}.weight"], w[f"{enc}fc{last}.bias"], precision)
            x = q_norm[lo:lo + block].float()
            n_enc = len(cfg["q_encoder"])
            for i in range(n_enc):
                x = dense(x, w[f"feature_encoder_{i}.weight"], w[f"feature_encoder_{i}.bias"],
                          precision)
                x = F.leaky_relu(x, slope) if i < n_enc - 1 else x
            x = torch.cat([pc, x], -1)
            n_dec = len(cfg["decoder"])
            for i in range(n_dec):
                x = dense(x, w[f"decoder_{i}.weight"], w[f"decoder_{i}.bias"], precision)
                x = F.leaky_relu(x, slope) if i < n_dec - 1 else x
            for k, v in zip(out, (p0, p1, sel0, sel1, count0, count1, tests0, tests1, f0, f1, x)):
                out[k].append(v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {k: torch.cat(v) for k, v in out.items()}
