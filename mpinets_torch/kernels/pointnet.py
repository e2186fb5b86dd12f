"""Plain PyTorch PointNet++ set-abstraction primitives: furthest-point
sampling, ball query and grouping.

Port of ``mpinets_tpu/kernels/pointnet.py``, with the same semantics as the
reference's CUDA ``pointnet2_ops`` kernels (``mpinets/model.py:27,364-383``):

* FPS starts from index 0 and repeatedly takes the point with the largest
  min-distance to the selected set, the lowest index winning ties.
* Ball query returns, per centroid, the first ``nsample`` point indices in
  index order within ``radius``; missing slots repeat the first found index,
  and a centroid with no neighbour gets index 0 everywhere.
* Grouping is a gather + recentre.

This is the plain path of :class:`mpinets_torch.model.policy.MotionPolicyNetwork`
and the oracle the hand kernels are tested against.
"""

from __future__ import annotations

import torch


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance, summed left to right: (dx*dx + dy*dy) + dz*dz."""
    d = a - b
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy furthest-point sampling. xyz: [B, N, 3] -> int32 [B, npoint]."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    out = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    min_d2 = torch.full((b, n), float("inf"), device=xyz.device)
    last = torch.zeros((b,), dtype=torch.long, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    for i in range(1, npoint):
        d2 = sq_dist(xyz, xyz[rows, last][:, None, :])
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=-1)  # first maximal index
        out[:, i] = last.to(torch.int32)
    return out


def ball_query(
    centroids: torch.Tensor, xyz: torch.Tensor, radius: float, nsample: int
) -> torch.Tensor:
    """First-``nsample`` neighbours within ``radius`` of each centroid.

    centroids: [B, S, 3]; xyz: [B, N, 3] -> int32 [B, S, nsample] with the
    CUDA kernel's fill-with-first semantics.
    """
    n = xyz.shape[1]
    d2 = sq_dist(centroids[:, :, None, :], xyz[:, None, :, :])
    in_ball = d2 < radius * radius
    idx = torch.arange(n, device=xyz.device).expand_as(in_ball)
    key = torch.where(in_ball, idx, torch.full_like(idx, n))
    k = min(nsample, n)
    first_k = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        pad = torch.full(first_k.shape[:-1] + (nsample - k,), n,
                         dtype=first_k.dtype, device=first_k.device)
        first_k = torch.cat([first_k, pad], dim=-1)
    found = first_k < n
    first = first_k[..., :1]
    fill = torch.where(first < n, first, torch.zeros_like(first))
    return torch.where(found, first_k, fill).to(torch.int32)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: [B, N, C], idx: [B, ...] int -> [B, ..., C]."""
    b = points.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.take_along_dim(points, flat[..., None], dim=1)
    return out.reshape(tuple(idx.shape) + (points.shape[-1],))


def query_and_group(
    centroids: torch.Tensor,
    xyz: torch.Tensor,
    features: torch.Tensor,
    radius: float,
    nsample: int,
) -> torch.Tensor:
    """Ball query + grouping, recentred xyz concatenated with features
    (``use_xyz=True``). -> [B, S, nsample, 3 + C]"""
    idx = ball_query(centroids, xyz, radius, nsample)
    grouped_xyz = gather_points(xyz, idx) - centroids[:, :, None, :]
    grouped_feat = gather_points(features, idx)
    return torch.cat([grouped_xyz, grouped_feat], dim=-1)


def group_all(xyz: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """The global grouping: every point in one group, xyz NOT recentred.
    -> [B, 1, N, 3 + C]"""
    return torch.cat([xyz, features], dim=-1)[:, None, :, :]
