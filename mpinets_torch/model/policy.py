"""Motion Policy Network as a ``torch.nn.Module``: PointNet++ point-cloud
encoder + configuration MLP + decoder.

Port of ``mpinets_tpu/model/policy.py`` (architecture of
``motion-policy-networks/mpinets/model.py:35-91,355-426``). Submodules carry the
flax module names (``point_cloud_encoder.sa0.mlp.conv0``, ``fc0``, ``gn0``,
``feature_encoder_0``, ``decoder_0``, ...), so a flax parameter tree maps
onto the ``state_dict`` key by key (:mod:`mpinets_torch.model.checkpoint`).

The forward is the plain path through :mod:`mpinets_torch.kernels.pointnet`;
:mod:`mpinets_torch.model.fused` runs the same weights through the hand
kernels. ``compute_dtype`` runs each Dense in that type, as flax's
``Dense(dtype=...)`` does, with GroupNorm in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from mpinets_torch.kernels import pointnet
from mpinets_torch.utils.device import resolve_device


def dense(lin: nn.Linear, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """flax ``Dense(dtype=compute_dtype)``: input, kernel and bias in that type."""
    return F.linear(x.to(compute_dtype), lin.weight.to(compute_dtype),
                    lin.bias.to(compute_dtype))


class SharedMLP(nn.Module):
    """1x1 convs (= pointwise Dense), ReLU after every layer
    (pointnet2_ops' SharedMLP with ``bn=False``)."""

    def __init__(self, in_features: int, features: Sequence[int], compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        for i, f in enumerate(features):
            self.add_module(f"conv{i}", nn.Linear(in_features, f))
            in_features = f
        self.depth = len(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(dense(getattr(self, f"conv{i}"), x, self.compute_dtype))
        return x


class SetAbstraction(nn.Module):
    """FPS centroids -> ball-query grouping -> shared MLP -> max-pool."""

    def __init__(self, npoint, radius, nsample, in_features, mlp, compute_dtype):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp = SharedMLP(3 + in_features, mlp, compute_dtype)

    def forward(self, xyz, features) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyz: [B, N, 3]; features: [B, N, C] -> ([B, S, 3], [B, S, mlp[-1]])."""
        idx = pointnet.furthest_point_sample(xyz, self.npoint)
        centroids = pointnet.gather_points(xyz, idx)
        grouped = pointnet.query_and_group(
            centroids, xyz, features, self.radius, self.nsample
        )
        return centroids, torch.amax(self.mlp(grouped), dim=-2)


class GlobalSetAbstraction(nn.Module):
    """The final group-all SA stage."""

    def __init__(self, in_features, mlp, compute_dtype):
        super().__init__()
        self.mlp = SharedMLP(3 + in_features, mlp, compute_dtype)

    def forward(self, xyz, features) -> torch.Tensor:
        out = self.mlp(pointnet.group_all(xyz, features))  # [B, 1, N, C]
        return torch.amax(out, dim=-2)[:, 0]


class MPiNetsPointNet(nn.Module):
    """Point-cloud encoder (``model.py:355-426``)."""

    def __init__(self, compute_dtype, sa_npoints, sa_nsamples, sa_radii):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.sa0 = SetAbstraction(sa_npoints[0], sa_radii[0], sa_nsamples[0], 1,
                                  (64, 64, 64), compute_dtype)
        self.sa1 = SetAbstraction(sa_npoints[1], sa_radii[1], sa_nsamples[1], 64,
                                  (128, 128, 256), compute_dtype)
        self.sa2 = GlobalSetAbstraction(256, (512, 512, 1024), compute_dtype)
        self.fc0 = nn.Linear(1024, 4096)
        self.gn0 = nn.GroupNorm(16, 4096, eps=1e-5)
        self.fc1 = nn.Linear(4096, 2048)
        self.gn1 = nn.GroupNorm(16, 2048, eps=1e-5)
        self.fc2 = nn.Linear(2048, 2048)

    def forward(self, point_cloud: torch.Tensor) -> torch.Tensor:
        """point_cloud: [B, N, 4] (xyz + segmentation) -> [B, 2048]."""
        cdt = self.compute_dtype
        xyz, features = self.sa0(point_cloud[..., :3], point_cloud[..., 3:])
        xyz, features = self.sa1(xyz, features)
        features = self.sa2(xyz, features)
        x = F.leaky_relu(self.gn0(dense(self.fc0, features, cdt).float()), 0.01)
        x = F.leaky_relu(self.gn1(dense(self.fc1, x, cdt).float()), 0.01)
        return dense(self.fc2, x, cdt)


class MotionPolicyNetwork(nn.Module):
    """The full policy: dq_norm = f(xyz [B, N, 4], q_norm [B, 7])
    (``model.py:35-91``). Built on ``device`` (default ``cuda``; raises when
    there is none unless ``device="cpu"``). ``generator`` makes the initial
    weights from an explicit seed."""

    def __init__(
        self,
        compute_dtype=torch.float32,
        sa_npoints: Tuple[int, int] = (512, 128),
        sa_nsamples: Tuple[int, int] = (128, 128),
        sa_radii: Tuple[float, float] = (0.05, 0.3),
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.sa_npoints = tuple(sa_npoints)
        self.point_cloud_encoder = MPiNetsPointNet(
            compute_dtype, sa_npoints, sa_nsamples, sa_radii
        )
        widths = (7, 32, 64, 128, 128, 64)
        for i in range(5):
            self.add_module(f"feature_encoder_{i}", nn.Linear(widths[i], widths[i + 1]))
        widths = (2048 + 64, 512, 256, 128, 7)
        for i in range(4):
            self.add_module(f"decoder_{i}", nn.Linear(widths[i], widths[i + 1]))
        if generator is not None:
            self.reset_parameters(generator)
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default Linear init (uniform in +-1/sqrt(fan_in)) drawn
        from ``generator``; GroupNorm scale 1, bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, xyz: torch.Tensor, q_norm: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        pc_encoding = self.point_cloud_encoder(xyz)
        x = q_norm
        for i in range(4):
            x = F.leaky_relu(dense(getattr(self, f"feature_encoder_{i}"), x, cdt), 0.01)
        feature_encoding = dense(self.feature_encoder_4, x, cdt)
        x = torch.cat([pc_encoding, feature_encoding], dim=-1)
        for i in range(3):
            x = F.leaky_relu(dense(getattr(self, f"decoder_{i}"), x, cdt), 0.01)
        return dense(self.decoder_3, x, cdt).float()


def make_policy(compute_dtype=None, device=None) -> MotionPolicyNetwork:
    """A :class:`MotionPolicyNetwork` computing in ``compute_dtype`` (f32 when
    None), as ``mpinets_tpu/model/policy.py:167`` makes it."""
    return MotionPolicyNetwork(compute_dtype=compute_dtype or torch.float32, device=device)
