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

import functools
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
    """The final group-all SA stage's MLP; :meth:`MotionPolicyNetwork.head`
    runs it."""

    def __init__(self, in_features, mlp, compute_dtype):
        super().__init__()
        self.mlp = SharedMLP(3 + in_features, mlp, compute_dtype)


class MPiNetsPointNet(nn.Module):
    """Point-cloud encoder's layers (``model.py:355-426``):
    :class:`MotionPolicyNetwork` runs SA0 and SA1, then the rest in its
    :meth:`~MotionPolicyNetwork.head`."""

    def __init__(self, compute_dtype, sa_npoints, sa_nsamples, sa_radii):
        super().__init__()
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
        """xyz: [B, N, 4] (xyz + segmentation), q_norm: [B, 7] -> dq [B, 7] f32."""
        enc = self.point_cloud_encoder
        cent, features = enc.sa0(xyz[..., :3], xyz[..., 3:])
        cent, features = enc.sa1(cent, features)
        return self.head(cent, features, q_norm,
                         functools.partial(dense, compute_dtype=self.compute_dtype),
                         lambda gn, x: gn(x.float()))

    def head(self, xyz, features, q_norm, dense_fn, group_norm_fn) -> torch.Tensor:
        """The policy after SA1: global SA (group all, xyz NOT recentred,
        max over points), the FC head with GroupNorm, the q-encoder and the
        decoder. ``dense_fn(linear, x)`` and ``group_norm_fn(gn, x)`` are the
        layers' forms: the plain forward's flax Dense and the GroupNorm
        module on f32, or the kernel path's (:func:`mpinets_torch.model.fused.tail`).
        xyz [B, S, 3], features [B, S, C] -> dq [B, 7] f32."""
        enc = self.point_cloud_encoder
        h = torch.cat([xyz, features], dim=-1)
        for conv in enc.sa2.mlp.children():
            h = torch.relu(dense_fn(conv, h))
        x = h.amax(dim=1)                                   # [B, 1024]
        x = F.leaky_relu(group_norm_fn(enc.gn0, dense_fn(enc.fc0, x)), 0.01)
        x = F.leaky_relu(group_norm_fn(enc.gn1, dense_fn(enc.fc1, x)), 0.01)
        pc_encoding = dense_fn(enc.fc2, x)                  # [B, 2048]
        x = q_norm
        for i in range(4):
            x = F.leaky_relu(dense_fn(getattr(self, f"feature_encoder_{i}"), x), 0.01)
        x = torch.cat([pc_encoding, dense_fn(self.feature_encoder_4, x)], dim=-1)
        for i in range(3):
            x = F.leaky_relu(dense_fn(getattr(self, f"decoder_{i}"), x), 0.01)
        return dense_fn(self.decoder_3, x).float()


def make_policy(compute_dtype=None, device=None) -> MotionPolicyNetwork:
    """A :class:`MotionPolicyNetwork` computing in ``compute_dtype`` (f32 when
    None), as ``mpinets_tpu/model/policy.py:167`` makes it."""
    return MotionPolicyNetwork(compute_dtype=compute_dtype or torch.float32, device=device)
