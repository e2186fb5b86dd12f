"""Random weights for a configuration, made on the device from the seed.

Shapes come from the configuration file's widths (nn.Linear layout [out,
in], under the system's ``state_dict`` names), so that loading them into
the system's model with ``strict=True`` also checks that the model runs
the configuration's widths. One ``torch.rand`` on the card draws every
Linear at once; each takes nn.Linear's default range, +-1/sqrt(fan_in).
GroupNorm starts at scale 1 and shift 0, as the model's own init.
"""

from __future__ import annotations

import math

import torch

from benchmark.generate import generator


def shapes(cfg):
    """[(name, shape, fan_in or None for GroupNorm)] in ``state_dict`` order."""
    out = []

    def linear(name, fan_in, width):
        out.append((f"{name}.weight", (width, fan_in), fan_in))
        out.append((f"{name}.bias", (width,), fan_in))

    enc = "point_cloud_encoder"
    fan = 3 + 1
    for i, width in enumerate(cfg["sa0"]["mlp"]):
        linear(f"{enc}.sa0.mlp.conv{i}", fan, width)
        fan = width
    fan = 3 + cfg["sa0"]["mlp"][-1]
    for i, width in enumerate(cfg["sa1"]["mlp"]):
        linear(f"{enc}.sa1.mlp.conv{i}", fan, width)
        fan = width
    fan = 3 + cfg["sa1"]["mlp"][-1]
    for i, width in enumerate(cfg["sa2"]["mlp"]):
        linear(f"{enc}.sa2.mlp.conv{i}", fan, width)
        fan = width
    for i, width in enumerate(cfg["fc"]):
        linear(f"{enc}.fc{i}", fan, width)
        if i < len(cfg["fc"]) - 1:
            out.append((f"{enc}.gn{i}.weight", (width,), None))
            out.append((f"{enc}.gn{i}.bias", (width,), None))
        fan = width
    fan = cfg["dof"]
    for i, width in enumerate(cfg["q_encoder"]):
        linear(f"feature_encoder_{i}", fan, width)
        fan = width
    fan = cfg["fc"][-1] + cfg["q_encoder"][-1]
    for i, width in enumerate(cfg["decoder"]):
        linear(f"decoder_{i}", fan, width)
        fan = width
    return out


def make(cfg, seed, device):
    """-> {name: f32 tensor on ``device``}, the same for the same seed."""
    table = shapes(cfg)
    total = sum(math.prod(s) for _, s, fan in table if fan is not None)
    flat = torch.rand(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for name, shape, fan in table:
        if fan is None:
            fill = 1.0 if name.endswith(".weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
            continue
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan)
        out[name] = (flat[at:at + n] * (2 * bound) - bound).view(shape)
        at += n
    return out
