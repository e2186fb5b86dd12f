"""Device selection for the port's entry points.

The port runs on the GPU. An entry point given no device runs on ``cuda``
and raises when there is none; it never carries on silently on the CPU. The
CPU path (the kernels' plain versions) is taken only when the caller asks
for it with ``device="cpu"``, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device
