"""Device selection for the port's entry points.

The port runs on the GPU. An entry point given no device runs on ``cuda``
and raises when there is none; it never carries on silently on the CPU. The
CPU path (the kernels' plain versions) is taken only when the caller asks
for it with ``device="cpu"``, as the tests do. :func:`host_table` puts a
constant table from host memory on a device, for callers that cache it.
"""

from __future__ import annotations

import torch

from mpinets_torch.utils import trace


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device


def host_table(site: str, array, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant table from host memory as a tensor on ``device``, for a
    caller that makes it once per (table, dtype, device) and reuses it. The
    copy to a card waits for the card's queue to drain, so it lies in the
    span ``wait.h2d.<site>``. The tensor is made outside inference mode, so
    autograd may save it for a later backward even when the first call came
    under ``torch.inference_mode``. Every caller shares it: none writes it in
    place."""
    with torch.inference_mode(False), trace.h2d_wait(site, device):
        return torch.as_tensor(array, dtype=dtype, device=device)
