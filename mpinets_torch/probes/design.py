"""Design probes of the v8 SA kernel: ``probe_wide_kernel`` and
``probe_scratch_kernel`` in ``csrc/probes.cu`` and their plain versions.

* :func:`wide_gather` replaces ``scripts/onchip_r4a.py::_wide_kernel``: a
  gather whose index is wider than its 128-lane table,
  ``out[b, p, k] = sum_{c < nc} tab[b, nc p + c, idx[b, nc p + c, k]]`` with
  tab [B, parts * nc, 128] f32 and idx [B, parts * nc, W] int32 (the probe:
  4 parts of 56 rows, W = 2048), summed over c in order. ``idx`` must lie in
  [0, 128) (the kernel reads shared memory at it unchecked) and start on a
  16-byte boundary (the kernel reads it 4 at a time).
* :func:`scratch_probe` replaces ``scripts/onchip_r4a.py::_scratch_kernel``,
  which asked whether scratch persists across sequential grid steps:
  ``out[j, r, l] = l + j`` for ``steps`` steps of [8, 128]. The kernel is one
  block that steps through the steps itself and writes its shared-memory
  scratch at step 0 only; on a GPU state persists within a block, never
  across blocks.
"""

from __future__ import annotations

import torch

from mpinets_torch.kernels import ops

WIDE_PARTS = 4
SCRATCH_ROWS = 8


def _check_wide(tab, idx, parts):
    b, rows = tab.shape[:2]
    ops._check(tab, "tab", (torch.float32,), (b, rows, ops.CHUNK))
    ops._check(idx, "idx", (torch.int32,), (b, rows, None))
    width = idx.shape[2]
    if parts < 1 or rows % parts or width < 4 or width % 4 or width > 2048:
        raise ValueError(f"the wide gather takes rows a multiple of parts and a width that is a "
                         f"multiple of 4 up to 2048; got rows={rows}, parts={parts}, W={width}")
    if idx.data_ptr() % 16:
        raise ValueError("idx: the wide gather reads it 4 at a time, from a 16-byte boundary")
    return b, rows // parts, width


def wide_plain(tab, idx, parts: int = WIDE_PARTS) -> torch.Tensor:
    """Plain version of the wide gather (see the module docstring)."""
    b, nc, width = _check_wide(tab, idx, parts)
    g = torch.gather(tab, 2, idx.long()).view(b, parts, nc, width)
    out = g[:, :, 0]
    for c in range(1, nc):
        out = out + g[:, :, c]
    return out


def wide_gather(tab, idx, parts: int = WIDE_PARTS) -> torch.Tensor:
    """The wide gather -> [B, parts, W] f32. CPU tensors: the plain version;
    CUDA tensors: the kernel, counted as ``probe_wide``."""
    if ops._on_cpu(tab, idx):
        return wide_plain(tab, idx, parts)
    b, nc, width = _check_wide(tab, idx, parts)
    out = torch.empty((b, parts, width), dtype=torch.float32, device=tab.device)
    ops._launch("probes", "mpn_probe_wide", tab.device, tab.data_ptr(), idx.data_ptr(), b, parts,
                nc, width, out.data_ptr())
    ops._count("probe_wide", parts * nc, width)
    return out


def scratch_plain(steps: int = 4, device="cpu") -> torch.Tensor:
    """Plain version of the scratch probe: out[j, r, l] = l + j."""
    lanes = torch.arange(ops.CHUNK, dtype=torch.float32, device=device)
    steps_f = torch.arange(steps, dtype=torch.float32, device=device)
    return (lanes + steps_f[:, None, None]).expand(steps, SCRATCH_ROWS, ops.CHUNK).contiguous()


def scratch_probe(steps: int = 4, device="cuda") -> torch.Tensor:
    """The scratch probe -> [steps, 8, 128] f32. On the CPU: the plain
    version; on a CUDA device: the kernel, counted as ``probe_scratch``."""
    device = torch.device(device)
    if steps < 1:
        raise ValueError(f"the scratch probe takes steps >= 1, got {steps}")
    if device.type == "cpu":
        return scratch_plain(steps, device)
    if device.type != "cuda":
        raise ValueError(f"scratch_probe runs on the CPU or a CUDA device, got {device}")
    out = torch.empty((steps, SCRATCH_ROWS, ops.CHUNK), dtype=torch.float32, device=device)
    ops._launch("probes", "mpn_probe_scratch", device, steps, out.data_ptr())
    ops._count("probe_scratch", steps * SCRATCH_ROWS, ops.CHUNK)
    return out
