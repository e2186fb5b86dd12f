"""Micro-op probes: ``probe_micro_kernel`` / ``probe_roll_kernel`` /
``probe_prefix_kernel`` in ``csrc/probes.cu`` and their plain version.

Replaces ``scripts/onchip_r3d.py::_micro_kernel``. ``a`` [rows, 128] f32 is
cut into blocks of ``rb`` rows; one op runs ``reps`` times over every row of
a block, and rows 0..7 of each block are the output ([8 rows / rb, 128]):

* ``gather``: ``sum_{r < reps} a[row, (idx[row, l] + r) mod 128]``;
* ``roll_narrow``: ``a[(row - reps) mod rb, 0]`` with 1 added ``reps`` times, one
  addition per roll, in every lane;
* ``roll_wide``: the same for every lane;
* ``vadd``: ``reps`` times ``v <- v * 1.0000001 + 1`` (two roundings, no FMA);
* ``bd_matmul``: ``reps`` times the sum of ``bf16(a[row', l])`` over the earlier
  rows ``row'`` of the same 49-row group, accumulated in f32 (``rb`` a multiple
  of 49). The TPU body computes this for every row; the kernel keeps every
  row's result by also writing, per group, the sum of its rows' accumulators
  and bf16 values in row order (``group_sums`` [rows / 49, 128]).

``idx`` must lie in [0, 128): the kernel reads shared memory at it unchecked.
"""

from __future__ import annotations

import torch

from mpinets_torch.kernels import ops

MICRO_OPS = ("gather", "roll_narrow", "roll_wide", "vadd", "bd_matmul")
OUT_ROWS = 8
GROUP = 49      # rows per prefix group of bd_matmul
VADD_SCALE = 1.0000001


def _check_shapes(a, idx, op, reps, rb, return_group_sums=False):
    if op not in MICRO_OPS:
        raise ValueError(f"unknown micro op {op!r}; one of {MICRO_OPS}")
    if return_group_sums and op != "bd_matmul":
        raise ValueError("group sums are bd_matmul's only")
    rows = a.shape[0]
    ops._check(a, "a", (torch.float32,), (rows, ops.CHUNK))
    ops._check(idx, "idx", (torch.int32,), (rows, ops.CHUNK))
    if rb < OUT_ROWS or rows < rb or rows % rb or reps < 0 or (op == "bd_matmul" and rb % GROUP):
        raise ValueError(f"the micro probe takes rows a multiple of rb >= {OUT_ROWS} (bd_matmul: "
                         f"rb a multiple of {GROUP}) and reps >= 0; got rows={rows}, rb={rb}, "
                         f"reps={reps}")
    return rows


def bd_matmul_plain(a, reps: int):
    """Plain version of bd_matmul over every row: (acc [rows / 49, 49, 128],
    group_sums [rows / 49, 128])."""
    vals = a.view(-1, GROUP, ops.CHUNK).to(torch.bfloat16).float()
    run = torch.zeros_like(vals[:, 0])
    prefix = []
    for j in range(GROUP):
        prefix.append(run)
        run = run + vals[:, j]
    prefix = torch.stack(prefix, 1)
    acc = torch.zeros_like(prefix)
    for _ in range(reps):
        acc = acc + prefix
    sums = torch.zeros_like(run)
    for j in range(GROUP):
        sums = (sums + acc[:, j]) + vals[:, j]
    return acc, sums


def micro_plain(a, idx, op: str, reps: int, rb: int, return_group_sums: bool = False):
    """Plain version of the micro probe (see the module docstring); it
    computes the output rows only, except for bd_matmul."""
    rows = _check_shapes(a, idx, op, reps, rb, return_group_sums)
    if op == "bd_matmul":
        acc, sums = bd_matmul_plain(a, reps)
        out = acc.view(rows // rb, rb, ops.CHUNK)[:, :OUT_ROWS].reshape(-1, ops.CHUNK)
        return (out, sums) if return_group_sums else out
    blocks = a.view(rows // rb, rb, ops.CHUNK)
    out_rows = torch.arange(OUT_ROWS, device=a.device)
    if op == "gather":
        cur = idx.view(rows // rb, rb, ops.CHUNK)[:, :OUT_ROWS].long()
        src = blocks[:, :OUT_ROWS]
        v = torch.zeros_like(src)
        for r in range(reps):
            v = v + torch.gather(src, 2, (cur + r) % ops.CHUNK)
    elif op in ("roll_narrow", "roll_wide"):
        v = blocks[:, (out_rows - reps) % rb]
        if op == "roll_narrow":
            v = v[..., :1]
        for _ in range(reps):
            v = v + 1.0
        v = v.expand(-1, -1, ops.CHUNK)
    else:   # vadd
        scale = torch.tensor(VADD_SCALE, dtype=torch.float32, device=a.device)
        v = blocks[:, :OUT_ROWS]
        for _ in range(reps):
            v = v * scale + 1.0
    return v.reshape(-1, ops.CHUNK).contiguous()


def micro_probe(a, idx, op: str, reps: int, rb: int, return_group_sums: bool = False):
    """The micro probe: a [rows, 128] f32, idx [rows, 128] int32 in [0, 128)
    -> [8 rows / rb, 128] f32, and with ``return_group_sums`` (bd_matmul
    only) also the group sums [rows / 49, 128]. CPU tensors: the plain
    version; CUDA tensors: the kernel, counted as ``probe_micro``."""
    if ops._on_cpu(a, idx):
        return micro_plain(a, idx, op, reps, rb, return_group_sums)
    rows = _check_shapes(a, idx, op, reps, rb, return_group_sums)
    out = torch.empty((OUT_ROWS * rows // rb, ops.CHUNK), dtype=torch.float32, device=a.device)
    sums = (torch.empty((rows // GROUP, ops.CHUNK), dtype=torch.float32, device=a.device)
            if op == "bd_matmul" else None)
    ops._launch("probes", "mpn_probe_micro", a.device, a.data_ptr(), idx.data_ptr(), rows, rb,
                MICRO_OPS.index(op), reps, out.data_ptr(),
                None if sums is None else sums.data_ptr())
    ops._count("probe_micro", 1, rows, rb)
    return (out, sums) if return_group_sums else out
