"""The SA0 scan cut off after one of its stages: ``probe_scan_kernel`` in
``csrc/probes.cu`` and its plain version.

Replaces ``scripts/onchip_r3b.py::_abl_kernel`` (stops 1-5),
``scripts/onchip_r3d.py::_abl_kernel`` (stops 3-4) and
``scripts/onchip_r3c.py::_abl2_kernel`` (stage 2 with or without the
cross-chunk scan). Point ``i = 128 c + l`` is lane ``l`` of chunk ``c``;
``hit(s, i)`` is ``dx*dx + dy*dy + dz*dz < r*r`` in f32, left to right, with
``r*r`` the Python product rounded once to f32 (as JAX compares it);
``lo_c`` / ``hi_c`` are centroid ``s``'s hits before / through chunk ``c``.
``out[b, s, l]`` ([B, S, 128] f32) is, by mode:

* ``hits`` (r3b stop 1, with or without ``fuse_inball``): ``sum_c hit(s, 128c + l)``;
* ``count`` (r3b stop 2, r3c with the scan): ``sum_c (lo_c + hits at lanes <= l
  of chunk c)``;
* ``count_noscan`` (r3c without the scan): ``sum_c (hits of chunk c + hits at
  lanes <= l)`` -- the TPU probe's "wrong values, same cost";
* ``slot`` (r3b / r3d stop 3): ``sum_c pos_c(l)``, the 7-round search's result:
  0 for ``l < lo_c``, 127 for ``l >= hi_c``, else the lane of the
  ``(l - lo_c)``-th hit of chunk ``c``;
* ``gather`` (r3b stops 4 and 5): ``P(n_l(s))`` for ``l < count(s)``, else 0,
  with ``n_l(s)`` the l-th hit in index order and ``P = ((x + y) + z) + feat``;
* ``tile_sum`` (r3d stop 4): ``gather``'s value summed over the tile of 32
  centroids that holds ``s``.

N must be a multiple of 128 and S of 32 (the TPU probes' tile).
"""

from __future__ import annotations

import torch

from mpinets_torch.kernels import ops, pointnet

SCAN_MODES = ("hits", "count", "count_noscan", "slot", "gather", "tile_sum")
TILE = 32     # centroids per tile (the probes' tile_s)
WARPS = 8     # the kernel's warps per tile, each summing 4 centroids first


def _check_shapes(xyz, feat, cent, mode):
    if mode not in SCAN_MODES:
        raise ValueError(f"unknown scan mode {mode!r}; one of {SCAN_MODES}")
    b, n = xyz.shape[:2]
    ops._check(xyz, "xyz", (torch.float32,), (b, n, 3))
    ops._check(feat, "feat", (torch.float32,), (b, n, 1))
    ops._check(cent, "cent", (torch.float32,), (b, None, 3))
    s = cent.shape[1]
    if n < ops.CHUNK or n % ops.CHUNK or s < TILE or s % TILE:
        raise ValueError(f"the scan probe takes N a multiple of {ops.CHUNK} and S of {TILE}; "
                         f"got N={n}, S={s}")
    return b, n, s


def scan_plain(xyz, feat, cent, radius: float, mode: str) -> torch.Tensor:
    """Plain version of the scan probe (see the module docstring)."""
    b, n, s = _check_shapes(xyz, feat, cent, mode)
    nc = n // ops.CHUNK
    r2 = torch.tensor(ops._r2(radius), dtype=torch.float32, device=xyz.device)
    hit = pointnet.sq_dist(xyz[:, None], cent[:, :, None]) < r2          # [B, S, N]
    if mode in ("hits", "count", "count_noscan", "slot"):
        h = hit.view(b, s, nc, ops.CHUNK).long()
        if mode == "hits":
            return h.sum(2).float()
        local = h.cumsum(-1)                     # hits at lanes <= l of the chunk
        tot = local[..., -1:]
        lo = tot.cumsum(2) - tot
        if mode == "count":
            return (local + lo).sum(2).float()
        if mode == "count_noscan":
            return (local + tot).sum(2).float()
        lanes = torch.arange(ops.CHUNK, device=xyz.device).expand_as(local).contiguous()
        pos = torch.searchsorted(local + lo, lanes, right=True).clamp(max=ops.CHUNK - 1)
        return pos.sum(2).float()
    key = torch.where(hit, torch.arange(n, device=xyz.device), n)
    first = torch.topk(key, ops.CHUNK, dim=-1, largest=False, sorted=True).values
    p = ((xyz[..., 0] + xyz[..., 1]) + xyz[..., 2]) + feat[..., 0]     # [B, N]
    val = torch.gather(p[:, None].expand(b, s, n), 2, first.clamp(max=n - 1))
    out = torch.where(first < n, val, torch.zeros_like(val))
    if mode == "gather":
        return out
    # the kernel's order: each warp sums its 4 centroids, then the 8 warps in turn
    parts = out.view(b, s // TILE, WARPS, TILE // WARPS, ops.CHUNK)
    per_warp = parts[:, :, :, 0]
    for g in range(1, TILE // WARPS):
        per_warp = per_warp + parts[:, :, :, g]
    tile = per_warp[:, :, 0]
    for w in range(1, WARPS):
        tile = tile + per_warp[:, :, w]
    return tile[:, :, None].expand(b, s // TILE, TILE, ops.CHUNK).reshape(b, s, ops.CHUNK)


def scan_probe(xyz, feat, cent, radius: float, mode: str) -> torch.Tensor:
    """The scan probe: xyz [B, N, 3], feat [B, N, 1], cent [B, S, 3] f32 ->
    [B, S, 128] f32. CPU tensors: the plain version; CUDA tensors: the
    kernel, counted as ``probe_scan``."""
    if ops._on_cpu(xyz, feat, cent):
        return scan_plain(xyz, feat, cent, radius, mode)
    b, n, s = _check_shapes(xyz, feat, cent, mode)
    out = torch.empty((b, s, ops.CHUNK), dtype=torch.float32, device=xyz.device)
    ops._launch("probes", "mpn_probe_scan", xyz.device, xyz.data_ptr(), feat.data_ptr(),
                cent.data_ptr(), b, n, s, ops._r2(radius), SCAN_MODES.index(mode), out.data_ptr())
    ops._count("probe_scan", b, n, s)
    return out
