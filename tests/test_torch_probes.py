"""Port parity for the TPU probe kernels' plain versions
(:mod:`mpinets_torch.probes`).

The six Pallas probe kernels live in session scripts that run their whole
session when imported, so their kernel bodies are taken out of the source
with ``ast`` (the ``FunctionDef`` alone, executed with ``jax``, ``jnp``,
``pl``, ``pltpu`` and ``functools``) and run through ``pl.pallas_call`` in
interpret mode with the scripts' BlockSpecs. The port's wrappers, which
compute their plain versions on CPU tensors, are held against them on the
same numpy-made inputs:

* scan probes (r3b stops 1-5, and stop 1 with ``fuse_inball``; r3c with and
  without the cross-chunk scan, r3d stops 3 and 4), on a cloud with a
  centroid of 150 neighbours, one off the cloud with none, an empty chunk
  between two full ones and points within a few ulps of the sphere:
  exact for the counts (stops 1-3, r3c), 1e-6 x max(1, max|out|) for stops
  4-5 (the four channels summed in another order), 1e-5 x max(1, max|out|)
  for r3d's stop 4 (32 centroids summed in another order);
* a numpy model of the scan kernel's own arithmetic (``csrc/probes.cu``:
  integer per-lane hit counts and one prefix over the lanes at the end;
  per-hit slots and gathers with the warp's stop at 128 hits), held
  against the same TPU kernel bodies on the edge-case cloud and on a cloud
  whose centroids pass 128 hits in their first chunks -- bit-equal for the
  counts (stops 1-3, r3c), within the tolerances above for stops 4-5 and
  r3d's stop 4 -- and bit-equal to the plain versions in every mode;
* micro-ops at 8 and 32 reps: exact for gather and the rolls, 1e-6 x
  max(1, max|out|) for vadd (XLA may contract it into an FMA), 1e-5 x
  max(1, max|out|) for bd_matmul (the MXU's sum order);
* the wide gather, 1e-5 x max(1, max|out|) (56 rows summed in another
  order); the scratch probe, exact.

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import ast
import functools
import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mpinets_torch.probes import __main__ as probes_main  # noqa: E402
from mpinets_torch.probes import design, micro, scan, session  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
R4A_CONSTS = dict(P=4, NC=56, TS=16)   # onchip_r4a.py:67
TILE = 32


@functools.lru_cache(maxsize=None)
def _tpu_kernel(script, name):
    """The kernel function ``name`` of ``scripts/<script>``, without running
    the script."""
    path = SCRIPTS / script
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools,
              **(R4A_CONSTS if script == "onchip_r4a.py" else {}))
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns[name]


def _lt128():
    i = np.arange(128)
    return jnp.asarray((i[:, None] <= i[None, :]).astype(np.float32)).astype(jnp.bfloat16)


def _tpu_scan(script, name, xyz, feat, cent, **kw):
    """The scripts' ``abl_run`` / ``abl2_run`` in interpret mode, r=0.05."""
    b, n, _ = xyz.shape
    s = cent.shape[1]
    nc, p = n // 128, 4
    planes = jnp.swapaxes(jnp.concatenate([xyz, feat], -1), 1, 2).reshape(b, p * nc, 128)
    cspec = pl.BlockSpec((1, TILE, 1), lambda i, j: (i, j, 0), memory_space=pltpu.VMEM)
    kernel = functools.partial(_tpu_kernel(script, name), radius=0.05, num_chunks=nc,
                               tile_s=TILE, **kw)
    return np.asarray(pl.pallas_call(
        kernel, grid=(b, s // TILE),
        in_specs=[pl.BlockSpec((1, p * nc, 128), lambda i, j: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  cspec, cspec, cspec,
                  pl.BlockSpec((128, 128), lambda i, j: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, TILE, 128), lambda i, j: (i, j, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, s, 128), jnp.float32), interpret=True,
    )(planes, cent[..., 0:1], cent[..., 1:2], cent[..., 2:3], _lt128()))


SCAN_CASES = {"edge": session.edge_scan_inputs, "dense": session.dense_scan_inputs}


@functools.lru_cache(maxsize=None)
def _scan_case(case):
    return SCAN_CASES[case](5)


@functools.lru_cache(maxsize=None)
def _tpu_scan_case(case, script, name, **kw):
    """The TPU kernel's output on ``case``'s cloud, computed once."""
    return _tpu_scan(script, name, *_scan_case(case), **kw)


def _check_scan(script, name, mode, tol, **kw):
    xyz, feat, cent = _scan_case("edge")
    ref = _tpu_scan_case("edge", script, name, **kw)
    out = scan.scan_probe(*map(torch.from_numpy, (xyz, feat, cent)), 0.05, mode).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


R3B_MODES = {1: "hits", 2: "count", 3: "slot", 4: "gather", 5: "gather"}


@pytest.mark.parametrize("stop, fuse", [(stop, False) for stop in sorted(R3B_MODES)]
                         + [(1, True)])   # the session fuses the in-ball test at stop 1
def test_r3b_stage_probe_matches_tpu_kernel(stop, fuse):
    _check_scan("onchip_r3b.py", "_abl_kernel", R3B_MODES[stop], 1e-6 if stop >= 4 else 0.0,
                stop=stop, fuse_inball=fuse)


@pytest.mark.parametrize("with_scan", [True, False])
def test_r3c_scan_isolation_probe_matches_tpu_kernel(with_scan):
    _check_scan("onchip_r3c.py", "_abl2_kernel", "count" if with_scan else "count_noscan", 0.0,
                with_scan=with_scan)


@pytest.mark.parametrize("stop", [3, 4])
def test_r3d_stage_probe_matches_tpu_kernel(stop):
    _check_scan("onchip_r3d.py", "_abl_kernel", {3: "slot", 4: "tile_sum"}[stop],
                1e-5 if stop == 4 else 0.0, stop=stop)


def test_edge_inputs_hold_the_edge_cases():
    """The scan input has what the parity cases rely on."""
    xyz, _, cent = session.edge_scan_inputs(5)
    dx = xyz[:, None] - cent[:, :, None]
    d2 = (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]) + dx[..., 2] * dx[..., 2]
    r2, r2_f32_product = np.float32(0.05 * 0.05), np.float32(0.05) * np.float32(0.05)
    hit = d2 < r2
    per_chunk = hit.reshape(2, 64, 3, 128).sum(-1)
    assert per_chunk[0, 0].tolist()[1] == 0 and per_chunk[0, 0, 0] > 0 and per_chunk[0, 0, 2] > 0
    assert hit[0, 0].sum() > 128
    assert hit[:, 1].sum() == 0
    near = np.abs(d2[0, 2] - r2) <= 8 * np.spacing(r2)
    assert hit[0, 2][near].any() and (~hit[0, 2][near]).any()
    # a threshold of f32(r) * f32(r) would change the answer
    assert ((d2[0, 2] < r2_f32_product) != hit[0, 2]).any()


LANE_PTS = 4    # the kernel's neighbouring points of a chunk a lane tests
CPW = 4         # the kernel's centroids a warp


def _tile_sum(vals):
    """``vals`` [B, S, 128] summed over each tile of 32 centroids in the
    kernel's order (each warp its 4 centroids, then the 8 warps in turn),
    broadcast back to [B, S, 128]."""
    b, s, _ = vals.shape
    parts = vals.reshape(b, s // TILE, TILE // CPW, CPW, 128)
    per_warp = parts[:, :, :, 0]
    for g in range(1, CPW):
        per_warp = per_warp + parts[:, :, :, g]
    tile = per_warp[:, :, 0]
    for w in range(1, TILE // CPW):
        tile = tile + per_warp[:, :, w]
    return np.repeat(tile[:, :, None], TILE, axis=2).reshape(b, s, 128)


def _scan_model(xyz, feat, cent, mode):
    """numpy model of ``probe_scan_kernel``'s arithmetic: lane t of a warp
    tests points 128 c + 4 t + j (j < 4) of chunk c against the warp's 4
    centroids, r=0.05.

    * hits, count, count_noscan: H, each lane's integer hit count at point
      4 t + j over the chunks; for count also T, the sum over chunks of the
      lane's H before the chunk (the warp's sum of T is sum_c lo_c); then
      the inclusive prefix of H over the 128 lanes plus sum_c lo_c (count)
      or all hits (count_noscan).
    * slot, gather, tile_sum: the lane's 4-bit mask a centroid (bit j for
      point 4 t + j); only chunks with a hit; per centroid the lanes
      holding hits in order, slot ``r`` taking the r-th hit until 128:
      ``127 c + lane`` (slot; slots past the count keep ``127 nc``, the 127
      of every chunk) or P (gather); the warp stops once its 4 centroids
      have 128 hits.
    Every count is an int64 sum, converted to f32 once."""
    b, n, _ = xyz.shape
    s = cent.shape[1]
    nc = n // 128
    d = xyz[:, None] - cent[:, :, None]                                   # [B, S, N, 3] f32
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    hit = (d2 < np.float32(0.05 * 0.05)).reshape(b, s, nc, 128 // LANE_PTS, LANE_PTS)
    if mode in ("hits", "count", "count_noscan"):
        h = hit.astype(np.int64).sum(2)                                  # H [B, S, lane, j]
        if mode == "hits":
            return h.reshape(b, s, 128).astype(np.float32)
        incl = np.cumsum(h, -1)                      # the lane's own 4 lanes
        mine = incl[..., -1]
        below = np.cumsum(mine, -1) - mine           # the warp's lanes before it
        if mode == "count":
            per_chunk = hit.astype(np.int64).sum(-1)                     # [B, S, c, lane]
            t = (np.cumsum(per_chunk, 2) - per_chunk).sum(2)              # T [B, S, lane]
            base = t.sum(-1)
        else:
            base = mine.sum(-1)
        out = base[..., None, None] + below[..., None] + incl
        return out.reshape(b, s, 128).astype(np.float32)
    p = ((xyz[..., 0] + xyz[..., 1]) + xyz[..., 2]) + feat[..., 0]       # [B, N] f32
    out = np.full((b, s, 128), 127 * nc if mode == "slot" else 0, np.float32)
    for bi in range(b):
        for s0 in range(0, s, CPW):
            lo = [0] * CPW
            for c in range(nc):
                bits = hit[bi, s0:s0 + CPW, c]                           # [g, lane, j]
                if not bits.any():
                    continue
                for g in range(CPW):
                    r = lo[g]
                    for t in np.flatnonzero(bits[g].any(-1)):
                        if r >= 128:
                            break
                        js = np.flatnonzero(bits[g, t])
                        for k, j in enumerate(js):
                            if r + k < 128:
                                lane = LANE_PTS * t + j
                                out[bi, s0 + g, r + k] = (127 * c + lane if mode == "slot"
                                                          else p[bi, 128 * c + lane])
                        r += len(js)
                    lo[g] = r
                if min(lo) >= 128:
                    break
    return _tile_sum(out) if mode == "tile_sum" else out


# (script, kernel, keyword arguments, the kernel's mode)
TPU_SCAN_KERNELS = (
    *(("onchip_r3b.py", "_abl_kernel", dict(stop=stop, fuse_inball=False), mode)
      for stop, mode in sorted(R3B_MODES.items())),
    ("onchip_r3b.py", "_abl_kernel", dict(stop=1, fuse_inball=True), "hits"),
    ("onchip_r3c.py", "_abl2_kernel", dict(with_scan=True), "count"),
    ("onchip_r3c.py", "_abl2_kernel", dict(with_scan=False), "count_noscan"),
    ("onchip_r3d.py", "_abl_kernel", dict(stop=3), "slot"),
    ("onchip_r3d.py", "_abl_kernel", dict(stop=4), "tile_sum"),
)


def _kernel_id(k):
    script, _, kw, _ = k
    return script.removesuffix(".py").removeprefix("onchip_") + "-" + "-".join(
        f"{key}={val}" for key, val in kw.items())


# The TPU bodies' gathered P: XLA sums the four planes and the chunks in one
# reduction whose order follows the hit's chunk (see
# test_tpu_body_sums_p_in_an_order_that_follows_the_chunk), so P differs from
# the model's ((x + y) + z) + feat in the last bits; r3d's stop 4 also sums
# its 32 centroids in another order. The largest gap read on either cloud is
# 1.19e-7 x max(1, max|out|) (gather, dense; the test prints its readings).
MODEL_TOL = {"gather": 1e-6, "tile_sum": 1e-6}


@pytest.mark.parametrize("kernel", TPU_SCAN_KERNELS, ids=_kernel_id)
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_model_matches_tpu_kernel(case, kernel):
    """The kernel's arithmetic against the TPU kernel body in interpret
    mode: bit-equal for the counts (hits, count, count_noscan, slot); within
    ``MODEL_TOL`` x max(1, max|out|) where the TPU body sums P otherwise."""
    script, name, kw, mode = kernel
    out = _scan_model(*_scan_case(case), mode)
    ref = _tpu_scan_case(case, script, name, **kw)
    tol = MODEL_TOL.get(mode, 0.0)
    if tol:
        ulps = np.abs(out.view(np.int32).astype(np.int64) - ref.view(np.int32))
        print(f"{case} {_kernel_id(kernel)}: {np.count_nonzero(ulps)} values differ, by at most "
              f"{ulps.max()} ulps, {np.abs(out - ref).max() / max(1.0, np.abs(ref).max()):.3g}"
              f" x max(1, max|out|)")
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))
    else:
        np.testing.assert_array_equal(out, ref)


def _add_trees(leaves=(0, 1, 2, 3)):
    """Every order of summing ``leaves``: each binary tree over them, up to
    swapping the operands of an add (f32 addition commutes), with its name."""
    if len(leaves) == 1:
        yield leaves[0], "xyzf"[leaves[0]]
        return
    for k in range(1, len(leaves)):
        for left in itertools.combinations(leaves, k):
            right = tuple(v for v in leaves if v not in left)
            if left[0] > right[0]:
                continue
            for lt, ln in _add_trees(left):
                for rt, rn in _add_trees(right):
                    yield (lt, rt), f"({ln}+{rn})"


def _add(tree, vals):
    if isinstance(tree, int):
        return vals[:, tree]
    return _add(tree[0], vals) + _add(tree[1], vals)


@pytest.mark.parametrize("stop", [4, 5])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_tpu_body_sums_p_in_an_order_that_follows_the_chunk(case, stop):
    """Why the model is held to r3b's stops 4-5 within a tolerance: each
    value the TPU body gathers is the hit's four planes x, y, z, feat summed
    in one of the 15 orders of four adds, one order for all the hits of a
    chunk; on the dense cloud no one order fits every chunk, so no fixed
    order of the model's (nor the plain version's) adds can be bit-equal."""
    xyz, feat, cent = _scan_case(case)
    ref = _tpu_scan_case(case, "onchip_r3b.py", "_abl_kernel", stop=stop, fuse_inball=False)
    d = xyz[:, None] - cent[:, :, None]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    hit = d2 < np.float32(0.05 * 0.05)
    planes = np.concatenate([xyz, feat[..., :1]], -1)                    # [B, N, 4] f32
    trees = list(_add_trees())
    assert len(trees) == 15
    fits = {}                                  # chunk -> which orders fit all its hits
    for bi, si in np.ndindex(*hit.shape[:2]):
        idx = np.flatnonzero(hit[bi, si])[:128]
        assert not ref[bi, si, len(idx):].any()
        got = ref[bi, si, :len(idx)]
        match = np.stack([_add(t, planes[bi, idx]) == got for t, _ in trees])   # [15, hits]
        assert match.any(0).all(), "a gathered value is no order of the hit's four planes"
        for c in np.unique(idx // 128):
            fits[c] = fits.get(c, True) & match[:, idx // 128 == c].all(1)
    print(f"{case} stop {stop}: orders by chunk " + "; ".join(
        f"{c}: {[n for (_, n), ok in zip(trees, f) if ok]}" for c, f in sorted(fits.items())))
    assert all(f.any() for f in fits.values())
    if case == "dense":
        assert not np.logical_and.reduce(list(fits.values())).any()


@pytest.mark.parametrize("mode", scan.SCAN_MODES)
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_model_matches_plain(case, mode):
    xyz, feat, cent = _scan_case(case)
    ref = scan.scan_plain(*map(torch.from_numpy, (xyz, feat, cent)), 0.05, mode).numpy()
    np.testing.assert_array_equal(_scan_model(xyz, feat, cent, mode), ref)


def test_dense_inputs_pass_128_early():
    """The dense cloud has what the model's stop relies on: the first warp's
    four centroids pass 128 hits before the last chunk, with hits after it;
    centroid 4 passes 128 beside three that do not."""
    xyz, _, cent = _scan_case("dense")
    dx = xyz[:, None] - cent[:, :, None]
    d2 = (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]) + dx[..., 2] * dx[..., 2]
    hit = d2 < np.float32(0.05 * 0.05)
    nc = xyz.shape[1] // 128
    running = hit.reshape(*hit.shape[:2], nc, 128).sum(-1).cumsum(-1)     # [B, S, nc]
    first_full = (running[0, :CPW] >= 128).argmax(-1)
    assert (running[0, :CPW, -1] >= 128).all() and first_full.max() < nc - 2
    assert hit[0, :CPW, 128 * (first_full.max() + 1):].any(-1).all()
    assert running[0, 4, -1] > 128 and (running[0, 5:8, -1] < 128).all()
    assert (running[..., -1] > 0).all()        # every centroid is a cloud point or near one


def test_scan_probe_bound_uses_the_non_fma_rate():
    """A scan probe's bound at the scripts' shape: 9 B S N uncontracted f32
    operations (8 of the distance and its compare) over the card's non-FMA
    f32 rate, 132 SMs x 128 lanes x 1.98 GHz."""
    b, n, s = 256, 6272, 512
    xyz, feat = torch.zeros(b, n, 3), torch.zeros(b, n, 1)
    cent = torch.zeros(b, s, 3)
    assert session.F32_NOFMA_OPS == pytest.approx(33.45e12, rel=1e-3)
    for probe in session._scan_probes(xyz, feat, cent):
        ms, by = probe.bound()
        assert by == "operations"
        assert ms == pytest.approx(1e3 * 9 * b * s * n / session.F32_NOFMA_OPS, rel=1e-12)
        assert ms == pytest.approx(0.2211, abs=1e-4)


def _tpu_micro(a, idx, op, reps, rb):
    kernel = functools.partial(_tpu_kernel("onchip_r3d.py", "_micro_kernel"), op=op, reps=reps)
    nblk = a.shape[0] // rb
    return np.asarray(pl.pallas_call(
        kernel, grid=(nblk,),
        in_specs=[pl.BlockSpec((rb, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8 * nblk, 128), jnp.float32), interpret=True,
    )(a, idx))


MICRO_TOL = {"gather": 0.0, "roll_narrow": 0.0, "roll_wide": 0.0, "vadd": 1e-6,
             "bd_matmul": 1e-5}


@pytest.mark.parametrize("reps", [8, 32])
@pytest.mark.parametrize("op", micro.MICRO_OPS)
def test_micro_probe_matches_tpu_kernel(op, reps):
    rng = np.random.default_rng(6)
    rb = 98
    a = rng.uniform(0, 1, (2 * rb, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (2 * rb, 128)).astype(np.int32)
    ref = _tpu_micro(a, idx, op, reps, rb)
    out = micro.micro_probe(torch.from_numpy(a), torch.from_numpy(idx), op, reps, rb).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=MICRO_TOL[op] * max(1.0, np.abs(ref).max()))


def test_micro_probe_bounds_use_the_non_fma_rate():
    """The micro probes' bounds at the session's shape (25,088 x 128 in blocks
    of 1,568 rows): every add and multiply at the card's non-FMA f32 rate,
    and gather's shared-memory reads (reps x rows x 128 words) at 32 words a
    clock a SM."""
    rows, rb = session.FULL["rows"], session.FULL["rb"]
    a, idx = torch.zeros(rows, 128), torch.zeros(rows, 128, dtype=torch.int32)
    bounds = {p.name: p.bound() for p in session._micro_probes(a, idx, rb) if p.timed}
    assert session.SMEM_WORDS_PER_S == pytest.approx(8.36e12, rel=1e-3)
    expect = {"micro_vadd_r32": (0.00614, "operations"), "micro_vadd_r8": (0.0039, "bytes"),
              "micro_roll_wide_r8": (0.0039, "bytes"), "micro_roll_wide_r32": (0.0039, "bytes"),
              "micro_gather_r32": (0.0123, "operations"), "micro_gather_r8": (0.0077, "bytes")}
    for name, (ms, by) in expect.items():
        assert bounds[name][1] == by, name
        assert bounds[name][0] == pytest.approx(ms, abs=5e-5), name
    assert bounds["micro_vadd_r32"][0] == pytest.approx(
        1e3 * 2 * 32 * rows * 128 / session.F32_NOFMA_OPS, rel=1e-12)
    assert bounds["micro_gather_r32"][0] == pytest.approx(
        1e3 * 32 * rows * 128 / session.SMEM_WORDS_PER_S, rel=1e-12)
    assert bounds["micro_bd_matmul_r32"] == pytest.approx(bounds["micro_vadd_r32"])


def test_probe_bounds_take_the_launch_floor():
    """On the card no probe's bound is below the launch floor (an empty
    kernel in the same loop): where the floor is the larger time it sets the
    bound, as ``launch``; elsewhere the bytes or operations do."""
    probes = {p.name: p for p in session.make_probes("cpu")}
    scratch, vadd = probes["scratch_when"], probes["micro_vadd_r32"]
    work_ms, work_by = scratch.bound()
    assert work_by == "bytes" and work_ms < 1e-5
    assert scratch.bound(0.0021) == (0.0021, "launch")
    assert vadd.bound(1e-9) == vadd.bound() and vadd.bound()[1] == "operations"


# The kernels' work layouts (csrc/probes.cu), modelled in numpy and held
# bit-equal to the plain version and to the TPU body: the roll's rings in
# registers (micro.roll_layout), gather's outputs sorted by the bank of their
# start, vadd's four float4s of one row a thread.
F32 = np.float32
GATHER_PITCH = 160     # a staged row, then its first 32 values again
GATHER_LIST = 64 * 128 + 32 * 2 * 32 + 32 * 64   # the sorted list's entries


def _roll_model(a, rb, reps, narrow):
    """``probe_roll_kernel``: thread u of a ring holds rows kC u + j (rows past
    rb hold 0); a rep sends each thread's last row (the ragged last thread
    its row ``last - 1``) to thread u + 1, the ring's last thread to thread
    0, then shifts its registers down one slot with 1 added. -> (out
    [8 rows / rb, 128], the ring's rows at each thread, for the checks)."""
    lay = micro.roll_layout(rb)
    kc, threads = lay.rows_per_thread, 32 * lay.warps
    blocks = a.reshape(-1, rb, 128)[..., :1 if narrow else 128]          # [nblk, rb, cols]
    rows_of = kc * np.arange(threads)[:, None] + np.arange(kc)[None]     # [u, j]
    held = rows_of < rb
    regs = np.where(held[None, None], np.swapaxes(blocks, 1, 2)[:, :, np.minimum(rows_of, rb - 1)],
                    F32(0))                                              # [nblk, cols, u, j]
    for _ in range(reps):
        send = regs[..., kc - 1].copy()
        send[..., lay.used - 1] = regs[..., lay.used - 1, lay.last - 1]
        got = np.concatenate([send[..., lay.used - 1:lay.used], send[..., :-1]], -1)
        shifted = np.empty_like(regs)
        shifted[..., 1:] = regs[..., :-1] + F32(1)
        shifted[..., 0] = got + F32(1)
        regs = shifted
    out = np.zeros((blocks.shape[0], micro.OUT_ROWS, blocks.shape[2]), F32)
    for row in range(micro.OUT_ROWS):
        out[:, row] = regs[:, :, row // kc, row % kc]
    out = np.broadcast_to(out, out.shape[:2] + (128,)) if narrow else out
    return out.reshape(-1, 128), rows_of[:lay.used][held[:lay.used]]


def _gather_model(a, idx, rb, reps):
    """``probe_micro_kernel<gather>``: each 64-row block stages its rows at a
    pitch of 160 (the first 32 values again), bins its outputs by the bank of
    their start (idx mod 32; the pitch is 0 mod 32) in a counting sort, and
    group g takes the g-th output of each bank, lane b bank b's (a lane past
    its bank's outputs reads a dummy window on bank b). Each sum adds its
    window in chunks of 32 from (idx + c) mod 128, in rep order. The sorted
    list holds 2-byte entries, bank b's from 2b on in a region of a multiple
    of 64. Checks that every output is taken once, that the list fits, and
    that every group's list read and its read at every rep each hit 32
    distinct banks. -> out [8 rows / rb, 128]."""
    rows = a.shape[0]
    sums = np.zeros((rows, 128), F32)
    blk_rows = micro.GATHER_ROWS
    for r0 in range(0, rows, blk_rows):
        nr = min(blk_rows, rows - r0)
        staged = np.concatenate([a[r0:r0 + nr], a[r0:r0 + nr, :32]], 1)   # [nr, 160]
        start = idx[r0:r0 + nr].reshape(-1)                              # output o = row 128 + col
        key = start & 31
        order = np.argsort(key, kind="stable")                           # the counting sort
        count = np.bincount(key, minlength=32)
        first = np.cumsum(count) - count
        size = (2 * np.arange(32) + count + 63) // 64 * 64
        place = np.cumsum(size) - size + 2 * np.arange(32)              # bank b's first entry
        assert size.sum() <= GATHER_LIST
        groups = count.max()
        taken = np.zeros(nr * 128, int)
        lane = np.arange(32)
        for g in range(groups):
            live = g < count
            words = (place + g)[live] // 2                               # 2-byte entries
            assert len(np.unique(words % 32)) == live.sum()
            o = np.where(live, order[np.minimum(first + g, nr * 128 - 1)], 0)
            s = np.where(live, start[o], lane)                           # dummy: row 0 at `lane`
            assert (s & 31 == lane).all()
            row = np.where(live, o // 128, 0)
            acc = np.zeros(32, F32)
            for c in range(0, reps, 32):
                w = (s + c) & 127
                for r in range(min(32, reps - c)):
                    addr = row * GATHER_PITCH + w + r
                    assert len(np.unique(addr % 32)) == 32                # one wavefront
                    acc = acc + staged[row, w + r]
            taken[o[live]] += 1
            sums[r0 + row[live], o[live] % 128] = acc[live]
        assert (taken == 1).all()
    out_rows = np.arange(rows) % rb < micro.OUT_ROWS
    return sums[out_rows]


def _vadd_model(a, rb, reps):
    """``probe_micro_kernel<vadd>``: thread t takes float4s 4t .. 4t + 3, one
    row's 16 values, and its store guard once. -> out [8 rows / rb, 128]."""
    rows = a.shape[0]
    q = 4 * np.arange(rows * 32 // 4)[:, None] + np.arange(4)[None]      # [thread, k]
    assert (q // 32 == (q[:, :1] // 32)).all()                          # one row a thread
    assert np.array_equal(np.sort(q.reshape(-1)), np.arange(rows * 32))  # each float4 once
    v = a.reshape(-1, 4)[q].reshape(-1, 16)                              # [thread, 16 chains]
    for _ in range(reps):
        v = v * F32(micro.VADD_SCALE) + F32(1)
    keep = (q[:, 0] // 32) % rb < micro.OUT_ROWS                         # the guard, once
    return v[keep].reshape(-1, 128)


@functools.lru_cache(maxsize=None)
def _layout_case(rb):
    rng = np.random.default_rng(9)
    rows = rb if rb > 98 else 2 * rb
    a = rng.uniform(0, 1, (rows, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (rows, 128)).astype(np.int32)
    return a, idx


@functools.lru_cache(maxsize=None)
def _tpu_micro_case(op, rb, reps):
    a, idx = _layout_case(rb)
    return _tpu_micro(a, idx, op, reps, rb)


def _layout_model(op, a, idx, rb, reps):
    if op.startswith("roll"):
        out, rows = _roll_model(a, rb, reps, op == "roll_narrow")
        assert np.array_equal(np.sort(rows), np.arange(rb))             # each row held once
        return out
    if op == "gather":
        return _gather_model(a, idx, rb, reps)
    return _vadd_model(a, rb, reps)


@pytest.mark.parametrize("reps", [0, 1, 8, 32])
@pytest.mark.parametrize("rb", [98, 1568])
@pytest.mark.parametrize("op", ["roll_narrow", "roll_wide", "gather", "vadd"])
def test_micro_layout_model_matches_plain_and_tpu_kernel(op, rb, reps):
    """The kernels' layouts compute the probe's function: bit-equal to the
    plain version, and to the TPU body in interpret mode (vadd within 1e-6 x
    max(1, max|out|): XLA may contract it into an FMA)."""
    a, idx = _layout_case(rb)
    out = _layout_model(op, a, idx, rb, reps)
    plain = micro.micro_plain(torch.from_numpy(a), torch.from_numpy(idx), op, reps, rb).numpy()
    np.testing.assert_array_equal(out, plain)
    ref = _tpu_micro_case(op, rb, reps)
    np.testing.assert_allclose(out, ref, rtol=0, atol=MICRO_TOL[op] * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("rb", [8, 33, 1000, 2049, 5000])
def test_roll_layout_model_at_other_ring_sizes(rb):
    """The roll's ragged last thread and rings over several warps: the model
    holds each row once and equals the plain version."""
    rng = np.random.default_rng(rb)
    a = rng.uniform(0, 1, (2 * rb, 128)).astype(np.float32)
    lay = micro.roll_layout(rb)
    assert lay.used <= 32 * lay.warps and 1 <= lay.last <= lay.rows_per_thread
    for op in ("roll_narrow", "roll_wide"):
        for reps in (0, 3, lay.rows_per_thread + 1):
            out = _layout_model(op, a, None, rb, reps)
            plain = micro.micro_plain(torch.from_numpy(a), torch.zeros(2 * rb, 128, dtype=torch.int32),
                                      op, reps, rb).numpy()
            np.testing.assert_array_equal(out, plain)


def test_bd_matmul_plain_covers_every_row():
    """bd_matmul's plain version over every row (the TPU body's full product,
    which the kernel keeps through its group sums): reps times the exclusive
    prefix of bf16(a) down each 49-row group, and the group sums of
    accumulators and values in row order."""
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (2 * 98, 128)).astype(np.float32)
    acc, sums = micro.bd_matmul_plain(torch.from_numpy(a), 8)
    vals = torch.from_numpy(a).to(torch.bfloat16).double().numpy().reshape(-1, 49, 128)
    prefix = np.cumsum(vals, 1) - vals
    np.testing.assert_allclose(acc.numpy(), 8 * prefix, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sums.numpy(), (8 * prefix + vals).sum(1), rtol=1e-5)
    out, group_sums = micro.micro_probe(torch.from_numpy(a), torch.zeros(196, 128, dtype=torch.int32),
                                        "bd_matmul", 8, 98, return_group_sums=True)
    assert torch.equal(group_sums, sums)
    assert torch.equal(out, acc.view(2, 98, 128)[:, :8].reshape(16, 128))


def _prefix_model(a, reps, tie=1):
    """``probe_prefix_kernel``'s rep loop in float32 numpy, one (group, lane)
    a column: the values rounded to bf16 once; each rep's running sum starts
    at abs(acc[tie]) * 0 (the kernel ties to row 1), then acc[j] += run,
    run += v[j] in row order; the group sums (acc[j] + v[j]) in row order.
    -> (acc [rows / 49, 49, 128], sums [rows / 49, 128])."""
    vals = torch.from_numpy(a).to(torch.bfloat16).float().numpy().reshape(-1, micro.GROUP, 128)
    acc = np.zeros_like(vals)
    for _ in range(reps):
        run = np.abs(acc[:, tie]) * F32(0)
        for j in range(micro.GROUP):
            acc[:, j] = acc[:, j] + run
            run = run + vals[:, j]
    sums = np.zeros_like(vals[:, 0])
    for j in range(micro.GROUP):
        sums = (sums + acc[:, j]) + vals[:, j]
    return acc, sums


@pytest.mark.parametrize("tie", [1, 48])
@pytest.mark.parametrize("reps", [0, 1, 8, 33])
@pytest.mark.parametrize("rb", [98, 1029])
def test_prefix_model_matches_plain_bit_for_bit(rb, reps, tie):
    """The kernel's rep loop (a rep's running sum started at |acc[tie]| * 0,
    not 0: row 1 in the kernel, or the group's last row) equals
    ``bd_matmul_plain`` bit for bit, signs of zero included, on signed
    inputs with +0.0 and -0.0 planted: in single entries, in the first rows
    of groups, and down a whole group in some lanes."""
    rng = np.random.default_rng(rb + reps)
    a = rng.uniform(-1, 1, (2 * rb, 128)).astype(np.float32)
    a[rng.random(a.shape) < 0.05] = 0.0
    a[rng.random(a.shape) < 0.05] = -0.0
    a[:5, :16] = -0.0
    a[micro.GROUP:micro.GROUP + 3, 16:32] = 0.0
    a[2 * micro.GROUP:3 * micro.GROUP, 32:40] = -0.0
    assert np.signbit(a[a == 0]).any() and not np.signbit(a[a == 0]).all()
    acc, sums = _prefix_model(a, reps, tie)
    ref_acc, ref_sums = (t.numpy() for t in micro.bd_matmul_plain(torch.from_numpy(a), reps))
    np.testing.assert_array_equal(acc.view(np.uint32), ref_acc.view(np.uint32))
    np.testing.assert_array_equal(sums.view(np.uint32), ref_sums.view(np.uint32))
    out, group_sums = micro.micro_probe(torch.from_numpy(a), torch.zeros(2 * rb, 128, dtype=torch.int32),
                                        "bd_matmul", reps, rb, return_group_sums=True)
    model_out = acc.reshape(2, rb, 128)[:, :micro.OUT_ROWS].reshape(-1, 128)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), model_out.view(np.uint32))
    np.testing.assert_array_equal(group_sums.numpy().view(np.uint32), sums.view(np.uint32))


def test_wide_gather_matches_tpu_kernel():
    rng = np.random.default_rng(7)
    tab = rng.normal(size=(2, 224, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (2, 224, 2048)).astype(np.int32)
    ref = np.asarray(pl.pallas_call(
        _tpu_kernel("onchip_r4a.py", "_wide_kernel"), grid=(2,),
        in_specs=[pl.BlockSpec((1, 224, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 224, 2048), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 4, 2048), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((2, 4, 2048), jnp.float32), interpret=True,
    )(tab, idx))
    out = design.wide_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_scratch_probe_matches_tpu_kernel():
    ref = np.asarray(pl.pallas_call(
        _tpu_kernel("onchip_r4a.py", "_scratch_kernel"), grid=(4,),
        out_specs=pl.BlockSpec((1, 8, 128), lambda j: (j, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((4, 8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32)], interpret=True,
    )())
    np.testing.assert_array_equal(design.scratch_probe(4, "cpu").numpy(), ref)


def test_probe_wrappers_reject_what_the_kernels_do_not_take():
    xyz, feat, cent = map(torch.from_numpy, session.edge_scan_inputs(0))
    with pytest.raises(ValueError, match="multiple"):
        scan.scan_probe(xyz[:, :300].contiguous(), feat[:, :300].contiguous(), cent, 0.05, "hits")
    with pytest.raises(ValueError, match="multiple"):
        scan.scan_probe(xyz, feat, cent[:, :40].contiguous(), 0.05, "hits")
    big = scan.MAX_POINTS + 128   # past what the kernel stages in shared memory
    with pytest.raises(ValueError, match="up to"):
        scan.scan_probe(torch.zeros(1, big, 3), torch.zeros(1, big, 1), cent[:1], 0.05, "hits")
    with pytest.raises(ValueError, match="unknown scan mode"):
        scan.scan_probe(xyz, feat, cent, 0.05, "stop6")
    a = torch.zeros(196, 128)
    with pytest.raises(TypeError):
        micro.micro_probe(a, torch.zeros(196, 128, dtype=torch.int64), "gather", 8, 98)
    with pytest.raises(ValueError, match="bd_matmul"):
        micro.micro_probe(a, torch.zeros(196, 128, dtype=torch.int32), "bd_matmul", 8, 28)
    with pytest.raises(ValueError, match="group sums"):
        micro.micro_probe(a, torch.zeros(196, 128, dtype=torch.int32), "vadd", 8, 98, True)
    with pytest.raises(ValueError):
        design.wide_gather(torch.zeros(1, 224, 128), torch.zeros(1, 224, 2047, dtype=torch.int32))
    shifted = torch.zeros(224 * 2048 + 1, dtype=torch.int32)[1:].view(1, 224, 2048)
    with pytest.raises(ValueError, match="16-byte"):
        design.wide_gather(torch.zeros(1, 224, 128), shifted)
    with pytest.raises(ValueError, match="all be on the CPU"):
        scan.scan_probe(xyz.to("meta"), feat, cent, 0.05, "hits")


def test_session_runs_on_the_cpu(capsys):
    """``python -m mpinets_torch.probes --device cpu``: every probe and the
    edge-case scan probes checked at small shapes, nothing timed."""
    assert probes_main.main(["--device", "cpu", "--seed", "3"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert recs[0]["kind"] == "device" and recs[0]["device"] == "cpu"
    assert recs[0]["launch_floor_ms"] is None
    parity = [r for r in recs if r["kind"] == "parity"]
    names = {r["name"] for r in parity}
    assert {f"scan_{mode}" for mode in scan.SCAN_MODES} <= names
    assert {f"micro_{op}_r{r}" for op in micro.MICRO_OPS for r in session.REPS} <= names
    assert {f"micro_bd_matmul_r{r}_group_sums" for r in session.REPS} <= names
    assert {"wide_gather_b2", "scratch_when"} <= names
    assert sum(n.startswith("edge_") for n in names) == len(scan.SCAN_MODES)
    assert sum(n.startswith("dense_") for n in names) == len(scan.SCAN_MODES)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in parity)
    assert not [r for r in recs if r["kind"] == "time"]


def test_reps_sweep_needs_a_card():
    """``python -m mpinets_torch.probes.reps`` times on the card only."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sweep would run")
    from mpinets_torch.probes import reps
    assert reps.OPS == micro.MICRO_OPS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reps.main([])
    with pytest.raises(ValueError, match="CUDA device"):
        session.empty_launch("cpu")


def test_session_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes_main.main([])
