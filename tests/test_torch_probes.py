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


def _check_scan(script, name, mode, tol, **kw):
    xyz, feat, cent = session.edge_scan_inputs(5)
    ref = _tpu_scan(script, name, xyz, feat, cent, **kw)
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
    parity = [r for r in recs if r["kind"] == "parity"]
    names = {r["name"] for r in parity}
    assert {f"scan_{mode}" for mode in scan.SCAN_MODES} <= names
    assert {f"micro_{op}_r{r}" for op in micro.MICRO_OPS for r in session.REPS} <= names
    assert {f"micro_bd_matmul_r{r}_group_sums" for r in session.REPS} <= names
    assert {"wide_gather_b2", "scratch_when"} <= names
    assert sum(n.startswith("edge_") for n in names) == len(scan.SCAN_MODES)
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for r in parity)
    assert not [r for r in recs if r["kind"] == "time"]


def test_session_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes_main.main([])
