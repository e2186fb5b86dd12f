"""FPS: the port's plain version against the JAX package, and the launch
plan of the CUDA kernel.

On the CPU ``ops.furthest_point_sample_with_coords`` computes
``ops.fps_plain``; it is held index for index and coordinate for coordinate
against ``mpinets_tpu.kernels.pallas_ops.furthest_point_sample_with_coords``
in interpret mode (``impl`` v1 and v2) and index for index against the JAX
oracle (``mpinets_tpu.kernels.pointnet.furthest_point_sample``), on clouds
with exact ties and duplicates, N not a multiple of 32 or 128, npoint == N,
in f32 and bf16 (``tests/torch_fps_cases.py``). ``tests/test_torch_cuda.py``
holds the kernel against ``fps_plain`` on the card, for every class of plan.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.kernels import ops  # noqa: E402
from mpinets_tpu.kernels import pallas_ops  # noqa: E402
from mpinets_tpu.kernels import pointnet as jpn  # noqa: E402

import torch_fps_cases as cases  # noqa: E402  (tests dir is on sys.path under pytest)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", cases.KINDS)
@pytest.mark.parametrize("case", cases.CPU_CASES, ids=lambda c: "B{}-N{}-S{}".format(*c))
def test_fps_plain_matches_pallas_and_oracle(case, kind, dtype):
    b, n, npoint = case
    xyz = cases.cloud(kind, b, n, seed=n + b)
    x = torch.from_numpy(xyz).to(getattr(torch, dtype))
    assert torch.equal(x.float(), torch.from_numpy(xyz))  # the grid is exact in bf16
    idx, coords = ops.furthest_point_sample_with_coords(x, npoint)
    assert idx.dtype == torch.int32 and idx.shape == (b, npoint)
    assert coords.dtype == x.dtype and coords.shape == (b, npoint, 3)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jpn.furthest_point_sample(jnp.asarray(xyz), npoint)))
    for impl in ("v1", "v2"):
        pidx, pcoords = pallas_ops.furthest_point_sample_with_coords(
            jnp.asarray(xyz).astype(dtype), npoint, interpret=True, impl=impl)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
        np.testing.assert_array_equal(coords.float().numpy(),
                                      np.asarray(pcoords.astype(jnp.float32)))
    if kind == "ties" and npoint > 125:  # every grid position picked: the rest is index 0
        assert (idx[:, 125:] == 0).all()


# The main paths' shapes: the server (B=1), validation (B=3), train (B=10,
# 64), the rollouts (B=256) at the 6272-point cloud and its 512 centroids;
# the small-cloud trainer's 192 and 16 points.
MAIN_PLANS = {
    (1, 6272): (224, 8, 4), (3, 6272): (224, 8, 4), (10, 6272): (224, 8, 4),
    (64, 6272): (416, 8, 2), (256, 6272): (800, 8, 1),
    **{(b, 512): (128, 4, 1) for b in (1, 3, 10, 64, 256)},
    (4, 192): (96, 2, 1), (4, 16): (32, 1, 1),
}


def test_fps_plan_pins_the_main_path_and_covers_every_cloud(monkeypatch):
    for (b, n), plan in MAIN_PLANS.items():
        assert ops.fps_plan(b, n) == ops.FpsPlan(*plan), (b, n)
    # a given cluster size (the plans chip_smoke.py compares), raised where it cannot hold N
    assert [tuple(ops.fps_plan(3, 6272, cluster=c)) for c in ops.FPS_CLUSTERS] == [
        (800, 8, 1), (416, 8, 2), (224, 8, 4), (128, 8, 8)]
    assert ops.fps_plan(1, 8192, cluster=1) == ops.FpsPlan(512, 8, 2)
    assert ops.fps_plan(20, 2048) == ops.FpsPlan(64, 8, 4)  # a cluster's blocks: 8 a thread
    for c in (0, 3, 16):
        with pytest.raises(ValueError, match="cluster"):
            ops.fps_plan(1, 6272, cluster=c)
    for b in (1, 2, 3, 4, 10, 33, 34, 64, 66, 67, 132, 256, 4096):
        for n in (*range(1, 300), *range(300, ops.FPS_MAX_POINTS + 1, 97),
                  2047, 2048, 6400, 6401, ops.FPS_MAX_POINTS):
            plan = ops.fps_plan(b, n)
            threads, p, cluster = plan
            assert ops.fps_plan_ok(n, plan), (b, n, plan)
            assert threads * p * cluster >= n and threads // 32 * cluster <= 32
            assert threads <= (800 if p == 8 else 1024) and (cluster == 1 or p == 8)
            # a cluster only where the batch leaves SMs idle, or above one block's points
            assert cluster == 1 or b * cluster <= ops.FPS_SMS or n > 800 * 8
            assert cluster <= ops.FPS_PLAN_MAX_CLUSTER
    # what the kernel does not take
    assert not ops.fps_plan_ok(6272, ops.FpsPlan(1024, 8, 1))    # above 800 threads at 8 points
    assert not ops.fps_plan_ok(6272, ops.FpsPlan(800, 4, 2))     # 50 warps of records
    assert not ops.fps_plan_ok(100, ops.FpsPlan(96, 1, 1))       # does not cover N
    assert not ops.fps_plan_ok(100, ops.FpsPlan(100, 1, 1))      # not whole warps
    assert not ops.fps_plan_ok(6272, ops.FpsPlan(256, 8, 8))     # 64 warps of records
    assert not ops.fps_plan_ok(6272, ops.FpsPlan(64, 8, 16))     # no cluster of 16
    assert not ops.fps_plan_ok(2048, ops.FpsPlan(128, 4, 4))     # a cluster holds 8 a thread
    for b, n in ((0, 100), (1, 0), (1, ops.FPS_MAX_POINTS + 1)):
        with pytest.raises(ValueError, match="FPS_MAX_POINTS"):
            ops.fps_plan(b, n)
    # the wrapper's kernel path refuses them before it touches a device
    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    ops.reset_launches()
    with pytest.raises(ValueError, match="FPS_MAX_POINTS"):
        ops.furthest_point_sample_with_coords(torch.zeros(1, ops.FPS_MAX_POINTS + 1, 3), 8)
    with pytest.raises(ValueError, match="npoint"):
        ops.furthest_point_sample_with_coords(torch.zeros(2, 100, 3), 101)
    with pytest.raises(TypeError):
        ops.furthest_point_sample_with_coords(torch.zeros(2, 100, 3, dtype=torch.float64), 8)
    assert not ops.LAUNCHES["fps"] and not ops.FPS_LAUNCHES_BY_PLAN
