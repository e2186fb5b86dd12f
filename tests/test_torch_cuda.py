"""The hand-written CUDA kernels against their plain versions, on the card.

Every kernel test here is marked ``cuda`` and skips without a CUDA device:
a CUDA kernel has no interpret mode. Unmarked tests check, on the CPU, that
the inputs built for the SA kernels' tiles do what they are built for. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: FPS indices and coordinates exact (the distance code is never
contracted into FMAs), for every class of launch plan; SA index arrays and
raw blocks exact; SA features 1e-5 in f32 (sums in another order) and 1e-2
in bf16 (one bf16 ulp of an activation; relative to max(1, max|f|) in the
tensor-core and CUDA-core cases); the SA backward kernel's cotangents
within 1e-4 relative L2 of its plain version's, tensor by tensor, under
weights whose every layer has one nonzero term an output (dyadic values),
so that the forward's activations, maxima and ties are the same bit for bit
in any summation order (with dense weights, rows within f32 rounding of a
max may swap, and a bf16 rounding flip can move a whole channel's
cotangent to another row); the fused
train path's f32 parameter gradients, kernels against plain versions,
atol 2e-5 + 1e-4 max|g| (``test_fused_train.py``), and its bf16 ones
within sqrt(2) times the larger of the tensor's and the whole model's
bf16-to-f32 relative L2 distance (``chip_smoke.py``'s gate: kernel and
plain round their sums apart, which moves bf16 maxima); the TPU probe kernels
(``csrc/probes.cu``) bit-equal to their plain versions, which round and sum
as the kernels do; the ball-query kernel's idx and count equal to its plain
version's. The batched IK (plain torch) on the card against the CPU: f64
residual, Jacobian and one DLS step within 1e-8, flags equal away from the
tolerances, every accepted solution valid on the CPU within 1e-5.
"""

import numpy as np
import pytest
import torch

from mpinets_torch.data import synthetic
from mpinets_torch.kernels import ops
from mpinets_torch.model import fused_train
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.train import learner
from mpinets_torch.probes import design, micro, scan, session

import torch_fps_cases as fps_cases  # (tests dir is on sys.path under pytest)
import torch_select_cases as select_cases
from torch_sa_cases import exact_mlp, grid_cloud, rel_l2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sa_inputs(seed, b=3, n=700, s=37, c=3, widths=(32, 16, 40)):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.6, 0.6, (b, n, 3)).astype(np.float32)
    feat = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    cent = xyz[:, :s].copy()
    cent[0, 1] = (5.0, 5.0, 5.0)  # no neighbour: the zero-row / idx-0 case
    dims = (3 + c,) + tuple(widths)
    weights = []
    for i in range(3):
        weights.append(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32) * 0.2)
        weights.append(rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.2)
    return [torch.from_numpy(a) for a in (xyz, feat, cent, *weights)]


def _stage_args(args, device, dtype=torch.bfloat16):
    """(xyz, features, centroids, SAWeights) on device."""
    xyz, feat, cent, *weights = (a.to(device) for a in args)
    return xyz, feat, cent, ops.prepare_sa_weights(*weights, compute_dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", fps_cases.CARD_KINDS)
@pytest.mark.parametrize("case", fps_cases.CARD_CASES, ids=lambda c: "B{}-N{}-S{}".format(*c))
def test_fps_kernel_matches_plain(cuda, case, kind, dtype):
    """Every class of plan the wrapper picks (tests/torch_fps_cases.py), on
    clouds with exact ties and duplicates and on a normal cloud whose
    distances round: both impls equal to the plain version, one launch
    each, counted under the plan."""
    b, n, npoint = case
    xyz = torch.from_numpy(fps_cases.cloud(kind, b, n, seed=n + b)).to(dtype)
    ref_idx, ref_coords = ops.fps_plain(xyz, npoint)
    plan = ops.fps_plan(b, n)
    for impl in ("v1", "v2"):
        before = ops.LAUNCHES["fps"], ops.FPS_LAUNCHES_BY_PLAN[plan]
        idx, coords = ops.furthest_point_sample_with_coords(xyz.to(cuda), npoint, impl=impl)
        torch.cuda.synchronize()
        assert (ops.LAUNCHES["fps"], ops.FPS_LAUNCHES_BY_PLAN[plan]) == (before[0] + 1,
                                                                          before[1] + 1)
        np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy())
        assert coords.dtype == dtype and torch.equal(coords.cpu(), ref_coords)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "normal"])
@pytest.mark.parametrize("case", fps_cases.CLUSTER_CASES, ids=lambda c: "B{}-N{}-S{}".format(*c))
def test_fps_kernel_every_cluster_matches_plain(cuda, monkeypatch, case, kind):
    """Every cluster size the kernel takes, the one the plan never picks too."""
    b, n, npoint = case
    xyz = torch.from_numpy(fps_cases.cloud(kind, b, n, seed=n + b))
    ref_idx, ref_coords = ops.fps_plain(xyz, npoint)
    for c in ops.FPS_CLUSTERS:
        plan = ops.fps_plan(b, n, cluster=c)
        monkeypatch.setattr(ops, "fps_plan", lambda *_, plan=plan: plan)
        before = ops.FPS_LAUNCHES_BY_PLAN[plan]
        idx, coords = ops.furthest_point_sample_with_coords(xyz.to(cuda), npoint)
        torch.cuda.synchronize()
        assert ops.FPS_LAUNCHES_BY_PLAN[plan] == before + 1, plan
        np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy(), err_msg=str(plan))
        assert torch.equal(coords.cpu(), ref_coords), plan
        monkeypatch.undo()


@pytest.mark.cuda
def test_fps_plan_rule_matches_the_kernel(cuda):
    """ops.fps_plan_ok, which chooses plans, and plan_ok in csrc/fps.cu,
    which refuses them, take the same plans."""
    for n in (1, 100, 2048, 6272, 8192):
        for cluster in (1, 2, 3, 4, 8, 16):
            for p in (1, 2, 3, 4, 8, 16):
                for threads in (*range(0, 1056 + 1, 32), 100):
                    plan = ops.FpsPlan(threads, p, cluster)
                    try:
                        ops.fps_plan_info(n, 1, plan)
                        taken = True
                    except RuntimeError as e:
                        taken = "CUDA error 1," not in str(e)  # cudaErrorInvalidValue: refused
                    assert taken == ops.fps_plan_ok(n, plan), (n, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sa_kernel_matches_plain(cuda, fast, dtype):
    args = _sa_inputs(11)
    fn = ops.sa_stage_fast if fast else ops.sa_stage
    kw = dict(radius=0.2, **({"window": 3} if fast else {}))
    counter = ops.mlp_launch_name("sa_fast" if fast else "sa", dtype)
    before = ops.LAUNCHES[counter]
    before_shape = ops.LAUNCHES_BY_SHAPE[(counter, 3, 700, 37)]
    if not fast:
        kw.update(impl="v8", centroids_in_cloud=True)
    feats, idx = fn(*_stage_args(args, cuda, dtype), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counter] == before + 1
    assert ops.LAUNCHES_BY_SHAPE[(counter, 3, 700, 37)] == before_shape + 1
    ref, ref_idx = fn(*_stage_args(args, "cpu", dtype), **kw)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(feats.cpu().numpy(), ref.numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = _stage_args(_sa_inputs(12), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sa_stage(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:],
                     radius=0.2)
    with pytest.raises(ValueError, match="padded input rows"):
        ops.sa_stage(args[0], args[1][..., :1].contiguous(), *args[2:], radius=0.2)
    with pytest.raises(TypeError):
        ops.sa_stage(args[0].double(), *args[1:], radius=0.2)
    with pytest.raises(ValueError):
        ops.sa_stage(args[0], *args[1:], radius=0.2, nsample=64)
    with pytest.raises(ValueError):
        ops.furthest_point_sample_with_coords(torch.zeros(1, 9000, 3, device=cuda), 10)
    with pytest.raises(ValueError):
        ops.sa_stage(args[0].cpu(), *args[1:], radius=0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sa_kernel_raw_block_matches_plain(cuda, dtype):
    """The raw block: bit-equal to the plain version's; launches count as
    sa_raw (sa_raw_f32 under f32)."""
    args = _sa_inputs(13)
    kw = dict(radius=0.2, impl="v8", centroids_in_cloud=True, return_raw=True)
    counter = ops.mlp_launch_name("sa_raw", dtype)
    before = ops.LAUNCHES[counter]
    feats, idx, raw = ops.sa_stage(*_stage_args(args, cuda, dtype), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counter] == before + 1
    ref, ref_idx, ref_raw = ops.sa_stage(*_stage_args(args, "cpu", dtype), **kw)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy())
    assert torch.equal(raw.cpu(), ref_raw)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(feats.cpu().numpy(), ref.numpy(), atol=tol, rtol=tol)
    # the inference launch of the same stage is unchanged by the raw output
    plain = ops.sa_stage(*_stage_args(args, cuda, dtype), radius=0.2, impl="v8",
                         centroids_in_cloud=True)
    assert torch.equal(plain[0], feats) and torch.equal(plain[1], idx)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["v3", "v5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sa_kernel_off_cloud_matches_plain(cuda, impl, dtype):
    """Centroids off the cloud (one with no neighbour: point 0's row)."""
    args = _sa_inputs(14)
    args[2][:, 2:9] += 0.011
    kw = dict(radius=0.2, impl=impl, centroids_in_cloud=False)
    counter = ops.mlp_launch_name("sa_v3", dtype)
    before = ops.LAUNCHES[counter]
    feats, idx = ops.sa_stage(*_stage_args(args, cuda, dtype), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counter] == before + 1
    ref, ref_idx = ops.sa_stage(*_stage_args(args, "cpu", dtype), **kw)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(feats.cpu().numpy(), ref.numpy(), atol=tol, rtol=tol)
    v8 = ops.sa_stage(*_stage_args(args, cuda, dtype), radius=0.2, impl="v8",
                      centroids_in_cloud=True)
    v5 = ops.sa_stage(*_stage_args(args, cuda, dtype), radius=0.2, impl="v5",
                      centroids_in_cloud=True)
    assert torch.equal(v5[0], v8[0]) and torch.equal(v5[1], v8[1])
    assert not torch.equal(feats[0, 1], v8[0][0, 1])  # the count==0 centroid


# ---------------------------------------------------------------------------
# The bf16 SA kernel on the tensor cores: every variant, real and odd widths,
# counts across the 16-row tile edges, rows past the count kept out of the max
# ---------------------------------------------------------------------------

WIDTHS = {"sa0": (1, (64, 64, 64), 0.1), "sa1": (64, (128, 128, 256), 0.3),
          "odd": (3, (36, 20, 40), 0.2)}   # C, (C1, C2, C3), radius
VARIANTS = {"sa": dict(impl="v8", centroids_in_cloud=True),
            "sa_raw": dict(impl="v8", centroids_in_cloud=True, return_raw=True),
            "sa_v3": dict(impl="v3", centroids_in_cloud=False),
            "sa_fast": None}
SPREAD = (0, 1, 15, 16, 17, 31, 127, 128, 200)  # in-ball points per centroid
# 49 centroids, so blocks of 8, 16 and 32 centroids (partial ones too) pack
# rows across centroids: 16 one-row centroids fill the first tile, one of
# 128 fills the next 8 tiles alone, and the rest put tile edges inside and
# between centroids (test_sa0_spread_puts_tile_edges_inside_and_between).
SPREAD_SA0 = (0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 1, 0, 0, 1, 128,
              2, 3, 5, 13, 15, 16, 17, 31, 200, 3, 5, 2, 1, 0, 13, 16,
              17, 31, 15, 16, 0, 1, 2, 3, 5, 13, 1, 1, 128, 0, 200, 3)
SPREAD_R = 0.1
# the count-spread cases: (counts, C, (C1, C2, C3)) at SA0 and SA1 widths
SPREADS = {"sa0": (SPREAD_SA0, 1, (64, 64, 64)), "sa1": (SPREAD, 64, (128, 128, 256))}


def _spread_inputs(seed, c=64, widths=(128, 128, 256), masked=False, b=2, spread=SPREAD):
    """Centroid i at (x0 - i, 0, 0) with spread[i] points inside its ball
    of radius SPREAD_R, shuffled among 400 points far from every ball.
    ``masked``: x0 = -20 and positive weights with W1's x row 1 and b1 = 1,
    so a zero raw row past the count (layer-1 input b1 - W1[:3]^T c, about
    21) would beat every real row (about 1 + sum feat W1) in the max-pool;
    else x0 = 0 and weights N(0, 0.2^2)."""
    rng = np.random.default_rng(seed)
    x0 = -20.0 if masked else 0.0
    cent = np.array([(x0 - i, 0.0, 0.0) for i in range(len(spread))], np.float32)
    xyz = []
    for _ in range(b):
        parts = [rng.uniform(-5, 5, (400, 3)) + (0, 0, 10)]
        for centre, k in zip(cent, spread):
            d = rng.normal(size=(k, 3))
            d *= 0.9 * SPREAD_R * rng.uniform(0, 1, (k, 1)) ** (1 / 3) / np.linalg.norm(
                d, axis=1, keepdims=True)
            parts.append(centre + d)
        pts = np.concatenate(parts)
        xyz.append(pts[rng.permutation(len(pts))])
    xyz = np.stack(xyz).astype(np.float32)
    feat = rng.uniform(0, 1, xyz.shape[:2] + (c,)).astype(np.float32)
    dims = (3 + c,) + tuple(widths)
    weights = []
    for i in range(3):
        w = rng.normal(size=(dims[i], dims[i + 1])) * 0.2
        bias = rng.normal(size=(dims[i + 1],)) * 0.2
        if masked:
            w, bias = np.abs(w), np.zeros_like(bias) + (i == 0)
            if i == 0:
                w[0] = 1.0
        weights += [w.astype(np.float32), bias.astype(np.float32)]
    cent = np.broadcast_to(cent, (b,) + cent.shape).copy()
    return [torch.from_numpy(a) for a in (xyz, feat, cent, *weights)]


def _spread_case(widths, seed, masked=False, counts=None):
    """The count-spread input at these widths (counts: SPREADS' own)."""
    spread, c, mlp = SPREADS[widths]
    return _spread_inputs(seed, c, mlp, masked, spread=counts or spread)


def _variant(variant, args, device, radius, dtype=torch.bfloat16):
    """One SA variant (counted under its name) on device."""
    xyz, feat, cent, w = _stage_args(args, device, dtype)
    if variant == "sa_fast":   # a window over every chunk: the counts stay exact
        return ops.sa_stage_fast(xyz, feat, cent, w, radius, window=-(-xyz.shape[1] // 128))
    return ops.sa_stage(xyz, feat, cent, w, radius, **VARIANTS[variant])


def _mma_kind(variant, widths):
    """The tensor-core kernel the plan gives a bf16 variant at these widths
    (C1, C2, C3): 2 (wgmma) for the exact in-cloud stage without the raw
    block whose layers are wider than 64, else 1 (mma.sync)."""
    return 2 if variant == "sa" and max(widths) > 64 else 1


def _check_mma(cuda, variant, args, radius):
    """bf16 kernel against plain: the tensor-core kernel the plan names
    (_mma_kind) is the one launched, idx equal, raw bit-equal, features
    within 1e-2 x max(1, max|f|)."""
    w = _stage_args(args, cuda)[3]
    b, _, c = args[1].shape
    plan = ops.sa_launch_plan(w, c, b, args[2].shape[1], variant != "sa_v3", variant == "sa_raw",
                              variant == "sa_fast")
    widths = (w.w1.shape[1], w.w2.shape[1], w.w3.shape[1])
    assert plan["mma"] == _mma_kind(variant, widths), plan
    before = ops.LAUNCHES[variant]
    out = _variant(variant, args, cuda, radius)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[variant] == before + 1
    ref = _variant(variant, args, "cpu", radius)
    np.testing.assert_array_equal(out[1].cpu().numpy(), ref[1].numpy())
    if variant == "sa_raw":
        assert torch.equal(out[2].cpu(), ref[2])
    scale = max(1.0, ref[0].abs().max().item())
    err = (out[0].cpu() - ref[0]).abs().max().item()
    assert err <= 1e-2 * scale, (err, scale)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sa_mma_matches_plain(cuda, variant, widths):
    c, mlp, radius = WIDTHS[widths]
    args = _sa_inputs(17, b=2, n=900, s=45, c=c, widths=mlp)
    if variant == "sa_v3":
        args[2][:, 3:11] += 0.011
    _check_mma(cuda, variant, args, radius)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(SPREADS))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sa_mma_counts_across_tile_edges(cuda, variant, masked, widths):
    """Counts on both sides of every tile edge, and (SA0 widths) packed
    tiles holding 1 to 16 centroids; ``masked``: rows past the count would
    win the max-pool if they entered it."""
    _check_mma(cuda, variant, _spread_case(widths, 18 + masked, masked), SPREAD_R)


def _kernel_variant(variant, args, radius, cpb):
    """One bf16 SA variant through sa_kernel at cpb centroids per block."""
    xyz, feat, cent, w = args
    if variant == "sa_fast":
        chunks = ops.chunk_window(xyz, cent, -(-xyz.shape[1] // 128))
        return ops.sa_kernel(xyz, feat, cent, w, radius, chunks, centroids_per_block=cpb)
    kw = VARIANTS[variant]
    return ops.sa_kernel(xyz, feat, cent, w, radius, None, kw["impl"] != "v3",
                         kw.get("return_raw", False), centroids_per_block=cpb)


# centroids per block the tensor-core kernel takes at each width: SA1's
# weights and tiles leave no room for 32 centroids' selections and max-pools
FITTING_CPB = {"sa0": (8, 16, 32), "sa1": (8, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(SPREADS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sa_mma_bit_equal_across_centroids_per_block(cuda, variant, widths):
    """idx, raw block and features bit-equal under every cpb the kernel
    takes at these widths (an mma row depends on its own A row only), on
    the 49-centroid spread, whose packed tiles straddle 1 to 16 centroids;
    one that does not fit raises."""
    args = _stage_args(_spread_case(widths, 24, counts=SPREAD_SA0), cuda)
    b, _, c = args[1].shape
    outs = {}
    for cpb in ops.SA_CENTROIDS_PER_BLOCK:
        plan_args = (args[3], c, b, args[2].shape[1], variant != "sa_v3", variant == "sa_raw",
                     variant == "sa_fast", cpb)
        if cpb not in FITTING_CPB[widths]:
            with pytest.raises(RuntimeError):
                ops.sa_launch_plan(*plan_args)
            with pytest.raises(RuntimeError):
                _kernel_variant(variant, args, SPREAD_R, cpb)
            continue
        plan = ops.sa_launch_plan(*plan_args)
        assert (plan["mma"], plan["cpb"]) == (_mma_kind(variant, SPREADS[widths][2]), cpb), plan
        outs[cpb] = _kernel_variant(variant, args, SPREAD_R, cpb)
    torch.cuda.synchronize()
    ref = outs[8]
    for cpb, out in outs.items():
        assert len(out) == len(ref)
        for got, want in zip(out, ref):
            assert torch.equal(got, want), (cpb, (got != want).sum().item())


@pytest.mark.cuda
def test_sa_centroids_per_block_outside_the_set_or_beyond_shared_memory_raises(cuda):
    """An override outside {8, 16, 32} raises before any launch; one the
    kernel does not take (SA1's bf16 widths at 32 on the tensor cores; on
    the CUDA cores, f32 widths whose max-pool rows leave no room for 32
    centroids: C3 = 1536) raises from the plan and from the launch, never
    falls back. The CUDA-core kernel takes what CC_FITTING_CPB lists at
    SA0 and SA1, and refuses the rest."""
    cases = (
        (_stage_args(_spread_case("sa1", 25), cuda, torch.bfloat16), (32,)),
        (_stage_args(_sa_inputs(25, b=2, n=600, s=20, c=64, widths=(128, 128, 1536)), cuda,
                     torch.float32), (32,)),
    )
    for args, refused in cases:
        b, _, c = args[1].shape
        s = args[2].shape[1]
        for cpb in (0, 4, 12, 64):
            with pytest.raises(ValueError, match="centroids per block"):
                ops.sa_launch_plan(args[3], c, b, s, centroids_per_block=cpb)
            with pytest.raises(ValueError, match="centroids per block"):
                ops.sa_kernel(*args, SPREAD_R, centroids_per_block=cpb)
        for cpb in refused:
            with pytest.raises(RuntimeError):
                ops.sa_launch_plan(args[3], c, b, s, centroids_per_block=cpb)
            before = dict(ops.LAUNCHES)
            with pytest.raises(RuntimeError, match="mpn_sa failed"):
                ops.sa_kernel(*args, SPREAD_R, centroids_per_block=cpb)
            assert ops.LAUNCHES == before
        assert ops.sa_launch_plan(args[3], c, b, s, centroids_per_block=8)["cpb"] == 8
    for widths in ("sa0", "sa1"):
        args = _stage_args(_spread_case(widths, 25), cuda, torch.float32)
        b, _, c = args[1].shape
        for cpb in ops.SA_CENTROIDS_PER_BLOCK:
            if cpb not in CC_FITTING_CPB[widths]:
                with pytest.raises(RuntimeError):
                    ops.sa_launch_plan(args[3], c, b, args[2].shape[1], centroids_per_block=cpb)
                continue
            plan = ops.sa_launch_plan(args[3], c, b, args[2].shape[1], centroids_per_block=cpb)
            assert (plan["mma"], plan["cpb"]) == (0, cpb), plan


@pytest.mark.cuda
def test_sa_launch_plan_takes_more_centroids_per_block_at_large_batch(cuda):
    """SA0's widths: 32 centroids a block at B=64 and 256 (the grid still
    fills the card), 8 at B <= 3; SA1 stays within shared memory, on wgmma
    (mma 2) on the exact path and mma.sync (mma 1) on the fast one."""
    cases = {"sa0": (1, (64, 64, 64), 512), "sa1": (64, (128, 128, 256), 128)}
    plans = {}
    for name, (c, mlp, s) in cases.items():
        w = _stage_args(_sa_inputs(26, b=1, n=200, s=8, c=c, widths=mlp), cuda)[3]
        for b in (1, 3, 64, 256):
            for fast in (False, True):
                plans[name, b, fast] = ops.sa_launch_plan(w, c, b, s, fast=fast)
    for fast in (False, True):
        assert [plans["sa0", b, fast]["cpb"] for b in (1, 3, 64, 256)] == [8, 8, 32, 32], plans
        assert all(plans["sa1", b, fast]["cpb"] in FITTING_CPB["sa1"] for b in (1, 3, 64, 256))
    assert all(p["mma"] == (2 if (name, fast) == ("sa1", False) else 1) and p["blocks_per_sm"] >= 1
               for (name, _, fast), p in plans.items()), plans


@pytest.mark.cuda
def test_sa_bf16_beyond_shared_memory_takes_the_cuda_core_kernel(cuda):
    """Widths whose bf16 weights do not fit in shared memory: the CUDA-core
    kernel, in bf16, at 32-row tiles of 4 rows a thread (larger ones do not
    fit beside 512-wide layers), against plain, and bit-equal under 8, 16
    and 32 centroids a block."""
    args = _sa_inputs(20, b=2, n=600, s=20, c=64, widths=(512, 512, 64))
    w = _stage_args(args, cuda)[3]
    plan = ops.sa_launch_plan(w, 64, 2, 20)
    assert (plan["mma"], plan["tile_rows"], plan["thread_rows"]) == (0, 32, 4), plan
    feats, idx = ops.sa_stage(*_stage_args(args, cuda), radius=0.3, impl="v8",
                              centroids_in_cloud=True)
    torch.cuda.synchronize()
    ref, ref_idx = ops.sa_stage(*_stage_args(args, "cpu"), radius=0.3, impl="v8",
                                centroids_in_cloud=True)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy())
    scale = max(1.0, ref.abs().max().item())
    assert (feats.cpu() - ref).abs().max().item() <= 1e-2 * scale
    for cpb in ops.SA_CENTROIDS_PER_BLOCK:
        out = _kernel_variant("sa", _stage_args(args, cuda), 0.3, cpb)
        assert torch.equal(out[0], feats) and torch.equal(out[1], idx), cpb


# ---------------------------------------------------------------------------
# The wgmma instantiation (exact, in-cloud, no raw block, a layer wider than
# 64): SA1's widths and widths that are multiples of 16 but not of 64, at the
# main paths' batches; counts across its 64-row tiles and its work items;
# bit-equal whatever the grid or the work items
# ---------------------------------------------------------------------------

# C, (C1, C2, C3), N, S, radius: "by16" has 32 input columns with the zero
# one (3 + 29 features, not a multiple of 4: the 4-byte copies), a 48-wide
# layer 1 and a second layer-3 product of 80 columns
WG_WIDTHS = {"sa1": (64, (128, 128, 256), 512, 128, 0.3),
             "by16": (29, (48, 112, 208), 300, 40, 0.3)}
WG_CPB = 8  # the plan's centroids a work item


def _exact_plain(xyz, feat, cent, w, radius, rows=64):
    """The exact in-cloud stage's plain version on the card, ``rows`` batch
    rows at a time. -> (features, idx)"""
    outs = [ops.sa_plain(xyz[i:i + rows], feat[i:i + rows], cent[i:i + rows], w, radius)
            for i in range(0, xyz.shape[0], rows)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 256, 512])
@pytest.mark.parametrize("widths", sorted(WG_WIDTHS))
def test_sa_wgmma_matches_plain(cuda, widths, b):
    """The wgmma kernel (the plan's mma 2, 64-row tiles) against plain at the
    main paths' batches: idx equal, features within 1e-2 x max(1, max|f|);
    one sa launch."""
    c, mlp, n, s, radius = WG_WIDTHS[widths]
    xyz, feat, cent, w = _stage_args(_sa_inputs(40, b=b, n=n, s=s, c=c, widths=mlp), cuda)
    plan = ops.sa_launch_plan(w, c, b, s)
    assert (plan["mma"], plan["tile_rows"], plan["thread_rows"], plan["cpb"]) == (2, 64, 0, WG_CPB)
    before = ops.LAUNCHES["sa"]
    feats, idx = ops.sa_stage(xyz, feat, cent, w, radius, impl="v8", centroids_in_cloud=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sa"] == before + 1
    ref, ref_idx = _exact_plain(xyz, feat, cent, w, radius)
    assert torch.equal(idx, ref_idx)
    scale = max(1.0, ref.abs().max().item())
    err = (feats - ref).abs().max().item()
    assert err <= 1e-2 * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("widths", sorted(WG_WIDTHS))
def test_sa_wgmma_counts_across_tile_and_item_edges(cuda, widths, masked):
    """SPREAD_TILES' counts (0, 1, 63, 64, 65, 127, 128 and beyond, whose
    packed rows put 64-row tile edges inside and between centroids:
    test_spread_tiles_puts_row_tile_edges_inside_and_between_centroids) in
    work items of 8 and 16 centroids (33 centroids: a partial last item):
    against plain, and bit-equal between the two; ``masked``: rows past a
    count would win the max-pool if they entered it."""
    c, mlp, *_ = WG_WIDTHS[widths]
    inputs = _spread_inputs(43 + masked, c, mlp, masked, spread=SPREAD_TILES)
    args = _stage_args(inputs, cuda)
    b, _, _ = inputs[1].shape
    ref, ref_idx = _variant("sa", inputs, "cpu", SPREAD_R)
    scale = max(1.0, ref.abs().max().item())
    outs = {}
    for cpb in (8, 16):
        plan = ops.sa_launch_plan(args[3], c, b, len(SPREAD_TILES), centroids_per_block=cpb)
        assert (plan["mma"], plan["cpb"], plan["tile_rows"]) == (2, cpb, 64), plan
        outs[cpb] = _kernel_variant("sa", args, SPREAD_R, cpb)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(outs[cpb][1].cpu().numpy(), ref_idx.numpy())
        err = (outs[cpb][0].cpu() - ref).abs().max().item()
        assert err <= 1e-2 * scale, (cpb, err, scale)
    assert all(map(torch.equal, outs[8], outs[16]))


@pytest.mark.cuda
def test_sa_wgmma_bit_equal_across_grids_and_work_items(cuda):
    """The same 64 batch rows launched at once (1,024 items on the whole
    card), row by row (16 items, 8 blocks) and in halves (a second grid), at
    8 and 16 centroids an item: features bit-equal (an output row depends on
    its own A row alone, summed in the same k order)."""
    c, mlp, n, s, radius = WG_WIDTHS["sa1"]
    xyz, feat, cent, w = _stage_args(_sa_inputs(44, b=64, n=n, s=s, c=c, widths=mlp), cuda)
    sel = ops.sa_select(xyz, cent, radius)

    def run(lo, hi, cpb=None):
        return ops.sa_kernel(xyz[lo:hi], feat[lo:hi], cent[lo:hi], w, radius,
                             selection=(sel[0][lo:hi], sel[1][lo:hi]),
                             centroids_per_block=cpb)[0]

    whole = run(0, 64)
    for other in (run(0, 64, 16), torch.cat([run(i, i + 1) for i in range(64)]),
                  torch.cat([run(0, 32, 16), run(32, 64)])):
        assert torch.equal(other, whole), (other != whole).sum().item()


@pytest.mark.cuda
def test_sa_wgmma_launch_plan(cuda):
    """ops.sa_launch_plan names the wgmma kernel (mma 2, 64-row tiles, 8
    centroids a work item, one block a SM) for the exact in-cloud SA1 stage
    at the main paths' batches, and keeps the old plans of the stages it
    does not take: SA0, the raw block, centroids off the cloud and the fast
    window on mma.sync (mma 1, 16-row tiles), f32 on the CUDA cores."""
    stages = {"sa0": (1, (64, 64, 64), 512), "sa1": (64, (128, 128, 256), 128)}
    for name, (c, mlp, s) in stages.items():
        for dtype in (torch.bfloat16, torch.float32):
            w = _stage_args(_sa_inputs(45, b=1, n=200, s=8, c=c, widths=mlp), cuda, dtype)[3]
            for b in (1, 3, 10, 64, 256, 512):
                for in_cloud, raw, fast in ((True, False, False), (True, True, False),
                                            (False, False, False), (True, False, True)):
                    plan = ops.sa_launch_plan(w, c, b, s, in_cloud, raw, fast)
                    key = (name, dtype, b, in_cloud, raw, fast)
                    if dtype == torch.float32:
                        assert plan["mma"] == 0 and plan["tile_rows"] in (32, 128), (key, plan)
                    elif name == "sa1" and (in_cloud, raw, fast) == (True, False, False):
                        assert (plan["mma"], plan["tile_rows"], plan["thread_rows"],
                                plan["cpb"], plan["blocks_per_sm"]) == (2, 64, 0, WG_CPB, 1), plan
                    else:
                        assert (plan["mma"], plan["tile_rows"]) == (1, 16), (key, plan)


# ---------------------------------------------------------------------------
# The CUDA-core SA MLP (f32; bf16 beyond the tensor cores' shared memory):
# every instantiation, packed rows across the row tiles' edges, every cpb
# ---------------------------------------------------------------------------

# 33 centroids whose counts hold 0, 1, tile - 1, tile, tile + 1 and 128 (and
# beyond) for 64- and 128-row tiles, ordered so that packing them, block by
# block of 8, 16 and 32 centroids, puts tile edges both inside a centroid's
# rows and between two centroids (test_spread_tiles_puts_row_tile_edges_
# inside_and_between_centroids)
SPREAD_TILES = (1, 63, 0, 65, 60, 0, 0, 128, 127, 1, 64, 1, 2, 17, 31, 1, 64, 63, 200, 1, 0,
                13, 62, 64, 1, 2, 127, 128, 33, 65, 5, 129, 3)
# the CUDA-core kernel's tile at each width: 128 rows, 4 a thread where
# every layer is at most 64 wide, else 8 a thread
CC_TILE = {"sa0": (128, 4), "sa1": (128, 8), "odd": (128, 4)}
# centroids per block the CUDA-core kernel takes at each width: SA1's
# 128-row tiles and weight slices leave no room for 32 centroids
CC_FITTING_CPB = {"sa0": (8, 16, 32), "sa1": (8, 16)}


def _check_cc(cuda, variant, args, radius, dtype=torch.float32):
    """CUDA-core kernel against plain: the kernel the plan names is the one
    launched, idx equal, raw bit-equal, features within 1e-5 (f32) x max(1,
    max|f|). -> the launch plan."""
    w = _stage_args(args, cuda, dtype)[3]
    b, _, c = args[1].shape
    plan = ops.sa_launch_plan(w, c, b, args[2].shape[1], variant != "sa_v3", variant == "sa_raw",
                              variant == "sa_fast")
    assert plan["mma"] == 0, plan
    counter = ops.mlp_launch_name(variant, dtype)
    before = ops.LAUNCHES[counter]
    out = _variant(variant, args, cuda, radius, dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counter] == before + 1
    ref = _variant(variant, args, "cpu", radius, dtype)
    np.testing.assert_array_equal(out[1].cpu().numpy(), ref[1].numpy())
    if variant == "sa_raw":
        assert torch.equal(out[2].cpu(), ref[2])
    scale = max(1.0, ref[0].abs().max().item())
    err = (out[0].cpu() - ref[0]).abs().max().item()
    assert err <= 1e-5 * scale, (err, scale)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sa_cuda_core_matches_plain(cuda, variant, widths):
    """Every instantiation of the CUDA-core kernel, f32, at SA0, SA1 and
    odd widths (C3 = 40: columns past the layer in the last pass)."""
    c, mlp, radius = WIDTHS[widths]
    args = _sa_inputs(27, b=2, n=900, s=45, c=c, widths=mlp)
    if variant == "sa_v3":
        args[2][:, 3:11] += 0.011
        args[2][:, 20] = torch.tensor([5.0, 5.0, 5.0])   # no neighbour: point 0's row
    plan = _check_cc(cuda, variant, args, radius)
    assert (plan["tile_rows"], plan["thread_rows"]) == CC_TILE[widths], plan


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(SPREADS))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sa_cuda_core_counts_across_row_tile_edges(cuda, variant, masked, widths):
    """Counts of 0, 1, tile - 1, tile, tile + 1 and 128 with row tiles
    starting inside and between centroids, f32; ``masked``: rows past the
    count would win the max-pool if they entered it."""
    _check_cc(cuda, variant, _spread_case(widths, 28 + masked, masked, SPREAD_TILES), SPREAD_R)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(SPREADS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sa_cuda_core_bit_equal_across_centroids_per_block(cuda, variant, widths):
    """f32: idx, raw block and features bit-equal under every number of
    centroids a block the kernel takes (a row's sums do not depend on its
    tile), on the count spread across the row tiles' edges; one it does not
    take raises."""
    args = _stage_args(_spread_case(widths, 30, counts=SPREAD_TILES), cuda, torch.float32)
    b, _, c = args[1].shape
    outs = {}
    for cpb in ops.SA_CENTROIDS_PER_BLOCK:
        plan_args = (args[3], c, b, args[2].shape[1], variant != "sa_v3", variant == "sa_raw",
                     variant == "sa_fast", cpb)
        if cpb not in CC_FITTING_CPB[widths]:
            with pytest.raises(RuntimeError):
                ops.sa_launch_plan(*plan_args)
            with pytest.raises(RuntimeError):
                _kernel_variant(variant, args, SPREAD_R, cpb)
            continue
        plan = ops.sa_launch_plan(*plan_args)
        assert (plan["mma"], plan["cpb"]) == (0, cpb), plan
        assert (plan["tile_rows"], plan["thread_rows"]) == CC_TILE[widths], plan
        outs[cpb] = _kernel_variant(variant, args, SPREAD_R, cpb)
    torch.cuda.synchronize()
    for cpb, out in outs.items():
        for got, want in zip(out, outs[8]):
            assert torch.equal(got, want), (cpb, (got != want).sum().item())


@pytest.mark.cuda
def test_sa_cuda_core_launch_plan(cuda):
    """f32 at the main paths' batches: the CUDA-core kernel, 128-row tiles
    of 4 rows a thread at SA0 and of 8 at SA1, more than 8 centroids a block
    at SA0 B=256, two blocks a SM at SA0, and never fewer blocks a SM than
    at 8 centroids a block."""
    cases = {"sa0": (1, (64, 64, 64), 512), "sa1": (64, (128, 128, 256), 128)}
    for name, (c, mlp, s) in cases.items():
        w = _stage_args(_sa_inputs(31, b=1, n=200, s=8, c=c, widths=mlp), cuda,
                        torch.float32)[3]
        for b in (1, 3, 32, 256):
            for fast in (False, True):
                plan = ops.sa_launch_plan(w, c, b, s, fast=fast)
                assert plan["mma"] == 0, plan
                assert (plan["tile_rows"], plan["thread_rows"]) == CC_TILE[name], plan
                at8 = ops.sa_launch_plan(w, c, b, s, fast=fast, centroids_per_block=8)
                assert plan["blocks_per_sm"] >= max(at8["blocks_per_sm"], 2 if name == "sa0" else 1)
        if name == "sa0":
            assert ops.sa_launch_plan(w, c, 256, s)["cpb"] > 8


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("cpb", ops.SA_CENTROIDS_PER_BLOCK)
def test_spread_tiles_puts_row_tile_edges_inside_and_between_centroids(cpb, tile):
    """CPU: packing SPREAD_TILES' rows, max(min(count, 128), 1) a centroid,
    block by block of cpb centroids, puts the edges of row tiles both
    inside a centroid's rows and between two centroids; and the input keeps
    each count (128 at most) under the plain ball query."""
    inside = between = 0
    for b0 in range(0, len(SPREAD_TILES), cpb):
        nrows = [max(min(k, 128), 1) for k in SPREAD_TILES[b0:b0 + cpb]]
        off = np.cumsum([0] + nrows)
        for edge in range(tile, off[-1], tile):
            between += edge in off
            inside += any(o < edge < o + n for o, n in zip(off, nrows))
    assert inside > 0 and between > 0, (inside, between)
    assert {0, 1, tile - 1, tile, tile + 1, 128} <= set(SPREAD_TILES)
    xyz, _, cent = _spread_case("sa1", 28, counts=SPREAD_TILES)[:3]
    _, count = ops.sa_select_plain(xyz, cent, SPREAD_R)
    assert count.tolist() == [[min(k, 128) for k in SPREAD_TILES]] * 2


@pytest.mark.parametrize("widths", sorted(SPREADS))
@pytest.mark.parametrize("masked", [False, True])
def test_spread_inputs_cross_every_tile_edge(masked, widths):
    """CPU: each centroid keeps its spread count of neighbours (128 at most),
    under the plain ball query too."""
    spread = SPREADS[widths][0]
    args = _spread_case(widths, 18 + masked, masked)
    xyz, _, cent = args[:3]
    inside = ((xyz[:, None] - cent[:, :, None]) ** 2).sum(-1) < SPREAD_R ** 2
    assert inside.sum(-1).tolist() == [list(spread)] * 2
    _, count = ops.sa_select_plain(xyz, cent, SPREAD_R)
    assert count.tolist() == [[min(k, 128) for k in spread]] * 2
    _, idx = _variant("sa", args, "cpu", SPREAD_R)
    kept = [min(k, 128) for k in spread]
    assert ((idx != idx[..., :1]).sum(-1) + 1).tolist()[0] == [max(k, 1) for k in kept]


@pytest.mark.parametrize("cpb", ops.SA_CENTROIDS_PER_BLOCK)
def test_sa0_spread_puts_tile_edges_inside_and_between_centroids(cpb):
    """CPU: packing the SA0 spread's rows, max(min(count, 128), 1) a
    centroid, block by block of cpb centroids, puts 16-row tile edges both
    inside a centroid's rows and between two centroids, and gives tiles of
    one centroid and of several (16 in one at cpb 16 and 32)."""
    xyz, _, cent = _spread_case("sa0", 18)[:3]
    _, count = ops.sa_select_plain(xyz, cent, SPREAD_R)
    inside = between = 0
    per_tile = set()
    for b0 in range(0, count.shape[1], cpb):
        nrows = [max(k, 1) for k in count[0, b0:b0 + cpb].tolist()]
        off = np.cumsum([0] + nrows)
        for edge in range(16, off[-1], 16):
            between += edge in off
            inside += any(o < edge < o + n for o, n in zip(off, nrows))
        for t0 in range(0, off[-1], 16):
            per_tile.add(sum(o < t0 + 16 and o + n > t0 for o, n in zip(off, nrows)))
    assert inside > 0 and between > 0, (inside, between)
    assert 1 in per_tile and max(per_tile) == (8 if cpb == 8 else 16), per_tile


@pytest.mark.parametrize("widths", sorted(SPREADS))
def test_masked_rows_would_win_the_max_pool(widths):
    """CPU: on the masked input, a zero raw row -- what fills a tile past the
    count -- gives every centroid with 0 < count < 128 that is not a multiple
    of 16 features far above its real ones, so a kernel that let such rows
    into the max would fail the 1e-2 gate many times over."""
    spread = SPREADS[widths][0]
    args = _spread_case(widths, 19, masked=True)
    feats, _ = _variant("sa", args, "cpu", SPREAD_R)
    w = _stage_args(args, "cpu")[3]
    rnd = lambda t: t.to(torch.bfloat16).float()
    h = rnd(torch.relu(w.b1 - args[2] @ w.w1_xyz))          # the zero row's layer 1
    h = rnd(torch.relu(h @ w.w2 + w.b2))
    zero_row = torch.relu(h @ w.w3 + w.b3)                   # [B, S, C3]
    gap = (zero_row - feats).amax(-1)
    scale = max(1.0, feats.abs().max().item())
    for i, k in enumerate(spread):
        if 0 < k < 128 and k % 16:
            assert (gap[:, i] > 10 * 1e-2 * scale).all(), (k, gap[:, i], scale)


# ---------------------------------------------------------------------------
# The exact ball query (sa_select_kernel): the edge cases of
# tests/torch_select_cases.py, the count spread, SA0 and SA1 at full shape
# and at B=1; the MLP kernel reading a given selection
# ---------------------------------------------------------------------------

FULL_SELECT = {"sa0": (6272, 512, 0.05, 0.5), "sa1": (512, 128, 0.3, 0.4)}  # N, S, r, half-width


def _select_inputs(case):
    """-> (xyz, cent, radius): numpy-made, on the CPU."""
    if case == "spread":
        xyz, _, cent = _spread_inputs(18)[:3]
        return xyz, cent, SPREAD_R
    if case in select_cases.CASES:
        return (*map(torch.from_numpy, select_cases.select_case(case)), select_cases.RADIUS)
    stage, b = case.split("_b")
    n, s, r, half = FULL_SELECT[stage]
    xyz = np.random.default_rng(22).uniform(-half, half, (int(b), n, 3)).astype(np.float32)
    return torch.from_numpy(xyz), torch.from_numpy(xyz[:, :s].copy()), r


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(select_cases.CASES) + ["spread", "sa0_b16", "sa0_b1",
                                                              "sa1_b16", "sa1_b1"])
def test_sa_select_kernel_matches_plain(cuda, case):
    """idx and count equal to the plain version's (on the card, by rows)."""
    xyz, cent, r = _select_inputs(case)
    b, n, _ = xyz.shape
    before = ops.LAUNCHES_BY_SHAPE[("sa_select", b, n, cent.shape[1])]
    idx, count = ops.sa_select(xyz.to(cuda), cent.to(cuda), r)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_SHAPE[("sa_select", b, n, cent.shape[1])] == before + 1
    ref = [ops.sa_select_plain(xyz[i:i + 4].to(cuda), cent[i:i + 4].to(cuda), r)
           for i in range(0, b, 4)]
    assert torch.equal(idx, torch.cat([t[0] for t in ref]))
    assert torch.equal(count, torch.cat([t[1] for t in ref]))
    assert (count > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sa_mlp_kernel_reads_a_given_selection(cuda, dtype):
    """With a selection given, only the MLP kernel launches, and it computes
    the plain MLP over that selection; an exact stage launches both."""
    args = _sa_inputs(21)
    xyz, feat, cent, w = _stage_args(args, "cpu", dtype)
    idx, count = ops.sa_select_plain(xyz, cent, 0.2)
    ref = ops.sa_mlp_plain(xyz, feat, cent, w, idx, count)
    before = dict(ops.LAUNCHES)
    out, out_idx = ops.sa_kernel(*_stage_args(args, cuda, dtype), 0.2,
                                 selection=(idx.to(cuda), count.to(cuda)))
    torch.cuda.synchronize()
    sa = ops.mlp_launch_name("sa", dtype)
    assert ops.LAUNCHES[sa] == before[sa] + 1 and ops.LAUNCHES["sa_select"] == before["sa_select"]
    assert torch.equal(out_idx.cpu(), idx)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = max(1.0, ref.abs().max().item())
    assert (out.cpu() - ref).abs().max().item() <= tol * scale
    ops.sa_stage(*_stage_args(args, cuda, dtype), 0.2, impl="v8", centroids_in_cloud=True)
    assert ops.LAUNCHES["sa_select"] == before["sa_select"] + 1
    assert ops.LAUNCHES[sa] == before[sa] + 2


@pytest.mark.cuda
def test_sa_select_refuses_a_cloud_beyond_shared_memory(cuda):
    n = ops.SELECT_MAX_POINTS + 1
    xyz = torch.zeros(1, n, 3, device=cuda)
    with pytest.raises(ValueError, match="SELECT_MAX_POINTS"):
        ops.sa_select(xyz, xyz[:, :8].contiguous(), 0.1)
    args = _stage_args(_sa_inputs(23, b=1, n=n, s=8), cuda)
    with pytest.raises(ValueError, match="SELECT_MAX_POINTS"):
        ops.sa_stage(*args, radius=0.1, impl="v8", centroids_in_cloud=True)
    plan = ops.sa_select_plan(1, ops.SELECT_MAX_POINTS, 512)
    assert plan["blocks_per_sm"] >= 1 and plan["smem_bytes"] == 12 * ops.SELECT_MAX_POINTS


def test_sa_timing_refuses_without_a_card():
    """CPU: the SA timing script measures nothing without a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mpinets_torch.kernels import sa_timing

    with pytest.raises(SystemExit, match="no CUDA device"):
        sa_timing.main(["--batch", "1"])


def _plain_ops(monkeypatch):
    """Route the train path's kernel launches to the plain versions, on any
    device. ``sa_stage`` stays: its mapping of ``impl`` and
    ``centroids_in_cloud`` onto the kernel is part of what is compared."""
    monkeypatch.setattr(ops, "furthest_point_sample_with_coords",
                        lambda xyz, npoint, impl="v1": ops.fps_plain(xyz, npoint))
    monkeypatch.setattr(ops, "sa_kernel", ops.sa_plain)
    monkeypatch.setattr(ops, "sa_stage_backward", ops.sa_stage_backward_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("sa_impl, dtype", [("v8", torch.float32), ("v3", torch.float32),
                                            ("v8", torch.bfloat16)],
                         ids=["v8", "v3", "v8-bf16"])
def test_fused_train_kernels_match_plain_gradients(cuda, monkeypatch, sa_impl, dtype):
    rng = np.random.default_rng(15)
    pc = torch.from_numpy(np.concatenate([rng.uniform(-0.7, 0.7, (2, 640, 3)),
                                          rng.integers(0, 3, (2, 640, 1))], -1)
                          .astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.uniform(-1, 1, (2, 7)).astype(np.float32)).to(cuda)
    model = MotionPolicyNetwork(sa_npoints=(64, 16), device=cuda,
                                generator=torch.Generator().manual_seed(15))

    def grads(cdt=dtype):
        apply = fused_train.make_fused_train_apply(cdt, sa_npoints=(64, 16), sa_impl=sa_impl)
        model.zero_grad()
        torch.sin(apply(model, pc, q)).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    counter = ops.mlp_launch_name("sa_raw" if sa_impl == "v8" else "sa_v3", dtype)
    before = ops.LAUNCHES[counter], ops.LAUNCHES["sa_bwd"]
    kernel = grads()
    torch.cuda.synchronize()
    # the bf16 v8 backward runs the backward kernel, one launch a stage
    bwd = 2 if (sa_impl, dtype) == ("v8", torch.bfloat16) else 0
    assert (ops.LAUNCHES[counter], ops.LAUNCHES["sa_bwd"]) == (before[0] + 2, before[1] + bwd)
    _plain_ops(monkeypatch)
    plain = grads()
    if dtype == torch.float32:
        for k, ref in plain.items():
            scale = max(ref.abs().max().item(), 1e-6)
            np.testing.assert_allclose(kernel[k].cpu().numpy(), ref.cpu().numpy(),
                                       atol=2e-5 + 1e-4 * scale, err_msg=k)
        return
    f32 = grads(torch.float32)
    whole = rel_l2(torch.cat([g.flatten() for g in plain.values()]),
                    torch.cat([f32[k].flatten() for k in plain]))
    for k, ref in plain.items():
        gate = 2 ** 0.5 * max(rel_l2(ref, f32[k]), whole)
        assert rel_l2(kernel[k], ref) <= gate, (k, rel_l2(kernel[k], ref), gate)


# ---------------------------------------------------------------------------
# The SA backward kernel (csrc/sa_bwd.cu) against its plain version
# ---------------------------------------------------------------------------

#: SA0 and SA1 of the policy: (cloud N, centroids S, features C, widths, radius)
BWD_STAGES = {"sa0": (6272, 512, 1, (64, 64, 64), 0.05),
              "sa1": (512, 128, 64, (128, 128, 256), 0.3)}


def _bwd_inputs(device, b, stage, seed, terms=1):
    """The stage's forward on a random cloud and FPS centroids, as the train
    path runs it: (raw, idx, centroids, SAWeights, g, N or None). Weights of
    ``exact_mlp``: one term an output, or ``terms`` on a grid cloud, where
    every sum of the forward is exact in any summation order."""
    n, s, c, widths, radius = BWD_STAGES[stage]
    gen = torch.Generator().manual_seed(seed)
    if terms == 1:
        xyz = torch.rand((b, n, 3), generator=gen)
        feat = (torch.randint(0, 3, (b, n, 1), generator=gen).float() if c == 1
                else torch.rand((b, n, c), generator=gen))
    else:
        xyz, feat = grid_cloud(b, n, c, gen)
    xyz, feat = xyz.to(device), feat.to(device)
    mlp = exact_mlp((3 + c,) + widths, gen, terms)
    weights = ops.prepare_sa_weights(*(t.to(device) for t in mlp))
    _, cent = ops.furthest_point_sample_with_coords(xyz, s)
    out, idx, raw = ops.sa_stage(xyz, feat, cent, weights, radius, impl="v8",
                                 centroids_in_cloud=True, return_raw=True)
    g = torch.randn(out.shape, generator=gen).to(device)
    return raw, idx, cent, weights, g, n if c > 1 else None


def _check_bwd(raw, idx, cent, weights, g, n):
    before = ops.LAUNCHES["sa_bwd"]
    kernel = ops.sa_stage_backward(raw, idx, cent, weights, g, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sa_bwd"] == before + 1
    plain = ops.sa_stage_backward_plain(raw, idx, cent, weights, g, n)
    assert (kernel.gf is None) == (n is None)
    for name, a, ref in zip(kernel._fields, kernel, plain):
        if ref is None:
            continue
        assert a.shape == ref.shape and bool(torch.isfinite(a).all()), name
        assert rel_l2(a, ref) <= 1e-4, (name, rel_l2(a, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [1, 8])
@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("stage", ["sa0", "sa1"])
def test_sa_backward_kernel_matches_plain(cuda, stage, b, terms):
    _check_bwd(*_bwd_inputs(cuda, b, stage, 20 + b, terms))


def _spread_bwd(device, counts, c, widths, seed=5):
    """A selection with the given kept counts [B, S] (fill with the first)
    over a random cloud, its raw block, and weights of these widths."""
    gen = np.random.default_rng(seed)
    b, s = counts.shape
    n = 300
    xyz = gen.uniform(0, 1, (b, n, 3)).astype(np.float32)
    feat = gen.uniform(0, 1, (b, n, c)).astype(np.float32)
    idx = np.zeros((b, s, 128), np.int32)
    for bi in range(b):
        for si in range(s):
            pick = np.sort(gen.choice(n, counts[bi, si], replace=False))
            idx[bi, si, :len(pick)], idx[bi, si, len(pick):] = pick, pick[0]
    valid = np.arange(128) < counts[..., None]
    rows = np.concatenate([np.take_along_axis(xyz, idx.reshape(b, -1, 1), 1),
                           np.take_along_axis(feat, idx.reshape(b, -1, 1), 1)], -1)
    raw = np.where(valid[..., None], rows.reshape(b, s, 128, -1), 0).astype(np.float32)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    mlp = exact_mlp((3 + c,) + widths, torch.Generator().manual_seed(seed))
    weights = ops.prepare_sa_weights(*(t.to(device) for t in mlp))
    g = to(gen.normal(size=(b, s, widths[-1])))
    return (to(raw), torch.from_numpy(idx).to(device), to(xyz[:, :s]), weights, g,
            n if c > 1 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["sa0", "sa1"])
def test_sa_backward_kernel_across_tile_and_item_edges(cuda, stage):
    """Packed rows that end on, before and after the 64-row tiles, within
    and between centroids; centroids of 1 and 128 rows; S not a multiple of
    the centroids an item (37), so the last item of each row is partial."""
    _, s, c, widths, _ = BWD_STAGES[stage]
    spread = (1, 63, 64, 65, 128, 127, 1, 2, 62, 128, 128, 3)
    counts = np.resize(np.array(spread), (3, 37))
    counts[1] = np.roll(counts[1], 5)
    _check_bwd(*_spread_bwd(cuda, counts, c, widths))
    assert ops.sa_bwd_plan(3, 37, 3 + c, *widths)["cpb"] in (8, 32)


@pytest.mark.cuda
def test_bf16_train_step_never_synchronises(cuda):
    """A warm bf16 train step's forward and backward on a prepared batch
    (the backward kernels included) makes no blocking call."""
    model = MotionPolicyNetwork(sa_npoints=(512, 128), device=cuda,
                                generator=torch.Generator().manual_seed(3))
    apply = fused_train.make_fused_train_apply(torch.bfloat16)
    batch = synthetic.training_batch(torch.Generator(cuda).manual_seed(4), 4, device=cuda)

    def step():
        model.zero_grad()
        total, _ = learner.loss_fn(model, batch, apply_fn=apply)
        total.backward()

    before = ops.LAUNCHES["sa_bwd"]
    step()  # builds the kernels, copies the tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sa_bwd"] == before + 4


# ---------------------------------------------------------------------------
# The TPU probe kernels (csrc/probes.cu): the cases of test_torch_probes.py,
# then every probe of the session at the scripts' full shapes
# ---------------------------------------------------------------------------

def _check_probe(kernel, run, plain, bits=False):
    """One launch, counted under ``kernel``, bit-equal to the plain version
    (``bits``: compared as int32 words, so signs of zero count too)."""
    before = ops.LAUNCHES[kernel]
    out = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
    ref = plain()
    assert out.shape == ref.shape
    assert torch.equal(out.cpu(), ref.cpu()), (out.cpu() - ref.cpu()).abs().max().item()
    if bits:
        assert torch.equal(out.cpu().view(torch.int32), ref.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", scan.SCAN_MODES)
def test_scan_probe_matches_plain(cuda, mode):
    """Edge cases: 150 neighbours, none, an empty chunk, points ulps from the
    sphere; then centroids that pass 128 hits early (the warp's stop)."""
    for make in (session.edge_scan_inputs, session.dense_scan_inputs):
        args = [torch.from_numpy(a) for a in make(5)]
        _check_probe("probe_scan",
                     lambda: scan.scan_probe(*(a.to(cuda) for a in args), 0.05, mode),
                     lambda: scan.scan_probe(*args, 0.05, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", scan.SCAN_MODES)
def test_scan_probe_plan_and_largest_cloud(cuda, mode):
    """Three blocks a SM at the session's cloud (x, y, z staged: 75 KB), and
    the largest cloud the kernel takes launches and equals plain."""
    plan = scan.scan_plan(6272, mode)
    assert plan == {"smem_bytes": 12 * 6272, "blocks_per_sm": 3}
    n = scan.MAX_POINTS
    gen = torch.Generator().manual_seed(3)
    xyz = torch.rand(1, n, 3, generator=gen) * 0.2
    feat = torch.randint(0, 3, (1, n, 1), generator=gen).float()
    cent = xyz[:, :64].contiguous()
    _check_probe("probe_scan",
                 lambda: scan.scan_probe(xyz.to(cuda), feat.to(cuda), cent.to(cuda), 0.05, mode),
                 lambda: scan.scan_probe(xyz, feat, cent, 0.05, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [0, 1, 8, 32, 33])
@pytest.mark.parametrize("op", micro.MICRO_OPS)
def test_micro_probe_matches_plain(cuda, op, reps):
    """Two blocks of rb = 98 rows (the roll's last thread holds 2 rows of 4),
    and of a ragged rb: 1,000 (8 rows of 32; bd_matmul 1,029 = 21 x 49); the
    rolls also at 5,000 (a ring over 3 warps); every op on a misaligned view
    (the kernels' scalar loads). bd_matmul also on signed inputs with +0.0
    and -0.0 planted, compared bit for bit, its group sums too."""
    rng = np.random.default_rng(6)
    rbs = [98, 1029 if op == "bd_matmul" else 1000] + [5000] * op.startswith("roll")
    cases = [(rb, rng.uniform(0, 1, (2 * rb, 128)).astype(np.float32)) for rb in rbs]
    if op == "bd_matmul":
        for rb in (98, 1029):
            a = rng.uniform(-1, 1, (2 * rb, 128)).astype(np.float32)
            a[rng.random(a.shape) < 0.05] = 0.0
            a[rng.random(a.shape) < 0.05] = -0.0
            a[:5, :16] = -0.0
            a[micro.GROUP:2 * micro.GROUP, 32:40] = -0.0
            cases.append((rb, a))
    for rb, a in cases:
        a = torch.from_numpy(a)
        idx = torch.from_numpy(rng.integers(0, 128, (2 * rb, 128)).astype(np.int32))
        _check_probe("probe_micro",
                     lambda: micro.micro_probe(a.to(cuda), idx.to(cuda), op, reps, rb),
                     lambda: micro.micro_probe(a, idx, op, reps, rb), bits=op == "bd_matmul")
        if op == "bd_matmul":   # every row's work, through the group sums
            _check_probe("probe_micro",
                         lambda: micro.micro_probe(a.to(cuda), idx.to(cuda), op, reps, rb, True)[1],
                         lambda: micro.bd_matmul_plain(a, reps)[1], bits=True)
    flat = torch.from_numpy(rng.uniform(-1, 1, 196 * 128 + 1).astype(np.float32))
    a, idx = flat[1:].view(196, 128), torch.from_numpy(
        rng.integers(0, 128, (196, 128)).astype(np.int32))
    shifted = torch.zeros(196 * 128 + 1, dtype=torch.int32, device=cuda)[1:].view(196, 128)
    shifted.copy_(idx)
    _check_probe("probe_micro",
                 lambda: micro.micro_probe(flat.to(cuda)[1:].view(196, 128), shifted, op, reps, 98),
                 lambda: micro.micro_probe(a, idx, op, reps, 98), bits=op == "bd_matmul")


@pytest.mark.cuda
def test_prefix_plan_and_launch_floor(cuda):
    """bd_matmul's kernel fits four blocks of 128 threads a SM at the
    session's rb (so its 512 blocks are one wave); the empty kernel
    launches, and its time in the probes' loop lies above 0 and below the
    scratch probe's."""
    plan = micro.micro_plan(session.FULL["rb"], "bd_matmul")
    assert (plan["kernel"], plan["threads"], plan["blocks_per_sm"]) == (
        "probe_prefix_kernel", 128, 4), plan
    session.empty_launch(cuda)
    torch.cuda.synchronize()
    floor = session.launch_floor_ms(cuda)
    assert 0 < floor < session.diff_ms(lambda: design.scratch_probe(4, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("rb", [8, 33, 98, 1000, 1568, 2048, 2049, 5000, 7264, 32768])
def test_roll_plan_matches_its_layout(cuda, rb):
    """The kernel's choice of rows a thread, raggedness and warps a ring is
    ``micro.roll_layout``'s (the CPU tests' model); one warp a ring of 49
    rows a thread at the session's rb."""
    lay = micro.roll_layout(rb)
    for op in ("roll_narrow", "roll_wide"):
        plan = micro.micro_plan(rb, op)
        assert (plan["rows_per_thread"], plan["ragged"], plan["ring_warps"]) == (
            lay.rows_per_thread, int(lay.ragged), lay.warps), plan
        assert plan["blocks_per_sm"] >= 1
    if rb == 1568:
        assert micro.micro_plan(rb, "roll_wide")["kernel"] == "probe_roll_kernel<49, ragged=0, ring=0>"


@pytest.mark.cuda
def test_wide_and_scratch_probes_match_plain(cuda):
    rng = np.random.default_rng(7)
    tab = torch.from_numpy(rng.normal(size=(2, 224, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 128, (2, 224, 2048)).astype(np.int32))
    _check_probe("probe_wide", lambda: design.wide_gather(tab.to(cuda), idx.to(cuda)),
                 lambda: design.wide_gather(tab, idx))
    _check_probe("probe_scratch", lambda: design.scratch_probe(4, cuda),
                 lambda: design.scratch_probe(4, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["probe_scan", "probe_micro", "probe_wide", "probe_scratch"])
def test_probe_kernels_at_full_shape(cuda, kernel):
    """Every probe of the session for this kernel, at the scripts' shapes."""
    probes = [p for p in session.make_probes(cuda) if p.kernel == kernel]
    assert probes
    for probe in probes:
        rec = session.check(probe)
        assert rec["ok"], rec


def _trajectory_case(name):
    """``tests/test_torch_eval.py``'s check_trajectories cases, made with the
    port's kinematics: (trajectories, num_steps, target rot, target trans,
    scene, target volumes, negative volumes) on the CPU."""
    from mpinets_torch.geom.scene import pack_scenes
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.robot import franka

    def line(q_end):
        a = np.linspace(0.0, 1.0, 20)[:, None]
        return ((1 - a) * q_start + a * q_end).astype(np.float32)

    def volumes(points, dims):
        return [[(p, (dims,) * 3, (1.0, 0, 0, 0))] for p in points]

    q_start = np.asarray(franka.NEUTRAL_Q)
    trajs = np.stack([line(q_start + np.array([0.3, 0.1, -0.2, 0.2, 0.1, -0.1, 0.2]))] * 2)
    num_steps = np.full((2,), 19, np.int32)
    if name in ("joint_limit", "frozen_tail"):
        bad = np.tile(q_start.astype(np.float32), (20, 1))
        bad[(0 if name == "joint_limit" else 10):, 0] = 3.5
        trajs = np.stack([bad, bad])
        if name == "frozen_tail":
            num_steps[:] = 5
    elif name == "partial_success":
        trajs = np.stack([line(q_start + 0.2)] * 2)
        num_steps[1] = 12
    rot, pos = kinematics.eff_pose(torch.from_numpy(trajs[:, -1]))
    final = pos.double().numpy()
    scene, tv, neg = [[], []], volumes(final, 2.0), [[], []]
    if name == "collision":
        scene = [[((0.0, 0.0, 0.5), (3.0, 3.0, 3.0), (1.0, 0, 0, 0))]] * 2
    elif name == "negative_volume":
        neg = [volumes(final, 2.0)[0], volumes(final, 0.2)[1]]
        tv[1] = volumes(final + np.array([5.0, 0, 0]), 0.5)[1]
    pack = lambda c: pack_scenes(c, [[] for _ in c], device="cpu")
    return (torch.from_numpy(trajs), torch.from_numpy(num_steps), rot, pos,
            pack(scene), pack(tv), pack(neg))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["success", "collision", "negative_volume", "joint_limit",
                                  "frozen_tail", "partial_success"])
def test_check_trajectories_on_the_card_matches_the_cpu(cuda, name):
    """The evaluator's checks on the card equal the CPU's: booleans equal,
    floats within 1e-4 x max(1, |x|), orientation within 0.05 deg and the
    orientation path within 0.05 deg a live segment (as ``chip_smoke.py``'s
    evaluation phase holds them)."""
    from mpinets_torch.eval.metrics import check_trajectories, to_host

    args = _trajectory_case(name)
    cpu = to_host(check_trajectories(*args))
    card = to_host(check_trajectories(*(a.to(cuda) for a in args)))
    for key, ref in cpu.items():
        if ref.dtype == bool:
            np.testing.assert_array_equal(card[key], ref, err_msg=key)
        elif key == "orientation_error":
            np.testing.assert_allclose(card[key], ref, atol=0.05, rtol=0, err_msg=key)
        elif key == "eff_orientation_path_length":   # 0.05 deg a live segment
            segments = np.maximum(args[1].numpy(), 1)
            np.testing.assert_array_less(np.abs(card[key] - ref), 0.05 * segments, err_msg=key)
        else:
            np.testing.assert_array_less(np.abs(card[key] - ref),
                                         1e-4 * np.maximum(1.0, np.abs(ref)) + 1e-30,
                                         err_msg=key)


# ---- scene generation: the batched IK and the environments ------------------

def _tabletop_poses(n, seed=0):
    """A tabletop scene made on the card, n of its candidate poses, and the
    scene on both devices."""
    from mpinets_torch import envs
    from mpinets_torch.geom.scene import SceneSet

    rng = np.random.default_rng(seed)
    env = envs.TabletopEnvironment(device="cuda")
    while not env.gen(rng):
        pass
    poses = env.sample_candidate_poses(rng, n)
    rot = torch.as_tensor(np.stack([p.matrix[:3, :3] for p in poses]), dtype=torch.float32)
    trans = torch.as_tensor(np.stack([p.position for p in poses]), dtype=torch.float32)
    scene = env._unbatched_scene()
    return rot, trans, scene, SceneSet(*(t.cpu() for t in scene)), int(rng.integers(0, 2**31 - 1))


def _near_tolerance(pos, ori, edge=1e-5):
    from mpinets_torch.kernels import ik

    return ((pos - ik.POS_TOL).abs() < edge) | ((ori - ik.ORI_TOL).abs() < edge)


@pytest.mark.cuda
def test_ik_on_the_card_matches_the_cpu(cuda):
    """The IK on the card against the CPU on 64 tabletop poses x 16 seeds,
    the same draws (``chip_smoke.py``'s scene phase holds 320): the seeds
    equal; residual, Jacobian and one DLS step within 1e-8 in f64; on the
    CPU's per-seed solutions, the flags equal away from the tolerances and
    each pick within 1e-4 of the best seed's score; end to end, the flags
    equal on 97% of the targets (30 DLS steps from random seeds round
    apart, ``tests/test_torch_ik.py``) and every solution the card accepts
    reaches its pose and is free on the CPU (within 1e-5)."""
    from unittest import mock

    from mpinets_torch.kernels import ik

    rot, trans, scene, scene_cpu, key = _tabletop_poses(64)
    b = rot.shape[0]
    u = ik.draw_uniforms(key, 16, b)
    seeds = ik.seeds_from_draws(u)
    assert torch.equal(ik.seeds_from_draws(ik.draw_uniforms(key, 16, b, cuda)).cpu(), seeds)

    flat = (seeds.double().reshape(-1, 7), rot.double().expand(16, b, 3, 3).reshape(-1, 3, 3),
            trans.double().expand(16, b, 3).reshape(-1, 3))
    for cpu, card in zip((*ik.residual_and_jacobian(*flat), ik.dls_step(*flat)),
                         (*ik.residual_and_jacobian(*(t.to(cuda) for t in flat)),
                          ik.dls_step(*(t.to(cuda) for t in flat)))):
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-8, rtol=0)

    qs = ik.dls_solve(seeds, rot, trans)
    pos, ori = ik.pose_errors(qs, rot, trans)
    ok = (pos < ik.POS_TOL) & (ori < ik.ORI_TOL) & ik.franka_free_space(qs, scene_cpu)
    score = pos + 0.1 * ori + torch.where(ok, 0.0, 1e6)
    best, cols = score.argmin(0), torch.arange(b)
    with mock.patch.object(ik, "dls_solve", lambda *a, **k: qs.to(cuda)):
        got = [t.cpu() for t in ik.collision_free_ik(None, rot.to(cuda), trans.to(cuda), scene,
                                                     draws=u.to(cuda))]
    pick = (qs == got[0][None]).all(-1).float().argmax(0)
    assert torch.equal(qs[pick, cols], got[0])
    away = ~_near_tolerance(pos[best, cols], ori[best, cols]) & ~_near_tolerance(got[2], got[3])
    assert torch.equal(got[1][away], ok[best, cols][away])
    low = score[best, cols]
    assert bool((score[pick, cols] <= low + 1e-4 + torch.where(low >= 1e6, 0.0625, 0.0)).all())

    got = ik.collision_free_ik(key, rot.to(cuda), trans.to(cuda), scene)
    got = ik.IKResult(*(t.cpu() for t in got))
    ref = ik.collision_free_ik(key, rot, trans, scene_cpu)
    away = ~_near_tolerance(ref.pos_err, ref.ori_err) & ~_near_tolerance(got.pos_err, got.ori_err)
    assert float((got.converged == ref.converged)[away].float().mean()) >= 0.97
    q = got.q[got.converged]
    pos, ori = ik.pose_errors(q, rot[got.converged], trans[got.converged])
    assert bool((pos < ik.POS_TOL + 1e-5).all()) and bool((ori < ik.ORI_TOL + 1e-5).all())
    assert bool(ik.franka_free_space(q, scene_cpu, -1e-5).all())


@pytest.mark.cuda
def test_ik_call_makes_no_host_sync(cuda):
    """collision_free_ik captures into a CUDA graph, which raises on any host
    sync while capturing: its 30 iterations, acceptance and selection never
    wait for the card. The replay equals the call."""
    from mpinets_torch.kernels import ik

    rot, trans, scene, _, key = _tabletop_poses(512)
    args = (rot.to(cuda), trans.to(cuda), scene)
    draws = ik.draw_uniforms(key, 16, rot.shape[0], cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = ik.collision_free_ik(None, *args, draws=draws)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ik.collision_free_ik(None, *args, draws=draws)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tabletop", "cubby", "merged-cubby", "dresser"])
def test_environment_on_the_card(cuda, name):
    """One scene of each environment on the card, its candidates re-checked
    on the CPU: every configuration reaches its pose; the additional and
    neutral candidates are free in the final scene (a dresser's start
    candidate is solved before its target drawer opens); the funnel adds
    up."""
    from mpinets_torch import envs
    from mpinets_torch.geom.scene import SceneSet
    from mpinets_torch.kernels import ik

    rng = np.random.default_rng(1)
    env = envs.ENVIRONMENTS[name](device=cuda)
    for _ in range(10):   # a dresser with one drawer, or no free candidate, is refused
        if env.gen(rng):
            break
    assert len(env.demo_candidates) == 2
    extra = env.gen_candidates(rng, 10)
    neutral = env.gen_neutral_candidates(5, rng)
    f = env.funnel
    assert f["poses"] >= f["ik_solved"] >= f["free"] >= f["kept"] >= 2 + len(extra)
    scene = SceneSet(*(t.cpu() for t in env._unbatched_scene()))
    for cands, margin in ((env.demo_candidates, None), (extra, 0.0), (neutral, 0.01)):
        if not cands:
            continue
        q = torch.as_tensor(np.stack([c.config for c in cands]), dtype=torch.float32)
        rot = torch.as_tensor(np.stack([c.pose.matrix[:3, :3] for c in cands]),
                              dtype=torch.float32)
        trans = torch.as_tensor(np.stack([c.pose.position for c in cands]), dtype=torch.float32)
        pos, ori = ik.pose_errors(q, rot, trans)
        assert bool((pos < ik.POS_TOL + 1e-5).all()) and bool((ori < ik.ORI_TOL + 1e-5).all())
        if margin is not None:
            assert bool(ik.franka_free_space(q, scene, margin - 1e-5).all())
