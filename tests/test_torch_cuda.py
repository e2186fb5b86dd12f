"""The hand-written CUDA kernels against their plain versions, on the card.

Every kernel test here is marked ``cuda`` and skips without a CUDA device:
a CUDA kernel has no interpret mode. Two unmarked tests check, on the CPU,
that the inputs built for the tensor-core SA kernel do what they are built
for. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: FPS indices and coordinates exact (the distance code is never
contracted into FMAs); SA index arrays and raw blocks exact; SA features
1e-5 in f32 (sums in another order) and 1e-2 in bf16 (one bf16 ulp of an
activation; relative to max(1, max|f|) in the tensor-core cases); the fused
train path's f32 parameter gradients, kernels against plain versions,
atol 2e-5 + 1e-4 max|g| (``test_fused_train.py``); the TPU probe kernels
(``csrc/probes.cu``) bit-equal to their plain versions, which round and sum
as the kernels do.
"""

import numpy as np
import pytest
import torch

from mpinets_torch.kernels import ops
from mpinets_torch.model import fused_train
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.probes import design, micro, scan, session


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
@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_fps_kernel_matches_plain(cuda, dtype, impl):
    rng = np.random.default_rng(10)
    xyz = torch.from_numpy(rng.normal(size=(4, 1000, 3)).astype(np.float32)).to(dtype)
    before = ops.LAUNCHES["fps"]
    idx, coords = ops.furthest_point_sample_with_coords(xyz.to(cuda), 100, impl=impl)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fps"] == before + 1
    ref_idx, ref_coords = ops.fps_plain(xyz, 100)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy())
    assert torch.equal(coords.cpu(), ref_coords)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sa_kernel_matches_plain(cuda, fast, dtype):
    args = _sa_inputs(11)
    fn = ops.sa_stage_fast if fast else ops.sa_stage
    kw = dict(radius=0.2, **({"window": 3} if fast else {}))
    counter = "sa_fast" if fast else "sa"
    before = ops.LAUNCHES[counter]
    before_shape = ops.LAUNCHES_BY_SHAPE[(counter, 700, 37)]
    if not fast:
        kw.update(impl="v8", centroids_in_cloud=True)
    feats, idx = fn(*_stage_args(args, cuda, dtype), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counter] == before + 1
    assert ops.LAUNCHES_BY_SHAPE[(counter, 700, 37)] == before_shape + 1
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
    """The raw block: bit-equal to the plain version's; launches count as sa_raw."""
    args = _sa_inputs(13)
    kw = dict(radius=0.2, impl="v8", centroids_in_cloud=True, return_raw=True)
    before = ops.LAUNCHES["sa_raw"]
    feats, idx, raw = ops.sa_stage(*_stage_args(args, cuda, dtype), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sa_raw"] == before + 1
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
    before = ops.LAUNCHES["sa_v3"]
    feats, idx = ops.sa_stage(*_stage_args(args, cuda, dtype), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sa_v3"] == before + 1
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
SPREAD_R = 0.1


def _spread_inputs(seed, c=64, widths=(128, 128, 256), masked=False, b=2):
    """Centroid i at (x0 - i, 0, 0) with SPREAD[i] points inside its ball
    of radius SPREAD_R, shuffled among 400 points far from every ball.
    ``masked``: x0 = -20 and positive weights with W1's x row 1 and b1 = 1,
    so a zero raw row past the count (layer-1 input b1 - W1[:3]^T c, about
    21) would beat every real row (about 1 + sum feat W1) in the max-pool;
    else x0 = 0 and weights N(0, 0.2^2)."""
    rng = np.random.default_rng(seed)
    x0 = -20.0 if masked else 0.0
    cent = np.array([(x0 - i, 0.0, 0.0) for i in range(len(SPREAD))], np.float32)
    xyz = []
    for _ in range(b):
        parts = [rng.uniform(-5, 5, (400, 3)) + (0, 0, 10)]
        for centre, k in zip(cent, SPREAD):
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


def _variant(variant, args, device, radius, dtype=torch.bfloat16):
    """One SA variant (counted under its name) on device."""
    xyz, feat, cent, w = _stage_args(args, device, dtype)
    if variant == "sa_fast":   # a window over every chunk: the counts stay exact
        return ops.sa_stage_fast(xyz, feat, cent, w, radius, window=-(-xyz.shape[1] // 128))
    return ops.sa_stage(xyz, feat, cent, w, radius, **VARIANTS[variant])


def _check_mma(cuda, variant, args, radius):
    """bf16 kernel against plain: the tensor-core kernel is the one launched,
    idx equal, raw bit-equal, features within 1e-2 x max(1, max|f|)."""
    w = _stage_args(args, cuda)[3]
    plan = ops.sa_launch_plan(w, args[1].shape[-1], variant != "sa_v3", variant == "sa_raw")
    assert plan["mma"] == 1, plan
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
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sa_mma_counts_across_tile_edges(cuda, variant, masked):
    """Counts on both sides of every tile edge; ``masked``: rows past the
    count would win the max-pool if they entered it."""
    _check_mma(cuda, variant, _spread_inputs(18 + masked, masked=masked), SPREAD_R)


@pytest.mark.cuda
def test_sa_bf16_beyond_shared_memory_takes_the_cuda_core_kernel(cuda):
    """Widths whose bf16 weights do not fit in shared memory: the CUDA-core
    kernel, in bf16, against plain."""
    args = _sa_inputs(20, b=2, n=600, s=20, c=64, widths=(512, 512, 64))
    w = _stage_args(args, cuda)[3]
    assert ops.sa_launch_plan(w, 64)["mma"] == 0
    feats, idx = ops.sa_stage(*_stage_args(args, cuda), radius=0.3, impl="v8",
                              centroids_in_cloud=True)
    torch.cuda.synchronize()
    ref, ref_idx = ops.sa_stage(*_stage_args(args, "cpu"), radius=0.3, impl="v8",
                                centroids_in_cloud=True)
    np.testing.assert_array_equal(idx.cpu().numpy(), ref_idx.numpy())
    scale = max(1.0, ref.abs().max().item())
    assert (feats.cpu() - ref).abs().max().item() <= 1e-2 * scale


@pytest.mark.parametrize("masked", [False, True])
def test_spread_inputs_cross_every_tile_edge(masked):
    """CPU: each centroid keeps SPREAD[i] neighbours (128 at most)."""
    xyz, _, cent = _spread_inputs(18 + masked, masked=masked)[:3]
    inside = ((xyz[:, None] - cent[:, :, None]) ** 2).sum(-1) < SPREAD_R ** 2
    assert inside.sum(-1).tolist() == [list(SPREAD)] * 2
    _, idx = _variant("sa", _spread_inputs(18 + masked, masked=masked), "cpu", SPREAD_R)
    kept = [min(k, 128) for k in SPREAD]
    assert ((idx != idx[..., :1]).sum(-1) + 1).tolist()[0][1:] == kept[1:]


def test_masked_rows_would_win_the_max_pool():
    """CPU: on the masked input, a zero raw row -- what fills a tile past the
    count -- gives every centroid with 0 < count < 128 that is not a multiple
    of 16 features far above its real ones, so a kernel that let such rows
    into the max would fail the 1e-2 gate many times over."""
    args = _spread_inputs(19, masked=True)
    feats, _ = _variant("sa", args, "cpu", SPREAD_R)
    w = _stage_args(args, "cpu")[3]
    rnd = lambda t: t.to(torch.bfloat16).float()
    h = rnd(torch.relu(w.b1 - args[2] @ w.w1_xyz))          # the zero row's layer 1
    h = rnd(torch.relu(h @ w.w2 + w.b2))
    zero_row = torch.relu(h @ w.w3 + w.b3)                   # [B, S, C3]
    gap = (zero_row - feats).amax(-1)
    scale = max(1.0, feats.abs().max().item())
    for i, k in enumerate(SPREAD):
        if 0 < k < 128 and k % 16:
            assert (gap[:, i] > 10 * 1e-2 * scale).all(), (k, gap[:, i], scale)


def _plain_ops(monkeypatch):
    """Route the train path's kernel launches to the plain versions, on any
    device. ``sa_stage`` stays: its mapping of ``impl`` and
    ``centroids_in_cloud`` onto the kernel is part of what is compared."""
    monkeypatch.setattr(ops, "furthest_point_sample_with_coords",
                        lambda xyz, npoint, impl="v1": ops.fps_plain(xyz, npoint))
    monkeypatch.setattr(ops, "sa_kernel", ops.sa_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("sa_impl", ["v8", "v3"])
def test_fused_train_kernels_match_plain_gradients(cuda, monkeypatch, sa_impl):
    rng = np.random.default_rng(15)
    pc = torch.from_numpy(np.concatenate([rng.uniform(-0.7, 0.7, (2, 640, 3)),
                                          rng.integers(0, 3, (2, 640, 1))], -1)
                          .astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.uniform(-1, 1, (2, 7)).astype(np.float32)).to(cuda)
    model = MotionPolicyNetwork(sa_npoints=(64, 16), device=cuda,
                                generator=torch.Generator().manual_seed(15))
    apply = fused_train.make_fused_train_apply(torch.float32, sa_npoints=(64, 16),
                                               sa_impl=sa_impl)

    def grads():
        model.zero_grad()
        torch.sin(apply(model, pc, q)).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    counter = "sa_raw" if sa_impl == "v8" else "sa_v3"
    before = ops.LAUNCHES[counter]
    kernel = grads()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[counter] == before + 2
    _plain_ops(monkeypatch)
    plain = grads()
    for k, ref in plain.items():
        scale = max(ref.abs().max().item(), 1e-6)
        np.testing.assert_allclose(kernel[k].cpu().numpy(), ref.cpu().numpy(),
                                   atol=2e-5 + 1e-4 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# The TPU probe kernels (csrc/probes.cu): the cases of test_torch_probes.py,
# then every probe of the session at the scripts' full shapes
# ---------------------------------------------------------------------------

def _check_probe(kernel, run, plain):
    """One launch, counted under ``kernel``, bit-equal to the plain version."""
    before = ops.LAUNCHES[kernel]
    out = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
    ref = plain()
    assert out.shape == ref.shape
    assert torch.equal(out.cpu(), ref.cpu()), (out.cpu() - ref.cpu()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", scan.SCAN_MODES)
def test_scan_probe_matches_plain(cuda, mode):
    """Edge cases: 150 neighbours, none, an empty chunk, points ulps from the sphere."""
    args = [torch.from_numpy(a) for a in session.edge_scan_inputs(5)]
    _check_probe("probe_scan", lambda: scan.scan_probe(*(a.to(cuda) for a in args), 0.05, mode),
                 lambda: scan.scan_probe(*args, 0.05, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [8, 32])
@pytest.mark.parametrize("op", micro.MICRO_OPS)
def test_micro_probe_matches_plain(cuda, op, reps):
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(0, 1, (196, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 128, (196, 128)).astype(np.int32))
    _check_probe("probe_micro", lambda: micro.micro_probe(a.to(cuda), idx.to(cuda), op, reps, 98),
                 lambda: micro.micro_probe(a, idx, op, reps, 98))
    if op == "bd_matmul":   # every row's work, through the group sums
        _check_probe("probe_micro",
                     lambda: micro.micro_probe(a.to(cuda), idx.to(cuda), op, reps, 98, True)[1],
                     lambda: micro.bd_matmul_plain(a, reps)[1])


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
