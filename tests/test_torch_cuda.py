"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no interpret mode. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: FPS indices and coordinates exact (the distance code is never
contracted into FMAs); SA index arrays and raw blocks exact; SA features
1e-5 in f32 (sums in another order) and 1e-2 in bf16 (one bf16 ulp of an
activation); the fused train path's f32 parameter gradients, kernels
against plain versions, atol 2e-5 + 1e-4 max|g| (``test_fused_train.py``).
"""

import numpy as np
import pytest
import torch

from mpinets_torch.kernels import ops
from mpinets_torch.model import fused_train
from mpinets_torch.model.policy import MotionPolicyNetwork


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
