"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no interpret mode. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: FPS indices and coordinates exact (the distance code is never
contracted into FMAs); SA index arrays exact; SA features 1e-5 in f32 (sums
in another order) and 1e-2 in bf16 (one bf16 ulp of an activation).
"""

import numpy as np
import pytest
import torch

from mpinets_torch.kernels import ops


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
