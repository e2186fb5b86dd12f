"""Port parity for the hand kernels' plain versions.

On the CPU the wrappers of :mod:`mpinets_torch.kernels.ops` compute their
plain versions, which follow the CUDA kernels' arithmetic. They are held
against the JAX package's oracle (:mod:`mpinets_tpu.kernels.pointnet` + the
MLP) and its Pallas kernels in interpret mode, at the shapes and radii of
``tests/test_pallas_sa.py``:

* FPS: identical indices;
* exact SA (v8): identical index sets, f32 features within 1e-5;
* fast SA (f1): identical index sets, f32 features within 1e-5;
* bf16: identical index sets, features within 1e-2 (a sum in another
  order can move a bf16 activation by one ulp, 2^-8 relative);
* the v8 raw block (``return_raw``): identical idx arrays and raw blocks;
* v3 / v5 off the cloud (a centroid with no neighbour takes point 0's
  layer-1 row): identical idx arrays, features 1e-5 (f32) / 1e-2 (bf16).

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.kernels import ops  # noqa: E402
from mpinets_torch.kernels import pointnet as tpn  # noqa: E402
from mpinets_tpu.kernels import pallas_ops  # noqa: E402
from mpinets_tpu.kernels import pointnet as jpn  # noqa: E402

torch.set_float32_matmul_precision("highest")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sa_inputs(seed, b=2, n=384, s=16, c=2, widths=(32, 32, 48), lo=-0.6, hi=0.6):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)
    feat = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    cent = xyz[:, :s].copy()
    dims = (3 + c,) + tuple(widths)
    weights = []
    for i in range(3):
        weights.append((rng.normal(size=(dims[i], dims[i + 1])) * 0.2).astype(np.float32))
        weights.append((rng.normal(size=(dims[i + 1],)) * 0.2).astype(np.float32))
    return xyz, feat, cent, weights


def _oracle(xyz, feat, cent, weights, radius):
    """The JAX package's XLA oracle: ball query + recentred grouping + MLP."""
    idx = jpn.ball_query(jnp.asarray(cent), jnp.asarray(xyz), radius, 128)
    g = jnp.concatenate([jpn.gather_points(jnp.asarray(xyz), idx) - jnp.asarray(cent)[:, :, None],
                         jpn.gather_points(jnp.asarray(feat), idx)], -1)
    w1, b1, w2, b2, w3, b3 = weights
    h = jnp.maximum(jnp.einsum("bsnc,cd->bsnd", g, w1) + b1, 0)
    h = jnp.maximum(jnp.einsum("bsnc,cd->bsnd", h, w2) + b2, 0)
    h = jnp.maximum(jnp.einsum("bsnc,cd->bsnd", h, w3) + b3, 0)
    return _np(jnp.max(h, axis=2)), _np(idx)


def _weights(weights, compute_dtype):
    return ops.prepare_sa_weights(*map(_t, weights), compute_dtype=compute_dtype)


def _assert_same_sets(a, b):
    a, b = np.asarray(a), np.asarray(b)
    for i in np.ndindex(a.shape[:-1]):
        assert set(a[i].tolist()) == set(b[i].tolist()), i


# ---------------------------------------------------------------------------
# FPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_fps_matches_oracle_and_pallas(impl):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(3, 384, 3)).astype(np.float32)
    idx, coords = ops.furthest_point_sample_with_coords(_t(xyz), 64, impl=impl)
    oracle = _np(jpn.furthest_point_sample(jnp.asarray(xyz), 64))
    pidx, pcoords = pallas_ops.furthest_point_sample_with_coords(
        jnp.asarray(xyz), 64, interpret=True, impl=impl)
    np.testing.assert_array_equal(idx.numpy(), oracle)
    np.testing.assert_array_equal(idx.numpy(), _np(pidx))
    np.testing.assert_array_equal(coords.numpy(), _np(pcoords))
    np.testing.assert_array_equal(tpn.furthest_point_sample(_t(xyz), 64).numpy(), oracle)


def test_fps_bf16_coordinates():
    """bf16 coordinates: f32 distances over the bf16 values, bf16 coords out."""
    rng = np.random.default_rng(1)
    xyz = torch.from_numpy(rng.normal(size=(2, 200, 3)).astype(np.float32)).to(torch.bfloat16)
    idx, coords = ops.furthest_point_sample_with_coords(xyz, 32)
    assert coords.dtype == torch.bfloat16
    np.testing.assert_array_equal(idx.numpy(), tpn.furthest_point_sample(xyz.float(), 32).numpy())
    np.testing.assert_array_equal(
        idx.numpy(), _np(jpn.furthest_point_sample(jnp.asarray(xyz.float().numpy()), 32)))


@pytest.mark.parametrize("radius", [0.02, 0.3, 0.9])
def test_ball_query_matches_oracle(radius):
    xyz, _, cent, _ = _sa_inputs(2)
    ours = tpn.ball_query(_t(cent), _t(xyz), radius, 128)
    np.testing.assert_array_equal(
        ours.numpy(), _np(jpn.ball_query(jnp.asarray(cent), jnp.asarray(xyz), radius, 128)))


# ---------------------------------------------------------------------------
# Exact SA (v8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [0.02, 0.3, 0.9])
def test_sa_stage_matches_oracle_and_pallas(radius):
    xyz, feat, cent, weights = _sa_inputs(3)
    feats, idx = ops.sa_stage(_t(xyz), _t(feat), _t(cent), _weights(weights, torch.float32),
                              radius=radius, impl="v8", centroids_in_cloud=True)
    ref, ref_idx = _oracle(xyz, feat, cent, weights, radius)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(feats.numpy(), ref, atol=1e-5, rtol=1e-5)
    pf, pidx = pallas_ops.sa_stage(
        *map(jnp.asarray, (xyz, feat, cent, *weights)), radius=radius, nsample=128,
        compute_dtype=jnp.float32, interpret=True, impl="v8", centroids_in_cloud=True)
    _assert_same_sets(idx.numpy(), pidx)
    np.testing.assert_allclose(feats.numpy(), _np(pf), atol=1e-5, rtol=1e-5)


def test_sa_stage_bf16_matches_pallas():
    xyz, feat, cent, weights = _sa_inputs(4)
    feats, idx = ops.sa_stage(_t(xyz), _t(feat), _t(cent), _weights(weights, torch.bfloat16),
                              radius=0.3, impl="v8", centroids_in_cloud=True)
    pf, pidx = pallas_ops.sa_stage(
        *map(jnp.asarray, (xyz, feat, cent, *weights)), radius=0.3, nsample=128,
        compute_dtype=jnp.bfloat16, interpret=True, impl="v8", centroids_in_cloud=True)
    _assert_same_sets(idx.numpy(), pidx)
    np.testing.assert_allclose(feats.numpy(), _np(pf), atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# Fast SA (f1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["narrow", "full", "empty"])
def test_sa_stage_fast_matches_pallas(case):
    if case == "narrow":   # nc=6, W=2: genuinely truncating
        xyz, feat, cent, weights = _sa_inputs(5, n=768, s=8, c=1, widths=(16, 16, 16),
                                              lo=-0.4, hi=0.4)
        radius, window = 0.25, 2
    else:                  # the window covers every chunk
        xyz, feat, cent, weights = _sa_inputs(6)
        radius, window = 0.1, 8
    if case == "empty":    # a centroid with no point in its ball
        cent[0, 3] = (5.0, 5.0, 5.0)
    args = (xyz, feat, cent, *weights)
    feats, idx = ops.sa_stage_fast(_t(xyz), _t(feat), _t(cent), _weights(weights, torch.float32),
                                   radius=radius, window=window)
    pf, pidx = pallas_ops.sa_stage_fast(*map(jnp.asarray, args), radius=radius, nsample=128,
                                        window=window, compute_dtype=jnp.float32,
                                        interpret=True)
    _assert_same_sets(idx.numpy(), pidx)
    np.testing.assert_allclose(feats.numpy(), _np(pf), atol=1e-5, rtol=1e-5)
    if case == "full":
        ref, ref_idx = _oracle(xyz, feat, cent, weights, radius)
        _assert_same_sets(idx.numpy(), ref_idx)
        np.testing.assert_allclose(feats.numpy(), ref, atol=1e-5, rtol=1e-5)
    if case == "empty":
        assert (idx[0, 3] == 0).all()
        w1, b1, w2, b2, w3, b3 = map(torch.from_numpy, weights)
        h = torch.relu(b1 - torch.from_numpy(cent[0, 3]) @ w1[:3])
        h = torch.relu(torch.relu(h @ w2 + b2) @ w3 + b3)
        np.testing.assert_allclose(feats[0, 3].numpy(), h.numpy(), atol=1e-5)


def test_sa_stage_fast_bf16_matches_pallas():
    xyz, feat, cent, weights = _sa_inputs(7, n=768, s=8, c=1, widths=(16, 16, 16),
                                          lo=-0.4, hi=0.4)
    args = (xyz, feat, cent, *weights)
    feats, idx = ops.sa_stage_fast(_t(xyz), _t(feat), _t(cent), _weights(weights, torch.bfloat16),
                                   radius=0.25, window=3)
    pf, pidx = pallas_ops.sa_stage_fast(*map(jnp.asarray, args), radius=0.25, nsample=128,
                                        window=3, compute_dtype=jnp.bfloat16, interpret=True)
    _assert_same_sets(idx.numpy(), pidx)
    np.testing.assert_allclose(feats.numpy(), _np(pf), atol=1e-2, rtol=1e-2)


def test_chunk_window_matches_top_k():
    xyz, _, cent, _ = _sa_inputs(8, n=700, s=8)
    ours = ops.chunk_window(_t(xyz), _t(cent), 3).numpy()
    n = xyz.shape[1]
    nc = -(-n // 128)
    xp = np.concatenate([xyz, np.zeros((2, nc * 128 - n, 3), np.float32)], 1)
    cnt = np.maximum(np.minimum(n - 128 * np.arange(nc), 128), 1).astype(np.float32)
    means = xp.reshape(2, nc, 128, 3).sum(2) / cnt[None, :, None]
    d2 = ((cent[:, :, None] - means[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ours, _np(jax.lax.top_k(-jnp.asarray(d2), 3)[1]))


def test_wrappers_reject_bad_input_and_count_only_launches():
    xyz, feat, cent, weights = _sa_inputs(9)
    ops.reset_launches()
    args = (_t(xyz), _t(feat), _t(cent), _weights(weights, torch.bfloat16))
    ops.sa_stage(*args, radius=0.3)
    ops.furthest_point_sample_with_coords(_t(xyz), 8)
    assert ops.LAUNCHES == dict.fromkeys(("fps", "sa", "sa_raw", "sa_v3", "sa_fast", "probe_scan",
                                          "probe_micro", "probe_wide", "probe_scratch"), 0)
    # (plain versions launch nothing)
    assert not ops.LAUNCHES_BY_SHAPE
    with pytest.raises(ValueError):
        ops.furthest_point_sample_with_coords(_t(xyz), 8, impl="v3")
    with pytest.raises(ValueError):
        ops.sa_stage(*args, radius=0.3, nsample=64)
    with pytest.raises(ValueError):
        _weights(weights, torch.float16)
    with pytest.raises(TypeError):
        _weights([w.astype(np.float64) for w in weights], torch.float32)
    with pytest.raises(ValueError):
        ops.sa_stage(_t(xyz).to("meta"), *args[1:], radius=0.3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sa_kernel(*args, radius=0.3)
    with pytest.raises(ValueError, match="cloud members"):
        ops.sa_stage(*args, radius=0.3, impl="v8")
    with pytest.raises(ValueError, match="v8"):
        ops.sa_stage(*args, radius=0.3, impl="v5", centroids_in_cloud=True, return_raw=True)
    with pytest.raises(ValueError, match="impl"):
        ops.sa_stage(*args, radius=0.3, impl="v4")


def test_prepared_weights_are_rounded_and_padded():
    """Layer 1 padded to a multiple of 4 rows with zeros; w1..w3 rounded to
    the compute type; the recentring weights and the biases left in f32;
    under bf16 the tensor-core copies: the rounded weights transposed to
    [out, in] and zero-padded to multiples of 16, bf16."""
    _, _, _, weights = _sa_inputs(10, c=2)
    w = _weights(weights, torch.bfloat16)
    w1, b1, w2, b2, w3, b3 = map(_t, weights)
    rnd = lambda t: t.to(torch.bfloat16).float()
    assert w.w1.shape == (8, 32) and w.w1.is_contiguous()
    assert torch.equal(w.w1[:5], rnd(w1)) and not w.w1[5:].any()
    assert torch.equal(w.w1_xyz, w1[:3]) and torch.equal(w.b1, b1)
    assert torch.equal(w.w1_f32, w1)
    assert torch.equal(w.w2, rnd(w2)) and torch.equal(w.w3, rnd(w3))
    assert torch.equal(w.b2, b2) and torch.equal(w.b3, b3)
    assert w.compute_dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in w.tensors)
    assert [tuple(t.shape) for t in w.mma_tensors] == [(32, 16), (32, 32), (48, 32)]
    for t, ref in zip(w.mma_tensors, (w1, w2, w3)):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        k, n = ref.shape
        assert torch.equal(t[:n, :k].float(), rnd(ref).t()) and not t[n:].any()
        assert not t[:, k:].any()
    assert _weights(weights, torch.float32).mma_tensors == ()


@pytest.mark.parametrize("c, widths", [(3, (36, 20, 40)), (64, (128, 128, 256))])
def test_mma_copies_pad_any_width_and_plain_never_reads_them(c, widths):
    """The tensor-core copies for widths that are not multiples of 16 (and
    the SA1 widths): zero-padded to [ceil16(out), ceil16(in)]; the plain
    version gives the same result with the copies poisoned."""
    xyz, feat, cent, weights = _sa_inputs(16, n=256, s=8, c=c, widths=widths)
    w = _weights(weights, torch.bfloat16)
    up = lambda d: -(-d // 16) * 16
    dims = (3 + c,) + widths
    for i, t in enumerate(w.mma_tensors):
        assert t.shape == (up(dims[i + 1]), up(dims[i])), i
        assert torch.equal(t[:dims[i + 1], :dims[i]].float(),
                           _t(weights[2 * i]).to(torch.bfloat16).float().t())
        assert not t[dims[i + 1]:].any() and not t[:, dims[i]:].any()
    args = (_t(xyz), _t(feat), _t(cent))
    ref = ops.sa_stage(*args, w, radius=0.3, impl="v8", centroids_in_cloud=True)
    poisoned = w._replace(**{k: torch.full_like(getattr(w, k), float("nan"))
                             for k in ("w1t", "w2t", "w3t")})
    out = ops.sa_stage(*args, poisoned, radius=0.3, impl="v8", centroids_in_cloud=True)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert torch.isfinite(ref[0]).all()


# ---------------------------------------------------------------------------
# The v8 raw block, and v3 / v5 with centroids off the cloud
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sa_stage_raw_block_matches_pallas(dtype):
    """idx arrays and raw blocks identical; each raw row is the cloud row of
    its idx up to the count, zero after it."""
    xyz, feat, cent, weights = _sa_inputs(11, n=256, c=1)
    feats, idx, raw = ops.sa_stage(_t(xyz), _t(feat), _t(cent), _weights(weights, dtype),
                                   radius=0.2, impl="v8", centroids_in_cloud=True,
                                   return_raw=True)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pf, pidx, praw = pallas_ops.sa_stage(
        *map(jnp.asarray, (xyz, feat, cent, *weights)), radius=0.2, nsample=128,
        compute_dtype=jdt, interpret=True, impl="v8", centroids_in_cloud=True, return_raw=True)
    np.testing.assert_array_equal(idx.numpy(), _np(pidx))
    assert raw.dtype == torch.float32 and raw.shape == (2, 16, 128, 4)
    np.testing.assert_array_equal(raw.numpy(), _np(praw))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(feats.numpy(), _np(pf), atol=tol, rtol=tol)
    rows = np.concatenate([xyz, feat], -1)
    count = (((xyz[:, None] - cent[:, :, None]) ** 2).sum(-1) < 0.04).sum(-1)
    for b, s in np.ndindex(count.shape):
        k = min(count[b, s], 128)
        np.testing.assert_array_equal(raw[b, s, :k].numpy(), rows[b, idx[b, s, :k].numpy()])
        assert not raw[b, s, k:].any()


def _off_cloud(seed):
    """Centroids off the cloud: one with no point in its ball (count 0, the
    point-0 branch) and others moved off their points."""
    xyz, feat, cent, weights = _sa_inputs(seed, n=256, c=2)
    cent[:, 1:6] += np.float32(0.013)
    cent[0, 3] = (5.0, 5.0, 5.0)
    cent[1, 7] = (-4.0, 0.0, 2.0)
    return xyz, feat, cent, weights


@pytest.mark.parametrize("impl, dtype", [("v3", torch.float32), ("v5", torch.float32),
                                         ("v3", torch.bfloat16)])
def test_sa_stage_off_cloud_matches_pallas(impl, dtype):
    xyz, feat, cent, weights = _off_cloud(12)
    feats, idx = ops.sa_stage(_t(xyz), _t(feat), _t(cent), _weights(weights, dtype),
                              radius=0.2, impl=impl, centroids_in_cloud=False)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pf, pidx = pallas_ops.sa_stage(
        *map(jnp.asarray, (xyz, feat, cent, *weights)), radius=0.2, nsample=128,
        compute_dtype=jdt, interpret=True, impl=impl, centroids_in_cloud=False)
    np.testing.assert_array_equal(idx.numpy(), _np(pidx))
    assert (idx[0, 3] == 0).all() and (idx[1, 7] == 0).all()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(feats.numpy(), _np(pf), atol=tol, rtol=tol)
    if dtype == torch.float32:
        # count 0: point 0's row, recentred on the centroid, through the MLP
        w1, b1, w2, b2, w3, b3 = map(torch.from_numpy, weights)
        pts0 = torch.from_numpy(np.concatenate([xyz[0, 0] - cent[0, 3], feat[0, 0]]))
        h = torch.relu(torch.relu(torch.relu(pts0 @ w1 + b1) @ w2 + b2) @ w3 + b3)
        np.testing.assert_allclose(feats[0, 3].numpy(), h.numpy(), atol=1e-5)


def test_sa_stage_impls_agree_on_the_cloud():
    """With cloud members as centroids v3, v5 and v8 compute the same stage;
    off the cloud v5 with centroids_in_cloud=True is v8 exactly."""
    xyz, feat, cent, weights = _sa_inputs(13)
    args = (_t(xyz), _t(feat), _t(cent), _weights(weights, torch.bfloat16))
    v8 = ops.sa_stage(*args, radius=0.3, impl="v8", centroids_in_cloud=True)
    for impl, in_cloud in (("v3", False), ("v5", False), ("v5", True), ("v3", True)):
        out = ops.sa_stage(*args, radius=0.3, impl=impl, centroids_in_cloud=in_cloud)
        assert torch.equal(out[0], v8[0]) and torch.equal(out[1], v8[1])
    xyz, feat, cent, weights = _off_cloud(14)
    args = (_t(xyz), _t(feat), _t(cent), _weights(weights, torch.bfloat16))
    v8 = ops.sa_stage(*args, radius=0.2, impl="v8", centroids_in_cloud=True)
    v5 = ops.sa_stage(*args, radius=0.2, impl="v5", centroids_in_cloud=True)
    v3 = ops.sa_stage(*args, radius=0.2, impl="v3", centroids_in_cloud=True)
    assert torch.equal(v5[0], v8[0]) and torch.equal(v5[1], v8[1])
    assert not torch.equal(v3[0][0, 3], v8[0][0, 3])  # v3 ignores the flag
