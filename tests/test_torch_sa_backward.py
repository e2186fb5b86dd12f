"""The SA backward's plain version (:func:`ops.sa_stage_backward_plain`)
against the autograd of the replay it replaces in the bf16 train step
(``fused_train._mlp_max`` over the saved raw block, the feature cotangent
rounded per slot and summed into its points).

Inputs are built slot by slot, at SA0's widths (C=1 -> 64, 64, 64; no
feature cotangent) and SA1's (C=64 -> 128, 128, 256), B = 1 and 3, one case
each: a centroid with one valid slot; one with all 128; duplicate points in
one ball (their rows tie and split the cotangent); a channel that layer 3's
bias puts at 0 on every row; selections that share points, so the feature
cotangent of a point sums over centroids.

f32: the two compute the same function (the twin folds the recentring into
layer 1's bias), within 1e-5 max|g| (sums in another order). bf16: they
round in different places (the replay rounds the recentred rows and every
matmul's output, the twin the raw rows, as the forward kernel does), so
maxima and ties move at bf16 resolution. Each tensor is held to the
replay's by the two's distance from the f32 gradients, as
``test_torch_fused_train.py`` holds the port to JAX: within sqrt(2) times
the larger relative L2 distance from f32, plus 1e-3; and, element by
element within 1e-2 max|g|, to the autograd of the forward kernel's own
arithmetic (whose maxima are the twin's), which differs only in where the
cotangents are rounded.
"""

import numpy as np
import pytest
import torch

from mpinets_torch.kernels import ops
from mpinets_torch.model import fused_train
from torch_sa_cases import rel_l2

SA0 = (1, (64, 64, 64))
SA1 = (64, (128, 128, 256))
CASES = ("one_slot", "all_slots", "ties", "dead_channel", "shared_points")
S, N = 6, 300
BF16_GRAD_FLOOR = 1e-3


def _inputs(case, b, widths, seed=3):
    """(raw, idx, centroids, MLP [in, out] f32, g, N) for one case."""
    c, mlp = widths
    rng = np.random.default_rng(seed + 7 * CASES.index(case) + b)
    xyz = rng.uniform(-0.2, 0.2, (b, N, 3)).astype(np.float32)
    feat = (rng.integers(0, 3, (b, N, c)) if c == 1 else rng.uniform(0, 1, (b, N, c)))
    feat = feat.astype(np.float32)
    counts = rng.integers(2, 60, (b, S))
    pool = N
    if case == "one_slot":
        counts[:, 0] = 1
    elif case == "all_slots":
        counts[:, 1] = 128
    elif case == "ties":
        xyz[:, 1], feat[:, 1] = xyz[:, 0], feat[:, 0]  # point 1 duplicates point 0
    elif case == "shared_points":
        pool = 140  # every selection draws from the first 140 points
    idx = np.zeros((b, S, 128), np.int32)
    for bi in range(b):
        for si in range(S):
            k = counts[bi, si]
            pick = np.sort(rng.choice(pool, k, replace=False))
            if case == "ties":
                pick = np.unique(np.concatenate([[0, 1], pick]))[:k]
            idx[bi, si, :k] = pick
            idx[bi, si, k:] = pick[0]  # fill with the first
    valid = np.arange(128) < counts[..., None]
    gathered = np.concatenate([np.take_along_axis(xyz, idx.reshape(b, -1, 1), 1),
                               np.take_along_axis(feat, idx.reshape(b, -1, 1), 1)], -1)
    raw = np.where(valid[..., None], gathered.reshape(b, S, 128, -1), 0).astype(np.float32)
    cent = xyz[:, :S].copy()
    dims = (3 + c,) + mlp
    weights = []
    for i in range(3):
        weights.append(rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i]))
        weights.append(rng.normal(size=dims[i + 1]) * 0.1)
    if case == "dead_channel":
        weights[-1][5] = -1e3  # layer 3's channel 5 is 0 on every row
    g = rng.normal(size=(b, S, dims[-1]))
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return to(raw), torch.from_numpy(idx), to(cent), [to(w) for w in weights], to(g), N, c


def _replay(raw, idx, cent, mlp, g, n, features_grad, cdt):
    """The replay's cotangents: autograd of _mlp_max, gf as the replay sums it."""
    valid = ops.valid_slots(idx)
    raw_ = raw.clone().requires_grad_(features_grad)
    mlp = [t.clone().requires_grad_() for t in mlp]
    out = fused_train._mlp_max(raw_, cent, valid, *mlp, cdt)
    grads = list(torch.autograd.grad(out, ([raw_] if features_grad else []) + mlp, g))
    return [_gf(grads.pop(0), idx, valid, n, cdt) if features_grad else None] + grads


def _gf(draw, idx, valid, n, cdt):
    b, c = draw.shape[0], draw.shape[-1] - 3
    delta = (draw[..., 3:] * valid[..., None]).to(cdt).float().reshape(-1, c)
    rows = idx.long() + n * torch.arange(b)[:, None, None]
    return torch.zeros((b * n, c)).index_add_(0, rows.reshape(-1), delta).reshape(b, n, c)


def _kernel_arithmetic(raw, idx, cent, mlp, g, n, features_grad, cdt):
    """Autograd of the stage in the forward kernel's arithmetic (raw rows
    rounded, the recentring folded into layer 1's bias, f32 pre-activations)."""
    rnd = lambda t: t.to(cdt).float()  # noqa: E731
    valid = ops.valid_slots(idx)
    raw_ = raw.clone().requires_grad_(features_grad)
    w = [t.clone().requires_grad_() for t in mlp]
    u1 = rnd(raw_) @ rnd(w[0]) + w[1] - (cent @ w[0][:3])[:, :, None, :]
    h2 = rnd(torch.relu(rnd(torch.relu(u1)) @ rnd(w[2]) + w[3]))
    z = torch.relu(h2 @ rnd(w[4]) + w[5])
    out = torch.where(valid[..., None], z, torch.full_like(z, -torch.inf)).amax(dim=2)
    grads = list(torch.autograd.grad(out, ([raw_] if features_grad else []) + w, g))
    return [_gf(grads.pop(0), idx, valid, n, cdt) if features_grad else None] + grads


def _twin(raw, idx, cent, mlp, g, n, features_grad, cdt):
    weights = ops.prepare_sa_weights(*mlp, compute_dtype=cdt)
    return list(ops.sa_stage_backward(raw, idx, cent, weights, g,
                                      n if features_grad else None))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("widths", [SA0, SA1], ids=["sa0", "sa1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sa_backward_twin_matches_replay(case, b, widths, dtype):
    raw, idx, cent, mlp, g, n, c = _inputs(case, b, widths)
    features_grad = c > 1
    args = (raw, idx, cent, mlp, g, n, features_grad)
    ours = _twin(*args, dtype)
    ref = _replay(*args, dtype)
    assert (ours[0] is None) == (not features_grad)
    names = ("gf", "dw1", "db1", "dw2", "db2", "dw3", "db3")

    def close(a, r, tol, name):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), r.numpy(),
                                   atol=tol * max(r.abs().max().item(), 1e-6), err_msg=name)

    if dtype == torch.float32:
        for name, a, r in zip(names, ours, ref):
            if r is not None:
                close(a, r, 1e-5, name)
        return
    f32 = _replay(*args, torch.float32)
    same_max = _kernel_arithmetic(*args, dtype)
    for name, a, r, r32, k in zip(names, ours, ref, f32, same_max):
        if r is None:
            continue
        bound = np.sqrt(2) * max(rel_l2(r, r32), rel_l2(a, r32)) + BF16_GRAD_FLOOR
        assert rel_l2(a, r) <= bound, (name, rel_l2(a, r), bound)
        close(a, k, 1e-2, name)


def _case_facts(case, b, widths):
    """What the case is built to show, read off the f32 replay's forward."""
    raw, idx, cent, mlp, g, n, c = _inputs(case, b, widths)
    valid = ops.valid_slots(idx)
    h = torch.cat([raw[..., :3] - cent[:, :, None, :], raw[..., 3:]], dim=-1)
    for i in range(3):
        h = torch.relu(h @ mlp[2 * i] + mlp[2 * i + 1])
    z = torch.where(valid[..., None], h, torch.full_like(h, -torch.inf))
    ties = (valid[..., None] & (z == z.amax(dim=2, keepdim=True)) & (z > 0)).sum(dim=2)
    return dict(counts=valid.sum(dim=2), ties=ties, zmax=z.amax(dim=2), idx=idx)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("widths", [SA0, SA1], ids=["sa0", "sa1"])
def test_sa_backward_cases_hold_what_they_are_built_for(case, widths):
    facts = _case_facts(case, 3, widths)
    if case == "one_slot":
        assert (facts["counts"][:, 0] == 1).all()
    elif case == "all_slots":
        assert (facts["counts"][:, 1] == 128).all()
    elif case == "ties":
        assert (facts["ties"] >= 2).any()
    elif case == "dead_channel":
        assert (facts["zmax"][..., 5] == 0).all()
    else:
        valid = ops.valid_slots(facts["idx"])
        for bi in range(3):
            picked = facts["idx"][bi][valid[bi]]
            assert len(torch.unique(picked)) < len(picked)  # a point in several selections


def test_sa_backward_dead_channel_and_single_rows_take_what_they_should():
    """A dead channel takes no cotangent (db3 0 there); a centroid whose only
    valid slot holds the max takes the whole cotangent on that row."""
    raw, idx, cent, mlp, g, n, _ = _inputs("dead_channel", 1, SA1)
    out = _twin(raw, idx, cent, mlp, g, n, True, torch.float32)
    assert out[6][5] == 0 and (out[5][:, 5] == 0).all()
    raw, idx, cent, mlp, g, n, _ = _inputs("one_slot", 1, SA1)
    g = torch.zeros_like(g)
    g[0, 0] = 1.0  # the one-slot centroid alone
    out = _twin(raw, idx, cent, mlp, g, n, True, torch.float32)
    z = torch.relu(raw[0, 0, 0] @ mlp[0] + mlp[1] - cent[0, 0] @ mlp[0][:3])
    z = torch.relu(torch.relu(z @ mlp[2] + mlp[3]) @ mlp[4] + mlp[5])
    np.testing.assert_allclose(out[6].numpy(), (z > 0).float().numpy(), atol=0)
