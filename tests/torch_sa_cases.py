"""Helpers shared by the SA kernels' checks (``tests/test_torch_cuda.py``,
``tests/test_torch_sa_backward.py`` and ``chip_smoke.py``, which imports
torch only once it runs)."""


def replay_backward(raw, idx, centroids, mlp, g, n_points, cdt):
    """The v8 SA stage's backward replayed in plain torch, the reference the
    backward kernels and their plain version are held to: autograd of the
    dense MLP over all 128 slots of the raw block [B, S, 128, 3 + C]
    (recentred first, activations stored in ``cdt``) and the max over the
    valid slots (the fill rule's), with cotangent ``g`` [B, S, C3]; with
    ``n_points`` (the cloud's N) the features' cotangent as
    :func:`feature_cotangent` sums it. ``mlp``: six f32 Dense [in, out]
    tensors. -> [gf or None, dw1, db1, dw2, db2, dw3, db3]."""
    import torch

    from mpinets_torch.kernels import ops

    valid = ops.valid_slots(idx)
    raw_ = raw.detach().requires_grad_(n_points is not None)
    w = [t.detach().requires_grad_() for t in mlp]
    with torch.enable_grad():
        h = torch.cat([raw_[..., :3] - centroids[:, :, None, :], raw_[..., 3:]], dim=-1).to(cdt)
        for i in (0, 2):
            h = torch.relu((h @ w[i].to(cdt)).float() + w[i + 1]).to(cdt)
        h = torch.relu((h @ w[4].to(cdt)).float() + w[5])
        out = torch.where(valid[..., None], h, torch.full_like(h, -torch.inf)).amax(dim=2)
        grads = list(torch.autograd.grad(out, ([raw_] if n_points is not None else []) + w, g))
    gf = feature_cotangent(grads.pop(0), idx, n_points, cdt) if n_points is not None else None
    return [gf] + grads


def feature_cotangent(draw, idx, n_points, cdt):
    """The features' cotangent [B, N, C] from the raw block's [B, S, 128, 3 + C]:
    each valid slot's feature columns rounded to ``cdt``, summed into its
    point in f32."""
    import torch

    from mpinets_torch.kernels import ops

    b, c = draw.shape[0], draw.shape[-1] - 3
    delta = (draw[..., 3:] * ops.valid_slots(idx)[..., None]).to(cdt).float().reshape(-1, c)
    rows = idx.long() + n_points * torch.arange(b, device=idx.device)[:, None, None]
    gf = torch.zeros((b * n_points, c), dtype=torch.float32, device=draw.device)
    return gf.index_add_(0, rows.reshape(-1), delta).reshape(b, n_points, c)


def exact_mlp(dims, gen, terms=1):
    """MLP weights [in, out] with ``terms`` nonzero terms an output (every
    input where a layer has fewer): output j takes input j mod in and
    ``terms`` - 1 others drawn at random, each times +-1/2, 3/4, 1 or 5/4,
    plus a bias in multiples of 1/32. With one term every product sums one
    term, exactly, in any order. With up to 8, on a cloud of
    :func:`grid_cloud` at the policy's widths, every sum of the SA forward
    is exact in f32 in any order too: the products of layer l are multiples
    of 2^-(6 + 2l) below 2^(4.6 + 3.3 (l - 1)), 23.2 bits at most."""
    import torch

    mlp = []
    for k, n in zip(dims[:-1], dims[1:]):
        w = torch.zeros(k, n)
        scale = torch.tensor([0.5, 0.75, 1.0, 1.25])[torch.randint(0, 4, (n,), generator=gen)]
        w[torch.arange(n) % k, torch.arange(n)] = scale * (
            torch.randint(0, 2, (n,), generator=gen) * 2 - 1)
        for j in range(n) if terms > 1 else ():
            others = [i for i in torch.randperm(k, generator=gen).tolist() if i != j % k]
            for i in others[:terms - 1]:
                w[i, j] = float(torch.tensor([0.5, 0.75, 1.0, 1.25])[
                    torch.randint(0, 4, (), generator=gen)]) * (
                    2 * int(torch.randint(0, 2, (), generator=gen)) - 1)
        mlp += [w, torch.randint(-8, 9, (n,), generator=gen) / 32]
    return mlp


def grid_cloud(b, n, c, gen):
    """A cloud [B, N, 3] on the 1/64 grid of the unit cube and features
    [B, N, C] exact in bf16: SA0's labels 0, 1 or 2 (C = 1), else multiples
    of 1/16 below 2. -> (xyz, features)."""
    import torch

    xyz = torch.randint(0, 64, (b, n, 3), generator=gen) / 64
    if c == 1:
        return xyz, torch.randint(0, 3, (b, n, 1), generator=gen).float()
    return xyz, torch.randint(0, 32, (b, n, c), generator=gen) / 16


def rel_l2(a, b):
    """Relative L2 distance of two tensors: |a - b| / |b|."""
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)
