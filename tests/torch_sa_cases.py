"""Helpers shared by the SA kernels' checks (``tests/test_torch_cuda.py``,
``tests/test_torch_sa_backward.py`` and ``chip_smoke.py``, which imports
torch only once it runs)."""


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
