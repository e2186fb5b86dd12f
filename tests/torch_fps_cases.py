"""FPS inputs shared by the CPU parity tests (``test_torch_fps.py``) and the
card tests (``test_torch_cuda.py``).

The grid kinds (``KINDS``) lie on a grid of step 1/32 within [-2, 2], so
coordinates are exact in bf16 and every squared distance is exact in f32:
an FMA, which the JAX reference may contract the distance into on the CPU,
rounds nothing, and the picks are compared index for index. The kinds:

* ``ties``: a 5^3 grid of step 0.5, so most points share their position
  with others and many lie at equal distances; once every position is
  picked all running minima are 0 and the picks fall back to index 0;
* ``dups``: every point appears twice, at shuffled indices;
* ``fine``: points on the 1/32 grid (few exact ties);
* ``normal`` (card tests only): standard normal coordinates, off any grid,
  so every squared distance rounds; a kernel whose distance were contracted
  into an FMA, or summed in another order, would pick differently.
"""

import numpy as np

KINDS = ("ties", "dups", "fine")
CARD_KINDS = ("ties", "dups", "normal")

#: (B, N, npoint) for the CPU tests against the JAX package: N not a
#: multiple of 32 or 128, npoint == N, a small and a tiny cloud.
CPU_CASES = ((3, 384, 200), (2, 192, 64), (2, 200, 200), (3, 16, 16), (2, 300, 150))

#: (B, N, npoint) for the card tests, one or more per class of plan the
#: wrapper picks (points a thread, cluster): (1, 1) 16 and 100 points;
#: (2, 1) 200; (4, 1) 300; (8, 1) 1000 (the old 4 x 1000 cloud), and 2050
#: at B > 66; (8, 2) 6272 and 8192 at 33 < B <= 66; (8, 4) 2048, 6272 and
#: 7001 at B <= 33. The plan never picks a cluster of 8: CLUSTER_CASES runs
#: every cluster size the kernel takes.
CARD_CASES = ((4, 16, 16), (2, 100, 100), (4, 200, 64), (4, 300, 128), (4, 1000, 1000),
              (67, 2050, 300), (34, 6272, 512), (40, 8192, 64), (20, 2048, 256),
              (2, 2048, 512), (1, 6272, 512), (3, 7001, 512))
CLUSTER_CASES = ((3, 6272, 512), (2, 2048, 256))


def cloud(kind: str, b: int, n: int, seed: int) -> np.ndarray:
    """A [b, n, 3] f32 cloud of the given kind."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        pts = rng.integers(-2, 3, (b, n, 3)) * 0.5
    elif kind == "dups":
        half = rng.integers(-64, 65, (b, (n + 1) // 2, 3)) / 32
        pts = np.concatenate([half, half], axis=1)[:, rng.permutation(n)]
    elif kind == "fine":
        pts = rng.integers(-64, 65, (b, n, 3)) / 32
    elif kind == "normal":
        pts = rng.normal(size=(b, n, 3))
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(pts, dtype=np.float32)
