"""Inputs for the exact ball query's edge cases, made with numpy from a seed.

Shared by ``test_torch_kernels.py`` (plain version against the JAX package)
and ``test_torch_cuda.py`` (kernel against plain version), so it imports no
JAX. Every case uses r = 0.05:

* ``n200_s8``: N=200, S=8 -- row 0's centroid 0 has all 200 points in its
  ball; row 1's centroids have 129, 1 and 0.
* ``n192_s16``: N=192, S=16 -- row 0's centroids have 128 and 1, row 1's
  127 and 0.
* ``edge_n384_s16``: N=384, S=16 -- the TPU probe session's edge cloud
  (``probes.session.edge_scan_inputs``): 150 neighbours in chunks 0 and 2
  with chunk 1 empty (151 hits with the centroid itself), a centroid with
  none, and points on the sphere whose squared distances are exact
  products a few ulps either side of f32(r*r).

Neither N is a multiple of the 128-point chunk nor S of the 32-centroid
tile. Points inside a ball lie within 0.9 r of its centre; the others lie
near z = 10, far from every centroid, so no test is near the threshold
except the edge cloud's, which is built from exact products.
"""

import numpy as np

from mpinets_torch.probes import session

RADIUS = 0.05
#: in-ball points per centroid, per row (the other centroids have none)
COUNTS = {"n200_s8": (200, [(200,), (129, 1, 0)], 8),
          "n192_s16": (192, [(128, 1), (127, 0)], 16)}
CASES = ("n200_s8", "n192_s16", "edge_n384_s16")


def _row(rng, n, s, counts):
    """One row: centroid i at (i, 0, 0) with counts[i] points in its ball."""
    cent = np.zeros((s, 3))
    cent[:, 0] = np.arange(s)
    parts = []
    for centre, k in zip(cent, counts):
        d = rng.normal(size=(k, 3))
        d *= 0.9 * RADIUS * rng.uniform(0, 1, (k, 1)) ** (1 / 3) / np.linalg.norm(
            d, axis=1, keepdims=True)
        parts.append(centre + d)
    far = n - sum(counts)
    parts.append(np.stack([rng.uniform(-5, 5, far), rng.uniform(-5, 5, far),
                           rng.uniform(9, 11, far)], 1))
    pts = np.concatenate(parts)
    return pts[rng.permutation(n)], cent


def select_case(name, seed=0):
    """-> (xyz [2, N, 3], cent [2, S, 3]) f32 numpy arrays for case ``name``."""
    if name == "edge_n384_s16":
        xyz, _, cent = session.edge_scan_inputs(seed, b=2, n=384, s=16)
        return xyz, cent
    n, rows, s = COUNTS[name]
    rng = np.random.default_rng(seed)
    xyz, cent = zip(*(_row(rng, n, s, counts) for counts in rows))
    return np.stack(xyz).astype(np.float32), np.stack(cent).astype(np.float32)


def in_ball_counts(xyz, cent, radius=RADIUS):
    """In-ball points per centroid, (dx*dx + dy*dy) + dz*dz < f32(r*r) in f32
    (numpy does not contract into FMAs). -> int [B, S]"""
    d = xyz[:, None, :, :] - cent[:, :, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return (d2 < np.float32(radius * radius)).sum(-1)
