"""Hand-written CUDA kernels for the PointNet++ hot ops, their plain
PyTorch versions, and the loader that builds the CUDA sources.

Port of ``mpinets_tpu/kernels/pallas_ops.py``:

* :func:`furthest_point_sample_with_coords` -- ``csrc/fps.cu``, replacing
  ``_fps_kernel`` / ``_fps_kernel_v2``.
* :func:`sa_stage` -- ``csrc/sa.cu`` (exact scan), replacing
  ``_sa_kernel_v8`` (``impl="v8"``, with its ``return_raw`` block), and
  ``_sa_kernel`` / ``_sa_kernel_v5`` (``impl="v3"``/``"v5"``): v3, and v5
  with ``centroids_in_cloud=False``, give a centroid without neighbours
  point 0's layer-1 row; v5 with ``centroids_in_cloud=True`` is v8.
* :func:`sa_stage_fast` -- ``csrc/sa.cu`` (chunk-window scan), replacing
  ``_sa_kernel_f1``. The window choice stays here, in torch, as the JAX
  package keeps it in XLA.

The SA stages take their MLP as :class:`SAWeights`, rounded and laid out
for the kernel once by :func:`prepare_sa_weights`. Under bf16 the kernel
runs the MLP on the tensor cores from the bf16 copies there
(:func:`sa_launch_plan` says which kernel a stage gets).

A wrapper given CPU tensors computes the plain version, which repeats the
kernel's arithmetic (the raw-row layer 1 with the folded recentring bias,
and the bf16 rounding points of the TPU kernels). Given CUDA tensors it
launches the kernel or raises; it never falls back. Each launch adds one to
:data:`LAUNCHES` and to :data:`LAUNCHES_BY_SHAPE`, under the name of the
kernel's variant: ``sa`` (exact, in-cloud), ``sa_raw`` (exact, with the raw
block), ``sa_v3`` (exact, off-cloud) or ``sa_fast``. The TPU probe kernels
(``csrc/probes.cu``, wrapped in :mod:`mpinets_torch.probes`) count as
``probe_scan``, ``probe_micro``, ``probe_wide`` and ``probe_scratch``.

The kernels are built at first use with ``nvcc`` into shared libraries with
a plain C interface, loaded through ``ctypes``, under :data:`BUILD_DIR`.
Nothing CUDA-specific happens at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import torch

from mpinets_torch.kernels import pointnet

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"fps": "fps.cu", "sa": "sa.cu", "probes": "probes.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Neighbours per centroid and points per chunk, fixed by both kernels.
NSAMPLE = 128
CHUNK = 128
#: Largest cloud the FPS kernel takes (1024 threads x 8 points each).
FPS_MAX_POINTS = 8192

#: Kernel launches since the last :func:`reset_launches`, by wrapper.
LAUNCHES: Dict[str, int] = {"fps": 0, "sa": 0, "sa_raw": 0, "sa_v3": 0, "sa_fast": 0,
                            "probe_scan": 0, "probe_micro": 0, "probe_wide": 0,
                            "probe_scratch": 0}
#: The same launches by (wrapper, N, S): cloud size and samples or centroids.
LAUNCHES_BY_SHAPE: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mpn_fps": [_P, _I, _I, _I, _I, _P, _P, _P],
    "mpn_sa": [_P] * 4 + [_I] + [_P] * 10 + [_I] * 8 + [ctypes.c_float, _I, _I] + [_P] * 4,
    "mpn_sa_plan": [_I] * 8 + [_P] * 3,
    "mpn_probe_scan": [_P] * 3 + [_I] * 3 + [ctypes.c_float, _I, _P, _P],
    "mpn_probe_micro": [_P, _P] + [_I] * 4 + [_P, _P, _P],
    "mpn_probe_wide": [_P, _P] + [_I] * 4 + [_P, _P],
    "mpn_probe_scratch": [_I, _P, _P],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def _count(name: str, n: int, s: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[(name, n, s)] += 1


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns seconds per source
    built; ``nvcc``'s output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<name>.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, target)
    seconds = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.mpn_error_string.argtypes = [ctypes.c_int]
        lib.mpn_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _launch(lib_name: str, fn: str, device: torch.device, *args) -> None:
    lib = _library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.mpn_error_string(rc).decode()
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc} ({msg})")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA ones (kernel);
    raises for anything else or a mix."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA device, got "
                     f"{sorted(str(t.device) for t in tensors)}")


def _check(t: torch.Tensor, name: str, dtypes, shape, contiguous: bool = True) -> None:
    """Kernel input check: dtype, shape (None = any extent), contiguity."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != len(shape) or any(e is not None and e != d for e, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


# ---------------------------------------------------------------------------
# Furthest-point sampling
# ---------------------------------------------------------------------------

def fps_plain(xyz: torch.Tensor, npoint: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the FPS kernel: f32 distances, first-index argmax."""
    idx = pointnet.furthest_point_sample(xyz, npoint)
    return idx, pointnet.gather_points(xyz, idx)


def furthest_point_sample_with_coords(
    xyz: torch.Tensor, npoint: int, impl: str = "v1"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS: [B, N, 3] -> (idx int32 [B, npoint], coords [B, npoint, 3]).

    Same function as :func:`mpinets_torch.kernels.pointnet.furthest_point_sample`
    (slot 0 is index 0; greedy max-min-distance picks; first-index ties),
    also returning the picked coordinates. ``impl`` "v1" and "v2" name the
    two TPU kernels and launch the same CUDA kernel.
    """
    if impl not in ("v1", "v2"):
        raise ValueError(f"unknown FPS impl {impl!r}")
    if _on_cpu(xyz):
        return fps_plain(xyz, npoint)
    _check(xyz, "xyz", (torch.float32, torch.bfloat16), (None, None, 3))
    b, n, _ = xyz.shape
    if b < 1 or not 1 <= npoint <= n or n > FPS_MAX_POINTS:
        raise ValueError(f"FPS takes 1 <= npoint <= N <= {FPS_MAX_POINTS}, B >= 1; "
                         f"got B={b}, N={n}, npoint={npoint}")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    coords = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    _launch("fps", "mpn_fps", xyz.device, xyz.data_ptr(),
            int(xyz.dtype == torch.bfloat16), b, n, npoint,
            idx.data_ptr(), coords.data_ptr())
    _count("fps", n, npoint)
    return idx, coords.to(xyz.dtype)


# ---------------------------------------------------------------------------
# Fused set-abstraction stage
# ---------------------------------------------------------------------------

def _rounder(compute_dtype):
    if compute_dtype == torch.float32:
        return lambda t: t
    if compute_dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")


def chunk_window(xyz: torch.Tensor, centroids: torch.Tensor, window: int) -> torch.Tensor:
    """The fast kernel's window: per centroid, the ``window`` chunks of 128
    points (clamped to the chunk count) whose mean is nearest, nearest first,
    the lower chunk winning ties -- ``top_k`` over chunk means as in
    ``pallas_ops.py:1249-1259``. Means leave out the pad points of a partial
    last chunk. -> int32 [B, S, W]."""
    b, n, _ = xyz.shape
    nc = -(-n // CHUNK)
    pad = nc * CHUNK - n
    xp = torch.nn.functional.pad(xyz.float(), (0, 0, 0, pad))
    wsum = xp.reshape(b, nc, CHUNK, 3).sum(dim=2)
    real = (torch.arange(nc * CHUNK, device=xyz.device) < n).float()
    wcnt = torch.clamp(real.reshape(nc, CHUNK).sum(dim=1), min=1.0)
    means = wsum / wcnt[None, :, None]
    d2 = ((centroids.float()[:, :, None, :] - means[:, None, :, :]) ** 2).sum(dim=-1)
    order = torch.sort(d2, dim=-1, stable=True).indices
    return order[..., : min(window, nc)].to(torch.int32).contiguous()


class SAWeights(NamedTuple):
    """One SA stage's 3-layer MLP as the kernel reads it: Dense weights
    [in, out], contiguous f32 on the stage's device; under bf16 also the
    tensor-core kernel's copies, which the plain version never reads."""

    w1: torch.Tensor       # [kp, C1] rounded to the compute type; zero rows past 3 + C
    w1_f32: torch.Tensor   # [3 + C, C1] unrounded: the recentring bias and the count==0 row
    b1: torch.Tensor       # [C1]
    w2: torch.Tensor       # [C1, C2] rounded
    b2: torch.Tensor       # [C2]
    w3: torch.Tensor       # [C2, C3] rounded
    b3: torch.Tensor       # [C3]
    compute_dtype: torch.dtype
    # bf16 only: W^T [out, in] in bf16, zero-padded to multiples of 16
    w1t: Optional[torch.Tensor] = None   # [ceil16(C1), ceil16(3 + C)]
    w2t: Optional[torch.Tensor] = None   # [ceil16(C2), ceil16(C1)]
    w3t: Optional[torch.Tensor] = None   # [ceil16(C3), ceil16(C2)]

    @property
    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """The f32 tensors (what the plain version reads)."""
        return tuple(self[:7])

    @property
    def mma_tensors(self) -> Tuple[torch.Tensor, ...]:
        """The tensor-core kernel's bf16 copies; empty under f32."""
        return () if self.w1t is None else (self.w1t, self.w2t, self.w3t)

    @property
    def w1_xyz(self) -> torch.Tensor:
        """[3, C1] unrounded: the folded recentring bias's weights."""
        return self.w1_f32[:3]


def _check_rows(weights: SAWeights, c: int) -> None:
    if weights.w1_f32.shape[0] != 3 + c:
        raise ValueError(f"weights take {weights.w1_f32.shape[0]} input rows "
                         f"({weights.w1.shape[0]} padded input rows), features give 3 + {c}")


def _ceil16(x: int) -> int:
    return -(-x // 16) * 16


def _mma_copy(w: torch.Tensor) -> torch.Tensor:
    """Dense [in, out] -> the tensor-core kernel's bf16 W^T [out, in], both
    dimensions zero-padded to multiples of 16 (the mma's k and n steps)."""
    k, n = w.shape
    wt = w.t().to(torch.bfloat16)
    return torch.nn.functional.pad(wt, (0, _ceil16(k) - k, 0, _ceil16(n) - n)).contiguous()


@torch.no_grad()
def prepare_sa_weights(w1, b1, w2, b2, w3, b3, compute_dtype=torch.bfloat16) -> SAWeights:
    """Round and lay out one stage's MLP weights (Dense [in, out], f32) for
    the SA stages; done once per model and compute type, not per call.
    Under bf16 this also makes the tensor-core kernel's W^T copies."""
    rnd = _rounder(compute_dtype)
    k, c1 = w1.shape
    c2, c3 = w2.shape[1], w3.shape[1]
    for t, name, shape in ((w1, "w1", (k, c1)), (b1, "b1", (c1,)), (w2, "w2", (c1, c2)),
                           (b2, "b2", (c2,)), (w3, "w3", (c2, c3)), (b3, "b3", (c3,))):
        _check(t, name, (torch.float32,), shape, contiguous=False)
    if k < 3:
        raise ValueError(f"w1 takes 3 + C >= 3 input rows, got {k}")
    kp = -(-k // 4) * 4
    mma = (_mma_copy(w1), _mma_copy(w2), _mma_copy(w3)) if compute_dtype == torch.bfloat16 else ()
    return SAWeights(
        torch.nn.functional.pad(rnd(w1), (0, 0, 0, kp - k)).contiguous(),
        w1.contiguous(), b1.contiguous(), rnd(w2).contiguous(), b2.contiguous(),
        rnd(w3).contiguous(), b3.contiguous(), compute_dtype, *mma,
    )


def sa_plain(xyz, features, centroids, weights: SAWeights, radius: float,
             chunks: Optional[torch.Tensor] = None, in_cloud: bool = True,
             return_raw: bool = False):
    """Plain version of the SA kernel (``chunks=None``: exact scan; else the
    fast window scan over ``chunks`` [B, S, W]), following the kernel's
    arithmetic. ``in_cloud=False`` gives a centroid without neighbours point
    0's layer-1 row. -> (features [B, S, C3] f32, idx int32 [B, S, 128]) and,
    with ``return_raw``, the raw block [B, S, 128, 3 + C] f32."""
    rnd = _rounder(weights.compute_dtype)
    bf16 = weights.compute_dtype == torch.bfloat16
    b, n, _ = xyz.shape
    _check_rows(weights, features.shape[-1])
    s = centroids.shape[1]
    dev = xyz.device
    if chunks is None:
        cand = torch.arange(n, device=dev).expand(b, s, n)
        pts = xyz[:, None, :, :]
        live = torch.ones((), dtype=torch.bool, device=dev)
    else:
        lanes = torch.arange(CHUNK, device=dev)
        cand = (chunks.long()[..., None] * CHUNK + lanes).reshape(b, s, -1)
        live = cand < n
        cand = torch.clamp(cand, max=n - 1)
        pts = pointnet.gather_points(xyz, cand)
        if bf16:
            pts = rnd(pts)
    in_ball = (pointnet.sq_dist(pts, centroids[:, :, None, :]) < radius * radius) & live
    count = in_ball.sum(dim=-1)
    length = cand.shape[-1]
    pos = torch.arange(length, device=dev).expand_as(in_ball)
    key = torch.where(in_ball, pos, torch.full_like(pos, length))
    k = min(NSAMPLE, length)
    first = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    if k < NSAMPLE:
        first = torch.cat([first, torch.full_like(first[..., :1], length)
                           .expand(b, s, NSAMPLE - k)], dim=-1)
    found = first < length
    sel = torch.take_along_dim(cand, torch.clamp(first, max=length - 1), dim=-1)
    fill = torch.where(count[..., None] > 0, sel[..., :1], torch.zeros_like(sel[..., :1]))
    idx = torch.where(found, sel, fill).to(torch.int32)

    raw = torch.cat([pointnet.gather_points(xyz, sel), pointnet.gather_points(features, sel)],
                    dim=-1).float()
    raw = torch.where(found[..., None], raw, torch.zeros_like(raw))
    w = weights
    bc = centroids.float() @ w.w1_xyz                         # [B, S, C1] f32
    h = rnd(raw) @ w.w1[: raw.shape[-1]] + w.b1 - bc[:, :, None, :]
    if not in_cloud:
        # count == 0: slot 0 is point 0's layer-1 row, unrounded, in f32
        pts0 = torch.cat([xyz[:, 0], features[:, 0]], dim=-1).float()  # [B, 3 + C]
        h0 = w.b1.expand(b, -1)
        for ch in range(pts0.shape[-1]):
            h0 = h0 + pts0[:, ch, None] * w.w1_f32[ch]
        h0 = h0[:, None, :] - bc                              # [B, S, C1]
        h[:, :, 0] = torch.where((count == 0)[..., None], h0, h[:, :, 0])
    h = rnd(torch.relu(h))
    h = rnd(torch.relu(h @ w.w2 + w.b2))
    h = torch.relu(h @ w.w3 + w.b3)
    valid = torch.arange(NSAMPLE, device=dev) < torch.clamp(count, 1, NSAMPLE)[..., None]
    h = torch.where(valid[..., None], h, torch.full_like(h, -torch.inf))
    if return_raw:
        return h.amax(dim=-2), idx, raw
    return h.amax(dim=-2), idx


def sa_kernel(xyz, features, centroids, weights: SAWeights, radius: float,
              chunks: Optional[torch.Tensor] = None, in_cloud: bool = True,
              return_raw: bool = False):
    """The SA kernel alone, on CUDA tensors: the exact scan (``chunks``
    None) or the window scan over ``chunks`` int32 [B, S, W]; ``in_cloud``
    and ``return_raw`` as in :func:`sa_plain`. What :func:`sa_stage` and
    :func:`sa_stage_fast` launch."""
    extra = () if chunks is None else (chunks,)
    if _on_cpu(xyz, features, centroids, *weights.tensors, *weights.mma_tensors, *extra):
        raise ValueError("sa_kernel takes CUDA tensors (sa_stage runs the plain version)")
    if return_raw and not (in_cloud and chunks is None):
        raise ValueError("the raw block is an output of the exact in-cloud (v8) scan only")
    b, n, _ = xyz.shape
    c = features.shape[-1]
    s = centroids.shape[1]
    w = weights
    kp, c1 = w.w1.shape
    c2, c3 = w.w2.shape[1], w.w3.shape[1]
    _check(xyz, "xyz", (torch.float32,), (b, n, 3))
    _check(features, "features", (torch.float32,), (b, n, c))
    _check(centroids, "centroids", (torch.float32,), (b, None, 3))
    if chunks is not None:
        _check(chunks, "chunks", (torch.int32,), (b, s, None))
    _check_rows(w, c)
    if w.compute_dtype == torch.bfloat16 and not w.mma_tensors:
        raise ValueError("bf16 weights need their tensor-core copies (prepare_sa_weights)")
    for t, name, shape in zip(w.mma_tensors, ("w1t", "w2t", "w3t"),
                              ((c1, 3 + c), (c2, c1), (c3, c2))):
        _check(t, name, (torch.bfloat16,), tuple(_ceil16(d) for d in shape))
    if c1 % 4 or c2 % 4 or b < 1 or s < 1:
        raise ValueError(f"the SA kernel takes C1, C2 multiples of 4 and B, S >= 1; "
                         f"got C1={c1}, C2={c2}, B={b}, S={s}")
    out = torch.empty((b, s, c3), dtype=torch.float32, device=xyz.device)
    idx = torch.empty((b, s, NSAMPLE), dtype=torch.int32, device=xyz.device)
    raw = (torch.empty((b, s, NSAMPLE, 3 + c), dtype=torch.float32, device=xyz.device)
           if return_raw else None)
    window = 0 if chunks is None else chunks.shape[-1]
    _launch(
        "sa", "mpn_sa", xyz.device,
        xyz.data_ptr(), features.data_ptr(), centroids.data_ptr(),
        None if chunks is None else chunks.data_ptr(), window,
        w.w1.data_ptr(), w.w1_f32.data_ptr(), w.b1.data_ptr(), w.w2.data_ptr(),
        w.b2.data_ptr(), w.w3.data_ptr(), w.b3.data_ptr(),
        *([t.data_ptr() for t in w.mma_tensors] or [None] * 3), b, n, s, c, kp, c1, c2, c3,
        float(torch.tensor(radius * radius, dtype=torch.float32)),
        int(w.compute_dtype == torch.bfloat16), int(in_cloud), out.data_ptr(), idx.data_ptr(),
        None if raw is None else raw.data_ptr(),
    )
    if chunks is not None:
        name = "sa_fast"
    elif return_raw:
        name = "sa_raw"
    else:
        name = "sa" if in_cloud else "sa_v3"
    _count(name, n, s)
    return (out, idx, raw) if return_raw else (out, idx)


def sa_launch_plan(weights: SAWeights, c: int, in_cloud: bool = True,
                   raw: bool = False) -> Dict[str, int]:
    """The launch :func:`sa_kernel` makes for these weights and C input
    features on the current CUDA device: ``mma`` 1 for the tensor-core
    kernel (bf16), 0 for the CUDA-core one; its dynamic shared memory in
    bytes; and the blocks of it that fit on one SM."""
    kp, c1 = weights.w1.shape
    c2, c3 = weights.w2.shape[1], weights.w3.shape[1]
    out = [ctypes.c_int() for _ in range(3)]
    rc = _library("sa").mpn_sa_plan(c, kp, c1, c2, c3, int(weights.compute_dtype == torch.bfloat16),
                                    int(in_cloud), int(raw), *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"mpn_sa_plan failed: CUDA error {rc}")
    return dict(zip(("mma", "smem_bytes", "blocks_per_sm"), (v.value for v in out)))


def sa_stage(xyz, features, centroids, weights: SAWeights, radius: float,
             nsample: int = NSAMPLE, impl: str = "v3", centroids_in_cloud: bool = False,
             return_raw: bool = False):
    """Exact fused SA stage: ball query (first 128 in index order) + gather +
    3-layer shared MLP + max-pool, with the CUDA ``pointnet2_ops``
    selection semantics, computed in ``weights.compute_dtype``.

    xyz [B, N, 3], features [B, N, C], centroids [B, S, 3]; ``weights`` from
    :func:`prepare_sa_weights`. -> (features [B, S, C3] f32, idx int32
    [B, S, 128] with fill-with-first), and with ``return_raw`` (``impl="v8"``
    only) the raw block [B, S, 128, 3 + C] f32: each slot's gathered
    ``[xyz, feat]`` as given, not recentred, zero past the count.

    ``impl`` names the TPU kernel and, with ``centroids_in_cloud``, the
    count==0 rule: "v3" always, and "v5" when ``centroids_in_cloud`` is
    False, give a centroid without neighbours point 0's layer-1 row (its
    idx all 0); "v8" requires ``centroids_in_cloud`` (every centroid a cloud
    member, as FPS gives them), and "v5" with it computes what v8 does.
    The defaults are the JAX package's (v3, off the cloud); the policy's
    paths pass ``impl`` and ``centroids_in_cloud`` explicitly.
    """
    if nsample != NSAMPLE:
        raise ValueError(f"the SA kernel keeps {NSAMPLE} neighbours, got nsample={nsample}")
    if impl not in ("v3", "v5", "v8"):
        raise ValueError(f"unknown SA impl {impl!r}")
    if impl == "v8" and not centroids_in_cloud:
        raise ValueError("impl='v8' assumes centroids are cloud members (centroids_in_cloud=True)")
    if return_raw and impl != "v8":
        raise ValueError("return_raw is an output of the v8 kernel only")
    in_cloud = centroids_in_cloud and impl != "v3"
    if _on_cpu(xyz, features, centroids, *weights.tensors):
        return sa_plain(xyz, features, centroids, weights, radius, None, in_cloud, return_raw)
    return sa_kernel(xyz, features, centroids, weights, radius, None, in_cloud, return_raw)


def sa_stage_fast(xyz, features, centroids, weights: SAWeights, radius: float,
                  nsample: int = NSAMPLE, window: int = 12):
    """Relaxed fast-grouping SA stage: each centroid searches only its
    ``window`` nearest chunks of 128 points (:func:`chunk_window`) and keeps
    up to 128 in-ball points in (window rank, lane) order; the rest of the
    stage is :func:`sa_stage`'s. With no in-ball point, slot 0 is a zero raw
    row and idx is all 0.
    """
    if nsample != NSAMPLE:
        raise ValueError(f"the SA kernel keeps {NSAMPLE} neighbours, got nsample={nsample}")
    cpu = _on_cpu(xyz, features, centroids, *weights.tensors)
    chunks = chunk_window(xyz, centroids, window)
    if cpu:
        return sa_plain(xyz, features, centroids, weights, radius, chunks)
    return sa_kernel(xyz, features, centroids, weights, radius, chunks)
