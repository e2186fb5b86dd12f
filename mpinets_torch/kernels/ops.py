"""Hand-written CUDA kernels for the PointNet++ hot ops, their plain
PyTorch versions, and the loader that builds the CUDA sources.

Port of ``mpinets_tpu/kernels/pallas_ops.py``:

* :func:`furthest_point_sample_with_coords` -- ``csrc/fps.cu``, replacing
  ``_fps_kernel`` / ``_fps_kernel_v2``, launched by the plan
  :func:`fps_plan` gives for (B, N).
* :func:`sa_stage` -- ``csrc/sa.cu`` (exact grouping: the ball-query
  kernel, :func:`sa_select`, then an MLP kernel that reads its selection),
  replacing ``_sa_kernel_v8`` (``impl="v8"``, with its ``return_raw``
  block), and ``_sa_kernel`` / ``_sa_kernel_v5`` (``impl="v3"``/``"v5"``):
  v3, and v5 with ``centroids_in_cloud=False``, give a centroid without
  neighbours point 0's layer-1 row; v5 with ``centroids_in_cloud=True`` is
  v8.
* :func:`sa_stage_fast` -- ``csrc/sa.cu`` (chunk-window scan), replacing
  ``_sa_kernel_f1``. The window choice stays here, in torch, as the JAX
  package keeps it in XLA.
* :func:`sa_stage_backward` -- ``csrc/sa_bwd.cu``, the train step's
  backward of an exact in-cloud bf16 stage over its valid rows. It replaces
  no TPU kernel: the JAX package's backward is plain XLA.

The SA stages take their MLP as :class:`SAWeights`, rounded and laid out
for the kernel once by :func:`prepare_sa_weights`. Under bf16 the kernel
runs the MLP on the tensor cores from the bf16 copies there: on ``wgmma``
(64-row tiles, a persistent grid) for exact in-cloud stages without the raw
block whose layers are wider than 64 (SA1), else on ``mma.sync`` (16-row
tiles); under f32 on the CUDA cores (register-tiled f32 FFMA over tiles of
128 packed rows, the weights streamed through shared memory). All pack
the rows of 8, 16 or 32 centroids a block or work item
(:func:`sa_launch_plan` says which kernel a stage gets, its centroids per
block and rows per tile).

A wrapper given CPU tensors computes the plain version, which repeats the
kernel's arithmetic (the raw-row layer 1 with the folded recentring bias,
and the bf16 rounding points of the TPU kernels). Given CUDA tensors it
launches the kernel or raises; it never falls back. Each launch adds one to
:data:`LAUNCHES` and to :data:`LAUNCHES_BY_SHAPE`, under the name of the
kernel: ``fps``; ``sa_select`` (the exact ball query); the SA MLP kernel by
variant, ``sa`` (exact, in-cloud), ``sa_raw`` (exact, with the raw block),
``sa_v3`` (exact, off-cloud) or ``sa_fast`` (its own window scan), each
with ``_f32`` appended under f32 weights (the CUDA-core kernel; bf16 runs
the tensor-core one); ``sa_bwd`` once a call of :func:`sa_stage_backward`
(its three kernels). An exact
SA stage counts one ``sa_select`` and one MLP launch; an FPS launch also
counts under its plan in :data:`FPS_LAUNCHES_BY_PLAN`. The TPU probe kernels
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
SOURCES = {"fps": "fps.cu", "sa": "sa.cu", "sa_bwd": "sa_bwd.cu", "probes": "probes.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Neighbours per centroid and points per chunk, fixed by both kernels.
NSAMPLE = 128
CHUNK = 128
#: Largest cloud the FPS kernel takes (each block keeps the row's copy and
#: its picks in shared memory: 128 KB at most at 8192 points).
FPS_MAX_POINTS = 8192
#: Largest cloud the ball-query kernel stages in shared memory (x, y, z f32:
#: 192 KB, one block per SM; 75 KB and two or more at the 6272-point cloud).
SELECT_MAX_POINTS = 16384
#: Centroids per block the SA MLP kernels take (the tensor-core one and the
#: CUDA-core one); the launch plan picks one (:func:`sa_launch_plan`).
SA_CENTROIDS_PER_BLOCK = (8, 16, 32)

#: Kernel launches since the last :func:`reset_launches`, by wrapper.
LAUNCHES: Dict[str, int] = {"fps": 0, "sa_select": 0, "sa": 0, "sa_raw": 0, "sa_v3": 0,
                            "sa_fast": 0, "sa_f32": 0, "sa_raw_f32": 0, "sa_v3_f32": 0,
                            "sa_fast_f32": 0, "sa_bwd": 0, "probe_scan": 0, "probe_micro": 0,
                            "probe_wide": 0, "probe_scratch": 0}
#: The same launches by (kernel, B, N, S): batch, cloud size, and samples or
#: centroids.
LAUNCHES_BY_SHAPE: Counter = Counter()
#: The FPS launches by :class:`FpsPlan`.
FPS_LAUNCHES_BY_PLAN: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mpn_fps": [_P] + [_I] * 7 + [_P] * 3,
    "mpn_fps_plan": [_I] * 6 + [_P] * 3,
    "mpn_sa": ([_P] * 4 + [_I] + [_P] * 10 + [_I] * 8 + [ctypes.c_float, _I, _I] + [_P] * 4
               + [_I, _I, _P]),
    "mpn_sa_plan": [_I] * 11 + [_P] * 6,
    "mpn_sa_select": [_P, _P, _I, _I, _I, ctypes.c_float, _P, _P, _P],
    "mpn_sa_select_plan": [_I] * 3 + [_P] * 3,
    "mpn_sa_bwd": [_P] * 11 + [_I] * 7 + [_P] * 9,
    "mpn_sa_bwd_plan": [_I] * 6 + [_P] * 5,
    "mpn_probe_scan": [_P] * 3 + [_I] * 3 + [ctypes.c_float, _I, _P, _P],
    "mpn_probe_scan_plan": [_I, _I, _P, _P],
    "mpn_probe_micro": [_P, _P] + [_I] * 4 + [_P, _P, _P],
    "mpn_probe_micro_plan": [_I, _I, _P],
    "mpn_probe_wide": [_P, _P] + [_I] * 4 + [_P, _P],
    "mpn_probe_scratch": [_I, _P, _P],
    "mpn_probe_empty": [_P],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()
    FPS_LAUNCHES_BY_PLAN.clear()


def mlp_launch_name(variant: str, compute_dtype) -> str:
    """The counter of an SA MLP launch: ``variant`` (sa, sa_raw, sa_v3,
    sa_fast) under bf16 weights (the tensor-core kernel), with ``_f32``
    appended under f32 weights (the CUDA-core kernel)."""
    return variant if compute_dtype == torch.bfloat16 else variant + "_f32"


def _count(name: str, b: int, n: int, s: int) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[(name, b, n, s)] += 1


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


class FpsPlan(NamedTuple):
    """A launch of the FPS kernel: each batch row runs on ``cluster`` blocks
    of ``threads`` threads, each thread holding ``points_per_thread`` points
    in registers."""

    threads: int
    points_per_thread: int
    cluster: int


#: Points a thread, and blocks a row, the FPS kernel is built for; a
#: cluster's blocks hold 8 points a thread.
FPS_POINTS_PER_THREAD = (1, 2, 4, 8)
FPS_CLUSTERS = (1, 2, 4, 8)
#: The largest cluster the plan picks: at 6272 points a cluster of 8 took
#: 2% longer than one of 4 at B=1 and 3 on the H100 (``chip_smoke.py``,
#: phase "FPS kernel vs plain"), so 8 is only there to be compared.
FPS_PLAN_MAX_CLUSTER = 4
#: Threads a block aims at; a larger share of a row goes to more points a
#: thread (up to 8) before more warps.
FPS_BLOCK_THREADS = 128
#: A cloud of at least this many points is split over a cluster of blocks
#: a row, up to FPS_PLAN_MAX_CLUSTER, as many as keep B x cluster within FPS_SMS (the SMs of an H100
#: SXM; on a card with fewer the clusters take more than one wave): one
#: row's chain of picks then runs on several SMs. The served clouds are
#: 6272 points (split) and 512, 192 and 16 (one block); no size between
#: 512 and 6272 was timed, so the threshold's place there is unmeasured.
FPS_CLUSTER_MIN_POINTS = 2048
FPS_SMS = 132


def _fps_max_threads(points_per_thread: int) -> int:
    """Threads a block may have (``max_threads`` in ``csrc/fps.cu``): 8
    points a thread are 32 registers of state, so those blocks stop at 800."""
    return 800 if points_per_thread == 8 else 1024


def fps_plan_ok(n: int, plan: FpsPlan) -> bool:
    """Whether the kernel takes this plan for N points: the plan's points
    cover N, a cluster's blocks hold 8 points a thread, and the warps of a
    row's blocks give at most 32 records, one a lane of the final reduction.
    ``plan_ok`` in ``csrc/fps.cu`` is the same rule on the device's side;
    ``tests/test_torch_cuda.py`` holds the two equal."""
    threads, p, cluster = plan
    return (p in FPS_POINTS_PER_THREAD and cluster in FPS_CLUSTERS
            and (cluster == 1 or p == 8)
            and threads % 32 == 0 and 32 <= threads <= _fps_max_threads(p)
            and threads // 32 * cluster <= 32 and 1 <= n <= threads * p * cluster)


def fps_plan(b: int, n: int, cluster: Optional[int] = None) -> FpsPlan:
    """The FPS kernel's launch for B rows of N points: blocks a row (a
    cluster for a large cloud at small B), then the fewest points a thread
    that keep a block within :data:`FPS_BLOCK_THREADS` threads and a row
    within 32 warps, else 8 and as many warps as needed (8 in a cluster).
    ``cluster`` (one of :data:`FPS_CLUSTERS`) sets the blocks a row instead,
    the next larger size where its blocks cannot hold N, so that plans can
    be compared. Raises for a shape no plan takes."""
    if b < 1 or not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"FPS takes 1 <= N <= {FPS_MAX_POINTS} (FPS_MAX_POINTS) and B >= 1; "
                         f"got B={b}, N={n}")
    if cluster is None:
        cluster = 1
        if n >= FPS_CLUSTER_MIN_POINTS:
            cluster = max(c for c in FPS_CLUSTERS
                          if c == 1 or (c <= FPS_PLAN_MAX_CLUSTER and b * c <= FPS_SMS))
    elif cluster not in FPS_CLUSTERS:
        raise ValueError(f"FPS runs a row on {FPS_CLUSTERS} blocks; got cluster={cluster}")
    # a cloud above one block's 800 x 8 points takes a larger cluster
    for c in FPS_CLUSTERS[FPS_CLUSTERS.index(cluster):]:
        per_block = -(-n // c)
        target = min(FPS_BLOCK_THREADS, 32 * (32 // c))
        p = 8 if c > 1 else next(p for p in FPS_POINTS_PER_THREAD
                                 if per_block <= target * p or p == 8)
        plan = FpsPlan(32 * -(-per_block // (32 * p)), p, c)
        if fps_plan_ok(n, plan):
            return plan
    raise AssertionError(f"no FPS plan for N={n} from cluster={cluster}")  # N <= FPS_MAX_POINTS


def fps_plan_info(n: int, npoint: int, plan: FpsPlan, dtype=torch.float32) -> Dict[str, int]:
    """What ``plan`` gets on the current CUDA device for N points of
    ``dtype`` and ``npoint`` picks: registers a thread, blocks that fit on
    one SM, and (cluster > 1) clusters that can run at once; raises when the
    kernel does not take the plan or the device cannot run it."""
    out = [ctypes.c_int() for _ in range(3)]
    rc = _library("fps").mpn_fps_plan(int(dtype == torch.bfloat16), n, npoint, *plan,
                                      *map(ctypes.byref, out))
    info = dict(zip(("registers", "blocks_per_sm", "max_clusters"), (v.value for v in out)))
    if rc != 0 or not info["blocks_per_sm"] or (plan.cluster > 1 and not info["max_clusters"]):
        raise RuntimeError(f"the FPS kernel cannot run {plan} for N={n}, npoint={npoint} "
                           f"({dtype}): CUDA error {rc}, {info}")
    return info


def furthest_point_sample_with_coords(
    xyz: torch.Tensor, npoint: int, impl: str = "v1"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS: [B, N, 3] -> (idx int32 [B, npoint], coords [B, npoint, 3]).

    Same function as :func:`mpinets_torch.kernels.pointnet.furthest_point_sample`
    (slot 0 is index 0; greedy max-min-distance picks; first-index ties),
    also returning the picked coordinates. ``impl`` "v1" and "v2" name the
    two TPU kernels and launch the same CUDA kernel, with the launch
    :func:`fps_plan` gives for (B, N); a launch the device refuses raises,
    naming the plan.
    """
    if impl not in ("v1", "v2"):
        raise ValueError(f"unknown FPS impl {impl!r}")
    if _on_cpu(xyz):
        return fps_plain(xyz, npoint)
    _check(xyz, "xyz", (torch.float32, torch.bfloat16), (None, None, 3))
    b, n, _ = xyz.shape
    plan = fps_plan(b, n)
    if not 1 <= npoint <= n:
        raise ValueError(f"FPS takes 1 <= npoint <= N; got N={n}, npoint={npoint}")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    coords = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    try:
        _launch("fps", "mpn_fps", xyz.device, xyz.data_ptr(),
                int(xyz.dtype == torch.bfloat16), b, n, npoint, *plan,
                idx.data_ptr(), coords.data_ptr())
    except RuntimeError as e:
        raise RuntimeError(f"FPS {plan} for B={b}, N={n}: {e}") from e
    _count("fps", b, n, npoint)
    FPS_LAUNCHES_BY_PLAN[plan] += 1
    return idx, coords.to(xyz.dtype)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices only (:func:`furthest_point_sample_with_coords`), the
    counterpart of ``mpinets_tpu/kernels/pallas_ops.py:223``."""
    return furthest_point_sample_with_coords(xyz, npoint)[0]


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
    ``pallas_ops.py:1249-1259``, computed in xyz's dtype as there (bf16
    under ``bf16_cloud``). Means leave out the pad points of a partial last
    chunk. -> int32 [B, S, W]."""
    b, n, _ = xyz.shape
    dt = xyz.dtype
    nc = -(-n // CHUNK)
    pad = nc * CHUNK - n
    xp = torch.nn.functional.pad(xyz, (0, 0, 0, pad))
    wsum = xp.reshape(b, nc, CHUNK, 3).sum(dim=2)
    real = (torch.arange(nc * CHUNK, device=xyz.device) < n).to(dt)
    wcnt = torch.clamp(real.reshape(nc, CHUNK).sum(dim=1), min=1.0)
    means = wsum / wcnt[None, :, None]
    d2 = ((centroids.to(dt)[:, :, None, :] - means[:, None, :, :]) ** 2).sum(dim=-1)
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


def sa_select_plain(xyz, centroids, radius: float, chunks: Optional[torch.Tensor] = None,
                    round_points: bool = False):
    """Plain version of the selection: candidates in scan order -- every
    point by index (``chunks=None``, the exact ball query), or the points of
    ``chunks`` [B, S, W] in window-rank, lane order -- and the first 128
    with ``(dx*dx + dy*dy) + dz*dz < r*r`` in f32 kept; ``round_points``
    tests bf16-rounded candidate coordinates (the fast kernel under bf16).
    -> (idx int32 [B, S, 128] with fill-with-first, 0 when none; count int32
    [B, S], the kept count min(in-ball, 128))."""
    b, n, _ = xyz.shape
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
        if round_points:
            pts = _rounder(torch.bfloat16)(pts)
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
    return idx, torch.clamp(count, max=NSAMPLE).to(torch.int32)


def sa_mlp_rows_plain(raw, centroids, weights: SAWeights, slot0=None):
    """The SA MLP on every slot of a raw block [B, S, 128, 3 + C], in the
    MLP kernel's arithmetic: the raw rows rounded, the recentring folded
    into layer 1's bias, the hidden activations rounded. ``slot0``, a
    (mask [B, S], u1 [B, S, C1]) pair, puts its rows in slot 0's layer-1
    pre-activation where the mask holds (:func:`sa_mlp_plain`'s off-cloud
    centroids without neighbours). -> (u1, u2, z), the f32 pre-activations
    of layers 1 and 2 and layer 3's ReLU output."""
    rnd = _rounder(weights.compute_dtype)
    w = weights
    bc = centroids.float() @ w.w1_xyz                          # [B, S, C1]
    u1 = rnd(raw) @ w.w1[: raw.shape[-1]] + w.b1 - bc[:, :, None, :]
    if slot0 is not None:
        u1[:, :, 0] = torch.where(slot0[0][..., None], slot0[1], u1[:, :, 0])
    u2 = rnd(torch.relu(u1)) @ w.w2 + w.b2
    return u1, u2, torch.relu(rnd(torch.relu(u2)) @ w.w3 + w.b3)


def sa_mlp_plain(xyz, features, centroids, weights: SAWeights, idx, count,
                 in_cloud: bool = True, return_raw: bool = False):
    """Plain version of the MLP kernel, from a selection (``idx``, ``count``
    as :func:`sa_select_plain` gives them), following the kernel's
    arithmetic. ``in_cloud=False`` gives a centroid without neighbours point
    0's layer-1 row. -> features [B, S, C3] f32 and, with ``return_raw``,
    the raw block [B, S, 128, 3 + C] f32."""
    rnd = _rounder(weights.compute_dtype)
    b = xyz.shape[0]
    _check_rows(weights, features.shape[-1])
    found = torch.arange(NSAMPLE, device=xyz.device) < count[..., None]
    raw = torch.cat([pointnet.gather_points(xyz, idx), pointnet.gather_points(features, idx)],
                    dim=-1).float()
    raw = torch.where(found[..., None], raw, torch.zeros_like(raw))
    w = weights
    slot0 = None
    if not in_cloud:
        # count == 0: slot 0 is point 0's layer-1 row, unrounded, in f32
        pts0 = torch.cat([xyz[:, 0], features[:, 0]], dim=-1).float()  # [B, 3 + C]
        h0 = w.b1.expand(b, -1)
        for ch in range(pts0.shape[-1]):
            h0 = h0 + pts0[:, ch, None] * w.w1_f32[ch]
        slot0 = (count == 0, h0[:, None, :] - centroids.float() @ w.w1_xyz)
    _, _, h = sa_mlp_rows_plain(raw, centroids, w, slot0)
    valid = torch.arange(NSAMPLE, device=xyz.device) < torch.clamp(count, min=1)[..., None]
    h = torch.where(valid[..., None], h, torch.full_like(h, -torch.inf))
    if return_raw:
        return h.amax(dim=-2), raw
    return h.amax(dim=-2)


def sa_plain(xyz, features, centroids, weights: SAWeights, radius: float,
             chunks: Optional[torch.Tensor] = None, in_cloud: bool = True,
             return_raw: bool = False):
    """Plain version of the SA stage (``chunks=None``: exact scan; else the
    fast window scan over ``chunks`` [B, S, W]): :func:`sa_select_plain`,
    then :func:`sa_mlp_plain`. -> (features [B, S, C3] f32, idx int32
    [B, S, 128]) and, with ``return_raw``, the raw block [B, S, 128, 3 + C]
    f32."""
    _check_rows(weights, features.shape[-1])
    idx, count = sa_select_plain(xyz, centroids, radius, chunks,
                                 chunks is not None and weights.compute_dtype == torch.bfloat16)
    out = sa_mlp_plain(xyz, features, centroids, weights, idx, count, in_cloud, return_raw)
    return (out[0], idx, out[1]) if return_raw else (out, idx)


def _check_select(xyz, centroids) -> Tuple[int, int, int]:
    b, n, _ = xyz.shape
    s = centroids.shape[1]
    _check(xyz, "xyz", (torch.float32,), (b, n, 3))
    _check(centroids, "centroids", (torch.float32,), (b, None, 3))
    if not (1 <= b <= 65535 and 1 <= n <= SELECT_MAX_POINTS and s >= 1):
        raise ValueError(f"the ball-query kernel stages clouds of 1 <= N <= {SELECT_MAX_POINTS}"
                         f" points (SELECT_MAX_POINTS) and takes 1 <= B <= 65535, S >= 1; "
                         f"got B={b}, N={n}, S={s}")
    return b, n, s


def _r2(radius: float) -> float:
    """r*r rounded to f32, as the kernels compare with it."""
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def sa_select(xyz, centroids, radius: float):
    """Exact ball query: per centroid, the first 128 points in index order
    with ``(dx*dx + dy*dy) + dz*dz < r*r`` in f32. xyz [B, N, 3], centroids
    [B, S, 3] f32 -> (idx int32 [B, S, 128] with fill-with-first, 0 when
    none; count int32 [B, S], min(in-ball, 128)). On CUDA tensors the
    ``sa_select_kernel`` of ``csrc/sa.cu`` (N <= :data:`SELECT_MAX_POINTS`),
    counted as ``sa_select``; on CPU tensors :func:`sa_select_plain`."""
    if _on_cpu(xyz, centroids):
        return sa_select_plain(xyz, centroids, radius)
    b, n, s = _check_select(xyz, centroids)
    idx = torch.empty((b, s, NSAMPLE), dtype=torch.int32, device=xyz.device)
    count = torch.empty((b, s), dtype=torch.int32, device=xyz.device)
    _launch("sa", "mpn_sa_select", xyz.device, xyz.data_ptr(), centroids.data_ptr(), b, n, s,
            _r2(radius), idx.data_ptr(), count.data_ptr())
    _count("sa_select", b, n, s)
    return idx, count


def sa_kernel(xyz, features, centroids, weights: SAWeights, radius: float,
              chunks: Optional[torch.Tensor] = None, in_cloud: bool = True,
              return_raw: bool = False,
              selection: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              centroids_per_block: Optional[int] = None):
    """The SA kernels alone, on CUDA tensors: the exact grouping (``chunks``
    None: the ball-query kernel, then the MLP kernel reading its selection)
    or the window scan over ``chunks`` int32 [B, S, W] (one kernel);
    ``in_cloud`` and ``return_raw`` as in :func:`sa_plain`. ``selection``
    (exact only): a given (idx, count), as :func:`sa_select` returns them,
    so only the MLP kernel launches. ``centroids_per_block`` (one of
    :data:`SA_CENTROIDS_PER_BLOCK`) sets the MLP kernel's centroids per
    block instead of its launch plan, to compare plans; a value the kernel
    does not take at these widths raises. What :func:`sa_stage` and
    :func:`sa_stage_fast` launch."""
    extra = () if chunks is None else (chunks,)
    extra += () if selection is None else tuple(selection)
    if _on_cpu(xyz, features, centroids, *weights.tensors, *weights.mma_tensors, *extra):
        raise ValueError("sa_kernel takes CUDA tensors (sa_stage runs the plain version)")
    if return_raw and not (in_cloud and chunks is None):
        raise ValueError("the raw block is an output of the exact in-cloud (v8) scan only")
    if chunks is not None and (selection is not None or not in_cloud):
        raise ValueError("the window scan selects for itself, centroids in the cloud")
    _check_cpb(centroids_per_block)
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
    elif selection is None:
        _check_select(xyz, centroids)
    else:
        _check(selection[0], "idx", (torch.int32,), (b, s, NSAMPLE))
        _check(selection[1], "count", (torch.int32,), (b, s))
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
    if selection is None:
        idx = torch.empty((b, s, NSAMPLE), dtype=torch.int32, device=xyz.device)
        count = (None if chunks is not None
                 else torch.empty((b, s), dtype=torch.int32, device=xyz.device))
    else:
        idx, count = selection
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
        _r2(radius), int(w.compute_dtype == torch.bfloat16), int(in_cloud), out.data_ptr(),
        idx.data_ptr(), None if count is None else count.data_ptr(),
        None if raw is None else raw.data_ptr(), int(selection is None),
        centroids_per_block or 0,
    )
    if chunks is not None:
        name = "sa_fast"
    else:
        if selection is None:
            _count("sa_select", b, n, s)
        name = "sa_raw" if return_raw else "sa" if in_cloud else "sa_v3"
    _count(mlp_launch_name(name, w.compute_dtype), b, n, s)
    return (out, idx, raw) if return_raw else (out, idx)


def _check_cpb(centroids_per_block: Optional[int]) -> None:
    if centroids_per_block is not None and centroids_per_block not in SA_CENTROIDS_PER_BLOCK:
        raise ValueError(f"the SA MLP kernel takes {SA_CENTROIDS_PER_BLOCK} centroids per block;"
                         f" got {centroids_per_block}")


def sa_launch_plan(weights: SAWeights, c: int, b: int, s: int, in_cloud: bool = True,
                   raw: bool = False, fast: bool = False,
                   centroids_per_block: Optional[int] = None) -> Dict[str, int]:
    """The MLP launch :func:`sa_kernel` makes for these weights, C input
    features, B rows and S centroids on the current CUDA device (``fast``:
    the window-scan instantiation; ``centroids_per_block`` as
    :func:`sa_kernel` takes it): ``mma`` 2 for the tensor-core kernel on
    ``wgmma`` (bf16, exact, in-cloud, no raw block, a layer wider than 64:
    SA1), 1 on ``mma.sync`` (the other bf16 stages), 0 for the CUDA-core one;
    its dynamic shared memory in bytes; the blocks of it that fit on one SM;
    ``cpb``, its centroids per block (``wgmma``: per work item of its
    persistent grid); ``tile_rows``, its rows per tile (64 on ``wgmma``, 16
    on ``mma.sync``; 128 or 32 on the CUDA cores); and ``thread_rows``, the
    output rows a thread of the CUDA-core kernel owns (4 or 8; 0 on the
    tensor cores). Raises where the kernel does not take
    ``centroids_per_block``, or where no tile of the CUDA-core kernel fits."""
    _check_cpb(centroids_per_block)
    c1, c2, c3 = weights.w1.shape[1], weights.w2.shape[1], weights.w3.shape[1]
    out = [ctypes.c_int() for _ in range(6)]
    rc = _library("sa").mpn_sa_plan(b, s, c, c1, c2, c3,
                                    int(weights.compute_dtype == torch.bfloat16), int(in_cloud),
                                    int(raw), int(fast), centroids_per_block or 0,
                                    *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"mpn_sa_plan failed: CUDA error {rc} (centroids_per_block="
                           f"{centroids_per_block})")
    return dict(zip(("mma", "smem_bytes", "blocks_per_sm", "cpb", "tile_rows", "thread_rows"),
                    (v.value for v in out)))


def sa_select_plan(b: int, n: int, s: int) -> Dict[str, int]:
    """The launch :func:`sa_select` makes for B rows of N points and S
    centroids on the current CUDA device: centroids per warp, the staged
    cloud's shared memory in bytes, and the blocks that fit on one SM."""
    out = [ctypes.c_int() for _ in range(3)]
    rc = _library("sa").mpn_sa_select_plan(b, n, s, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"mpn_sa_select_plan failed: CUDA error {rc}")
    return dict(zip(("centroids_per_warp", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in out)))


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


class SABackward(NamedTuple):
    """What :func:`sa_stage_backward` returns, all f32: the features'
    cotangent [B, N, C] (None without one) and the MLP's, Dense [in, out]."""

    gf: Optional[torch.Tensor]
    dw1: torch.Tensor
    db1: torch.Tensor
    dw2: torch.Tensor
    db2: torch.Tensor
    dw3: torch.Tensor
    db3: torch.Tensor


def valid_slots(idx: torch.Tensor) -> torch.Tensor:
    """The kept slots of an exact in-cloud selection, from its fill rule:
    slot 0 and every slot whose index differs from slot 0's. -> bool [B, S, 128]."""
    return torch.cat([torch.ones_like(idx[..., :1], dtype=torch.bool),
                      idx[..., 1:] != idx[..., :1]], dim=-1)


def sa_stage_backward_plain(raw, idx, centroids, weights: SAWeights, g,
                            n_points: Optional[int] = None) -> SABackward:
    """Plain version of the SA backward kernel, in its arithmetic.

    The forward is recomputed as the MLP kernel computes it (raw rows
    rounded, the recentring folded into layer 1's bias, the bf16 rounding
    points of :func:`sa_mlp_plain`); each (centroid, channel) cotangent goes
    to the valid rows equal to its max, split equally over ties, where the
    max is > 0. Backward with the compute type's operands in every product
    and f32 sums: dz3 -> dh2 [u2 > 0] -> dh1 [u1 > 0] and, with
    ``n_points``, dx = dz1 W1^T, whose feature columns are rounded per
    addend and summed into their points. Weight cotangents A^T dz over the
    valid rows, layer 1's A the recentred rows rounded; bias cotangents the
    f32 column sums of dz. raw [B, S, 128, 3 + C] f32 as the v8 forward
    saves it, idx [B, S, 128], centroids [B, S, 3], g [B, S, C3] f32."""
    rnd = _rounder(weights.compute_dtype)
    w = weights
    kin = raw.shape[-1]
    valid = valid_slots(idx)
    vmask = valid[..., None]
    u1, u2, z = sa_mlp_rows_plain(raw, centroids, w)
    h1, h2 = rnd(torch.relu(u1)), rnd(torch.relu(u2))
    zmax = torch.where(vmask, z, torch.full_like(z, -torch.inf)).amax(dim=2, keepdim=True)
    tie = vmask & (z == zmax)
    share = g[:, :, None, :] / tie.sum(dim=2, keepdim=True).clamp(min=1)
    dz3 = torch.where(tie & (zmax > 0), share, torch.zeros_like(z))
    dz2 = (rnd(dz3) @ w.w3.t()) * (u2 > 0)
    dz1 = (rnd(dz2) @ w.w2.t()) * (u1 > 0)
    a1 = rnd(torch.cat([raw[..., :3] - centroids[:, :, None, :], raw[..., 3:]], dim=-1))

    def cot(a, dz):
        return a.reshape(-1, a.shape[-1]).t() @ rnd(dz).reshape(-1, dz.shape[-1])

    gf = None
    if n_points is not None:
        b, c = raw.shape[0], kin - 3
        dx = rnd((rnd(dz1) @ w.w1[:kin].t())[..., 3:]) * vmask
        rows = idx.long() + n_points * torch.arange(b, device=idx.device)[:, None, None]
        gf = torch.zeros((b * n_points, c), dtype=torch.float32, device=raw.device)
        gf.index_add_(0, rows.reshape(-1), dx.reshape(-1, c))
        gf = gf.reshape(b, n_points, c)
    return SABackward(gf, cot(a1, dz1), dz1.sum(dim=(0, 1, 2)), cot(h1, dz2),
                      dz2.sum(dim=(0, 1, 2)), cot(h2, dz3), dz3.sum(dim=(0, 1, 2)))


def sa_bwd_plan(b: int, s: int, kin: int, c1: int, c2: int, c3: int) -> Dict[str, int]:
    """The launches :func:`sa_stage_backward` makes for B rows of S
    centroids at these widths on the current CUDA device: ``cpb``, centroids
    per work item; ``grid``, the row kernel's persistent blocks; ``splits``,
    the weight-cotangent kernel's blocks a layer; ``smem_bytes``, the row
    kernel's dynamic shared memory; ``scratch_bytes``, the device scratch a
    call takes (bf16 activations and cotangents of every row a selection
    could hold, B * S * 128, and the f32 partial sums)."""
    out = [ctypes.c_int64() for _ in range(5)]
    rc = _library("sa_bwd").mpn_sa_bwd_plan(b, s, kin, c1, c2, c3, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"mpn_sa_bwd_plan failed for B={b}, S={s}, widths "
                           f"{(kin, c1, c2, c3)}: CUDA error {rc}")
    return dict(zip(("cpb", "grid", "splits", "smem_bytes", "scratch_bytes"),
                    (v.value for v in out)))


def sa_stage_backward(raw, idx, centroids, weights: SAWeights, g,
                      n_points: Optional[int] = None) -> SABackward:
    """Backward of an exact in-cloud SA stage (``sa_stage(impl="v8",
    return_raw=True)``) over its valid rows: the forward recomputed, the
    max-pool's cotangent on the rows that hold each max, the MLP's backward
    and, with ``n_points`` (the cloud's N), the features' cotangent. On CUDA
    tensors the kernels of ``csrc/sa_bwd.cu`` (bf16 weights only), counted
    once a call as ``sa_bwd``; on CPU tensors
    :func:`sa_stage_backward_plain`, whose arithmetic they follow."""
    if _on_cpu(raw, idx, centroids, g, *weights.tensors):
        return sa_stage_backward_plain(raw, idx, centroids, weights, g, n_points)
    w = weights
    if w.compute_dtype != torch.bfloat16:
        raise ValueError("the SA backward kernel runs bf16 stages")
    b, s, _, kin = raw.shape
    c1, c2, c3 = w.w1.shape[1], w.w2.shape[1], w.w3.shape[1]
    _check(raw, "raw", (torch.float32,), (b, s, NSAMPLE, kin))
    _check(idx, "idx", (torch.int32,), (b, s, NSAMPLE))
    _check(centroids, "centroids", (torch.float32,), (b, s, 3))
    _check(g, "g", (torch.float32,), (b, s, c3))
    _check_rows(w, kin - 3)
    for t, name, shape in zip(w.mma_tensors, ("w1t", "w2t", "w3t"),
                              ((c1, kin), (c2, c1), (c3, c2))):
        _check(t, name, (torch.bfloat16,), tuple(_ceil16(d) for d in shape))
    if n_points is not None and not 1 <= n_points < 1 << 19:
        raise ValueError(f"the SA backward kernel takes 1 <= N < 2**19 points, got {n_points}")
    plan = sa_bwd_plan(b, s, kin, c1, c2, c3)
    dev = raw.device
    f32 = dict(dtype=torch.float32, device=dev)
    # gf one float into its storage: the kernel's column pairs (k, k + 1),
    # k even, then lie 8 bytes aligned for its paired atomics (C even)
    gf = None
    if n_points is not None:
        gf = torch.zeros(b * n_points * (kin - 3) + 1, **f32)[1:].view(b, n_points, kin - 3)
    outs = SABackward(
        gf,
        torch.empty((kin, c1), **f32), torch.empty(c1, **f32), torch.empty((c1, c2), **f32),
        torch.empty(c2, **f32), torch.empty((c2, c3), **f32), torch.empty(c3, **f32))
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=dev)
    _launch("sa_bwd", "mpn_sa_bwd", dev, raw.data_ptr(), idx.data_ptr(), centroids.data_ptr(),
            g.data_ptr(), *(t.data_ptr() for t in w.mma_tensors), w.w1_f32.data_ptr(),
            w.b1.data_ptr(), w.b2.data_ptr(), w.b3.data_ptr(), b, s, kin, c1, c2, c3,
            n_points or 0, None if outs.gf is None else outs.gf.data_ptr(),
            *(t.data_ptr() for t in outs[1:]), scratch.data_ptr())
    _count("sa_bwd", b, n_points or 0, s)
    return outs


def sa_stage_fast(xyz, features, centroids, weights: SAWeights, radius: float,
                  nsample: int = NSAMPLE, window: int = 12):
    """Relaxed fast-grouping SA stage: each centroid searches only its
    ``window`` nearest chunks of 128 points (:func:`chunk_window`) and keeps
    up to 128 in-ball points in (window rank, lane) order; the rest of the
    stage is :func:`sa_stage`'s. With no in-ball point, slot 0 is a zero raw
    row and idx is all 0. Coordinates may be bf16 (``bf16_cloud``): the
    window is chosen in their dtype, the stage reads them as f32.
    """
    if nsample != NSAMPLE:
        raise ValueError(f"the SA kernel keeps {NSAMPLE} neighbours, got nsample={nsample}")
    cpu = _on_cpu(xyz, features, centroids, *weights.tensors)
    chunks = chunk_window(xyz, centroids, window)
    xyz, centroids = xyz.float(), centroids.float()
    if cpu:
        return sa_plain(xyz, features, centroids, weights, radius, chunks)
    return sa_kernel(xyz, features, centroids, weights, radius, chunks)
