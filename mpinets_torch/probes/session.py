"""The probe session: the counterpart of the TPU scripts' sessions.

Runs each TPU probe's CUDA counterpart at the scripts' shapes -- the scan
probes at the SA0 shape of ``scripts/onchip_r3b.py:240-245`` (B=256,
N=6272, S=512, r=0.05, xyz uniform in [-0.8, 0.8], feat in {0, 1, 2},
centroids the first 512 points), the micro-ops on 25,088 x 128 in blocks of
1,568 rows at 8 and 32 reps, the wide gather at B=256, the scratch probe --
holds each against its plain version, and times it by the scripts'
long-minus-short loop (``onchip_r3b.py:248-265``: 2 and 10 calls, best of
3), with CUDA events. Under the scan times it times SA0 exact
(``ops.sa_stage``, bf16) at the same shape, so the stages can be read
beside the kernel they explain. The scan probes are also held against
their plain version on a small cloud with the scan's edge cases
(:func:`edge_scan_inputs`) and on one where centroids pass 128 hits early
(:func:`dense_scan_inputs`); the micro-ops at the kernels' other layouts
(:data:`MICRO_EDGE_CASES`). Inputs are made from ``seed`` with a
``torch.Generator``. Bounds count uncontracted f32 operations at the
card's non-FMA rate (:data:`F32_NOFMA_OPS`: the scan's distances and every
micro-op's adds and multiplies) and gather's shared-memory reads at
:data:`SMEM_WORDS_PER_S`; on the card no bound is below the launch floor,
the time of an empty kernel (``probe_empty_kernel``, one warp) in the same
loop (:func:`launch_floor_ms`).

Each scan mode runs once, for every measurement of the scripts that
computes the same function (:data:`SCAN_PROBES`). Each record is one JSON
line on stdout: ``kind`` ``parity`` (kernel against plain), ``time``
(milliseconds per call on the card, launches, bound, library call, the
scripts' measurements it stands for) or ``device`` (the card, its power
limit and the launch floor). On the CPU (``device="cpu"``) the probes run
smaller, the wrappers compute their plain versions, and nothing is timed.

The scripts' XLA-only measurements (``top_k``, scatter-add, sort,
``xla_tile``, the v5 stage timings) are not kernels and are not here.
"""

from __future__ import annotations

import json
import subprocess
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mpinets_torch.kernels import ops
from mpinets_torch.probes import design, micro, scan
from mpinets_torch.utils.device import resolve_device

RADIUS = 0.05
#: The scripts' shapes, and the smaller ones of a CPU run.
FULL = dict(batch=256, n=6272, s=512, rows=25088, rb=1568)
SMALL = dict(batch=2, n=384, s=64, rows=392, rb=98)
REPS = (8, 32)
WIDE_ROWS, WIDE_WIDTH = 224, 2048      # onchip_r4a.py: P * NC rows, TS * 128 columns
SCRATCH_STEPS = 4
TIMING_CALLS = (2, 10)
TIMING_BEST_OF = 3
PLAIN_ROWS = 16          # batch rows per plain scan call, to bound its memory
SLEEP_CYCLES = 4_000_000  # device busy-wait before a timed loop, so the host's
                          # enqueueing is not what the events measure
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 CUDA-core FLOP/s
# (an FMA counted as two).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations a second without FMA: 132 SMs x 128 f32 lanes x 1.98 GHz
# (the boost clock at which the data sheet's 67e12 counts each FMA as two).
# The distance tests (__fsub_rn / __fmul_rn / __fadd_rn, never contracted,
# and a compare) issue one operation a slot at this rate.
F32_NOFMA_OPS = 132 * 128 * 1.98e9
# 4-byte shared-memory reads a second: 132 SMs x 32 banks, one word a bank a
# clock, x 1.98 GHz (a warp's conflict-free 32-bit read is one wavefront of
# 128 bytes a clock); wider reads move no more words a clock.
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9

#: One probe per scan mode: (mode, the scripts' measurements it stands for,
#: the TPU kernels it replaces). Probes of the scripts that compute the same
#: function (stop 5 is stop 4 transposed, fuse_inball changes no value, r3c's
#: scan is r3b's stop 2, r3d's stop 3 is r3b's) are one kernel launch here.
SCAN_PROBES = (
    ("hits", ("onchip_r3b sa0_abl_stop1", "onchip_r3b sa0_abl_stop1_fused_inball"),
     "scripts/onchip_r3b.py:120"),
    ("count", ("onchip_r3b sa0_abl_stop2", "onchip_r3c sa0_stage2_with_scan"),
     "scripts/onchip_r3b.py:120, scripts/onchip_r3c.py:184"),
    ("count_noscan", ("onchip_r3c sa0_stage2_no_scan",), "scripts/onchip_r3c.py:184"),
    ("slot", ("onchip_r3b sa0_abl_stop3", "onchip_r3d sa0_abl3_search"),
     "scripts/onchip_r3b.py:120, scripts/onchip_r3d.py:69"),
    ("gather", ("onchip_r3b sa0_abl_stop4", "onchip_r3b sa0_abl_stop5"),
     "scripts/onchip_r3b.py:120"),
    ("tile_sum", ("onchip_r3d sa0_abl4_gathers",), "scripts/onchip_r3d.py:69"),
)


@dataclass
class Probe:
    name: str
    kernel: str                       # its key in ops.LAUNCHES
    replaces: str                     # file:line of the TPU kernel
    run: Callable[[], torch.Tensor]   # the wrapper on the session's inputs
    plain: Callable[[], torch.Tensor]
    nbytes: float                     # each input read once, each output written once
    flops: float                      # f32 operations the probe's work needs
    library: Optional[Callable[[], torch.Tensor]] = None   # one PyTorch call, timed only
    stands_for: Tuple[str, ...] = ()  # the scripts' measurements this probe takes the place of
    timed: bool = True                # False: a check only
    rate: float = F32_FLOPS           # the card's rate for ``flops`` a second
    smem_reads: float = 0.0           # 4-byte shared-memory reads the probe's work needs

    def bound(self, floor_ms: float = 0.0):
        """(ms, "bytes" | "operations" | "launch"): the least time the card
        could take: bytes over HBM's rate, or operations, the f32 ones at
        ``rate`` and the shared-memory reads at :data:`SMEM_WORDS_PER_S`, or
        ``floor_ms``, the launch floor, where that is larger."""
        t_bytes = 1e3 * self.nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * max(self.flops / self.rate, self.smem_reads / SMEM_WORDS_PER_S)
        return max((t_bytes, "bytes"), (t_ops, "operations"), (floor_ms, "launch"),
                   key=lambda t: t[0])


def _by_rows(fn, *tensors, rows=PLAIN_ROWS):
    return torch.cat([fn(*(t[i:i + rows] for t in tensors))
                      for i in range(0, tensors[0].shape[0], rows)])


def edge_scan_inputs(seed: int = 0, b: int = 2, n: int = 384, s: int = 64):
    """A small cloud (numpy, from ``seed``) with the scan's edge cases, r=0.05:
    row 0's centroid 0 has 150 neighbours in chunks 0 and 2 and none in
    chunk 1; centroid 1 lies off the cloud with no neighbour; row 0's
    centroid 2 lies off the cloud with points whose squared distances are
    within a few ulps of f32(r*r) on both sides, one of them exactly
    f32(r*r) (outside, though inside f32(r)*f32(r)).
    -> (xyz [b, n, 3], feat [b, n, 1], cent [b, s, 3]) f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xyz = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(f32)
    feat = rng.integers(0, 3, (b, n, 1)).astype(f32)
    centre = np.array([0.3, -0.2, 0.1], f32)
    xyz[0, 0] = centre
    pick = np.r_[1:60, 2 * 128:2 * 128 + 91]                      # chunks 0 and 2
    d = rng.normal(size=(len(pick), 3))
    d *= 0.045 * rng.uniform(0, 1, (len(pick), 1)) ** (1 / 3) / np.linalg.norm(d, axis=1,
                                                                                keepdims=True)
    xyz[0, pick] = centre + d
    chunk1 = xyz[0, 128:256]
    chunk1[np.linalg.norm(chunk1 - centre, axis=1) < 0.2] += f32(0.5)
    c2 = np.array([0.0, 0.0, -0.5], f32)   # dx = x, dy = y exactly
    for k in range(-4, 5):                  # x = f32(r) moved k ulps
        x = f32(RADIUS)
        for _ in range(abs(k)):
            x = np.nextafter(x, f32(np.inf if k > 0 else -np.inf), dtype=f32)
        xyz[0, 114 + k] = (x, 0.0, c2[2])
    # x*x + y*y = (1937^2 + 2643^2) / 2^32 is exactly f32(r*r), every product
    # and sum exact (so an FMA gives the same): outside, inside f32(r)*f32(r)
    xyz[0, 119] = (f32(1937 / 2 ** 16), f32(2643 / 2 ** 16), c2[2])
    cent = xyz[:, :s].copy()
    cent[:, 1] = 5.0
    cent[0, 2] = c2
    return xyz, feat, cent


def dense_scan_inputs(seed: int = 0, b: int = 2, n: int = 640, s: int = 64):
    """A small cloud (numpy, from ``seed``) where centroids pass 128 hits
    early, r=0.05: row 0 holds 280 points within 0.04 of one centre, 200 of
    them in chunks 0-1 and the rest in chunks 3 and 4; row 0's centroids 0-4
    lie within 0.002 of it, so the first warp's four centroids all pass 128
    hits by chunk 1 and centroid 4 passes 128 beside three that do not; the
    other centroids are cloud points of chunk 2.
    -> (xyz [b, n, 3], feat [b, n, 1], cent [b, s, 3]) f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xyz = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(f32)
    feat = rng.integers(0, 3, (b, n, 1)).astype(f32)
    centre = np.array([0.1, 0.2, -0.3], f32)
    pick = np.r_[rng.choice(256, 200, replace=False), 384 + rng.choice(128, 60, replace=False),
                 512 + rng.choice(128, 20, replace=False)]
    d = rng.normal(size=(len(pick), 3))
    d *= 0.04 * rng.uniform(0, 1, (len(pick), 1)) ** (1 / 3) / np.linalg.norm(d, axis=1,
                                                                               keepdims=True)
    xyz[0, pick] = centre + d
    cent = xyz[:, 260:260 + s].copy()
    cent[0, :5] = centre + rng.uniform(-0.002, 0.002, (5, 3))
    return xyz, feat, cent


def _scan_probes(xyz, feat, cent, prefix="scan_", timed=True) -> List[Probe]:
    b, n, _ = xyz.shape
    s = cent.shape[1]
    nbytes = 4.0 * (b * n * 4 + b * s * 3 + b * s * ops.CHUNK)
    flops = 9.0 * b * s * n      # the distance tests; the later stages' work is per hit
    return [Probe(prefix + mode, "probe_scan", replaces,
                  lambda m=mode: scan.scan_probe(xyz, feat, cent, RADIUS, m),
                  lambda m=mode: _by_rows(lambda x, f, c: scan.scan_plain(x, f, c, RADIUS, m),
                                          xyz, feat, cent),
                  nbytes, flops, stands_for=stands_for, timed=timed, rate=F32_NOFMA_OPS)
            for mode, stands_for, replaces in SCAN_PROBES]


def _micro_probes(a, idx, rb, reps=REPS, which=micro.MICRO_OPS, timed=True,
                  prefix="micro_") -> List[Probe]:
    """The micro-op probes of the ops ``which`` on ``a``, ``idx`` in blocks of
    ``rb`` rows, at each of ``reps``. Every add and multiply is uncontracted,
    so operations count at the non-FMA rate; gather also reads ``reps`` words
    of shared memory an element. bd_matmul's group sums, which show that the
    kernel keeps every row's work, are checked and not timed."""
    rows = a.shape[0]
    idx_long = idx.long()
    out_bytes = 4.0 * micro.OUT_ROWS * (rows // rb) * ops.CHUNK
    probes = []
    for op in which:
        in_bytes = {"gather": 8.0 * rows * ops.CHUNK, "roll_narrow": 4.0 * rows}.get(
            op, 4.0 * rows * ops.CHUNK)
        if op == "bd_matmul":
            in_bytes += 4.0 * rows // micro.GROUP * ops.CHUNK    # the group sums
        per_rep = {"gather": 1, "roll_narrow": 1.0 / ops.CHUNK, "roll_wide": 1}.get(op, 2)
        for r in reps:
            name = f"{prefix}{op}_r{r}"
            probes.append(Probe(
                name, "probe_micro", "scripts/onchip_r3d.py:175",
                lambda o=op, r=r: micro.micro_probe(a, idx, o, r, rb),
                lambda o=op, r=r: micro.micro_plain(a, idx, o, r, rb),
                in_bytes + out_bytes, float(per_rep * r * rows * ops.CHUNK),
                # one rep of gather: the whole array gathered once
                (lambda: torch.gather(a, 1, idx_long)) if op == "gather" else None,
                stands_for=(f"onchip_r3d {name}",) if timed else (), timed=timed,
                rate=F32_NOFMA_OPS,
                smem_reads=float(r * rows * ops.CHUNK) if op == "gather" else 0.0))
            if op == "bd_matmul":
                probes.append(Probe(
                    f"{name}_group_sums", "probe_micro", "scripts/onchip_r3d.py:175",
                    lambda r=r: micro.micro_probe(a, idx, "bd_matmul", r, rb, True)[1],
                    lambda r=r: micro.bd_matmul_plain(a, r)[1], 0.0, 0.0, timed=False))
    return probes


#: The micro probes' other layouts, checked only: (rb, reps, ops). rb = 98
#: leaves the roll's last thread 2 rows of 4 (and 196 rows end in a gather
#: block of 4 rows); rb = 1,000 leaves it 8 rows of 32 (bd_matmul: 1,029 =
#: 21 x 49); 5,000 spans 3 warps a ring; reps 0 and 33 (a window past 32).
MICRO_EDGE_CASES = (
    (98, (0, 1, 33), micro.MICRO_OPS),
    (1000, (8,), ("gather", "roll_narrow", "roll_wide", "vadd")),
    (1029, (8,), ("bd_matmul",)),
    (5000, (3,), ("roll_narrow", "roll_wide")),
)


def edge_micro_probes(device, seed: int = 0) -> List[Probe]:
    """The micro probes at :data:`MICRO_EDGE_CASES`, two blocks of rb rows
    each, on inputs made from ``seed``; checks only."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    probes = []
    for rb, reps, which in MICRO_EDGE_CASES:
        a = torch.rand((2 * rb, ops.CHUNK), generator=gen, device=device)
        idx = torch.randint(0, ops.CHUNK, (2 * rb, ops.CHUNK), generator=gen, device=device,
                            dtype=torch.int32)
        probes += _micro_probes(a, idx, rb, reps, which, timed=False, prefix=f"micro_rb{rb}_")
    return probes


def _size(device, batch):
    size = dict(SMALL if torch.device(device).type == "cpu" else FULL)
    size["batch"] = batch or size["batch"]
    return size


def scan_inputs(device, batch: Optional[int] = None, seed: int = 0):
    """The scan probes' cloud (``onchip_r3b.py:240-245``): xyz uniform in
    [-0.8, 0.8] [B, N, 3], feat in {0, 1, 2} [B, N, 1], centroids the first
    S points. -> (xyz, feat, cent) on ``device``."""
    size = _size(device, batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    b, n = size["batch"], size["n"]
    xyz = torch.rand((b, n, 3), generator=gen, device=device) * 1.6 - 0.8
    feat = torch.randint(0, 3, (b, n, 1), generator=gen, device=device).float()
    return xyz, feat, xyz[:, :size["s"]].contiguous()


def make_probes(device, batch: Optional[int] = None, seed: int = 0) -> List[Probe]:
    """Every probe of the session at the scripts' shapes (smaller on the
    CPU), on inputs made from ``seed``; bd_matmul's group sums, which show
    that the kernel keeps every row's work, are checked and not timed."""
    device = torch.device(device)
    size = _size(device, batch)
    b = size["batch"]
    probes = _scan_probes(*scan_inputs(device, batch, seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)

    rows, rb = size["rows"], size["rb"]
    a = rand(rows, ops.CHUNK)
    idx = torch.randint(0, ops.CHUNK, (rows, ops.CHUNK), generator=gen, device=device,
                        dtype=torch.int32)
    probes += _micro_probes(a, idx, rb)

    tab = torch.randn((b, WIDE_ROWS, ops.CHUNK), generator=gen, device=device)
    widx = torch.randint(0, ops.CHUNK, (b, WIDE_ROWS, WIDE_WIDTH), generator=gen, device=device,
                         dtype=torch.int32)
    widx_long = widx.long()
    parts, nc = design.WIDE_PARTS, WIDE_ROWS // design.WIDE_PARTS
    probes.append(Probe(
        f"wide_gather_b{b}", "probe_wide", "scripts/onchip_r4a.py:71",
        lambda: design.wide_gather(tab, widx), lambda: design.wide_plain(tab, widx),
        4.0 * (tab.numel() + widx.numel() + b * parts * WIDE_WIDTH),
        float(widx.numel()),
        lambda: torch.gather(tab, 2, widx_long).view(b, parts, nc, WIDE_WIDTH).sum(2),
        stands_for=("onchip_r4a wide_gather_b256",)))
    probes.append(Probe(
        "scratch_when", "probe_scratch", "scripts/onchip_r4a.py:129",
        lambda: design.scratch_probe(SCRATCH_STEPS, device),
        lambda: design.scratch_plain(SCRATCH_STEPS, device),
        4.0 * SCRATCH_STEPS * design.SCRATCH_ROWS * ops.CHUNK,
        float(SCRATCH_STEPS * design.SCRATCH_ROWS * ops.CHUNK),
        stands_for=("onchip_r4a scratch_when",)))
    return probes


def edge_probes(device, seed: int = 0) -> List[Probe]:
    """The scan probes, one per mode, on :func:`edge_scan_inputs` and on
    :func:`dense_scan_inputs`; checks only."""
    probes = []
    for prefix, make in (("edge_scan_", edge_scan_inputs), ("dense_scan_", dense_scan_inputs)):
        xyz, feat, cent = (torch.from_numpy(t).to(device) for t in make(seed))
        probes += _scan_probes(xyz, feat, cent, prefix=prefix, timed=False)
    return probes


def _timed(fn):
    """(fn(), its milliseconds by CUDA events, synchronised)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def diff_ms(fn, calls=TIMING_CALLS, best_of=TIMING_BEST_OF) -> float:
    """Milliseconds per fn() by the scripts' long-minus-short loop: the best
    of ``best_of`` loops of each length in ``calls``, by CUDA events, each
    loop queued behind a device busy-wait so that the events see the
    device's time and not the host's launches; after one warm-up call."""
    fn()
    best = {}
    for k in calls:
        times = []
        for _ in range(best_of):
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        best[k] = min(times)
    return (best[calls[1]] - best[calls[0]]) / (calls[1] - calls[0])


def check(probe: Probe) -> Dict:
    """The probe's wrapper against its plain version on the same inputs.
    They must be bit-equal: each kernel rounds and sums as its plain version
    does."""
    out = probe.run()
    cuda = out.device.type == "cuda"
    ref, plain_ms = _timed(probe.plain) if cuda else (probe.plain(), None)
    same_shape = out.shape == ref.shape
    err = (out - ref).abs().max().item() if same_shape else float("inf")
    return dict(kind="parity", name=probe.name, kernel=probe.kernel, device=out.device.type,
                shape=list(out.shape), max_abs_err=err,
                ok=bool(same_shape and torch.equal(out, ref)),
                plain_ms=plain_ms)


def empty_launch(device) -> None:
    """One launch of ``probe_empty_kernel`` (``<<<1, 32>>>``, no body) on a
    CUDA device: the launch floor's yardstick. It replaces no TPU kernel,
    no main path calls it, and it is not counted in ``ops.LAUNCHES``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the empty kernel runs on a CUDA device, got {device}")
    ops._launch("probes", "mpn_probe_empty", device)


def launch_floor_ms(device) -> float:
    """The launch floor: milliseconds per empty kernel by :func:`diff_ms`,
    the loop that times every probe, so no probe can read below it."""
    return diff_ms(lambda: empty_launch(device))


def time_probe(probe: Probe, floor_ms: float = 0.0) -> Dict:
    """The probe's time on the card (:func:`diff_ms`), its launches in this
    timing, its bound with the launch floor ``floor_ms`` (``bound_ms``,
    ``bound_by``) and without it (``work_bound_ms``, ``work_bound_by``:
    bytes or operations), and the library call's time where there is one."""
    before = ops.LAUNCHES[probe.kernel]
    ms = diff_ms(probe.run)
    bound_ms, bound_by = probe.bound(floor_ms)
    work_ms, work_by = probe.bound()
    return dict(kind="time", name=probe.name, kernel=probe.kernel, ms=ms,
                launches=ops.LAUNCHES[probe.kernel] - before, bound_ms=bound_ms,
                bound_by=bound_by, work_bound_ms=work_ms, work_bound_by=work_by,
                library_ms=None if probe.library is None else diff_ms(probe.library),
                replaces=probe.replaces, stands_for=list(probe.stands_for))


def sa0_exact_ms(device, batch: Optional[int] = None, seed: int = 0) -> Dict:
    """SA0 exact (``ops.sa_stage``, v8, bf16, random 4-64-64-64 weights) at
    the scan probes' shape and inputs, timed as they are."""
    xyz, feat, cent = scan_inputs(device, batch, seed)
    gen = torch.Generator().manual_seed(seed)
    dims = (4, 64, 64, 64)
    params = []
    for i in range(3):
        params.append(torch.randn(dims[i], dims[i + 1], generator=gen) * 0.2)
        params.append(torch.randn(dims[i + 1], generator=gen) * 0.2)
    w = ops.prepare_sa_weights(*(p.to(device) for p in params), compute_dtype=torch.bfloat16)
    run = lambda: ops.sa_stage(xyz, feat, cent, w, RADIUS, impl="v8", centroids_in_cloud=True)
    return dict(kind="time", name="sa0_exact_v8_bf16", kernel="sa", ms=diff_ms(run),
                shape=[*xyz.shape[:2], cent.shape[1]])


def _card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(device=None, batch: Optional[int] = None, seed: int = 0) -> List[Dict]:
    """The session: the card and, on a CUDA device, the launch floor; every
    probe (and the edge-case scan probes) against its plain version --
    raising if a kernel differs -- then, on a CUDA device, every timed probe
    timed against its bound with that floor, with SA0 exact's time after the
    scan probes'; each record printed as a JSON line. -> the records."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    records = []

    def out(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    floor = launch_floor_ms(dev) if cuda else None
    out(dict(kind="device", device=dev.type, seed=seed, torch=torch.__version__,
             name=torch.cuda.get_device_name(dev) if cuda else "cpu",
             card=_card() if cuda else None, launch_floor_ms=floor))
    probes = edge_probes(dev, seed) + edge_micro_probes(dev, seed) + make_probes(dev, batch, seed)
    for probe in probes:
        out(check(probe))
    failed = [r["name"] for r in records if r["kind"] == "parity" and not r["ok"]]
    if failed:
        raise AssertionError(f"kernels differ from their plain versions: {failed}")
    timed = [p for p in probes if p.timed]
    last_scan = [p for p in timed if p.kernel == "probe_scan"][-1]
    if cuda:
        for probe in timed:
            out(time_probe(probe, floor))
            if probe is last_scan:
                out(sa0_exact_ms(dev, batch, seed))
    return records
