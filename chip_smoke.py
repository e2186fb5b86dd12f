#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpinets_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mpinets_torch/csrc/`` (logging each SA
instantiation's registers, spills and launch plan, and counting the
tensor-core ``HMMA`` instructions in the built SASS where the toolkit has
``cuobjdump``), holds each kernel against its plain PyTorch version at the
main path's shapes -- FPS, the exact SA stage, its raw-block output (train
path), its off-cloud branch (``sa_impl="v3"``) and the chunk-window SA0,
and every SA variant on a cloud whose neighbour counts cross the bf16
kernel's 16-row tiles -- and the train path's parameter gradients, kernels
against plain versions. It then checks the
full-width forward against the plain paths and drives, with random weights
made from a seed, each path a user calls: the planning server
(``cli.serve.Planner``, exact grouping), the batched closed-loop rollout
(B=256, ``fast_grouping=4``, timed by long-minus-short, 30 - 5 steps, as
``bench.py`` does), a short rollout through the v3 stage, and the trainer
(``train.trainer.Trainer``, synthetic data, reference widths, bf16, at
B=10 and B=64: steps, validation, checkpoints, a restore, then at least
``TRAIN_MIN_S`` seconds of timed steps in chunks, reported as the median
and range of the chunks' rates; and once at a small cloud, which runs the
kernels as well). Last it drives the TPU probe session
(``mpinets_torch.probes.session``, what ``python -m mpinets_torch.probes``
runs): each probe kernel of ``csrc/probes.cu`` against its plain version at
the scripts' full shapes and on the scan's edge cases, then timed by the
scripts' long-minus-short loop, with SA0 exact timed beside the scan stages.

Any failed phase raises, so the script exits non-zero. It also exits
non-zero, printing no result, when there is no CUDA device or when the
``mpinets_torch`` package is not beside it. Launch counts are set to 0
before each main path and read after it. The line before the last is a
JSON object with one entry per kernel and shape: ``ms`` times the kernel
alone, ``launches`` counts that kernel at that shape over the main paths;
a probe kernel has one entry per timed probe of the session (a scan mode
stands for every TPU script probe that computes the same function), its
launches in the timed runs of the probe session.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from unittest import mock

SEED = 0
B = 256
FAST_W = 4
STEPS_SHORT, STEPS_LONG = 5, 30
V3_STEPS = 5              # the rollout through the v3 stage
TRAIN_BATCHES = (10, 64)  # the reference per-device batch (config.py:45), and a larger one
TRAIN_MIN_S = 5.0         # seconds of timed train steps per batch size and rate
TRAIN_CHUNK = 5           # train steps per timed chunk
GRAD_B = 8                # batch of the train-gradient check
PLAIN_ROWS = 16           # rows per plain-version call, to bound its memory
SPREAD = (0, 1, 15, 16, 17, 31, 127, 128, 200)  # neighbours per centroid, across the tiles
F32_TOL = 1e-5            # kernel vs plain, f32: sums in another order
BF16_TOL = 1e-2           # kernel vs plain, bf16: a 1-ulp flip of a bf16 activation
FWD_F32_TOL = 2e-5        # full forward, kernel path vs plain policy, f32
FWD_BF16_TOL = 2e-2       # full forward, kernel path vs plain path, bf16 (relative to max |dq|)
# train gradients, kernels vs plain versions, per tensor: f32 element-wise as
# the CPU tests (test_fused_train.py); bf16 by relative L2 distance. Two bf16
# runs that round in different places are each about the bf16-to-f32
# distance from the f32 gradients, so sqrt(2) times it from each other. The
# loss's collision hinge and the max-pools turn a one-ulp flip of the
# forward into a shift of the whole cotangent, about the same share of every
# tensor downstream (1.8% on this input), while one tensor's own bf16-to-f32
# distance can be smaller by chance; so a tensor's gate takes the larger of
# its own and the whole policy's bf16-to-f32 distance.
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
BF16_GRAD_FACTOR = 2 ** 0.5

# H100 SXM peak of the bf16 tensor cores (NVIDIA data sheet, dense); those of
# HBM and the f32 CUDA cores are mpinets_torch.probes.session's.
BF16_FLOPS = 989e12

TPU_SOURCES = {
    "fps": "mpinets_tpu/kernels/pallas_ops.py:32",
    "sa": "mpinets_tpu/kernels/pallas_ops.py:749",
    "sa_raw": "mpinets_tpu/kernels/pallas_ops.py:749",
    "sa_v3": "mpinets_tpu/kernels/pallas_ops.py:267",
    "sa_fast": "mpinets_tpu/kernels/pallas_ops.py:989",
}
# The TPU probe kernels. One CUDA kernel serves several TPU probes, so each
# probe's record from mpinets_torch/probes/session.py names the script lines
# it replaces (scripts/onchip_r3b.py:120, onchip_r3c.py:184, onchip_r3d.py:69
# and :175, onchip_r4a.py:71 and :129) and the scripts' measurements it
# stands for.
PROBE_KERNELS = ("probe_scan", "probe_micro", "probe_wide", "probe_scratch")
CUDA_SOURCES = {"fps": "mpinets_torch/csrc/fps.cu", "sa": "mpinets_torch/csrc/sa.cu",
                "sa_raw": "mpinets_torch/csrc/sa.cu", "sa_v3": "mpinets_torch/csrc/sa.cu",
                "sa_fast": "mpinets_torch/csrc/sa.cu",
                **dict.fromkeys(PROBE_KERNELS, "mpinets_torch/csrc/probes.cu")}


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"== {name}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def by_rows(fn, *tensors, rows=PLAIN_ROWS):
    """fn over row slices of the batch, outputs concatenated."""
    import torch

    outs = [fn(*(t[i:i + rows] for t in tensors)) for i in range(0, tensors[0].shape[0], rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


@contextlib.contextmanager
def plain_ops(ops):
    """Route the kernel launches that the train path makes to the plain
    versions, on any device (the plain reference of the kernels).
    ``sa_stage`` stays, so its mapping of ``impl`` and ``centroids_in_cloud``
    onto the kernel is compared too."""
    with mock.patch.object(ops, "sa_kernel", ops.sa_plain), \
            mock.patch.object(ops, "furthest_point_sample_with_coords",
                              lambda xyz, npoint, impl="v1": ops.fps_plain(xyz, npoint)):
        yield


def rel_l2(a, b):
    """Relative L2 distance of two tensors: |a - b| / |b|."""
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def step_times(step, min_s, chunk):
    """Seconds per call of ``step()``, one value per chunk of ``chunk``
    calls, over chunks until ``min_s`` seconds have passed (5 chunks at
    least); each chunk ends with a device synchronisation."""
    import torch

    times = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < min_s or len(times) < 5:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / chunk)
    return times


def tabletop_scan(rng):
    """A numpy-made scan: a table top, its mount table and a few boxes."""
    import numpy as np

    parts = [
        np.stack([rng.uniform(0.3, 1.2, 12000), rng.uniform(-0.25, 0.9, 12000),
                  rng.normal(0.0, 0.002, 12000)], 1),
        np.stack([rng.uniform(-0.3, 0.25, 3000), rng.uniform(-0.45, 0.45, 3000),
                  rng.normal(0.0, 0.002, 3000)], 1),
    ]
    for _ in range(4):
        lo = np.array([rng.uniform(0.4, 0.9), rng.uniform(-0.2, 0.6), 0.0])
        size = rng.uniform(0.05, 0.2, 3)
        pts = lo + rng.uniform(0, 1, (2000, 3)) * size
        face = rng.integers(0, 3, 2000)
        pts[np.arange(2000), face] = (lo + size * rng.integers(0, 2, 2000)[:, None])[
            np.arange(2000), face]
        parts.append(pts)
    return np.concatenate(parts).astype(np.float32)


def sa_data_ops(idx, n, chunks, p, widths):
    """Operations this run's data needs for one SA call: f32 distance tests
    up to the 128th hit (or the whole candidate list) and the MLP over each
    centroid's max(count, 1) rows. -> (f32 FLOP, MLP FLOP)."""
    import torch

    saturated = idx[..., 127] != idx[..., 0]
    kept = torch.where(saturated, 128, (idx != idx[..., :1]).sum(-1) + 1)
    if chunks is None:
        scanned = torch.where(saturated, idx[..., 127].long() + 1, n)
    else:
        last = idx[..., 127].long()
        rank = (chunks.long() == (last // 128)[..., None]).int().argmax(-1)
        scanned = torch.where(saturated, rank * 128 + last % 128 + 1, chunks.shape[-1] * 128)
    c1, c2, c3 = widths
    per_row = 2 * (p * c1 + c1 * c2 + c2 * c3)
    return 9.0 * float(scanned.sum()), float(kept.sum()) * per_row


def kernel_resources(log_text):
    """Per kernel instantiation in an ``nvcc -Xptxas -v`` log: registers,
    spill stores and loads, stack frame bytes. -> {short name: dict}."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            t = re.search(r"([a-z][a-z_]*?_kernel(?:_mma)?)(?:ILb([01])ELb([01])E|ILi(\d+)E)?",
                          m.group(1))
            full = m.group(1)
            name = full if t is None else t.group(1) + (
                f"<raw={t.group(2)}, point0={t.group(3)}>" if t.group(2) is not None
                else f"<{t.group(4)}>" if t.group(4) is not None
                else "<bf16>" if "bfloat16" in full else "<f32>" if "IfE" in full else "")
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_hmma(lib):
    """HMMA instructions per kernel in a built library's SASS (``cuobjdump
    -sass``), or None where the toolkit has no cuobjdump."""
    import re
    import shutil
    from pathlib import Path

    from mpinets_torch.kernels import ops

    tool = Path(ops._nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if not tool:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


def spread_cloud(gen, radius, c, b, dev):
    """A cloud whose centroid i, at (i, 0, 0), has SPREAD[i] points inside
    its ball (0.9 of the radius at most), shuffled among 400 points far from
    every ball; features uniform in [0, 1). -> (xyz, features, centroids)."""
    import torch

    cent = torch.tensor([(float(i), 0.0, 0.0) for i in range(len(SPREAD))], device=dev)
    rows = []
    for _ in range(b):
        parts = [torch.rand(400, 3, generator=gen, device=dev) * 10 - 5
                 + torch.tensor([0.0, 0.0, 10.0], device=dev)]
        for centre, k in zip(cent, SPREAD):
            d = torch.randn(k, 3, generator=gen, device=dev)
            r = 0.9 * radius * torch.rand(k, 1, generator=gen, device=dev) ** (1 / 3)
            parts.append(centre + d / d.norm(dim=1, keepdim=True) * r)
        pts = torch.cat(parts)
        rows.append(pts[torch.randperm(len(pts), generator=gen, device=dev)])
    xyz = torch.stack(rows).contiguous()
    feat = torch.rand(b, xyz.shape[1], c, generator=gen, device=dev)
    return xyz, feat, cent.expand(b, -1, -1).contiguous()


def bound(nbytes, f32_flops, mlp_flops=0.0, mlp_peak=BF16_FLOPS):
    from mpinets_torch.probes.session import F32_FLOPS, HBM_BYTES_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_flops / F32_FLOPS + mlp_flops / mlp_peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


KERNEL_GROUPS = (  # device-time buckets of a profile, by kernel name
    ("SA kernels", ("sa_kernel",)),
    ("FPS kernel", ("fps_kernel",)),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma", "cublas")),
)


def kernel_rows(prof):
    """The profile's rows of device kernels, without the ranges annotated
    on the device timeline (``record_function``, ``Optimizer.step``)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_rollout(run, problem, generator, top=12):
    """Device time by kernel over one ``run(problem, generator)``, the same
    time in groups (``KERNEL_GROUPS``, the rest as "other"), and the
    device's busy share of the window: kernel time on the device over wall
    time. Only kernel rows count; the rows of the aten ops that launch them,
    and of the ranges annotated on the device timeline, repeat their time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(problem, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.count, e.key) for e in kernel_rows(prof)
            if e.self_device_time_total > 0]
    total = sum(r[0] for r in rows)
    if not total:
        log("profiler: no device time recorded (CUDA events above are the timing)")
        return
    log(f"profiler: wall {wall * 1e3:.1f} ms, device kernel time {total / 1e3:.1f} ms, "
        f"busy share {total / 1e6 / wall:.3f}")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (elementwise, copies, reductions)"] = 0.0
    for dev_us, _, key in rows:
        name = next((g for g, subs in KERNEL_GROUPS if any(x in key.lower() for x in subs)),
                    "other (elementwise, copies, reductions)")
        groups[name] += dev_us
    log("  by group: " + "; ".join(f"{g} {t / 1e3:.1f} ms ({100 * t / total:.1f}%)"
                                   for g, t in groups.items()))
    for dev_us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {dev_us / 1e3:9.3f} ms  {100 * dev_us / total:5.1f}%  x{count:<5d} {key[:90]}")


def profile_train_layers(state, apply, make_batch, steps=3):
    """Device and host milliseconds per step in each layer of the trainer's
    step (``learner.make_train_step`` with the batch generation before it),
    over ``steps`` profiled steps. A layer is a ``record_function`` range;
    its device time counts the kernels launched under it. The backward runs
    on autograd's own thread, so it is read from autograd's per-node
    ranges: the SA stages' (``SAStageTrainBackward``, plain torch) apart
    from the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mpinets_torch.train import learner

    def forward(model, xyz, q):
        with record_function("train: policy forward"):
            return apply(model, xyz, q)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("train: batch generation"):
                batch = make_batch()
            state.optimizer.zero_grad(set_to_none=True)
            with record_function("train: policy forward + loss"):
                total, _ = learner.loss_fn(state.model, batch, apply_fn=forward)
            with record_function("train: backward (host call)"):
                total.backward()
            with record_function("train: optimizer"):
                state.optimizer.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    kernels = sum(e.self_device_time_total for e in kernel_rows(prof))

    def kernel_us(e):
        """Device time of the kernels launched under a CPU event, its
        children's included. A range's mirror on the device timeline (a
        user annotation, under the range's own name) is not a kernel."""
        return (sum(k.duration for k in e.kernels if k.name != e.name)
                + sum(kernel_us(c) for c in e.cpu_children))

    def ancestors(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e

    def ms(pred, host=False):
        us = sum(e.cpu_time_total if host else kernel_us(e) for e in events if pred(e))
        return us / 1e3 / steps

    # autograd's per-node ranges; a node's own torch.autograd.grad nests more
    node = "autograd::engine::evaluate_function: "
    is_bwd = lambda e: e.name.startswith(node) and not any(
        a.name.startswith(node) for a in ancestors(e))
    is_sa_bwd = lambda e: e.name == node + "SAStageTrainBackward" and is_bwd(e)
    named = lambda label: lambda e: e.name == label
    fwd, fwd_loss = named("train: policy forward"), named("train: policy forward + loss")
    layers = [
        ("batch generation", ms(named("train: batch generation")),
         ms(named("train: batch generation"), True)),
        ("policy forward (FPS, SA kernels, tail)", ms(fwd), ms(fwd, True)),
        ("loss (loss-bank FK, SDF)", ms(fwd_loss) - ms(fwd), ms(fwd_loss, True) - ms(fwd, True)),
        ("backward: SA stages (plain torch)", ms(is_sa_bwd), ms(is_sa_bwd, True)),
        ("backward: the rest", ms(is_bwd) - ms(is_sa_bwd), ms(is_bwd, True) - ms(is_sa_bwd, True)),
        ("optimizer (clip + Adam)", ms(named("train: optimizer")),
         ms(named("train: optimizer"), True)),
    ]
    log(f"train layers over {steps} steps: wall {1e3 * wall / steps:.2f} ms/step, device "
        f"kernel time {kernels / 1e3 / steps:.2f} ms/step (busy share "
        f"{kernels / 1e6 / wall:.3f}), the layers' sum {sum(d for _, d, _ in layers):.2f} "
        f"ms/step; backward host call {ms(named('train: backward (host call)'), True):.2f} "
        f"ms/step")
    for name, dev_ms, host_ms in layers:
        log(f"  {name:40s} device {dev_ms:8.3f} ms/step  host {host_ms:8.3f} ms/step")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mpinets_torch.kernels import ops
    except ImportError as e:
        print(f"chip_smoke: the mpinets_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    from collections import Counter

    from mpinets_torch.cli.config import load_config
    from mpinets_torch.cli.serve import Planner, serve
    from mpinets_torch.data.synthetic import (
        random_configuration,
        random_problem_batch,
        training_batch,
    )
    from mpinets_torch.geom.assembly import assemble_point_cloud
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.model import checkpoint as ckpt
    from mpinets_torch.model import fused
    from mpinets_torch.model.fused_train import make_fused_train_apply
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.robot import franka
    from mpinets_torch.rollout.engine import make_rollout_fn
    from mpinets_torch.train import learner
    from mpinets_torch.train.trainer import Trainer
    from mpinets_torch.utils.normalization import normalize_franka_joints

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    # ---- 0. card and build ------------------------------------------------
    phase("card and kernel build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = ops.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall, per source {built}")
    resources = {}
    for name in ops.SOURCES:
        resources.update(kernel_resources((ops.BUILD_DIR / f"{name}.log").read_text()))
    for kname, res in resources.items():
        log(f"  {kname}: {res}")
    if resources.get("sa_kernel_mma<raw=0, point0=0>", {}).get("spill_stores", 1):
        raise AssertionError("the inference tensor-core SA instantiation spills (or is missing)")
    hmma = sass_hmma(ops._target("sa"))
    if hmma is None:
        log("cuobjdump not found: HMMA count skipped")
    else:
        log(f"HMMA instructions in the SASS of sa.cu, per kernel: {hmma}")
        mma_kernels = {k: v for k, v in hmma.items() if "sa_kernel_mma" in k}
        if len(mma_kernels) != 3 or not all(mma_kernels.values()):
            raise AssertionError(f"sa_kernel_mma instantiations without HMMA: {hmma}")

    gen = torch.Generator().manual_seed(SEED)
    model = MotionPolicyNetwork(compute_dtype=bf16, device="cpu", generator=gen).to(dev).eval()
    sa_w = {dt: fused.sa_weights(model, dt) for dt in (f32, bf16)}
    stage_radii = [size["radius"] for size in fused.stage_sizes(model)]
    for stage, c_in in ((0, 1), (1, 64)):  # sa_fast launches what sa does
        for dt in (f32, bf16):
            for variant, in_cloud, raw in (("sa", True, False), ("sa_raw", True, True),
                                           ("sa_v3", False, False)):
                plan = ops.sa_launch_plan(sa_w[dt][stage], c_in, in_cloud, raw)
                log(f"  launch plan SA{stage} {str(dt)[6:]} {variant}: {plan}")
    ggen = torch.Generator(dev).manual_seed(SEED)
    problem = random_problem_batch(ggen, B, device=dev)
    with torch.no_grad():
        pc = assemble_point_cloud(problem.q0, problem.target_rot, problem.target_trans,
                                  problem.scene, generator=ggen)
    xyz = pc[..., :3].contiguous()
    feat = pc[..., 3:].contiguous()
    q_norm = normalize_franka_joints(problem.q0)
    report = {}

    # ---- 1. each kernel against its plain version -------------------------
    phase("FPS kernel vs plain")
    cent = {}
    for label, pts, npoint in (("SA0", xyz, 512), ("SA1", None, 128)):
        if pts is None:
            pts = cent["SA0"]
        ref_idx, ref_c = by_rows(lambda t: ops.fps_plain(t, npoint), pts)
        for impl in ("v1", "v2"):
            idx, coords = ops.furthest_point_sample_with_coords(pts, npoint, impl=impl)
            torch.cuda.synchronize()
            if not torch.equal(idx, ref_idx) or not torch.equal(coords, ref_c):
                bad = (idx != ref_idx).any(-1).sum().item()
                raise AssertionError(f"FPS {label} impl={impl}: {bad} rows differ from plain")
        cent[label] = coords
        ms = cuda_ms(lambda: ops.furthest_point_sample_with_coords(pts, npoint), 5)
        plain_ms = cuda_ms(lambda: by_rows(lambda t: ops.fps_plain(t, npoint), pts), 1)
        b_, n_ = pts.shape[:2]
        bnd, by = bound(b_ * n_ * 12 + b_ * npoint * 16, 9.0 * (npoint - 1) * n_ * b_)
        report[f"fps {n_}->{npoint}"] = dict(kernel="fps", shape=(n_, npoint), max_abs_err=0.0,
                                               ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                                               bound_by=by)
        log(f"FPS [{b_},{n_}]->{npoint}: idx equal (v1, v2); kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bnd:.4f} ms ({by})")

    def check_sa(label, kernel, args, stage, widths, dtype, chunks_fn=None, in_cloud=True,
                 raw=False, timed=True):
        """One SA kernel variant against its plain version: idx arrays equal,
        raw blocks bit-equal, features within the gate; timed in bf16."""
        radius = stage_radii[stage]
        weights = sa_w[dtype][stage]
        chunks = None if chunks_fn is None else chunks_fn(*args[::2])
        run = lambda: ops.sa_kernel(*args, weights, radius, chunks, in_cloud, raw)
        out = run()
        torch.cuda.synchronize()

        def plain(xs, fs, cs):
            ch = None if chunks_fn is None else chunks_fn(xs, cs)
            return ops.sa_plain(xs, fs, cs, weights, radius, ch, in_cloud, raw)

        ref = by_rows(plain, *args)
        if not torch.equal(out[1], ref[1]):
            bad = (out[1] != ref[1]).any(-1).sum().item()
            raise AssertionError(f"{label} {dtype}: idx differs from plain at {bad} centroids")
        if raw and not torch.equal(out[2], ref[2]):
            raise AssertionError(f"{label} {dtype}: raw block differs from plain")
        err = (out[0] - ref[0]).abs().max().item()
        tol = F32_TOL if dtype == f32 else BF16_TOL
        scale = max(1.0, ref[0].abs().max().item())
        log(f"{label} {str(dtype)[6:]}: idx equal{'; raw bit-equal' if raw else ''}; "
            f"max |feat err| {err:.3e} (tol {tol} x {scale:.2f}), "
            f"max |feat| {ref[0].abs().max().item():.3f}")
        if not err <= tol * scale:
            raise AssertionError(f"{label} {dtype}: feature error {err} > {tol * scale}")
        if dtype != bf16 or not timed:
            return out
        xs, fs, cs = args
        b_, n_, c_ = fs.shape
        s_ = cs.shape[1]
        # the kernel alone: window and weights made outside the timed calls
        ms = cuda_ms(run, 3)
        plain_ms = cuda_ms(lambda: by_rows(plain, *args), 1)
        f32_ops, mlp_ops = sa_data_ops(out[1], n_, chunks, 3 + c_, widths)
        nbytes = 4 * (xs.numel() + fs.numel() + cs.numel()
                      + sum(t.numel() for t in weights.tensors)
                      + (0 if chunks is None else chunks.numel())
                      + b_ * s_ * widths[2] + b_ * s_ * 128
                      + (b_ * s_ * 128 * (3 + c_) if raw else 0))
        bnd, by = bound(nbytes, f32_ops, mlp_ops)
        report[label] = dict(kernel=kernel, shape=(n_, s_), max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bnd, bound_by=by)
        log(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd:.4f} ms "
            f"({by}); data: {f32_ops / 9:.3e} distance tests, {mlp_ops:.3e} MLP FLOP")
        return out

    fast_chunks = lambda xs, cs: ops.chunk_window(xs, cs, FAST_W)
    phase("exact SA kernel vs plain (SA0, SA1)")
    sa0_args = (xyz, feat, cent["SA0"])
    f0 = None
    for dtype in (f32, bf16):
        f0 = check_sa("sa SA0", "sa", sa0_args, 0, (64, 64, 64), dtype)[0]
    sa1_args = (cent["SA0"], f0, cent["SA1"])
    for dtype in (f32, bf16):
        check_sa("sa SA1", "sa", sa1_args, 1, (128, 128, 256), dtype)
    phase(f"fast SA0 kernel vs plain (W={FAST_W})")
    for dtype in (f32, bf16):
        check_sa(f"sa_fast SA0 W={FAST_W}", "sa_fast", sa0_args, 0, (64, 64, 64), dtype,
                 chunks_fn=fast_chunks)
    phase("SA kernel raw block vs plain (SA0, SA1)")
    for dtype in (f32, bf16):
        check_sa("sa_raw SA0", "sa_raw", sa0_args, 0, (64, 64, 64), dtype, raw=True)
        check_sa("sa_raw SA1", "sa_raw", sa1_args, 1, (128, 128, 256), dtype, raw=True)
    phase("SA kernel, centroids off the cloud (v3) vs plain (SA0, SA1)")
    for label, args, stage, widths in (("SA0", sa0_args, 0, (64, 64, 64)),
                                       ("SA1", sa1_args, 1, (128, 128, 256))):
        off = args[2].clone()
        off[:, 1::3] += 0.013                   # beside their points
        off[:, 2::17] = torch.tensor([5.0, -4.0, 3.0], device=dev)  # no neighbour: point 0's row
        off_args = (args[0], args[1], off)
        for dtype in (f32, bf16):
            out = check_sa(f"sa_v3 {label} off-cloud", "sa_v3", off_args, stage, widths, dtype,
                           in_cloud=False, timed=False)
            radius = stage_radii[stage]
            v8 = ops.sa_stage(*off_args, sa_w[dtype][stage], radius, impl="v8",
                              centroids_in_cloud=True)
            v5 = ops.sa_stage(*off_args, sa_w[dtype][stage], radius, impl="v5",
                              centroids_in_cloud=True)
            if not (torch.equal(v5[0], v8[0]) and torch.equal(v5[1], v8[1])):
                raise AssertionError(f"{label} {dtype}: impl v5 differs from v8")
            if torch.equal(out[0][:, 2::17], v8[0][:, 2::17]):
                raise AssertionError(f"{label} {dtype}: the count==0 branch did not fire")
        log(f"{label}: impl v5 (centroids_in_cloud) equals v8 bit for bit")
        check_sa(f"sa_v3 {label}", "sa_v3", args, stage, widths, bf16, in_cloud=False)

    phase("SA kernel, neighbour counts across the 16-row tiles (SA0, SA1 widths)")
    sgen = torch.Generator(dev).manual_seed(SEED + 6)
    for label, stage, c_in, widths in (("SA0", 0, 1, (64, 64, 64)), ("SA1", 1, 64, (128, 128, 256))):
        spread = spread_cloud(sgen, stage_radii[stage], c_in, 4, dev)
        whole = lambda xs, cs: ops.chunk_window(xs, cs, -(-xs.shape[1] // 128))
        for dtype in (f32, bf16):
            for kernel, kw in (("sa", {}), ("sa_raw", dict(raw=True)),
                               ("sa_v3", dict(in_cloud=False)), ("sa_fast", dict(chunks_fn=whole))):
                check_sa(f"{kernel} {label} counts {SPREAD}", kernel, spread, stage, widths, dtype,
                         timed=False, **kw)

    # ---- 2. full-width forward: kernel path against the plain paths -------
    phase(f"full-width forward, B={B}")

    def plain_path(cdt, fast):
        w0, w1 = sa_w[cdt]

        def fwd(p, q):
            x, f = p[..., :3].contiguous(), p[..., 3:].contiguous()
            _, c0 = ops.fps_plain(x, 512)
            chunks = ops.chunk_window(x, c0, fast) if fast else None
            f0_, _ = ops.sa_plain(x, f, c0, w0, stage_radii[0], chunks)
            _, c1 = ops.fps_plain(c0, 128)
            f1_, _ = ops.sa_plain(c0, f0_, c1, w1, stage_radii[1])
            return fused.tail(model, c1, f1_, q, cdt)
        with torch.no_grad():
            return by_rows(fwd, pc, q_norm)

    model32 = MotionPolicyNetwork(compute_dtype=f32, device="cpu")
    model32.load_state_dict(model.state_dict())
    model32.to(dev).eval()
    with torch.no_grad():
        oracle = by_rows(model32, pc, q_norm)
    kern32 = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=f32)
    err = (kern32 - oracle).abs().max().item()
    log(f"f32 kernel path vs plain policy (pointnet oracle): max |dq err| {err:.3e}, "
        f"max |dq| {oracle.abs().max().item():.3f}")
    if not err <= FWD_F32_TOL:
        raise AssertionError(f"f32 forward error {err} > {FWD_F32_TOL}")
    for fast in (0, FAST_W):
        kern = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=bf16,
                                        fast_grouping=fast)
        ref = plain_path(bf16, fast)
        if not torch.isfinite(kern).all() or kern.shape != (B, 7):
            raise AssertionError(f"bf16 forward: bad output shape/values {kern.shape}")
        err = (kern - ref).abs().max().item()
        scale = ref.abs().max().item()
        log(f"bf16 kernel path vs plain path, fast_grouping={fast}: max |dq err| {err:.3e}, "
            f"max |dq| {scale:.3f}")
        if not err <= FWD_BF16_TOL * max(scale, 1e-3):
            raise AssertionError(f"bf16 forward (W={fast}) error {err} > tol")
    kern_v3 = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=bf16, sa_impl="v3")
    kern_v8 = fused.fused_policy_apply(model, pc, q_norm, compute_dtype=bf16)
    if not torch.equal(kern_v3, kern_v8):
        raise AssertionError("bf16 forward: sa_impl v3 differs from v8 on FPS centroids")
    log("bf16 kernel path, sa_impl v3 equals v8 on FPS centroids")
    torch.cuda.synchronize()

    phase(f"fused train step: kernels vs plain, B={GRAD_B}, full widths")
    tb = training_batch(torch.Generator(dev).manual_seed(SEED + 3), GRAD_B, device=dev)

    def train_grads(cdt, sa_impl="v8"):
        apply = make_fused_train_apply(cdt, sa_impl=sa_impl)
        model.zero_grad(set_to_none=True)
        total, _ = learner.loss_fn(model, tb, apply_fn=apply)
        total.backward()
        return total.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    for sa_impl in ("v8", "v3"):
        grads = {}
        for cdt in (f32, bf16):
            grads[cdt, "kernel"] = train_grads(cdt, sa_impl)
            with plain_ops(ops):
                grads[cdt, "plain"] = train_grads(cdt, sa_impl)
        worst = max((grads[f32, "kernel"][1][k] - g).abs().max().item()
                    / (GRAD_ATOL + GRAD_RTOL * g.abs().max().item())
                    for k, g in grads[f32, "plain"][1].items())
        # per tensor: rel L2 kernel-plain (bf16) over its gate, sqrt(2) x the
        # larger of the tensor's and the whole policy's bf16-to-f32 distance
        g_bf16, g_f32 = grads[bf16, "plain"][1], grads[f32, "plain"][1]
        whole = rel_l2(torch.cat([g.flatten() for g in g_bf16.values()]),
                       torch.cat([g_f32[k].flatten() for k in g_bf16]))
        ratios = []
        for k, g in g_bf16.items():
            d = rel_l2(grads[bf16, "kernel"][1][k], g)
            gate = BF16_GRAD_FACTOR * max(rel_l2(g, g_f32[k]), whole)
            ratios.append((d / gate, k, d, gate))
        ratios.sort(reverse=True)
        sa_worst = next(r for r in ratios if ".sa0." in r[1] or ".sa1." in r[1])
        log(f"sa_impl {sa_impl}: loss f32 kernel {grads[f32, 'kernel'][0]:.6f} plain "
            f"{grads[f32, 'plain'][0]:.6f}, bf16 kernel {grads[bf16, 'kernel'][0]:.6f} plain "
            f"{grads[bf16, 'plain'][0]:.6f}; f32 grads worst |err| / (atol + rtol max|g|) "
            f"{worst:.3f}; bf16 grads rel L2 bf16-f32 (plain, whole policy) {whole:.3e}; "
            f"kernel-plain per tensor {min(r[2] for r in ratios):.3e} to "
            f"{max(r[2] for r in ratios):.3e}; over its gate, worst: "
            + "; ".join(f"{k} {d:.3e}/{gate:.3e} = {r:.3f}"
                        for r, k, d, gate in ratios[:3] + [sa_worst]))
        if not worst <= 1.0:
            raise AssertionError(f"train gradients f32 ({sa_impl}): kernel vs plain {worst} > 1")
        if not ratios[0][0] <= 1.0:
            raise AssertionError(f"train gradients bf16 ({sa_impl}): {ratios[0][1]} rel L2 "
                                 f"{ratios[0][2]} > {ratios[0][3]}")
    model.zero_grad(set_to_none=True)

    # ---- 3+4. the main paths: server, batched rollout, v3 rollout, trainer -
    main_launches = Counter()

    def count_path(name, kernels):
        """Read the counts of the path just driven, check that each of its
        kernels ran, and add them to the main-path totals."""
        run = dict(ops.LAUNCHES_BY_SHAPE)
        main_launches.update(run)
        per_kernel = {k: v for k, v in ops.LAUNCHES.items() if v}
        log(f"{name}: launches {per_kernel}")
        for k in kernels:
            if not ops.LAUNCHES[k]:
                raise AssertionError(f"{name}: kernel {k} was not launched")
        return run

    ops.reset_launches()
    phase("planning server: 3 requests on the exact path")
    rng = np.random.default_rng(SEED)
    planner = Planner(model, tabletop_scan(rng), device=dev)
    requests = []
    for _ in range(3):
        q0 = random_configuration(ggen, (), dev)
        pos, quat = kinematics.eff_pose_quat(random_configuration(ggen, (), dev))
        requests.append(json.dumps({"q0": q0.tolist(), "target_position": pos.tolist(),
                                    "target_quaternion": quat.tolist()}))
    out = io.StringIO()
    t0 = time.perf_counter()
    serve(planner, io.StringIO("\n".join(requests) + "\n"), out)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    lo, hi = franka.JOINT_LIMITS[:, 0] - 1e-4, franka.JOINT_LIMITS[:, 1] + 1e-4
    for line in out.getvalue().splitlines():
        resp = json.loads(line)
        if set(resp) != {"success", "num_steps", "trajectory", "times"}:
            raise AssertionError(f"server response keys {sorted(resp)}")
        traj = np.asarray(resp["trajectory"])
        if traj.shape != (resp["num_steps"] + 1, 7) or len(resp["times"]) != len(traj):
            raise AssertionError(f"server trajectory shape {traj.shape}")
        if not (np.isfinite(traj).all() and (traj >= lo).all() and (traj <= hi).all()):
            raise AssertionError("server trajectory leaves the joint limits")
        log(f"response: success={resp['success']} num_steps={resp['num_steps']}")
    log(f"server: 3 requests in {t_serve:.2f} s")
    count_path("server", ("fps", "sa"))

    phase(f"batched rollout: B={B}, fast_grouping={FAST_W}, {STEPS_LONG} - {STEPS_SHORT} steps")
    apply_fn = fused.make_fused_apply(bf16, fast_grouping=FAST_W)
    rollouts = {
        n: make_rollout_fn(model, max_steps=n, stop_on_success=False,
                           record_trajectory=False, apply_fn=apply_fn, device=dev)
        for n in (STEPS_SHORT, STEPS_LONG)
    }

    def timed(n):
        t0 = time.perf_counter()
        res = rollouts[n](problem, torch.Generator(dev).manual_seed(SEED + 1))
        final = res.final_q.cpu()
        return time.perf_counter() - t0, final

    ops.reset_launches()
    t_long, final = timed(STEPS_LONG)
    per_step = {f"{k} N={n} S={s_}": v / STEPS_LONG
                for (k, n, s_), v in ops.LAUNCHES_BY_SHAPE.items()}
    if not torch.isfinite(final).all():
        raise AssertionError("rollout: non-finite configurations")
    rates = []
    for _ in range(3):
        t_short, _ = timed(STEPS_SHORT)
        t_long, _ = timed(STEPS_LONG)
        rates.append(B * (STEPS_LONG - STEPS_SHORT) / (t_long - t_short))
    rate = float(np.median(rates))
    log(f"rollout: env-steps/s {rates} (median {rate:.1f}); launches per step {per_step}")
    count_path("rollouts", ("fps", "sa", "sa_fast"))

    phase(f"profile: one {STEPS_SHORT}-step rollout (torch.profiler)")
    profile_rollout(rollouts[STEPS_SHORT], problem, torch.Generator(dev).manual_seed(SEED + 2))

    phase(f"rollout through the v3 stage: B={B}, {V3_STEPS} steps, exact grouping")
    finals = {}
    for sa_impl in ("v8", "v3"):
        rollout = make_rollout_fn(model, max_steps=V3_STEPS, stop_on_success=False,
                                  record_trajectory=False, device=dev,
                                  apply_fn=fused.make_fused_apply(bf16, sa_impl=sa_impl))
        if sa_impl == "v3":
            ops.reset_launches()
        finals[sa_impl] = rollout(problem, torch.Generator(dev).manual_seed(SEED + 4)).final_q
        if sa_impl == "v3":
            torch.cuda.synchronize()
            count_path("v3 rollout", ("fps", "sa_v3"))
    if not torch.equal(finals["v3"], finals["v8"]):
        raise AssertionError("v3 rollout differs from the v8 rollout on FPS centroids")
    log("v3 rollout: final configurations equal the v8 rollout's")

    phase(f"trainer: synthetic data, reference widths, bf16, B={TRAIN_BATCHES}")
    train_rates = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        for tb_size in TRAIN_BATCHES:
            cfg = load_config(None, {"optim": {"batch_size": tb_size, "bf16": True},
                                     "save_checkpoint_dir": tmp, "seed": SEED})
            cfg.data.synthetic = True
            ops.reset_launches()
            t0 = time.perf_counter()
            trainer = Trainer(cfg, test=True, device="cuda")
            state = trainer.run()
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            count_path(f"trainer B={tb_size}", ("fps", "sa_raw", "sa"))
            rows = [json.loads(line) for line in open(trainer.ckpt_dir / "metrics.jsonl")]
            val = [r for r in rows if "avg_target_error" in r]
            losses = [r["val_loss"] for r in rows if "val_loss" in r]
            if state.step != 10 or len(val) != 5 or not all(
                    np.isfinite(v) for r in rows for v in r.values()):
                raise AssertionError(f"trainer B={tb_size}: step {state.step}, rows {rows}")
            log(f"trainer B={tb_size}: 10 steps + 5 validations in {t_run:.1f} s; "
                f"loss {losses}; last validation {val[-1]}")
            # checkpoint round trip: the last checkpoint restores the state exactly
            fresh = learner.init_state(MotionPolicyNetwork(
                compute_dtype=bf16, device=dev, generator=torch.Generator().manual_seed(9)))
            restored = ckpt.restore_checkpoint(ckpt.latest_checkpoint(trainer.ckpt_dir), fresh)
            same = all(torch.equal(a, b) for a, b in zip(restored.model.state_dict().values(),
                                                         state.model.state_dict().values()))
            if not (same and restored.step == 10
                    and restored.optimizer.param_groups[0]["count"] == 10):
                raise AssertionError(f"trainer B={tb_size}: checkpoint restore differs")
            log(f"trainer B={tb_size}: checkpoint {ckpt.latest_checkpoint(trainer.ckpt_dir).name}"
                f" restores step {restored.step} bit for bit")

            # timed steps of the trainer's own step function: one batch
            # reused, then a fresh batch made before each step
            step_fn = learner.make_train_step(apply_fn=make_fused_train_apply(bf16))
            gen = torch.Generator(dev).manual_seed(SEED + 5)
            batch = training_batch(gen, tb_size, device=dev)
            holder = [step_fn(state, batch)[0]]
            torch.cuda.synchronize()
            before = dict(ops.LAUNCHES)

            def step(make=None):
                holder[0], _ = step_fn(holder[0], batch if make is None else make())

            times = step_times(step, TRAIN_MIN_S, TRAIN_CHUNK)
            per_step = {k: (v - before[k]) / (len(times) * TRAIN_CHUNK)
                        for k, v in ops.LAUNCHES.items() if v - before[k]}
            data_times = step_times(
                lambda: step(lambda: training_batch(gen, tb_size, device=dev)),
                TRAIN_MIN_S, TRAIN_CHUNK)
            state = holder[0]
            tr = {}
            for key, ts in (("", times), ("with_data_", data_times)):
                samples = sorted(tb_size / t for t in ts)
                tr.update({
                    f"{key}samples_per_s_median": float(np.median(samples)),
                    f"{key}samples_per_s_min": samples[0],
                    f"{key}samples_per_s_max": samples[-1],
                    f"{key}steps_per_s_median": float(np.median(samples)) / tb_size,
                    f"{key}timed_steps": len(ts) * TRAIN_CHUNK,
                    f"{key}timed_s": sum(ts) * TRAIN_CHUNK,
                })
            train_rates[tb_size] = tr
            log(f"train step B={tb_size}: {tr['timed_steps']} steps in "
                f"{tr['timed_s']:.2f} s, chunks of {TRAIN_CHUNK}: samples/s median "
                f"{tr['samples_per_s_median']:.1f} (min {tr['samples_per_s_min']:.1f}, "
                f"max {tr['samples_per_s_max']:.1f}), steps/s median "
                f"{tr['steps_per_s_median']:.2f}; with batch generation "
                f"{tr['with_data_timed_steps']} steps in {tr['with_data_timed_s']:.2f} s:"
                f" samples/s median {tr['with_data_samples_per_s_median']:.1f} (min "
                f"{tr['with_data_samples_per_s_min']:.1f}, max "
                f"{tr['with_data_samples_per_s_max']:.1f}) [{smi}]; "
                f"kernel launches per train step {per_step}")
            phase(f"profile: train step by layer, B={tb_size} (torch.profiler)")
            profile_train_layers(state, make_fused_train_apply(bf16),
                                 lambda: training_batch(gen, tb_size, device=dev))
            if tb_size == TRAIN_BATCHES[-1]:
                phase(f"profile: 3 train steps, B={tb_size} (torch.profiler)")
                profile_rollout(lambda *_: [step_fn(state, batch) for _ in range(3)], None, None)

        phase("trainer: a small cloud (64 + 96 + 32 points, SA 16/8) runs the kernels too")
        cfg = load_config(None, {
            "data": {"num_robot_points": 64, "num_obstacle_points": 96, "num_target_points": 32},
            "model": {"sa_npoints": [16, 8]}, "rollout": {"val_rollout_length": 3},
            "optim": {"batch_size": 4, "bf16": True}, "save_checkpoint_dir": tmp, "seed": SEED})
        cfg.data.synthetic = True
        ops.reset_launches()
        small = Trainer(cfg, test=True, device="cuda").run()
        torch.cuda.synchronize()
        count_path("trainer, small cloud", ("fps", "sa_raw", "sa"))
        if small.step != 10 or not all(torch.isfinite(p).all() for p in small.model.parameters()):
            raise AssertionError(f"trainer, small cloud: step {small.step} or non-finite weights")
    # ---- 5. the TPU probe session ----------------------------------------
    from mpinets_torch.probes import session as probe_session

    phase("TPU probes: kernels vs plain, and their times (probes.session, full shape)")
    t0 = time.perf_counter()
    ops.reset_launches()
    records = probe_session.run(dev, seed=SEED)   # raises if a kernel differs from plain
    torch.cuda.synchronize()
    parity = {r["name"]: r for r in records if r["kind"] == "parity"}
    probe_times = [r for r in records if r["kind"] == "time" and r["kernel"] in PROBE_KERNELS]
    # the timed runs are the path; the launches of the parity checks do not count
    timed_launches = Counter()
    for r in probe_times:
        timed_launches[r["kernel"]] += r["launches"]
    log(f"TPU probe session: launches in the timed runs {dict(timed_launches)}")
    for k in PROBE_KERNELS:
        if not timed_launches[k]:
            raise AssertionError(f"TPU probe session: kernel {k} was not launched")
    sa0_exact = next(r for r in records if r["kind"] == "time" and r["kernel"] == "sa")
    stages = {r["name"]: r["ms"] for r in probe_times if r["kernel"] == "probe_scan"}
    log(f"SA0 scan stages at B=256, N=6272, S=512, r=0.05 (ms): {stages}; SA0 exact (v8, bf16) "
        f"{sa0_exact['ms']:.4f} ms [{smi}]; the phase took {time.perf_counter() - t0:.1f} s")

    by_shape = dict(main_launches)
    log(f"main-path launches by (kernel, N, S): {by_shape}")

    # ---- 6. per-kernel line ------------------------------------------------
    kernels = []
    for name, r in report.items():
        k = r["kernel"]
        if not by_shape.get((k, *r["shape"])):
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": CUDA_SOURCES[k],
            "replaces": TPU_SOURCES[k], "launches": by_shape.get((k, *r["shape"]), 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    for r in probe_times:
        if not r["launches"]:
            raise AssertionError(f"probe {r['name']} was not launched in the probe session")
        kernels.append({
            "name": f"{r['kernel']} {r['name']}", "route": "cuda",
            "source": CUDA_SOURCES[r["kernel"]],
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": parity[r["name"]]["max_abs_err"], "ms": r["ms"],
            "plain_ms": parity[r["name"]]["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "stands_for": r["stands_for"],
        })
    log(json.dumps({"env_steps_per_s_median": rate, "env_steps_per_s": rates, "batch": B,
                    "fast_grouping": FAST_W, "compute_dtype": "bfloat16",
                    "train": {str(k): v for k, v in train_rates.items()}, "card": smi}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
