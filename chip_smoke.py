#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpinets_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``mpinets_torch/csrc/``, holds each kernel
against its plain PyTorch version at the main path's shapes, checks the
full-width forward against the plain paths, drives the planning server
(``cli.serve.Planner``, exact grouping) and the batched closed-loop rollout
(B=256, ``fast_grouping=4``) with random weights made from a seed, and
times the rollout by long-minus-short (30 - 5 steps) as ``bench.py`` does.

Any failed phase raises, so the script exits non-zero. It also exits
non-zero, printing no result, when there is no CUDA device or when the
``mpinets_torch`` package is not beside it. The line before the last is a
JSON object with one entry per kernel and shape: ``ms`` times the kernel
alone, ``launches`` counts that kernel at that shape on the main path
(server and rollouts). The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time

SEED = 0
B = 256
FAST_W = 4
STEPS_SHORT, STEPS_LONG = 5, 30
PLAIN_ROWS = 16           # rows per plain-version call, to bound its memory
F32_TOL = 1e-5            # kernel vs plain, f32: sums in another order
BF16_TOL = 1e-2           # kernel vs plain, bf16: a 1-ulp flip of a bf16 activation
FWD_F32_TOL = 2e-5        # full forward, kernel path vs plain policy, f32
FWD_BF16_TOL = 2e-2       # full forward, kernel path vs plain path, bf16 (relative to max |dq|)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM, f32 CUDA cores, bf16 tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

TPU_SOURCES = {
    "fps": "mpinets_tpu/kernels/pallas_ops.py:32",
    "sa": "mpinets_tpu/kernels/pallas_ops.py:749",
    "sa_fast": "mpinets_tpu/kernels/pallas_ops.py:989",
}
CUDA_SOURCES = {"fps": "mpinets_torch/csrc/fps.cu", "sa": "mpinets_torch/csrc/sa.cu",
                "sa_fast": "mpinets_torch/csrc/sa.cu"}


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


def bound(nbytes, f32_flops, mlp_flops=0.0, mlp_peak=BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_flops / F32_FLOPS + mlp_flops / mlp_peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_rollout(rollout, problem, generator, top=12):
    """Device time by kernel over one rollout, and the device's busy share
    of the window (kernel time summed over one stream / wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(problem, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    total = sum(r[0] for r in rows)
    if not total:
        log("profiler: no device time recorded (CUDA events above are the timing)")
        return
    log(f"profiler: wall {wall * 1e3:.1f} ms, device kernel time {total / 1e3:.1f} ms, "
        f"busy share {total / 1e6 / wall:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {dev_us / 1e3:9.3f} ms  {100 * dev_us / total:5.1f}%  x{count:<5d} {key[:90]}")


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

    from mpinets_torch.cli.serve import Planner, serve
    from mpinets_torch.data.synthetic import random_configuration, random_problem_batch
    from mpinets_torch.geom.assembly import assemble_point_cloud
    from mpinets_torch.kernels import kinematics
    from mpinets_torch.model import fused
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.robot import franka
    from mpinets_torch.rollout.engine import make_rollout_fn
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
    for name in ops.SOURCES:
        for line in (ops.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    model = MotionPolicyNetwork(compute_dtype=bf16, device="cpu", generator=gen).to(dev).eval()
    sa_w = {dt: fused.sa_weights(model, dt) for dt in (f32, bf16)}
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

    def check_sa(label, kernel, args, stage, widths, chunks_fn, dtype):
        radius = fused.SA1["radius"] if label.endswith("SA1") else fused.SA0["radius"]
        weights = sa_w[dtype][stage]
        extra = {"window": FAST_W} if kernel is ops.sa_stage_fast else {}
        run = lambda: kernel(*args, weights, radius=radius, **extra)
        feats, idx = run()
        torch.cuda.synchronize()

        def plain(xs, fs, cs):
            return ops.sa_plain(xs, fs, cs, weights, radius, chunks_fn(xs, cs))

        ref_f, ref_i = by_rows(plain, *args)
        if not torch.equal(idx, ref_i):
            bad = (idx != ref_i).any(-1).sum().item()
            raise AssertionError(f"{label} {dtype}: idx differs from plain at {bad} centroids")
        err = (feats - ref_f).abs().max().item()
        tol = F32_TOL if dtype == f32 else BF16_TOL
        scale = max(1.0, ref_f.abs().max().item())
        log(f"{label} {str(dtype)[6:]}: idx equal; max |feat err| {err:.3e} "
            f"(tol {tol} x {scale:.2f}), max |feat| {ref_f.abs().max().item():.3f}")
        if not err <= tol * scale:
            raise AssertionError(f"{label} {dtype}: feature error {err} > {tol * scale}")
        if dtype != bf16:
            return feats, err
        xs, fs, cs = args
        b_, n_, c_ = fs.shape
        s_ = cs.shape[1]
        chunks = chunks_fn(xs, cs)
        # the kernel alone: window and weights made outside the timed calls
        ms = cuda_ms(lambda: ops.sa_kernel(xs, fs, cs, weights, radius, chunks), 3)
        wrapper_ms = cuda_ms(run, 3)
        plain_ms = cuda_ms(lambda: by_rows(plain, *args), 1)
        f32_ops, mlp_ops = sa_data_ops(idx, n_, chunks, 3 + c_, widths)
        nbytes = 4 * (xs.numel() + fs.numel() + cs.numel()
                      + sum(t.numel() for t in weights.tensors)
                      + (0 if chunks is None else chunks.numel())
                      + b_ * s_ * widths[2] + b_ * s_ * 128)
        bnd, by = bound(nbytes, f32_ops, mlp_ops)
        report[label] = dict(kernel="sa_fast" if extra else "sa", shape=(n_, s_),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                             bound_by=by)
        log(f"{label}: kernel {ms:.3f} ms (wrapper {wrapper_ms:.3f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}); data: {f32_ops / 9:.3e} "
            f"distance tests, {mlp_ops:.3e} MLP FLOP")
        return feats, err

    exact_chunks = lambda xs, cs: None
    fast_chunks = lambda xs, cs: ops.chunk_window(xs, cs, FAST_W)
    phase("exact SA kernel vs plain (SA0, SA1)")
    sa0_args = (xyz, feat, cent["SA0"])
    f0 = None
    for dtype in (f32, bf16):
        f0, _ = check_sa("sa SA0", ops.sa_stage, sa0_args, 0, (64, 64, 64), exact_chunks, dtype)
    sa1_args = (cent["SA0"], f0, cent["SA1"])
    for dtype in (f32, bf16):
        check_sa("sa SA1", ops.sa_stage, sa1_args, 1, (128, 128, 256), exact_chunks, dtype)
    phase(f"fast SA0 kernel vs plain (W={FAST_W})")
    for dtype in (f32, bf16):
        check_sa(f"sa_fast SA0 W={FAST_W}", ops.sa_stage_fast, sa0_args, 0, (64, 64, 64),
                 fast_chunks, dtype)

    # ---- 2. full-width forward: kernel path against the plain paths -------
    phase(f"full-width forward, B={B}")

    def plain_path(cdt, fast):
        w0, w1 = sa_w[cdt]

        def fwd(p, q):
            x, f = p[..., :3].contiguous(), p[..., 3:].contiguous()
            _, c0 = ops.fps_plain(x, 512)
            chunks = ops.chunk_window(x, c0, fast) if fast else None
            f0_, _ = ops.sa_plain(x, f, c0, w0, fused.SA0["radius"], chunks)
            _, c1 = ops.fps_plain(c0, 128)
            f1_, _ = ops.sa_plain(c0, f0_, c1, w1, fused.SA1["radius"])
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
    torch.cuda.synchronize()

    # ---- 3+4. the main path: server, then the batched rollout --------------
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
    served = dict(ops.LAUNCHES)
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
    log(f"server: 3 requests in {t_serve:.2f} s; launches {served}")
    if not (served["fps"] > 0 and served["sa"] > 0):
        raise AssertionError(f"server path launched {served}")

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

    before = dict(ops.LAUNCHES_BY_SHAPE)
    t_long, final = timed(STEPS_LONG)
    per_step = {f"{k} N={n} S={s_}": (v - before.get((k, n, s_), 0)) / STEPS_LONG
                for (k, n, s_), v in ops.LAUNCHES_BY_SHAPE.items()}
    if not torch.isfinite(final).all():
        raise AssertionError("rollout: non-finite configurations")
    rates = []
    for _ in range(3):
        t_short, _ = timed(STEPS_SHORT)
        t_long, _ = timed(STEPS_LONG)
        rates.append(B * (STEPS_LONG - STEPS_SHORT) / (t_long - t_short))
    rate = float(np.median(rates))
    launches = dict(ops.LAUNCHES)
    by_shape = dict(ops.LAUNCHES_BY_SHAPE)
    log(f"rollout: env-steps/s {rates} (median {rate:.1f}); launches per step {per_step}")
    log(f"main-path launches (server + rollouts): {launches}; by (kernel, N, S): {by_shape}")
    for k in ("fps", "sa", "sa_fast"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")

    phase(f"profile: one {STEPS_SHORT}-step rollout (torch.profiler)")
    profile_rollout(rollouts[STEPS_SHORT], problem, torch.Generator(dev).manual_seed(SEED + 2))

    # ---- 5. per-kernel line ------------------------------------------------
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
    log(json.dumps({"env_steps_per_s_median": rate, "env_steps_per_s": rates, "batch": B,
                    "fast_grouping": FAST_W, "compute_dtype": "bfloat16", "card": smi}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
