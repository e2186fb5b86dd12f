"""Times FPS and the SA stages on one GPU at given batch sizes, and the
batched rollout, through the package's public API alone, so that one file
times two checkouts of ``mpinets_torch`` in turns on one card:

    python mpinets_torch/kernels/sa_timing.py [--batch 1 3 256] [--seed 0] [--cpb 8 16 32]
        [--dtype bf16|f32]
    PYTHONPATH=OTHER_CHECKOUT python mpinets_torch/kernels/sa_timing.py

The second form imports ``mpinets_torch`` from OTHER_CHECKOUT: a script run
by its path puts its own directory, not the repository root, first on
``sys.path``. The inputs are ``chip_smoke.py``'s: random weights from the
seed, B=256 synthetic tabletop problems and their assembled 6272-point
cloud, FPS centroids; a smaller batch takes the first rows; FPS
is also timed on the small-cloud trainer's shapes (192 -> 16 on the first
192 points, then 16 -> 8). A
stage's time is the mean of 5 calls by CUDA events after a warm-up, queued
behind a device busy-wait (all of the stage's launches: on the exact path
the ball query and the MLP), and the MLP kernel alone at each stage,
reading the ball query's selection (``mlp ...``). ``--dtype`` sets the SA
weights' compute type: bf16 (the tensor-core kernel) or f32 (the CUDA-core
kernel, what ``cli.infer --fp32`` runs). The rollout, under bf16 only:
B=256, ``fast_grouping=4``, env-steps/s from 30 - 5 steps, the median of
three. ``--cpb`` also times the SA MLP kernel alone under each given number
of centroids per block
(the exact MLP reading the ball query's selection at SA0 and SA1, and the
fast SA0), through ``ops.sa_kernel``'s ``centroids_per_block`` (a checkout
whose kernel has no such choice cannot take it); a number the kernel does
not take at a stage's widths is recorded as null. Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 3, 10, 64, 256])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpb", type=int, nargs="*", default=[],
                    help="centroids per block to time the SA MLP kernel at")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="the SA weights' compute type")
    args = ap.parse_args(argv)

    import mpinets_torch
    from mpinets_torch.data.synthetic import random_problem_batch
    from mpinets_torch.geom.assembly import assemble_point_cloud
    from mpinets_torch.kernels import ops
    from mpinets_torch.model import fused
    from mpinets_torch.model.policy import MotionPolicyNetwork
    from mpinets_torch.rollout.engine import make_rollout_fn

    if not torch.cuda.is_available():
        raise SystemExit("sa_timing: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    ops.build(["fps", "sa"])
    build_s = time.perf_counter() - t0
    bf16 = torch.bfloat16
    dtype = bf16 if args.dtype == "bf16" else torch.float32
    model = MotionPolicyNetwork(compute_dtype=bf16, device="cpu",
                                generator=torch.Generator().manual_seed(args.seed)).to(dev).eval()
    w0, w1 = fused.sa_weights(model, dtype)
    r0, r1 = (size["radius"] for size in fused.stage_sizes(model))
    gen = torch.Generator(dev).manual_seed(args.seed)
    problem = random_problem_batch(gen, max(max(args.batch), 256), device=dev)
    with torch.no_grad():
        pc = assemble_point_cloud(problem.q0, problem.target_rot, problem.target_trans,
                                  problem.scene, generator=gen)

    times, by_cpb, plans = {}, {}, {}
    for b in args.batch:
        xyz, feat = pc[:b, :, :3].contiguous(), pc[:b, :, 3:].contiguous()
        c0 = ops.furthest_point_sample_with_coords(xyz, 512)[1]
        c1 = ops.furthest_point_sample_with_coords(c0, 128)[1]
        f0 = ops.sa_stage(xyz, feat, c0, w0, r0, impl="v8", centroids_in_cloud=True)[0]
        times[f"fps 6272->512 B={b}"] = _ms(lambda: ops.furthest_point_sample_with_coords(xyz, 512))
        times[f"fps 512->128 B={b}"] = _ms(lambda: ops.furthest_point_sample_with_coords(c0, 128))
        # the small-cloud trainer's shapes (64 + 96 + 32 points, SA 16/8)
        small = xyz[:, :192].contiguous()
        s0 = ops.furthest_point_sample_with_coords(small, 16)[1]
        times[f"fps 192->16 B={b}"] = _ms(lambda: ops.furthest_point_sample_with_coords(small, 16))
        times[f"fps 16->8 B={b}"] = _ms(lambda: ops.furthest_point_sample_with_coords(s0, 8))
        for label, stage_args, w, r in (("SA0", (xyz, feat, c0), w0, r0),
                                        ("SA1", (c0, f0, c1), w1, r1)):
            for name, kw in (("sa", dict(impl="v8", centroids_in_cloud=True)),
                             ("sa_raw", dict(impl="v8", centroids_in_cloud=True,
                                             return_raw=True)),
                             ("sa_v3", dict(impl="v3"))):
                times[f"{name} {label} B={b}"] = _ms(
                    lambda: ops.sa_stage(*stage_args, w, r, **kw))
        times[f"sa_fast SA0 W=4 B={b}"] = _ms(
            lambda: ops.sa_stage_fast(xyz, feat, c0, w0, r0, window=4))
        for label, (xs, fs, cs), w, r in (("SA0", (xyz, feat, c0), w0, r0),
                                          ("SA1", (c0, f0, c1), w1, r1)):
            sel = ops.sa_select(xs, cs, r)
            times[f"mlp {label} B={b}"] = _ms(lambda: ops.sa_kernel(xs, fs, cs, w, r,
                                                                    selection=sel))
        if not args.cpb:
            continue
        chunks = ops.chunk_window(xyz, c0, 4)
        for label, (xs, fs, cs), w, r, fast in (("sa SA0", (xyz, feat, c0), w0, r0, False),
                                                ("sa_fast SA0 W=4", (xyz, feat, c0), w0, r0, True),
                                                ("sa SA1", (c0, f0, c1), w1, r1, False)):
            key = f"{label} B={b}"
            plans[key] = ops.sa_launch_plan(w, fs.shape[-1], b, cs.shape[1], fast=fast)["cpb"]
            sel = None if fast else ops.sa_select(xs, cs, r)
            for cpb in args.cpb:
                try:
                    ops.sa_launch_plan(w, fs.shape[-1], b, cs.shape[1], fast=fast,
                                       centroids_per_block=cpb)
                except RuntimeError:   # beyond shared memory at these widths
                    by_cpb[f"{key} cpb={cpb}"] = None
                    continue
                by_cpb[f"{key} cpb={cpb}"] = _ms(lambda: ops.sa_kernel(
                    xs, fs, cs, w, r, chunks if fast else None, selection=sel,
                    centroids_per_block=cpb))

    rates = []
    if dtype == bf16:
        apply_fn = fused.make_fused_apply(bf16, fast_grouping=4)
        rollouts = {n: make_rollout_fn(model, max_steps=n, stop_on_success=False,
                                       record_trajectory=False, apply_fn=apply_fn, device=dev)
                    for n in (5, 30)}
        batch = random_problem_batch(torch.Generator(dev).manual_seed(args.seed), 256,
                                     device=dev)

        def run(n):
            t = time.perf_counter()
            rollouts[n](batch, torch.Generator(dev).manual_seed(args.seed + 1)).final_q.cpu()
            return time.perf_counter() - t

        run(30)
        for _ in range(3):
            short, long_ = run(5), run(30)
            rates.append(256 * 25 / (long_ - short))
    print(json.dumps({"package": mpinets_torch.__file__, "card": smi, "build_s": build_s,
                      "dtype": args.dtype, "ms": times, "mlp_ms_by_cpb": by_cpb,
                      "plan_cpb": plans, "env_steps_per_s": rates,
                      "env_steps_per_s_median": float(np.median(rates)) if rates else None}),
          flush=True)


if __name__ == "__main__":
    main()
