"""Headline benchmark: closed-loop policy env-steps/s on one GPU.

Port of the JAX package's ``bench.py``::

    python -m mpinets_torch.bench [--batch 256 | --sweep] [--fast-grouping W]
        [--sa-impl v8] [--fps-impl v1] [--no-fused] [--profile DIR] [--device cuda]

Runs the lockstep rollout engine (:mod:`mpinets_torch.rollout.engine`)
through the kernel forward (:func:`mpinets_torch.model.fused.make_fused_apply`:
the CUDA FPS and SA kernels) on a batch of synthetic problems at the
reference input shapes (6272-point clouds, the reference PointNet++ widths,
bf16) with random weights from seed 0, and reports steady-state env-steps/s.
The rollouts have a fixed length and never stop on success, so the weights
do not change the work.

Every measurement ends with a device->host copy of the result, and a
repeat's rate is the *difference* between a long and a short rollout, so
that set-up, launch latency and cloud assembly cancel out and only the
steady per-step cost remains.

Prints on stderr each batch's rates (and, on the card, the kernel launches
a step by (kernel, B, N, S)), then ONE JSON line on stdout, last::

    {"metric": "env_steps_per_s_per_chip", "value": best, "unit": "steps/s",
     "median": m, "rates": {"B": [...]}, "config": {...}, "card": "..."}

``value`` is the best repeat over the measured batches, ``median`` the
median repeat of the batch that gave it, ``card`` the card's name and power
limit as ``nvidia-smi`` prints them (null on the CPU). ``--device cpu`` runs
the kernels' plain versions on the host; it measures the host, not a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

from mpinets_torch.data.synthetic import random_problem_batch
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.kernels import ops
from mpinets_torch.model.fused import make_fused_apply
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.rollout.engine import make_rollout_fn
from mpinets_torch.utils.device import resolve_device

SWEEP_BATCHES = (64, 256, 512)


def _run_sync(rollout, problem, generator) -> float:
    """Run one rollout and copy its result to the host, which waits for the
    device; returns seconds."""
    t0 = time.perf_counter()
    result = rollout(problem, generator)
    result.final_q.cpu()
    return time.perf_counter() - t0


def _problem(batch, device):
    """The batch's problems, seeded by the batch size."""
    return random_problem_batch(torch.Generator(device).manual_seed(batch), batch, device)


def measure_batch(model, apply_fn, batch, steps_short, steps_long, repeats, device,
                  sizes=PointCloudSizes()) -> list:
    """Env-steps/s of each repeat at ``batch``: B * (long - short) / (t_long -
    t_short), kept where t_long > t_short. Each rollout is run once first
    (generator seed 2), which also builds the kernels; repeat r draws from
    seed 100 + r."""
    device = resolve_device(device)
    problem = _problem(batch, device)
    rollouts = {
        n: make_rollout_fn(model, max_steps=n, sizes=sizes, stop_on_success=False,
                           record_trajectory=False, apply_fn=apply_fn, device=device)
        for n in (steps_short, steps_long)
    }
    for rollout in rollouts.values():
        _run_sync(rollout, problem, torch.Generator(device).manual_seed(2))

    rates = []
    extra = steps_long - steps_short
    for r in range(repeats):
        t_short = _run_sync(rollouts[steps_short], problem,
                            torch.Generator(device).manual_seed(100 + r))
        t_long = _run_sync(rollouts[steps_long], problem,
                           torch.Generator(device).manual_seed(100 + r))
        if t_long > t_short:
            rates.append(batch * extra / (t_long - t_short))
    return rates


def _profile(model, apply_fn, batch, steps, device, out_dir: Path) -> Path:
    """A ``torch.profiler`` trace of one ``steps``-step rollout at ``batch``,
    written to ``out_dir`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    rollout = make_rollout_fn(model, max_steps=steps, stop_on_success=False,
                              record_trajectory=False, apply_fn=apply_fn, device=device)
    problem = _problem(batch, device)
    with profile(activities=activities) as prof:
        _run_sync(rollout, problem, torch.Generator(device).manual_seed(100))
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"rollout_b{batch}_{steps}steps.json"
    prof.export_chrome_trace(str(path))
    return path


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m mpinets_torch.bench",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--sweep", action="store_true",
                        help=f"measure batches {SWEEP_BATCHES} and report the best")
    parser.add_argument("--steps-short", type=int, default=5)
    parser.add_argument("--steps-long", type=int, default=30)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--no-fused", action="store_true",
                        help="the plain policy forward (model(xyz, q)): no hand kernel runs")
    parser.add_argument("--bf16-cloud", action="store_true",
                        help="carry coordinates in bf16 through FPS")
    parser.add_argument("--fps-impl", default="v1", choices=("v1", "v2"),
                        help="the TPU FPS kernel the FPS calls stand for (both launch "
                             "csrc/fps.cu)")
    parser.add_argument("--sa-impl", default="v8", choices=("v3", "v5", "v8"),
                        help="exact SA stage: v8 and v5 take the count==0 rule of cloud "
                             "members, v3 that of centroids off the cloud (csrc/sa.cu)")
    parser.add_argument("--fast-grouping", type=int, default=4, metavar="W",
                        help="relaxed chunk-window grouping at SA0: each centroid searches "
                             "only its W nearest chunks of 128 points. 0 = the exact "
                             "ball query")
    parser.add_argument("--gather16", action="store_true",
                        help="a TPU layout mode (16-bit in-kernel gathers) that computes "
                             "the same function; accepted and ignored here")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of one measured (short) rollout "
                             "per batch into DIR")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card), or cpu: the kernels' "
                             "plain versions on the host")
    return parser


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.gather16:
        log("# WARNING: --gather16 is a TPU layout mode (16-bit in-kernel gathers) that "
            "computes the same function; the CUDA kernels have no such mode and it is IGNORED")

    device = resolve_device(args.device)
    card = _card() if device.type == "cuda" else None
    model = MotionPolicyNetwork(compute_dtype=torch.bfloat16, device=device,
                                generator=torch.Generator().manual_seed(0)).eval()
    if args.no_fused:
        apply_fn = None
        log("# --no-fused: the plain policy forward model(xyz, q); no hand kernel runs")
    else:
        apply_fn = make_fused_apply(torch.bfloat16, bf16_cloud=args.bf16_cloud,
                                    fps_impl=args.fps_impl, sa_impl=args.sa_impl,
                                    fast_grouping=args.fast_grouping)

    batches = SWEEP_BATCHES if args.sweep else (args.batch,)
    steps_run = (args.steps_short + args.steps_long) * (1 + args.repeats)
    rates = {}
    for b in batches:
        before = Counter(ops.LAUNCHES_BY_SHAPE)
        rates[b] = measure_batch(model, apply_fn, b, args.steps_short, args.steps_long,
                                 args.repeats, device)
        best_b = max(rates[b], default=0.0)
        log(f"# batch {b}: {best_b:,.1f} env-steps/s (repeats: "
            + ", ".join(f"{r:,.1f}" for r in rates[b]) + ")")
        launched = Counter(ops.LAUNCHES_BY_SHAPE)
        launched.subtract(before)
        if device.type == "cuda":
            log("#   launches a step by (kernel, B, N, S): "
                + "; ".join(f"{k} B={b_} N={n} S={s} {v / steps_run:g}"
                            for (k, b_, n, s), v in sorted(launched.items()) if v))
        if args.profile:
            path = _profile(model, apply_fn, b, args.steps_short, device, Path(args.profile))
            log(f"#   profile: {path}")

    best_batch = max(batches, key=lambda b: max(rates[b], default=0.0))
    best = max(rates[best_batch], default=0.0)
    result = {
        "metric": "env_steps_per_s_per_chip",
        "value": round(best, 1),
        "unit": "steps/s",
        "median": round(statistics.median(rates[best_batch]), 1) if rates[best_batch] else 0.0,
        "rates": {str(b): [round(r, 1) for r in rs] for b, rs in rates.items()},
        "config": {
            "sa_impl": args.sa_impl,
            "fast_grouping": args.fast_grouping,
            "fps_impl": args.fps_impl,
            "batch": max(batches),
            "fused": not args.no_fused,
            "bf16_cloud": args.bf16_cloud,
            "compute_dtype": "bfloat16",
            "device": str(device),
        },
        "card": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
