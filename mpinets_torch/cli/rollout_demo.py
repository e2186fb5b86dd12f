"""Rollout demo / smoke driver: one batched lockstep rollout, end to end.

Port of ``mpinets_tpu/cli/rollout_demo.py``::

    python -m mpinets_torch.cli.rollout_demo [--batch 16] [--steps 20]
        [--fused | --no-fused] [--checkpoint PATH] [--device cuda]

Builds a batch of synthetic problems, runs the closed-loop rollout engine
(through the CUDA kernels by default on ``cuda``; ``--checkpoint`` takes
what :func:`mpinets_torch.cli.infer.load_params` reads, else random weights
from seed 0), and prints success and step statistics.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mpinets_torch.cli.infer import load_params
from mpinets_torch.data.synthetic import random_problem_batch
from mpinets_torch.model.fused import make_fused_apply
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.rollout.engine import make_rollout_fn
from mpinets_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction, default=None,
                    help="the CUDA-kernel forward (default: on cuda)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu: the plain path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = MotionPolicyNetwork(compute_dtype=torch.bfloat16, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        model.load_state_dict(load_params(args.checkpoint))
    model = model.to(device).eval()
    fused = device.type == "cuda" if args.fused is None else args.fused
    apply_fn = make_fused_apply(torch.bfloat16) if fused else None

    problems = random_problem_batch(torch.Generator(device).manual_seed(1), args.batch,
                                    device=device)
    rollout = make_rollout_fn(model, max_steps=args.steps, apply_fn=apply_fn, device=device)

    def timed(seed):
        t0 = time.perf_counter()
        result = rollout(problems, torch.Generator(device).manual_seed(seed))
        result.final_q.cpu()
        return time.perf_counter() - t0, result

    first, _ = timed(0)
    steady, result = timed(2)
    steps = result.num_steps.cpu().numpy()
    print(f"batch {args.batch} x {args.steps} steps ({'fused-cuda' if fused else 'plain'} "
          f"on {device})")
    print(f"first run {first:.1f}s, steady {steady:.3f}s "
          f"({args.batch * args.steps / steady:,.0f} env-steps/s)")
    print(f"success {int(result.success.sum())}/{args.batch}, "
          f"steps min/med/max {steps.min()}/{int(np.median(steps))}/{steps.max()}")
    print(f"final_q finite: {bool(torch.isfinite(result.final_q).all())}")


if __name__ == "__main__":
    main()
