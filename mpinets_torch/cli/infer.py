"""Inference / evaluation CLI, on the GPU.

Port of ``mpinets_tpu/cli/infer.py``, the reference's evaluator driver
(``run_inference.py:423-474``)::

    python -m mpinets_torch.cli.infer <checkpoint> <problems.pkl>
        {tabletop|cubby|merged-cubby|dresser|all}
        {task-oriented|neutral-start|neutral-goal|all}
        [--save-metrics DIR] [--max-problems N] [--batch-size B] [--fp32]
        [--use-depth] [--fast-grouping W] [--no-fused] [--use-ema]
        [--b1-timing] [--device cuda]

``checkpoint`` (:func:`load_params`) is a PyTorch-Lightning ``.ckpt`` or a
bare state-dict ``.pt`` of the reference's model (converted on load,
:mod:`mpinets_torch.model.checkpoint`), a flax-layout ``.npz``
(``save_flax_npz``), a checkpoint directory of the port's trainer, or an
orbax directory of the JAX package in the OCDBT layout, such as the
committed ``checkpoints/r5_ft_best_ema`` (read without JAX,
:mod:`mpinets_torch.model.orbax`).

Whole problem groups run as batched lockstep rollouts on the device, through
the CUDA kernels on ``cuda`` (:mod:`mpinets_torch.model.fused`); on the CPU,
or with ``--no-fused``, through the plain policy. Per-problem planning time
is the batch's wall-clock shared by step counts, or with ``--b1-timing`` the
reference's batch-1 semantics.

``--use-depth`` reproduces the reference's depth mode
(``run_inference.py:194-257``): each primitive scene is sphere-traced to a
depth cloud on the device (:mod:`mpinets_torch.geom.depth`) and the policy
sees the sensed points while the metrics keep the true primitives.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from mpinets_torch.data import problems as problems_mod
from mpinets_torch.data.synthetic import Problem, random_problem_batch
from mpinets_torch.eval.metrics import Evaluator
from mpinets_torch.geom import depth
from mpinets_torch.model import checkpoint as ckpt_mod
from mpinets_torch.model import orbax
from mpinets_torch.model.fused import make_fused_apply
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.rollout.engine import MAX_ROLLOUT_LENGTH, make_rollout_fn
from mpinets_torch.utils.device import resolve_device

SCENE_TYPES = ("tabletop", "cubby", "merged-cubby", "dresser")
PROBLEM_TYPES = ("task-oriented", "neutral-start", "neutral-goal")
#: Files that mark an orbax checkpoint directory (the JAX package's trainer).
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt", "_METADATA")
#: Points of a depth-rendered obstacle cloud (``infer.py:211-213``).
DEPTH_POINTS = 4096

#: ``(lo, problem) -> (init_cloud [B, N, 4], robot_indices [T, B, R])``: the
#: draws of the chunk starting at problem ``lo``.
Draws = Callable[[int, Problem], Tuple[torch.Tensor, torch.Tensor]]


def _pick_orbax(tree: dict, use_ema: bool) -> dict:
    """The flax variables of an orbax tree, as the JAX package's
    ``load_params`` picks them: a saved train state's EMA tree
    (``use_ema``) or its ``params``; else the tree itself."""
    if use_ema and tree.get("ema_params") is not None:
        return tree["ema_params"]
    if "opt_state" in tree or "step" in tree:
        return tree["params"]
    return tree


def load_params(path, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """A :class:`MotionPolicyNetwork` state dict (on the CPU) from a
    Lightning ``.ckpt`` / state-dict ``.pt``, a flax-layout ``.npz``, an
    orbax OCDBT directory of the JAX package, or a checkpoint directory of
    the port's trainer: its newest (``last``, else the highest ``step_*``)
    or, given ``best``/``last``/``step_*`` itself, that one. ``use_ema``
    takes the directory's EMA parameters where it has them. An orbax
    directory in another layout raises ``ValueError``."""
    p = Path(path)
    if not p.is_dir():
        if p.suffix == ".npz":
            return ckpt_mod.params_from_flax(ckpt_mod.load_flax_npz(p))
        return ckpt_mod.params_from_flax(ckpt_mod.load_torch_checkpoint(p))
    step_dir = ckpt_mod.latest_checkpoint(p) or p
    for d in dict.fromkeys((step_dir, p)):
        if orbax.is_ocdbt_checkpoint(d):
            return ckpt_mod.params_from_flax(_pick_orbax(orbax.load_tree(d), use_ema))
    if any((d / m).exists() for d in {p, step_dir} for m in ORBAX_MARKERS):
        raise ValueError(
            f"{p} is an orbax checkpoint without an OCDBT manifest, which only the JAX "
            "package reads. Convert it on a machine with JAX: "
            "mpinets_torch.model.checkpoint.save_flax_npz(path, "
            "mpinets_tpu.cli.infer.load_params(dir, model)), then pass the .npz")
    state = step_dir / "state.pt"
    if not state.exists():
        raise FileNotFoundError(f"{p}: no trainer checkpoint ({state} is missing)")
    blob = torch.load(state, map_location="cpu", weights_only=True)
    if use_ema and blob.get("ema_params") is not None:
        return blob["ema_params"]
    return blob["params"]


def _b1_step_seconds(model, apply_fn, device) -> float:
    """Per-step seconds of a batch-1 rollout, by a 25-minus-5-step
    difference after a settling run of each (``infer.py:170-188``)."""
    cal_prob = random_problem_batch(torch.Generator(device).manual_seed(999), 1, device=device)
    fns = [make_rollout_fn(model, max_steps=n, stop_on_success=False, record_trajectory=False,
                           apply_fn=apply_fn, device=device) for n in (5, 25)]

    def run(fn):
        t0 = time.perf_counter()
        fn(cal_prob, torch.Generator(device).manual_seed(0)).final_q.cpu()
        return time.perf_counter() - t0

    for fn in fns:  # settle
        run(fn)
    t_s, t_l = run(fns[0]), run(fns[1])
    return max((t_l - t_s) / 20.0, 1e-6)


def evaluate_problem_set(
    params: Optional[Dict[str, torch.Tensor]],
    problem_set,
    scene_filter: str = "all",
    type_filter: str = "all",
    batch_size: int = 32,
    max_problems: Optional[int] = None,
    max_steps: int = MAX_ROLLOUT_LENGTH,
    model: Optional[MotionPolicyNetwork] = None,
    use_depth: bool = False,
    fused: Optional[bool] = None,
    fast_grouping: int = 0,
    b1_timing: bool = False,
    device=None,
    draws: Optional[Draws] = None,
) -> Evaluator:
    """Batched evaluation of a ProblemSet with the reference's Evaluator
    semantics, on ``device`` (default ``cuda``; raises when there is none
    unless ``device="cpu"``).

    ``params`` (a state dict, or None for ``model``'s own weights) is loaded
    into ``model`` (default: the bf16 policy at the reference widths).
    ``fused`` (default: on ``cuda``) runs the rollout's forward through the
    CUDA kernels; ``False`` is the plain policy. Each chunk of problems
    starting at ``lo`` draws from a generator seeded ``lo`` (its depth
    clouds from one seeded ``7000 + lo``), or takes ``draws(lo, problem)``.

    Timing: by default ``time`` is the batch's wall-clock shared by step
    counts (a throughput number, about batch-size times lower than the
    reference's). ``b1_timing=True`` restores the reference's semantics
    (``run_inference.py:287-303``): a batch-1 long-minus-short difference
    measures the per-step cost and ``time_i = num_steps_i * per_step_b1``.
    """
    device = resolve_device(device)
    if model is None:
        model = MotionPolicyNetwork(compute_dtype=torch.bfloat16, device="cpu")
    if params is not None:
        model.load_state_dict(params)
    model = model.to(device).eval()
    if fused is None:
        fused = device.type == "cuda"
    apply_fn = None
    if fused:
        apply_fn = make_fused_apply(model.compute_dtype, fast_grouping=fast_grouping)
    path = f"fused-cuda{f'+fast{fast_grouping}' if fast_grouping else ''}" if fused else "plain"
    print(f"# rollout path: {path} ({str(model.compute_dtype)[6:]}) on {device}", flush=True)
    rollout = make_rollout_fn(model, max_steps=max_steps, apply_fn=apply_fn, device=device)
    evaluator = Evaluator()

    per_step_b1 = None
    if b1_timing:
        per_step_b1 = _b1_step_seconds(model, apply_fn, device)
        print(f"# batch-1 per-step time: {per_step_b1 * 1e3:.2f} ms", flush=True)

    for scene_type, by_type in problem_set.items():
        if scene_filter != "all" and scene_type != scene_filter:
            continue
        for problem_type, problems in by_type.items():
            if type_filter != "all" and problem_type != type_filter:
                continue
            if max_problems is not None:
                problems = problems[:max_problems]
            if not problems:
                continue
            group_key = f"{scene_type}_{problem_type}"
            evaluator.create_new_group(group_key)
            print(f"== group {group_key}: {len(problems)} problems", flush=True)

            for lo in range(0, len(problems), batch_size):
                chunk = problems[lo: lo + batch_size]
                batch = problems_mod.problems_to_batch(chunk, device=device)
                problem = batch["problem"]
                if use_depth and problem.obstacle_points is None:
                    # the policy sees the sensed cloud; the metrics keep primitives
                    pts = depth.scene_to_point_cloud(
                        problem.scene, DEPTH_POINTS,
                        torch.Generator(device).manual_seed(7000 + lo))
                    problem = problem._replace(obstacle_points=pts)
                kw = {}
                if draws is not None:
                    kw["init_cloud"], kw["robot_indices"] = draws(lo, problem)
                else:
                    kw["generator"] = torch.Generator(device).manual_seed(lo)
                t0 = time.perf_counter()
                result = rollout(problem, **kw)
                num_steps = result.num_steps.cpu().numpy()  # waits for the rollout
                wall = time.perf_counter() - t0
                total_steps = max(int(num_steps.sum()), 1)
                if per_step_b1 is not None:
                    times = num_steps * per_step_b1  # the reference's B=1 semantics
                else:
                    times = wall * num_steps / total_steps
                evaluator.evaluate_batch(
                    result.trajectories, num_steps, problem.target_rot,
                    problem.target_trans, problem.scene, batch["target_volumes"],
                    batch["negative_volumes"], times=times,
                )
            evaluator.print_group_metrics(group_key)
    return evaluator


def main(argv=None) -> Evaluator:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoint", help=".ckpt / .pt, flax-layout .npz, or a trainer directory")
    parser.add_argument("problems")
    parser.add_argument("scene_type", choices=SCENE_TYPES + ("all",))
    parser.add_argument("problem_type", choices=PROBLEM_TYPES + ("all",))
    parser.add_argument("--save-metrics", default=None, metavar="DIR")
    parser.add_argument("--max-problems", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--fp32", action="store_true",
                        help="evaluate in f32 (TF32 off) instead of bf16")
    parser.add_argument("--use-depth", action="store_true",
                        help="policy consumes depth-rendered obstacle clouds")
    parser.add_argument("--fast-grouping", type=int, default=0, metavar="W",
                        help="relaxed chunk-window SA0 grouping (each centroid searches "
                             "only its W nearest point chunks); 0 = exact semantics")
    parser.add_argument("--no-fused", action="store_true",
                        help="the plain policy's forward (default on cuda: the CUDA kernels)")
    parser.add_argument("--use-ema", action="store_true",
                        help="evaluate a trainer checkpoint's EMA parameters when present")
    parser.add_argument("--b1-timing", action="store_true",
                        help="report per-problem 'time' with the reference's batch-1 "
                             "wall-clock semantics (one extra calibration run)")
    parser.add_argument("--device", default="cuda", help="cuda (default), or cpu: the plain path")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.fp32:
        # exact f32 products, as jax_default_matmul_precision="highest" in
        # the JAX package: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = MotionPolicyNetwork(compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
                                device="cpu")
    params = load_params(args.checkpoint, use_ema=args.use_ema)
    problem_set = problems_mod.load_problems(args.problems)
    evaluator = evaluate_problem_set(
        params, problem_set, args.scene_type, args.problem_type,
        batch_size=args.batch_size, max_problems=args.max_problems, model=model,
        use_depth=args.use_depth, fused=False if args.no_fused else None,
        fast_grouping=args.fast_grouping, b1_timing=args.b1_timing, device=device,
    )
    print("\n== overall ==")
    evaluator.print_overall_metrics()
    if args.save_metrics:
        Path(args.save_metrics).mkdir(parents=True, exist_ok=True)
        evaluator.save(args.save_metrics, "mpinets_torch_eval")
    return evaluator


if __name__ == "__main__":
    main()
