"""Interactive planning server over JSON lines, on the GPU.

Port of ``mpinets_tpu/cli/serve.py``, the stand-in for the reference's ROS
planning node (``motion-policy-networks/interactive_demo/mpinets_ros/nodes/
planning_node.py``): it crops a scanned point cloud to the workspace and
downsamples it to 4096 obstacle points (``planning_node.py:186-228``),
plans with at most 75 policy steps under the 1 cm / 15 deg stop rule, and
answers with a trajectory at 0.12 s spacing.

Request (one JSON object per line)::

    {"q0": [7 floats],
     "target_position": [x, y, z],
     "target_quaternion": [w, x, y, z]}

Response::

    {"success": bool, "num_steps": int,
     "trajectory": [[7 floats], ...],            # q0 first
     "times": [0.0, 0.12, 0.24, ...]}

A malformed request gets ``{"success": false, "error": str(exception)}``,
as the JAX server answers it.

Usage, the JAX server's command line::

    python -m mpinets_torch.cli.serve CHECKPOINT SCAN.npy [--max-steps 75] [--no-fused]

or with the weights named by an option::

    python -m mpinets_torch.cli.serve
        (--weights WEIGHTS.npz | --checkpoint PATH | --random-init SEED)
        SCAN.npy [--max-steps 75] [--no-fused] [--device cuda]

``CHECKPOINT`` (the same as ``--checkpoint``) is what
:func:`mpinets_torch.cli.infer.load_params` reads (a Lightning ``.ckpt``, a
``.npz``, a trainer directory or the JAX package's orbax directory, such as
``checkpoints/r5_ft_best_ema``), as the JAX server loads through its
``cli.infer.load_params``; ``WEIGHTS.npz`` holds flax-layout weights
(:func:`mpinets_torch.model.checkpoint.save_flax_npz`). ``--no-fused`` runs
the plain policy instead of the kernel path.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from mpinets_torch import types as T
from mpinets_torch.cli.infer import load_params
from mpinets_torch.data.problems import problems_to_batch
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.rollout.engine import make_rollout_fn
from mpinets_torch.utils.device import resolve_device

#: planning_node.py:44-47
MAX_ROLLOUT_LENGTH = 75
NUM_OBSTACLE_POINTS = 4096
#: trajectory point spacing seconds (planning_node.py:340)
POINT_SPACING = 0.12


def clean_point_cloud(
    xyz: np.ndarray, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Workspace crop + downsample to 4096 points
    (``planning_node.py:186-228`` masks, exactly)."""
    rng = rng or np.random.default_rng(0)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    task_tabletop = (
        (x > 0.25) & (x < 1.35) & (y > -0.3) & (y < 1.6)
        & (z > -0.05) & (z < 0.35)
    )
    mount_table = (
        (x > -0.35) & (x < 0.30) & (y > -0.5) & (y < 0.5)
        & (z > -0.05) & (z < 0.05)
    )
    xyz = xyz[task_tabletop | mount_table]
    pick = rng.choice(len(xyz), size=NUM_OBSTACLE_POINTS,
                      replace=len(xyz) < NUM_OBSTACLE_POINTS)
    return xyz[pick].astype(np.float32)


class Planner:
    """Holds the policy and the scan; plans one problem per call
    (``planning_node.py:78-151``). Runs on ``device`` (default ``cuda``;
    raises when there is none unless ``device="cpu"``). ``fused`` as the JAX
    package's planner takes it: None takes the kernel path on the card and
    the plain policy on the CPU, False the plain policy, True the kernel
    path (on the CPU, the kernels' plain versions)."""

    def __init__(self, model: MotionPolicyNetwork, scan_xyz: np.ndarray,
                 max_steps: int = MAX_ROLLOUT_LENGTH, device=None,
                 fused: Optional[bool] = None, fast_grouping: int = 0):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.obstacle_points = clean_point_cloud(scan_xyz)
        if fused is None:
            fused = self.device.type == "cuda"
        apply_fn = None
        if fused:
            from mpinets_torch.model.fused import make_fused_apply

            apply_fn = make_fused_apply(model.compute_dtype, fast_grouping=fast_grouping)
        print(f"# rollout path: {'fused-cuda' if fused else 'plain'} on {self.device}",
              file=sys.stderr, flush=True)
        self.rollout = make_rollout_fn(
            self.model, max_steps=max_steps, stop_on_success=True,
            apply_fn=apply_fn, device=self.device,
        )
        self.generator = torch.Generator(self.device).manual_seed(0)

    def plan(self, q0, target_position, target_quaternion):
        problem = T.PlanningProblem(
            target=T.Pose(np.asarray(target_position, np.float64),
                          np.asarray(target_quaternion, np.float64)),
            target_volume=T.Cuboid(
                np.asarray(target_position, np.float64),
                (0.2, 0.2, 0.2), (1.0, 0.0, 0.0, 0.0),
            ),
            q0=np.asarray(q0, np.float64),
            obstacles=None,
            obstacle_point_cloud=self.obstacle_points,
        )
        batch = problems_to_batch([problem], device=self.device)
        result = self.rollout(batch["problem"], self.generator)
        steps = int(result.num_steps[0])
        traj = result.trajectories[0, : steps + 1].cpu().numpy()
        return {
            "success": bool(result.success[0]),
            "num_steps": steps,
            "trajectory": traj.tolist(),
            "times": [POINT_SPACING * i for i in range(len(traj))],
        }


def serve(planner: Planner, infile=sys.stdin, outfile=sys.stdout) -> None:
    for line in infile:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            resp = planner.plan(
                req["q0"], req["target_position"], req["target_quaternion"]
            )
        except Exception as e:  # noqa: BLE001 -- the server answers every line
            resp = {"success": False, "error": str(e)}
        outfile.write(json.dumps(resp) + "\n")
        outfile.flush()


def load_model(weights: Optional[str], random_init: Optional[int], device=None,
               compute_dtype=torch.bfloat16) -> MotionPolicyNetwork:
    """The policy from ``weights`` -- a flax-layout ``.npz``, or anything
    :func:`mpinets_torch.cli.infer.load_params` reads -- or random weights
    from a seed."""
    generator = None if random_init is None else torch.Generator().manual_seed(random_init)
    model = MotionPolicyNetwork(compute_dtype=compute_dtype, device="cpu",
                                generator=generator)
    if weights is not None:
        model.load_state_dict(load_params(weights))
    return model.to(resolve_device(device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--weights", help="flax-layout weights .npz")
    src.add_argument("--checkpoint", metavar="PATH", dest="checkpoint_opt",
                     help="a Lightning .ckpt, a .npz, a trainer checkpoint directory or an "
                          "orbax directory")
    src.add_argument("--random-init", type=int, metavar="SEED",
                     help="random weights made from SEED")
    ap.add_argument("checkpoint", nargs="?", help="the same as --checkpoint")
    ap.add_argument("scan", help=".npy point cloud [N, 3] (or [N, >=3])")
    ap.add_argument("--max-steps", type=int, default=MAX_ROLLOUT_LENGTH)
    ap.add_argument("--no-fused", action="store_true",
                    help="run the plain policy instead of the kernel path")
    ap.add_argument("--device", default=None, help="default cuda; cpu runs the plain path")
    # the positionals may stand on either side of the options, as the JAX
    # server's two required ones may
    args = ap.parse_intermixed_args(argv)
    sources = [v for v in (args.checkpoint, args.weights, args.checkpoint_opt,
                           args.random_init) if v is not None]
    if len(sources) != 1:
        ap.error("give the weights once: CHECKPOINT, --checkpoint, --weights or --random-init")

    weights = args.checkpoint or args.weights or args.checkpoint_opt
    model = load_model(weights, args.random_init, args.device)
    scan = np.load(args.scan)[:, :3]
    planner = Planner(model, scan, max_steps=args.max_steps, device=args.device,
                      fused=False if args.no_fused else None)
    print("ready", file=sys.stderr, flush=True)
    serve(planner, sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()
