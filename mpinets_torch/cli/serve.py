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

A malformed request gets ``{"success": false, "error": "..."}``.

Usage::

    python -m mpinets_torch.cli.serve (--weights WEIGHTS.npz | --random-init SEED)
        SCAN.npy [--max-steps 75] [--device cuda]

``WEIGHTS.npz`` holds flax-layout weights
(:func:`mpinets_torch.model.checkpoint.save_flax_npz`).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from mpinets_torch import types as T
from mpinets_torch.data.problems import problems_to_batch
from mpinets_torch.model import checkpoint
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
    raises when there is none unless ``device="cpu"``) through the kernel
    path; on the CPU through the plain policy, as the JAX package's planner
    does off the TPU."""

    def __init__(self, model: MotionPolicyNetwork, scan_xyz: np.ndarray,
                 max_steps: int = MAX_ROLLOUT_LENGTH, device=None,
                 fast_grouping: int = 0):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.obstacle_points = clean_point_cloud(scan_xyz)
        apply_fn = None
        if self.device.type == "cuda":
            from mpinets_torch.model.fused import make_fused_apply

            apply_fn = make_fused_apply(
                model.compute_dtype, sa_npoints=model.sa_npoints,
                fast_grouping=fast_grouping,
            )
        print(f"# rollout path: {'fused-cuda' if apply_fn else 'plain'} on {self.device}",
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
            resp = {"success": False, "error": f"{type(e).__name__}: {e}"}
        outfile.write(json.dumps(resp) + "\n")
        outfile.flush()


def load_model(weights: Optional[str], random_init: Optional[int], device=None,
               compute_dtype=torch.bfloat16) -> MotionPolicyNetwork:
    """The policy from a flax-layout ``.npz``, or random weights from a seed."""
    generator = None if random_init is None else torch.Generator().manual_seed(random_init)
    model = MotionPolicyNetwork(compute_dtype=compute_dtype, device="cpu",
                                generator=generator)
    if weights is not None:
        model.load_state_dict(checkpoint.params_from_flax(checkpoint.load_flax_npz(weights)))
    return model.to(resolve_device(device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="flax-layout weights .npz")
    src.add_argument("--random-init", type=int, metavar="SEED",
                     help="random weights made from SEED")
    ap.add_argument("scan", help=".npy point cloud [N, 3] (or [N, >=3])")
    ap.add_argument("--max-steps", type=int, default=MAX_ROLLOUT_LENGTH)
    ap.add_argument("--device", default=None, help="default cuda; cpu runs the plain path")
    args = ap.parse_args(argv)

    model = load_model(args.weights, args.random_init, args.device)
    scan = np.load(args.scan)[:, :3]
    planner = Planner(model, scan, max_steps=args.max_steps, device=args.device)
    print("ready", file=sys.stderr, flush=True)
    serve(planner, sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()
