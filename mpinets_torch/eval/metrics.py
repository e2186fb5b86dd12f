"""Batched trajectory evaluation: the ``Evaluator``.

Port of ``mpinets_tpu/eval/metrics.py`` (a redesign of the reference's
``mpinets/metrics.py:50-763``). :func:`check_trajectories` checks a whole
batch of trajectories in plain torch on their device: scene collision of
the 57-sphere model under batched FK against the scene SDF, collision
depths, sphere self-collision, joint limits, final position error in cm and
orientation error in degrees, target-region membership with the corrected
negative volumes, end-effector path lengths and the speed profiles; success
is pos < 1 cm AND ori < 15 deg AND region AND no physical violation
(``metrics.py:514-519``). Lockstep rollouts give fixed-length [B, T, 7]
trajectories with frozen tails, so a per-step validity mask confines every
check to the live prefix.

:class:`Evaluator` keeps the reference's groups, ``metrics()`` keys,
printout and pickles. It copies a batch's checks to the host once and runs
SPARC there (:func:`mpinets_torch.eval.sparc.sparc`), where the live
prefixes' lengths vary, as the JAX package does.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from mpinets_torch.eval.sparc import sparc
from mpinets_torch.geom.scene import SceneSet
from mpinets_torch.kernels import kinematics, sdf
from mpinets_torch.robot import franka

#: Evaluation control-rate timestep (12 Hz; ``run_inference.py:297``).
EVAL_DT = 0.08
#: SPARC smoothness threshold (``metrics.py:589-594``).
SMOOTHNESS_THRESHOLD = -1.6


def percent_true(arr: Sequence) -> float:
    """Percent of true/nonzero entries (``metrics.py:50-57``)."""
    a = np.asarray(arr)
    return 100.0 * np.count_nonzero(a) / len(a)


def _quat_angle_deg(rot_a: torch.Tensor, rot_b: torch.Tensor) -> torch.Tensor:
    """Geodesic SO(3) angle in degrees between matrix batches (the
    reference's |(q1 * q2.conjugate).radians|, ``metrics.py:356-362``)."""
    tr = torch.einsum("...ij,...ij->...", rot_a, rot_b)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


@torch.no_grad()
def check_trajectories(
    trajectories: torch.Tensor,  # [B, T, 7] configs incl. start
    num_steps: torch.Tensor,     # [B] int: index of the final live config
    target_rot: torch.Tensor,    # [B, 3, 3]
    target_trans: torch.Tensor,  # [B, 3]
    scene: SceneSet,             # batched [B, ...]
    target_volumes: SceneSet,    # batched [B, ...] (one live primitive each)
    negative_volumes: SceneSet,  # batched [B, ...] (padded)
) -> Dict[str, torch.Tensor]:
    """Every per-trajectory check of a batch, on the trajectories' device.
    Returns [B]-shaped tensors, [B, T, 57] collision depths and the
    [B, T - 1] speed profiles."""
    b, t, _ = trajectories.shape
    dev = trajectories.device
    num_steps = num_steps.to(dev).long()
    valid = torch.arange(t, device=dev)[None, :] <= num_steps[:, None]  # [B, T]

    # --- physical violations over the live prefix -------------------------
    # with_base_link=False (mpinets/model.py:270): the base sphere is not
    # checked against the scene.
    centers = kinematics.scene_collision_spheres(trajectories)
    radii = torch.as_tensor(franka.SCENE_SPHERE_RADII, dtype=trajectories.dtype, device=dev)
    sdf_vals = sdf.scene_sdf_sequence(centers.reshape(b, t, -1, 3), scene).reshape(b, t, -1)
    step_collision = torch.any(sdf_vals <= radii, dim=-1)           # [B, T]
    in_collision = torch.any(step_collision & valid, dim=-1)
    depth = torch.clamp(radii - sdf_vals, min=0.0)                  # [B, T, 57] (m)
    depth = torch.where(valid[..., None], depth, torch.zeros_like(depth))

    self_collision = torch.any(kinematics.self_collision(trajectories) & valid, dim=-1)
    limit_violation = torch.any(~kinematics.within_limits(trajectories) & valid, dim=-1)
    physical = in_collision | self_collision | limit_violation

    # --- final-pose errors -------------------------------------------------
    final_q = torch.take_along_dim(trajectories, num_steps[:, None, None], dim=1)[:, 0]
    final_rot, final_pos = kinematics.eff_pose(final_q)
    position_error_cm = 100.0 * torch.linalg.norm(final_pos - target_trans, dim=-1)
    orientation_error = _quat_angle_deg(final_rot, target_rot)

    # --- target-region check (metrics.py:364-384,507-512) ------------------
    in_volume = sdf.scene_sdf(final_pos[:, None, :], target_volumes)[:, 0] <= 0.0
    neg_at_final = sdf.scene_sdf_per_primitive(final_pos[:, None, :], negative_volumes)[..., 0]
    neg_at_target = sdf.scene_sdf_per_primitive(target_trans[:, None, :], negative_volumes)[..., 0]
    # A negative volume that contains the target itself is dropped from the
    # check (metrics.py:507-512); padding (+inf) is kept and always passes.
    kept = neg_at_target > 0.0
    outside_negatives = torch.all(torch.where(kept, neg_at_final > 0.0, True), dim=-1)
    correct_region = in_volume & outside_negatives

    # --- path lengths over the live prefix (metrics.py:411-434) ------------
    rots, transs = kinematics.eff_pose(trajectories)  # [B, T, 3, 3], [B, T, 3]
    seg_valid = valid[:, 1:]  # segment i-1 -> i is live iff config i is
    pos_steps = torch.linalg.norm(torch.diff(transs, dim=1), dim=-1)
    zeros = torch.zeros_like(pos_steps)
    eff_position_path = torch.where(seg_valid, pos_steps, zeros).sum(dim=-1)
    ang_steps = _quat_angle_deg(rots[:, :-1], rots[:, 1:])
    eff_orientation_path = torch.where(seg_valid, ang_steps, zeros).sum(dim=-1)

    # --- speed profiles for the host's SPARC -------------------------------
    config_speed = torch.linalg.norm(torch.diff(trajectories, dim=1), dim=-1) / EVAL_DT
    eff_speed = pos_steps / EVAL_DT

    success = ((position_error_cm < 1.0) & correct_region & (orientation_error < 15.0)
               & ~physical)

    return {
        "collision": in_collision,
        "collision_depths": depth,
        "self_collision": self_collision,
        "joint_limit_violation": limit_violation,
        "physical_violations": physical,
        "position_error": position_error_cm,
        "orientation_error": orientation_error,
        "correct_region": correct_region,
        "eff_position_path_length": eff_position_path,
        "eff_orientation_path_length": eff_orientation_path,
        "config_speed": config_speed,
        "eff_speed": eff_speed,
        "success": success,
    }


def to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """:func:`check_trajectories`' outputs as numpy arrays, in one copy from
    the device: every value is packed into one f32 row per problem (the
    booleans as 0/1, which round-trip exactly), copied, and split again."""
    b = next(iter(out.values())).shape[0]
    flat = torch.cat([v.reshape(b, -1).to(torch.float32) for v in out.values()], dim=1)
    host = flat.cpu().numpy()
    arrays, col = {}, 0
    for key, v in out.items():
        width = v[0].numel()
        a = host[:, col:col + width].reshape(v.shape)
        arrays[key] = a.astype(bool) if v.dtype == torch.bool else a
        col += width
    return arrays


class Evaluator:
    """Group-structured metric accumulation with reference-parity reporting
    (``metrics.py:60-763``). Feed it whole batches; read out the same metric
    dictionary and printout as the reference's ``Evaluator.metrics``."""

    def __init__(self):
        self.groups: Dict[str, Dict[str, list]] = {}
        self.current_group: Optional[Dict[str, list]] = None
        self.current_group_key: Optional[str] = None

    def create_new_group(self, key: str) -> None:
        self.groups[key] = {}
        self.current_group_key = key
        self.current_group = self.groups[key]

    def _add(self, key: str, values) -> None:
        assert self.current_group is not None, "create_new_group first"
        self.current_group.setdefault(key, []).extend(values)

    def evaluate_batch(
        self,
        trajectories: torch.Tensor,  # [B, T, 7]
        num_steps,                   # [B] final live index
        target_rot: torch.Tensor,    # [B, 3, 3]
        target_trans: torch.Tensor,  # [B, 3]
        scene: SceneSet,
        target_volumes: SceneSet,
        negative_volumes: SceneSet,
        times: np.ndarray,           # [B] wall-clock seconds per problem
        skip_mask: Optional[np.ndarray] = None,  # [B] hard failures
    ) -> None:
        """Evaluate a batch on the trajectories' device and append
        per-problem rows to the current group (``evaluate_trajectory``,
        ``metrics.py:436-563``, batched). Arrays may be numpy or tensors."""
        trajectories = torch.as_tensor(trajectories)
        dev = trajectories.device
        on = lambda x: torch.as_tensor(x, device=dev)
        out = to_host(check_trajectories(
            trajectories, on(num_steps), on(target_rot), on(target_trans),
            scene.to(dev), target_volumes.to(dev), negative_volumes.to(dev)))
        b = trajectories.shape[0]
        num_steps = np.asarray(torch.as_tensor(num_steps).cpu())
        skip_mask = np.zeros(b, bool) if skip_mask is None else np.asarray(skip_mask)

        for i in range(b):
            if skip_mask[i]:
                # Hard-failure convention (metrics.py:464-468).
                self._add("success", [False])
                self._add("time", [np.inf])
                self._add("skips", [True])
                continue
            n = int(num_steps[i])
            depths_i = out["collision_depths"][i, : n + 1]
            depths_i = depths_i[depths_i > 0.0]
            self._add("collision_depths", [depths_i.tolist()])
            self._add("collision", [bool(out["collision"][i])])
            self._add("joint_limit_violation", [bool(out["joint_limit_violation"][i])])
            self._add("self_collision", [bool(out["self_collision"][i])])
            self._add("physical_violations", [bool(out["physical_violations"][i])])
            self._add("position_error", [float(out["position_error"][i])])
            self._add("orientation_error", [float(out["orientation_error"][i])])
            # SPARC over the live prefix only (variable length: the host).
            config_sparc = sparc(out["config_speed"][i, :n], 1.0 / EVAL_DT) if n else 0.0
            eff_sparc = sparc(out["eff_speed"][i, :n], 1.0 / EVAL_DT) if n else 0.0
            self._add("config_smoothness", [config_sparc])
            self._add("eff_smoothness", [eff_sparc])
            self._add("eff_position_path_length", [float(out["eff_position_path_length"][i])])
            self._add("eff_orientation_path_length",
                      [float(out["eff_orientation_path_length"][i])])
            self._add("success", [bool(out["success"][i])])
            self._add("time", [float(times[i])])
            self._add("num_steps", [n + 1])

    # -- aggregation (metrics.py:565-663) -----------------------------------

    @staticmethod
    def metrics(group: Dict[str, Any]) -> Dict[str, Any]:
        """Group summary with the reference's exact key set and semantics."""
        success = percent_true(group["success"])
        pos = np.asarray(group["position_error"])
        ori = np.asarray(group["orientation_error"])
        all_times = np.asarray(group["time"])

        skips: List = []
        if "skips" in group:
            successes = np.asarray(group["success"])
            unskipped_successes = successes[~np.isinf(all_times)]
            skips = group["skips"]
        else:
            unskipped_successes = np.asarray(group["success"])

        pos_paths = np.asarray(group["eff_position_path_length"])
        ori_paths = np.asarray(group["eff_orientation_path_length"])
        success_pos_paths = pos_paths[unskipped_successes]
        success_ori_paths = ori_paths[unskipped_successes]
        success_times = all_times[np.asarray(group["success"])]
        num_steps = np.asarray(group["num_steps"])
        success_num_steps = num_steps[unskipped_successes]

        depths = np.array([d for row in group["collision_depths"] for d in row])
        with np.errstate(invalid="ignore"):
            mean_depth = 100 * np.mean(depths) if depths.size else np.nan
            median_depth = 100 * np.median(depths) if depths.size else np.nan

        def mean_std(a):
            return (np.mean(a) if a.size else np.nan, np.std(a) if a.size else np.nan)

        return {
            "success": success,
            "total": len(group["success"]),
            "skips": len(skips),
            "time": (np.mean(success_times), np.std(success_times)),
            "step time": mean_std(success_times / success_num_steps),
            "env collision": percent_true(group["collision"]),
            "self collision": percent_true(group["self_collision"]),
            "joint violation": percent_true(group["joint_limit_violation"]),
            "physical violations": percent_true(group["physical_violations"]),
            "average collision depth": mean_depth,
            "median collision depth": median_depth,
            "1 cm": percent_true(pos < 1),
            "5 cm": percent_true(pos < 5),
            "15 deg": percent_true(ori < 15),
            "30 deg": percent_true(ori < 30),
            "165 deg": percent_true(ori > 165),
            "is smooth": percent_true(np.logical_and(
                np.asarray(group["config_smoothness"]) < SMOOTHNESS_THRESHOLD,
                np.asarray(group["eff_smoothness"]) < SMOOTHNESS_THRESHOLD,
            )),
            "average config sparc": np.mean(group["config_smoothness"]),
            "average eff sparc": np.mean(group["eff_smoothness"]),
            "eff position path length": mean_std(success_pos_paths),
            "eff orientation path length": mean_std(success_ori_paths),
        }

    # -- reporting (metrics.py:665-763) --------------------------------------

    @staticmethod
    def print_metrics(group: Dict[str, Any]) -> None:
        m = Evaluator.metrics(group)
        print(f"Total problems: {m['total']}")
        print(f"# Skips (Hard Failures): {m['skips']}")
        print(f"% Success: {m['success']:4.2f}")
        print(f"% Within 1cm: {m['1 cm']:4.2f}")
        print(f"% Within 5cm: {m['5 cm']:4.2f}")
        print(f"% Within 15deg: {m['15 deg']:4.2f}")
        print(f"% Within 30deg: {m['30 deg']:4.2f}")
        print(f"% Within 15deg of 180: {m['165 deg']:4.2f}")
        print(f"% With Environment Collision: {m['env collision']:4.2f}")
        print(f"% With Self Collision: {m['self collision']:4.2f}")
        print(f"% With Joint Limit Violations: {m['joint violation']:4.2f}")
        print(f"Average Collision Depth (cm): {m['average collision depth']}")
        print(f"Median Collision Depth (cm): {m['median collision depth']}")
        print(f"% With Physical Violations: {m['physical violations']:4.2f}")
        print(f"Average Config SPARC: {m['average config sparc']:4.2f}")
        print(f"Average End Eff SPARC: {m['average eff sparc']:4.2f}")
        print(f"% Smooth: {m['is smooth']:4.2f}")
        print("Average End Eff Position Path Length:"
              f" {m['eff position path length'][0]:4.2f}"
              f" ± {m['eff position path length'][1]:4.2f}")
        print("Average End Eff Orientation Path Length:"
              f" {m['eff orientation path length'][0]:4.2f}"
              f" ± {m['eff orientation path length'][1]:4.2f}")
        print(f"Average Time: {m['time'][0]:4.2f} ± {m['time'][1]:4.2f}")
        print("Average Time Per Step (Not Always Valuable):"
              f" {m['step time'][0]:4.6f}"
              f" ± {m['step time'][1]:4.6f}")

    def print_group_metrics(self, key: Optional[str] = None) -> None:
        if key is not None:
            self.current_group = self.groups[key]
            self.current_group_key = key
        assert self.current_group is not None
        self.print_metrics(self.current_group)

    def print_overall_metrics(self) -> None:
        keys = set()
        for group in self.groups.values():
            keys.update(group.keys())
        supergroup = {key: [row for group in self.groups.values() for row in group.get(key, [])]
                      for key in keys}
        self.print_metrics(supergroup)

    def save_group(self, directory: str, test_name: str, key: Optional[str] = None) -> None:
        group = self.current_group if key is None else self.groups[key]
        path = Path(directory) / f"{test_name}_{self.current_group_key}.pkl"
        with open(path, "wb") as f:
            pickle.dump(group, f)

    def save(self, directory: str, test_name: str) -> None:
        path = Path(directory) / f"{test_name}_metrics.pkl"
        with open(path, "wb") as f:
            pickle.dump(self.groups, f)
