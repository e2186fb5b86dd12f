"""Expert data generation: exhaust procedural environments into
reference-schema datasets.

Port of ``mpinets_tpu/pipeline/gen.py``, the counterpart of
``gen_data.py``'s scene fan-out
(the reference's ``mpinets/data_pipeline/gen_data.py:531-795``): every
scene's candidate pairs are planned as ONE device batch (smooth family +
SDF-cost trajectory optimization, :mod:`mpinets_torch.pipeline.expert`),
verified on the device and written in the reference's on-disk schema
(``gen_data.py:675-762``). Both directions of each pair are attempted
(``forward_backward``, ``gen_data.py:433-528``), and inference problems
get the reference's hindsight goal revision: the stored target is the FK
pose of the planned trajectory's final configuration
(``gen_data.py:832-836,888-893``).

CLI::

    python -m mpinets_torch.pipeline.gen {tabletop|cubby|merged-cubby|dresser}
        --output DIR [--num-scenes N] [--candidates-per-scene K] [--neutral]
        [--for-inference PKL] [--seed S] [--device cpu]
    python -m mpinets_torch.pipeline.gen tabletop --output DIR --visualize-scene OUT.html

Runs on ``cuda`` unless ``--device cpu``. Prints per-scene and overall
valid-plan rates (the reference's error-code tallies,
``gen_data.py:419-430``). Writing the HDF5 dataset needs ``h5py``; with
``eval_every=1`` every kept scene feeds the problem pickle and nothing is
written to HDF5.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from mpinets_torch import types as T
from mpinets_torch.data import problems as problem_io
from mpinets_torch.data import writer
from mpinets_torch.data.process import merge_files
from mpinets_torch.envs import ENVIRONMENTS
from mpinets_torch.envs.base import Environment
from mpinets_torch.eval.visualize import write_html
from mpinets_torch.kernels import kinematics
from mpinets_torch.pipeline import expert
from mpinets_torch.utils.device import resolve_device

ENVS = ENVIRONMENTS


def _candidate_pairs(cands_a, cands_b):
    """All directed pairs, each direction exactly once (forward_backward
    style, ``gen_data.py:433-528``)."""
    pairs = []
    for i, a in enumerate(cands_a):
        for b in cands_b[i + 1:]:
            if a is b:
                continue
            pairs.append((a, b))
            pairs.append((b, a))
    return pairs


def plan_scene(
    env: Environment,
    rng: np.random.Generator,
    candidates_per_scene: int,
    include_neutral: bool,
    pair_bucket: int | None = None,
    plan_kwargs: dict | None = None,
):
    """Plan all candidate pairs of one generated scene in one batch on the
    environment's device.

    ``pair_bucket`` pads the pair batch to a fixed width (repeating the
    first pair; padded results are masked out), as the JAX package does to
    share one compiled program between scenes.

    Returns (trajectories [V, 50, 7] f32, scene arrays dict, stats dict).
    """
    extra = env.gen_candidates(rng, candidates_per_scene)
    cands = list(env.demo_candidates) + extra
    if include_neutral:
        cands += env.gen_neutral_candidates(max(2, candidates_per_scene // 2), rng)
    pairs = _candidate_pairs(cands, cands)
    if not pairs:
        return np.zeros((0, expert.SEQUENCE_LENGTH, 7)), {}, {"pairs": 0, "valid": 0}
    n_real = len(pairs)
    if pair_bucket is not None:
        n_real = min(n_real, pair_bucket)
        pairs = pairs[:pair_bucket] + [pairs[0]] * (pair_bucket - n_real)

    def stack(xs):
        return torch.as_tensor(np.stack(xs).astype(np.float32), device=env.device)

    q_starts = stack([a.config for a, _ in pairs])
    q_goals = stack([b.config for _, b in pairs])
    rots = stack([b.pose.matrix[:3, :3] for _, b in pairs])
    trans = stack([b.pose.position for _, b in pairs])
    scene = env._unbatched_scene()
    res = expert.plan_pair_optimized(q_starts, q_goals, rots, trans, scene, **(plan_kwargs or {}))
    # per-pair failure tallies on the final trajectories (the reference's
    # error-code convention, gen_data.py:91-103,419-430)
    ver = expert.verify_trajectory(res.trajectory, rots, trans, scene)
    flags = torch.stack([res.valid, ver.miss > expert.MISS_TOLERANCE,
                         ver.max_jerk > expert.MAX_JERK, ver.has_self_collision,
                         ver.has_env_collision, ~ver.within_limits], dim=1)
    flags = flags.cpu().numpy()[:n_real]          # one copy to the host
    valid = flags[:, 0]
    trajs = res.trajectory.cpu().numpy()[:n_real][valid]
    stats = {
        "pairs": n_real,
        "valid": int(valid.sum()),
        "miss": int(flags[:, 1].sum()),
        "jerk": int(flags[:, 2].sum()),
        "self_collision": int(flags[:, 3].sum()),
        "env_collision": int(flags[:, 4].sum()),
        "limit_violation": int(flags[:, 5].sum()),
    }
    return trajs, _scene_arrays(env, len(trajs)), stats


def _scene_arrays(env: Environment, n: int) -> dict:
    """Replicate the scene's primitive arrays for each of n trajectories."""
    cubs = env.cuboids
    cyls = env.cylinders
    mc = max(len(cubs), 1)
    my = max(len(cyls), 1)
    out = {
        "cuboid_dims": np.zeros((n, mc, 3)),
        "cuboid_centers": np.zeros((n, mc, 3)),
        "cuboid_quats": np.zeros((n, mc, 4)),
        "cylinder_radii": np.zeros((n, my, 1)),
        "cylinder_heights": np.zeros((n, my, 1)),
        "cylinder_centers": np.zeros((n, my, 3)),
        "cylinder_quats": np.zeros((n, my, 4)),
    }
    for i, c in enumerate(cubs):
        out["cuboid_dims"][:, i] = c.dims
        out["cuboid_centers"][:, i] = c.center
        out["cuboid_quats"][:, i] = c.quaternion
    for i, c in enumerate(cyls):
        out["cylinder_radii"][:, i, 0] = c.radius
        out["cylinder_heights"][:, i, 0] = c.height
        out["cylinder_centers"][:, i] = c.center
        out["cylinder_quats"][:, i] = c.quaternion
    return out


def hindsight_problems(trajs: np.ndarray, env: Environment) -> List[T.PlanningProblem]:
    """Inference problems with hindsight goal revision: target := FK pose of
    each trajectory's final configuration (``gen_data.py:832-836``), on the
    environment's device."""
    if len(trajs) == 0:
        return []
    q_final = torch.as_tensor(np.asarray(trajs[:, -1], np.float32), device=env.device)
    rot, trans = kinematics.eff_pose(q_final)
    host = torch.cat([rot.reshape(-1, 9), trans], dim=1).cpu().numpy().astype(np.float64)
    problems = []
    for i in range(len(trajs)):
        position = host[i, 9:]
        problems.append(
            T.PlanningProblem(
                target=T.Pose(position, T.matrix_to_quat_np(host[i, :9].reshape(3, 3))),
                target_volume=T.Cuboid(position, (0.1, 0.1, 0.1), (1.0, 0.0, 0.0, 0.0)),
                q0=np.asarray(trajs[i, 0], np.float64),
                obstacles=list(env.obstacles),
            )
        )
    return problems


def gen(
    scene_type: str,
    output_dir,
    num_scenes: int = 10,
    candidates_per_scene: int = 4,
    include_neutral: bool = False,
    seed: int = 0,
    inference_pkl=None,
    time_budget_s: float | None = None,
    pair_bucket: int | None = None,
    clear_every: int = 10,
    eval_every: int = 0,
    scene_pad: tuple | None = None,
    plan_kwargs: dict | None = None,
    device=None,
) -> dict:
    """Generate ``num_scenes`` scenes worth of verified expert data into
    ``output_dir/all_data.hdf5``; optionally dump hindsight inference
    problems (an :mod:`mpinets_torch.types` pickle, which the JAX package
    cannot read). Returns overall stats. Runs on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``).

    ``pair_bucket`` fixes the planner's batch (see :func:`plan_scene`).
    ``clear_every`` is the JAX package's period for dropping its compile
    cache; PyTorch compiles nothing here, so it has no effect and stays for
    the signature. ``eval_every`` > 0 makes every N-th successful scene
    EVAL-ONLY: its trajectories feed the problem pickle instead of the
    training dataset (a scene-level held-out split, gen_data.py:832-845)."""
    del clear_every
    device = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    scene_files = []
    problems: List[T.PlanningProblem] = []
    total = {"scenes": 0, "pairs": 0, "valid": 0, "eval_scenes": 0, "eval_problems": 0}
    t_start = time.time()

    for s in range(num_scenes):
        if time_budget_s is not None and time.time() - t_start > time_budget_s:
            print(f"wall-clock budget reached after {total['scenes']} scenes", flush=True)
            break
        env = ENVS[scene_type](device=device)
        if scene_pad is not None:
            env.SCENE_PAD = scene_pad
        ok = env.gen(rng)
        # the funnel counts refused scenes too: they ran the candidate IK
        for k, v in env.funnel.items():
            total[f"funnel_{k}"] = total.get(f"funnel_{k}", 0) + v
        if not ok:
            continue
        funnel_pre = dict(env.funnel)
        trajs, scene_arrays, stats = plan_scene(
            env, rng, candidates_per_scene, include_neutral,
            pair_bucket=pair_bucket, plan_kwargs=plan_kwargs,
        )
        total["scenes"] += 1
        total["pairs"] += stats["pairs"]
        total["valid"] += stats["valid"]
        for k, v in env.funnel.items():
            total[f"funnel_{k}"] = total.get(f"funnel_{k}", 0) + v - funnel_pre.get(k, 0)
        for k, v in stats.items():
            if k not in ("pairs", "valid"):
                total[k] = total.get(k, 0) + v
        fails = {k: v for k, v in stats.items() if k not in ("pairs", "valid") and v}
        print(f"scene {s}: {stats['valid']}/{stats['pairs']} plans valid"
              + (f" (fails: {fails})" if fails else ""), flush=True)
        if len(trajs) == 0:
            continue
        if eval_every and total["scenes"] % eval_every == 0:
            if inference_pkl is not None:
                new = hindsight_problems(trajs, env)
                problems.extend(new)
                total["eval_scenes"] += 1
                total["eval_problems"] += len(new)
            continue
        arrays = {"global_solutions": trajs, "hybrid_solutions": trajs, **scene_arrays}
        path = out / f"scene_{s:05d}.hdf5"
        writer.write_dataset(path, arrays)
        scene_files.append(path)
        if inference_pkl is not None and not eval_every:
            problems.extend(hindsight_problems(trajs, env))

    if scene_files:
        # overwrite: a stale all_data.hdf5 must not strand a whole run
        merge_files(scene_files, out / "all_data.hdf5", overwrite=True)
        for f in scene_files:
            f.unlink()
    if inference_pkl is not None:
        problem_io.save_problems(inference_pkl, {scene_type: {"task-oriented": problems}})
    rate = total["valid"] / max(total["pairs"], 1)
    print(f"TOTAL: {total['scenes']}/{num_scenes} scenes, "
          f"{total['valid']}/{total['pairs']} plans valid ({100 * rate:.1f}%)", flush=True)
    if total.get("funnel_poses"):
        fp = total
        print(
            "candidate-IK funnel: "
            f"{fp['funnel_poses']} poses -> {fp['funnel_ik_solved']} accurate IK "
            f"({100 * fp['funnel_ik_solved'] / fp['funnel_poses']:.1f}%) -> "
            f"{fp['funnel_free']} collision-free "
            f"({100 * fp['funnel_free'] / max(fp['funnel_ik_solved'], 1):.1f}% of solved) -> "
            f"{fp['funnel_kept']} kept",
            flush=True,
        )
    return total


def visualize_scene(scene_type: str, out_html, seed: int = 0, device=None,
                    plan_kwargs: dict | None = None) -> expert.PlanResult:
    """The reference's ``test-environment`` mode analog
    (``gen_data.py:798-815`` ``visualize_single_env`` + the CLI mode at
    ``:1089-1098``): generate one scene (at most 10 attempts), plan its two
    demo candidates on ``device`` (default ``cuda``) with the planner's own
    draws (``plan_kwargs`` go to :func:`expert.plan_pair_optimized`), and
    write the trajectory + primitives to a standalone HTML viewer
    (:mod:`mpinets_torch.eval.visualize`, the PyBullet-GUI stand-in).
    Returns the plan (one pair)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    env = ENVS[scene_type](device=device)
    for _ in range(10):
        if env.gen(rng):
            break
    else:
        raise SystemExit("could not generate a valid scene in 10 attempts")
    a, b = env.demo_candidates[0], env.demo_candidates[1]

    def row(x):
        return torch.as_tensor(np.asarray(x, np.float32)[None], device=device)

    res = expert.plan_pair_optimized(row(a.config), row(b.config), row(b.pose.matrix[:3, :3]),
                                     row(b.pose.position), env._unbatched_scene(),
                                     **(plan_kwargs or {}))
    print(f"scene generated; demo plan valid={bool(res.valid[0])} "
          f"(family code {int(res.which[0])})")
    path = write_html(out_html, res.trajectory[0], cuboids=env.cuboids, cylinders=env.cylinders,
                      target_position=np.asarray(b.pose.position))
    print(f"wrote {path}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene_type", choices=sorted(ENVS))
    ap.add_argument("--output", required=True)
    ap.add_argument("--num-scenes", type=int, default=10)
    ap.add_argument("--candidates-per-scene", type=int, default=4)
    ap.add_argument("--neutral", action="store_true")
    ap.add_argument("--for-inference", default=None, metavar="PKL")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--visualize-scene", default=None, metavar="HTML",
                    help="test-environment mode (gen_data.py:798-815,1089-1098): generate "
                         "ONE scene, plan its demo pair, and write an interactive HTML "
                         "trajectory viewer instead of a dataset")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.visualize_scene:
        visualize_scene(args.scene_type, args.visualize_scene, args.seed, device=args.device)
        return
    gen(
        args.scene_type, args.output,
        num_scenes=args.num_scenes,
        candidates_per_scene=args.candidates_per_scene,
        include_neutral=args.neutral,
        seed=args.seed,
        inference_pkl=args.for_inference,
        device=args.device,
    )


if __name__ == "__main__":
    main()
