"""The comparison that decides a rollout cell's ``correct``.

It reads what the timed rollouts produced -- every rollout's trajectory,
success mask and step count, and, for one rollout drawn from the seed, the
policy's inputs and every stage's output at two steps (t = 0 and one drawn
later step) -- and holds them against the plain reference
(:mod:`benchmark.reference.policy`, :mod:`benchmark.reference.robot`),
which recomputes each from the inputs the benchmark made: the weights, the
problems, and the program's state at the captured steps (the cloud and the
configuration the policy was given). The closed loop itself cannot be
followed from the start, since a rounding difference in one step's Delta-q
changes every later cloud; so the captured step's state is the program's,
and the parts that this skips are checked by themselves: the cloud's
assembly at t = 0 and its robot resample (every point on the robot's, the
gripper's or the scene's surface), the transition from a step's Delta-q to
the next configuration, and the success mask and step counts of every
rollout from the reference's forward kinematics.

Each number is compared with its limit in the configuration file
(``limits``); an exact comparison's limit is 0.
"""

from __future__ import annotations

import torch

from benchmark.reference import policy, robot

def rel_err(out, ref):
    """|out - ref| / |ref| (2-norms over every element); inf where the
    shapes differ."""
    if out.shape != ref.shape:
        return float("inf")
    ref = ref.double()
    den = torch.linalg.vector_norm(ref)
    num = torch.linalg.vector_norm(out.double() - ref)
    return float(num / den) if float(den) > 0 else float(num)


def spread_err(out, ref):
    """|out - ref| / |ref - its mean over the batch|: the error against the
    part of the output that the inputs set (a random policy's Delta-q is
    mostly one vector shared by the batch)."""
    if out.shape != ref.shape:
        return float("inf")
    ref = ref.double()
    den = torch.linalg.vector_norm(ref - ref.mean(0, keepdim=True))
    num = torch.linalg.vector_norm(out.double() - ref)
    return float(num / den) if float(den) > 0 else float(num)


def policy_numbers(cfg, weights, cap, precision="f32", ref=None):
    """The policy forward at one captured step: the reference on the
    program's inputs (``cap["cloud"]``, ``cap["q_norm"]``) against the
    program's outputs. -> (numbers, the reference's outputs)."""
    if ref is None:
        with torch.no_grad():
            ref = policy.forward(weights, cfg, cap["cloud"], cap["q_norm"], precision)
    def mism(a, b):
        return int((a.long() != b.long()).sum()) if a.shape == b.shape else b.numel()
    nums = {
        "fps_mismatch": mism(cap["fps0"], ref["fps0"]) + mism(cap["fps1"], ref["fps1"]),
        "select_mismatch": mism(cap["sel0"], ref["sel0"]) + mism(cap["sel1"], ref["sel1"]),
        "f0_err": rel_err(cap["f0"], ref["f0"]),
        "f1_err": rel_err(cap["f1"], ref["f1"]),
        "dq_err": spread_err(cap["dq"], ref["dq"]),
    }
    return nums, ref


def control_numbers(cfg, weights, cap, ref, precision):
    """The control: the reference in ``precision`` put in the program's
    place, on the same inputs, against the float32 reference."""
    with torch.no_grad():
        low = policy.forward(weights, cfg, cap["cloud"], cap["q_norm"], precision)
    return {"f0_err": rel_err(low["f0"], ref["f0"]), "f1_err": rel_err(low["f1"], ref["f1"]),
            "dq_err": spread_err(low["dq"], ref["dq"])}


def status_numbers(traj, success, num_steps, problem, margin_tol=1e-3):
    """One rollout's success mask and step counts against the reference's
    success predicate along its trajectory [B, T+1, 7]; the tail after the
    first success must repeat it (the frozen configuration). Problems whose
    distance to a threshold is under ``margin_tol`` of it at some step are
    set aside, since rounding could flip them. -> (mismatches, set aside)."""
    b, t1, _ = traj.shape
    reached, margin = robot.success(traj, problem["target_rot"][:, None],
                                    problem["target_trans"][:, None])
    ambiguous = (margin < margin_tol).any(1)
    steps = torch.arange(t1, device=traj.device)
    first = torch.where(reached, steps, torch.full_like(steps, t1)).amin(1)
    want_success = first < t1
    want_steps = torch.where(want_success, first, torch.full_like(first, t1 - 1))
    held = traj.gather(1, first.clamp(max=t1 - 1)[:, None, None].expand(b, 1, 7))
    moved = ((steps[None, :] > first[:, None]) & (traj != held).any(-1)).any(1)
    bad = ((success.bool() != want_success) | (num_steps.long() != want_steps)
           | moved) & ~ambiguous
    return int(bad.sum()), int(ambiguous.sum())


def transition_err(cap, traj, t, done):
    """max |q_{t+1} - q'| (radians), q' the next configuration that the
    captured step's Delta-q gives (clamped in normalized space; held where
    done), and the captured input's distance from normalize(q_t)."""
    q_norm = cap["q_norm"].double()
    nxt = torch.clamp(q_norm + cap["dq"].double(), -1.0, 1.0)
    nxt = torch.where(done[:, None], q_norm, nxt)
    want = robot.unnormalize(nxt)
    step = (traj[:, t + 1].double() - want).abs().amax()
    held = (robot.normalize(traj[:, t].double()) - q_norm).abs().amax()
    return float(torch.maximum(step, held))


def cloud_numbers(cfg, cloud, q, problem, first_cloud=None):
    """The cloud the policy was given at a step with configuration ``q``:
    its labels, every robot point on the robot's sphere surface at ``q``,
    obstacle points on the scene's primitives, target points on the
    gripper's spheres at the target pose, and (``first_cloud``) obstacle
    and target segments unchanged since t = 0.
    -> (surface gap in metres, mismatched labels or segments)."""
    nr, no = cfg["points"]["robot"], cfg["points"]["obstacle"]
    xyz, label = cloud[..., :3], cloud[..., 3]
    want = torch.cat([torch.zeros(nr), torch.ones(no), torch.full((cloud.shape[1] - nr - no,), 2.0)]
                     ).to(cloud.device)
    mism = int((label != want).sum())
    rots, trans = robot.fk(q.float())
    centres, radii = robot.sphere_centres(rots, trans)
    gap = robot.surface_gap(xyz[:, :nr], centres, radii).amax()
    scene = {k: v for k, v in problem.items() if k.startswith(("cuboid", "cylinder"))}
    gap = torch.maximum(gap, robot.scene_surface_gap(xyz[:, nr:nr + no], scene).amax())
    grots, gtrans = robot.gripper_frames(problem["target_rot"], problem["target_trans"])
    centres, radii = robot.sphere_centres(grots, gtrans, robot.GRIPPER_FRAMES)
    gap = torch.maximum(gap, robot.surface_gap(xyz[:, nr + no:], centres, radii).amax())
    if first_cloud is not None:
        mism += int((cloud[:, nr:] != first_cloud[:, nr:]).sum())
    return float(gap), mism


def done_before(traj, problem, t):
    """[B] bool: the success predicate held at some step <= t."""
    reached, _ = robot.success(traj[:, :t + 1], problem["target_rot"][:, None],
                               problem["target_trans"][:, None])
    return reached.any(1)


def rollout_numbers(cfg, weights, sample, rollouts):
    """Every number of a rollout cell. ``sample``: the drawn rollout's
    {"traj", "problem", "caps": [(t, cap), ...]} (t = 0 first);
    ``rollouts``: [(traj, success, num_steps, problem)] of every rollout the
    window finished. -> (numbers, problems set aside as too near a threshold,
    the reference's outputs by captured step)."""
    nums = {"fps_mismatch": 0, "select_mismatch": 0, "f0_err": 0.0, "f1_err": 0.0,
            "dq_err": 0.0, "step_err": 0.0, "surface_gap": 0.0, "cloud_mismatch": 0,
            "status_mismatch": 0}
    refs = {}
    first_cloud = None
    traj, problem = sample["traj"], sample["problem"]
    for t, cap in sample["caps"]:
        got, refs[t] = policy_numbers(cfg, weights, cap)
        for k, v in got.items():
            nums[k] = max(nums[k], v) if isinstance(v, float) else nums[k] + v
        done = done_before(traj, problem, t)
        nums["step_err"] = max(nums["step_err"], transition_err(cap, traj, t, done))
        gap, mism = cloud_numbers(cfg, cap["cloud"], traj[:, t], problem, first_cloud)
        nums["surface_gap"] = max(nums["surface_gap"], gap)
        nums["cloud_mismatch"] += mism
        if first_cloud is None:
            first_cloud = cap["cloud"]
    aside = 0
    for traj_i, success, num_steps, problem_i in rollouts:
        bad, amb = status_numbers(traj_i, success, num_steps, problem_i)
        nums["status_mismatch"] += bad
        aside += amb
    return nums, aside, refs
