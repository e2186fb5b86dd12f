"""The plain reference of the behaviour-cloning train step, and the
comparison that decides a train cell's ``correct``.

From the draws the benchmark made (:func:`benchmark.generate.training_draws`)
and the weights it made, the reference builds each batch itself -- points
along a minimum-jerk trajectory (Fishman et al., ``data_loader.py:141-280``),
joint noise clamped to the limits, the cloud of the robot at the noisy
configuration (its surface bank gathered by the drawn indices), the scene's
surface points and the gripper at the goal -- runs the policy
(:mod:`benchmark.reference.policy`, float32 with TF32 off), the losses
(point match: MSE + L1 between the robot's fixed loss points at the
prediction and at the supervision; collision: the mean hinge of 3 cm on
the scene's SDF of the predicted points; ``loss.py:31-166``), autograd, and
Adam after a global-norm clip (``run_training.py:71-115``), for the first
steps of the run. It compares the first gradient as the optimizer got it
(the program's, read back from Adam's first moment after one step), the
parameters' change over the steps, each batch the program built, and each
step's loss against the reference's loss of the program's own Delta-q on
that batch; it reports each step's loss gap against its own forward.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import policy, robot

BANKS = {}


def banks(cfg):
    """The robot's surface bank (8192 points, seed 0, every sphere), the
    fixed loss points (1024, seed 1, no base link) and the gripper's (the
    target's points, seed 2): worked out here from the sphere model."""
    key = (cfg["points"]["target"],)
    if key not in BANKS:
        BANKS[key] = {
            "full": robot.sphere_union_bank(8192, 0),
            "loss": robot.sphere_union_bank(1024, 1, tuple(range(1, robot.NUM_FRAMES))),
            "gripper": robot.sphere_union_bank(cfg["points"]["target"], 2,
                                               robot.GRIPPER_FRAMES, by_frame=False),
        }
    return BANKS[key]


def min_jerk(q0, q_goal, length):
    step = 1.0 / max(length - 1, 1)
    s = torch.arange(length, dtype=q0.dtype, device=q0.device) * step
    s2 = s * s
    s4 = s2 * s2
    s = 10 * (s2 * s) - 15 * s4 + 6 * (s4 * s)
    return q0[..., None, :] + s[:, None] * (q_goal - q0)[..., None, :]


def obstacle_points(scene, d):
    """Points on the scene's primitive surfaces from the draws."""
    m1 = scene["cuboid_dims"].shape[1]
    which = d["which"]
    pick = lambda t, i: torch.take_along_dim(t, i[..., None], dim=-2)
    cub = torch.clamp(which, 0, m1 - 1)
    cyl = torch.clamp(which - m1, 0, scene["cylinder_radii"].shape[1] - 1)
    half = pick(scene["cuboid_dims"], cub) / 2.0
    onehot = torch.nn.functional.one_hot(d["cuboid_face"], 3).to(half.dtype)
    sign = torch.where(d["cuboid_positive"], 1.0, -1.0)[..., None]
    local = d["cuboid_uv"] * half * (1.0 - onehot) + (sign * half) * onehot
    rot = robot._quat_matrix(pick(scene["cuboid_quats"], cub))
    cub_w = (rot @ local[..., None])[..., 0] + pick(scene["cuboid_centers"], cub)
    r = pick(scene["cylinder_radii"], cyl)[..., 0]
    h = pick(scene["cylinder_heights"], cyl)[..., 0]
    th = d["cylinder_theta"]
    side = torch.stack([r * torch.cos(th), r * torch.sin(th), d["cylinder_z"] * h], -1)
    rc = r * torch.sqrt(d["cylinder_r"])
    cap = torch.stack([rc * torch.cos(th), rc * torch.sin(th),
                       torch.where(d["cylinder_top"], 0.5, -0.5) * h], -1)
    local = torch.where(d["cylinder_on_cap"][..., None], cap, side)
    rot = robot._quat_matrix(pick(scene["cylinder_quats"], cyl))
    cyl_w = (rot @ local[..., None])[..., 0] + pick(scene["cylinder_centers"], cyl)
    return torch.where((which < m1)[..., None], cub_w, cyl_w)


def batch(draws, cfg, traffic):
    """The training batch of one set of draws."""
    bk = banks(cfg)
    traj = min_jerk(draws["q0"], draws["q_goal"], traffic["sequence_length"])
    rows = torch.arange(traj.shape[0], device=traj.device)
    t = draws["t"].long()
    q_t = traj[rows, t]
    q_next = traj[rows, torch.clamp(t + 1, 0, traffic["sequence_length"] - 1)]
    rot_goal, trans_goal = robot.eff_pose(draws["q_goal"])
    lo, hi = robot.limits(q_t.device)
    q_noisy = torch.minimum(torch.maximum(q_t + traffic["random_scale"] * draws["noise"], lo), hi)
    world = robot.bank_world(q_noisy, bk["full"])
    robot_pts = torch.take_along_dim(world, draws["robot_indices"][..., None].long(), dim=-2)
    obstacles = obstacle_points(draws["scene"], draws["obstacle"])
    target = robot.gripper_bank_world(rot_goal, trans_goal, bk["gripper"])
    xyz = torch.cat([robot_pts, obstacles, target], -2)
    p = cfg["points"]
    labels = torch.cat([torch.zeros(p["robot"]), torch.ones(p["obstacle"]),
                        torch.full((p["target"],), 2.0)]).to(xyz.device)
    out = {"xyz": torch.cat([xyz, labels.expand(xyz.shape[:-1])[..., None]], -1),
           "configuration": robot.normalize(q_noisy), "supervision": robot.normalize(q_next),
           "target_position": trans_goal}
    out.update(draws["scene"])
    return out


def losses(weights, cfg, train, b, precision="f32"):
    """(total, point match, collision) of the policy with ``weights`` on batch ``b``."""
    dq = policy.forward(weights, cfg, b["xyz"], b["configuration"], precision)["dq"]
    return loss_terms(cfg, train, b, dq)


def loss_terms(cfg, train, b, dq):
    """(total, point match, collision) of the prediction ``dq`` on batch ``b``."""
    q = b["configuration"]
    y_hat = torch.clamp(q + dq.float(), -1.0, 1.0)
    loss_bank = banks(cfg)["loss"]
    pred = robot.bank_world(robot.unnormalize(y_hat), loss_bank)
    want = robot.bank_world(robot.unnormalize(b["supervision"]), loss_bank)
    diff = pred - want
    point_match = (diff ** 2).mean() + diff.abs().mean()
    scene = {k: v for k, v in b.items() if k.startswith(("cuboid", "cylinder"))}
    collision = torch.relu(train["collision_margin"] - robot.scene_sdf(pred, scene)).mean()
    total = train["point_match_weight"] * point_match + train["collision_weight"] * collision
    return total, point_match, collision


def follow(weights, cfg, train, batches, precision="f32"):
    """The first ``len(batches)`` steps from ``weights``: each step's losses,
    the first step's clipped gradient by leaf, and the parameters after the
    last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"point_match": [], "collision": [], "grad": None}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for count, b in enumerate(batches, start=1):
            total, pm, coll = losses(params, cfg, train, b, precision)
            grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), grads)}
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
            scale = 1.0 if float(norm) < train["grad_clip"] else train["grad_clip"] / norm
            grads = {k: g * scale for k, g in grads.items()}
            out["point_match"].append(float(pm.detach()))
            out["collision"].append(float(coll.detach()))
            if out["grad"] is None:
                out["grad"] = {k: g.detach().clone() for k, g in grads.items()}
            c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
            c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
            with torch.no_grad():
                for k, p in params.items():
                    mu[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                    nu[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                    p -= train["learning_rate"] * (mu[k] / c1.item()) / (
                        torch.sqrt(nu[k] / c2.item()) + eps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out


def leaf_gaps(prog, ref, leaves):
    """| |prog| - |ref| | / max(|ref|, the median leaf's |ref|) of each leaf
    (2-norms), sorted."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    norms = {k: norm(ref[k]) for k in leaves}
    median = sorted(norms.values())[len(norms) // 2]
    return sorted(abs(norm(prog[k]) - norms[k]) / max(norms[k], median) for k in leaves)


def loss_gap(w, pp, pr, cp, cr):
    """The larger of the point-match and weighted collision terms' gaps,
    against the reference's weighted loss."""
    return max(abs(pp - pr), w * abs(cp - cr)) / (pr + w * cr)


def direction_gaps(prog, ref, leaves):
    """|prog - ref| / max(|ref|, the median leaf's |ref|) of each leaf
    (2-norms), sorted, and the same over all leaves as one vector."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    norms = {k: norm(ref[k]) for k in leaves}
    median = sorted(norms.values())[len(norms) // 2]
    per_leaf = sorted(norm(prog[k].double() - ref[k].double()) / max(norms[k], median)
                      for k in leaves)
    whole = math.sqrt(sum(norm(prog[k].double() - ref[k].double()) ** 2 for k in leaves))
    return per_leaf, whole / math.sqrt(sum(v * v for v in norms.values()))


def train_numbers(cfg, train, weights, ref, prog):
    """The numbers of a train cell: ``grad_err``, the worst leaf's gap
    (:func:`leaf_gaps`) of the first clipped gradient; ``change_err``, the
    worst leaf's gap of the change over the steps, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's; and,
    where ``prog`` holds the program's Delta-q of each first step
    (``dq``), ``loss_err``: the worst step's gap (:func:`loss_gap`) between
    the program's loss terms and the reference's on the same Delta-q and
    batch, which holds the loss's reduction over every row by itself (the
    forward's outputs are compared by :func:`benchmark.reference.check.
    policy_numbers`). Beside them, not compared: each step's loss gap
    against the reference's own forward (no control or fault reading stood
    at three or ten times the sound runs': the bf16 forward's rounding
    sets it, and the later steps' carry Adam's sign noise, as Adam moves
    every weight by about the learning rate whatever its gradient's size),
    and the first gradient's direction gaps (:func:`direction_gaps`).
    ``prog`` holds the program's first steps (``point_match``,
    ``collision``: per step; ``grad``: the first clipped gradient by leaf;
    ``params``: after the steps; ``dq`` and ``batches``), ``ref`` the
    reference's (:func:`follow`)."""
    w = train["collision_weight"]
    gaps = [loss_gap(w, pp, pr, cp, cr)
            for pp, pr, cp, cr in zip(prog["point_match"], ref["point_match"],
                                      prog["collision"], ref["collision"])]
    gnorm = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref["grad"].items()}
    median = sorted(gnorm.values())[len(gnorm) // 2]
    moving = [k for k, v in gnorm.items() if v >= 1e-3 * median]
    change_p = {k: prog["params"][k].double() - weights[k].double() for k in moving}
    change_r = {k: ref["params"][k].double() - weights[k].double() for k in moving}
    nums = {
        "grad_err": leaf_gaps(prog["grad"], ref["grad"], list(gnorm))[-1],
        "change_err": leaf_gaps(change_p, change_r, moving)[-1],
    }
    if "dq" in prog:
        with torch.no_grad():
            at = [loss_terms(cfg, train, b, dq)[1:] if dq.shape == b["configuration"].shape
                  else None for b, dq in zip(prog["batches"], prog["dq"])]
        nums["loss_err"] = max(math.inf if r is None else loss_gap(w, pp, float(r[0]), cp,
                                                                   float(r[1]))
                               for pp, cp, r in zip(prog["point_match"], prog["collision"], at))
    per_leaf, whole = direction_gaps(prog["grad"], ref["grad"], list(gnorm))
    return nums, {"leaves_left_out": len(gnorm) - len(moving), "loss_gaps": gaps,
                  "grad_dir_worst_leaf": per_leaf[-1], "grad_dir_median_leaf":
                  per_leaf[len(per_leaf) // 2], "grad_dir_whole": whole}


def batch_err(prog_batches, ref_batches):
    """Largest difference between a batch the program built and the
    reference's, over the fields the step reads."""
    worst = 0.0
    for p, r in zip(prog_batches, ref_batches):
        for k in ("xyz", "configuration", "supervision", "target_position"):
            if p[k].shape != r[k].shape:
                return math.inf
            worst = max(worst, float((p[k].double() - r[k].double()).abs().max()))
    return worst
