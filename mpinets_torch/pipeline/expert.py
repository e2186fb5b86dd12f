"""Expert-trajectory synthesis, optimization and verification, batched in
PyTorch.

Port of ``mpinets_tpu/pipeline/expert.py``, the stand-in for the
reference's OMPL AIT* + Lula expert (``gen_data.py:106-430``):

* **verification** (``gen_data.py:327-430``): target miss > 5 cm, jerk >
  0.15, self-collision, environment collision and the real joint limits,
  over whole batches of trajectories;
* **the smooth family**: direct and via-point minimum-jerk paths;
* **the SDF trajectory optimizer**: heavy-ball descent on a smoothness +
  sphere-clearance + joint-limit cost, differentiated through the FK and
  the scene SDF by ``torch.autograd.grad``;
* **the global stages** seeding it: sampled via configurations and a
  fixed-shape lazy PRM (dense min-plus relaxation, argmin backtrack);
* **constant-velocity retiming to 50 steps** (``gen_data.py:310-324``).

The JAX package plans one pair and vmaps it; here every function takes a
leading batch. A scene is either one unbatched
:class:`~mpinets_torch.geom.scene.SceneSet` shared by every row, or one
scene per row (batched to the first axis). The spheres' SDF against the
scene is computed in chunks of rows, so that its
[configurations, 56 spheres, primitives, 3] intermediate stays under
``SDF_CHUNK_BYTES``.

Random draws are split from the construction. :func:`draw_plan` makes a
:class:`PlanDraws` per pair from CPU ``torch.Generator`` s seeded with the
integer the JAX package folds into ``PRNGKey(0x5EED)`` (and a mix of it
with ``1000 + i`` for PRM seed i), then moves them to the device, so the
card and the CPU plan alike. They follow the JAX package's distributions,
not its bits; a test hands the construction JAX's own draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpinets_torch.geom.scene import SceneSet
from mpinets_torch.kernels import ik, kinematics, sdf
from mpinets_torch.robot import franka

SEQUENCE_LENGTH = 50      # gen_data.py:77
MAX_JERK = 0.15           # gen_data.py:80
MISS_TOLERANCE = 0.05     # 5 cm, gen_data.py verification
#: Dense sample count used for collision checking before retiming.
DENSE_STEPS = 150
#: the largest [configurations, 56, primitives, 3] SDF intermediate one
#: chunk of rows may make
SDF_CHUNK_BYTES = 2 << 30


class VerifyResult(NamedTuple):
    """Per-trajectory failure predicates (gen_data.py:91-103 error codes)."""

    valid: torch.Tensor               # [...]
    miss: torch.Tensor                # [...] final EE position error (m)
    max_jerk: torch.Tensor            # [...] max |third difference|
    has_self_collision: torch.Tensor  # [...]
    has_env_collision: torch.Tensor   # [...]
    within_limits: torch.Tensor       # [...]


class PlanResult(NamedTuple):
    trajectory: torch.Tensor  # [..., SEQUENCE_LENGTH, 7]
    valid: torch.Tensor       # [...] bool
    which: torch.Tensor       # [...] int32: index of the accepted candidate path
    score: torch.Tensor       # [...] severity of the returned trajectory


# ---------------------------------------------------------------------------
# Scenes and the sphere model, by chunks of rows
# ---------------------------------------------------------------------------

def _table(name: str, like: torch.Tensor) -> torch.Tensor:
    return kinematics.franka_table(name, like.dtype, like.device)


def _per_row(scene: SceneSet) -> bool:
    return scene.cuboid_centers.dim() > 2


def _lift(scene: SceneSet, ndim: int) -> SceneSet:
    """A scene batched per row, [R, M, c] -> [R, 1, ..., M, c], to broadcast
    over ``ndim`` batch dims; an unbatched scene broadcasts as it is."""
    if not _per_row(scene) or ndim <= 1:
        return scene
    return SceneSet(*(t.reshape(t.shape[:1] + (1,) * (ndim - 1) + t.shape[1:]) for t in scene))


def _over_rows(fn: Callable, q: torch.Tensor, scene: SceneSet) -> torch.Tensor:
    """``fn(q_chunk, scene_chunk)`` over chunks of the rows (first axis) of
    configurations q [R, ..., 7], concatenated. A chunk's sphere-to-primitive
    intermediate stays under ``SDF_CHUNK_BYTES``; a per-row scene is sliced
    with its rows and lifted to q's batch dims."""
    rows = q.shape[0]
    prims = scene.num_cuboids + scene.num_cylinders
    per_row = (q[:1].numel() // franka.DOF) * len(franka.SCENE_SPHERE_RADII) * prims * 3
    step = max(1, SDF_CHUNK_BYTES // max(per_row * q.element_size(), 1))

    def part(lo, hi):
        sc = SceneSet(*(t[lo:hi] for t in scene)) if _per_row(scene) else scene
        return fn(q[lo:hi], _lift(sc, q.dim() - 1))

    if rows <= step:
        return part(0, rows)
    return torch.cat([part(lo, min(lo + step, rows)) for lo in range(0, rows, step)])


def sphere_sdf(q: torch.Tensor, scene: SceneSet) -> torch.Tensor:
    """Scene SDF at the 56 scene-sphere centres of configurations
    q [R, ..., 7] -> [R, ..., 56]."""
    return _over_rows(
        lambda q_, sc: sdf.scene_sdf(kinematics.scene_collision_spheres(q_), sc), q, scene)


def free_space(q: torch.Tensor, scene: SceneSet, margin: float = 0.0) -> torch.Tensor:
    """:func:`mpinets_torch.kernels.ik.franka_free_space` over configurations
    q [R, ..., 7], by chunks of rows -> bool [R, ...]."""
    return _over_rows(lambda q_, sc: ik.franka_free_space(q_, sc, margin), q, scene)


# ---------------------------------------------------------------------------
# Paths, retiming, verification
# ---------------------------------------------------------------------------

def linspace(stop: float, num: int, like: torch.Tensor) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` as XLA computes it, in ``like``'s dtype
    and device: i * k with k = (1 / (num - 1)) * stop, each constant rounded
    to the dtype (XLA turns the division by a constant into a product and
    folds the constants), the last exactly ``stop``."""
    div = num - 1
    k = torch.tensor(1.0 / div, dtype=like.dtype) * stop
    step = torch.arange(div, dtype=like.dtype, device=like.device) * k.item()
    return torch.cat([step, torch.full((1,), stop, dtype=like.dtype, device=like.device)])


def min_jerk_interp(q_a: torch.Tensor, q_b: torch.Tensor, length: int) -> torch.Tensor:
    """Minimum-jerk time scaling of the straight segment a->b: [..., length, 7]."""
    s = linspace(1.0, length, q_a)
    s2 = s * s
    s4 = s2 * s2
    s = 10 * (s * s2) - 15 * s4 + 6 * (s * s4)   # XLA's integer powers
    return q_a[..., None, :] + s[:, None] * (q_b - q_a)[..., None, :]


def via_point_path(q_a: torch.Tensor, q_via: torch.Tensor, q_b: torch.Tensor,
                   length: int) -> torch.Tensor:
    """Two blended minimum-jerk segments a->via->b with continuous velocity
    (the second half starts where the first ends), [..., length, 7]."""
    h = length // 2
    first = min_jerk_interp(q_a, q_via, h + 1)
    second = min_jerk_interp(q_via, q_b, length - h)
    return torch.cat([first[..., :-1, :], second], dim=-2)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def constant_velocity_retime(traj: torch.Tensor, length: int = SEQUENCE_LENGTH) -> torch.Tensor:
    """Resample paths [..., T, 7] to ``length`` steps at constant
    configuration-space speed (``gen_data.py:310-324``): uniform positions
    along cumulative arc length, linear interpolation between supports."""
    seg = _norm(torch.diff(traj, dim=-2))                               # [..., T-1]
    cum = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, dim=-1)], dim=-1)
    total = torch.clamp(cum[..., -1:], min=1e-9)
    s_new = linspace(1.0, length, traj) * total                    # [..., length]
    idx = torch.searchsorted(cum.contiguous(), s_new.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, traj.shape[-2] - 2)
    s0 = torch.gather(cum, -1, idx)
    s1 = torch.gather(cum, -1, idx + 1)
    w = torch.where(s1 > s0, (s_new - s0) / torch.clamp(s1 - s0, min=1e-12),
                    torch.zeros_like(s_new))
    t0 = torch.take_along_dim(traj, idx[..., None], dim=-2)
    t1 = torch.take_along_dim(traj, idx[..., None] + 1, dim=-2)
    return t0 + w[..., None] * (t1 - t0)


def trajectory_max_jerk(traj: torch.Tensor) -> torch.Tensor:
    """Max |third finite difference| over steps and joints (the reference's
    jerk cutoff operates on the retimed 50-step trajectory,
    ``gen_data.py:80,396-430``). traj: [..., T, 7] -> [...]."""
    return torch.diff(traj, n=3, dim=-2).abs().amax(dim=(-2, -1))


def env_collision_any(traj: torch.Tensor, scene: SceneSet) -> torch.Tensor:
    """True when any scene sphere penetrates the scene at any step.
    traj [R, ..., T, 7] -> bool [R, ...]."""
    d = sphere_sdf(traj, scene)                                         # [..., T, 56]
    return torch.any((d < _table("SCENE_SPHERE_RADII", traj)).flatten(-2), dim=-1)


def verify_trajectory(traj: torch.Tensor, target_rot: torch.Tensor, target_trans: torch.Tensor,
                      scene: SceneSet) -> VerifyResult:
    """All five reference failure predicates (``gen_data.py:396-430``) on
    trajectories [..., T, 7] with targets [..., 3, 3], [..., 3]."""
    _, trans = kinematics.eff_pose(traj[..., -1, :])
    miss = _norm(trans - target_trans)
    jerk = trajectory_max_jerk(traj)
    self_c = kinematics.self_collision(traj).any(-1)
    env_c = env_collision_any(traj, scene)
    # the tighter empirical FrankaRealRobot limits (gen_data.py:391)
    limits = kinematics.within_limits(traj, use_real_constraints=True).all(-1)
    valid = (miss <= MISS_TOLERANCE) & (jerk <= MAX_JERK) & ~self_c & ~env_c & limits
    return VerifyResult(valid, miss, jerk, self_c, env_c, limits)


def _severity(res: VerifyResult) -> torch.Tensor:
    """Badness of a verified trajectory (lower is better): the number of
    failed predicates dominates, miss and jerk break ties. The best
    *attempted* trajectory is kept when no restart is valid, so that the
    failure tallies diagnose a real trajectory (``gen_data.py:419-430``)."""
    fails = (
        (res.miss > MISS_TOLERANCE).to(res.miss.dtype)
        + (res.max_jerk > MAX_JERK)
        + res.has_self_collision
        + res.has_env_collision
        + ~res.within_limits
    )
    return 100.0 * fails + res.miss + res.max_jerk


def _dense_ok(res: VerifyResult) -> torch.Tensor:
    """The collision, limit and miss predicates (jerk is checked on the
    retimed trajectory)."""
    return ((res.miss <= MISS_TOLERANCE) & ~res.has_self_collision & ~res.has_env_collision
            & res.within_limits)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P, K, ...] at index idx [P] of each row -> [P, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def plan_pair(q_start: torch.Tensor, q_goal: torch.Tensor, target_rot: torch.Tensor,
              target_trans: torch.Tensor, scene: SceneSet) -> PlanResult:
    """Plan pairs q [P, 7] with the smooth family: direct minimum-jerk, via
    the neutral posture, and via two blends of the start/goal midpoint with
    it; verify each on the dense sampling and keep the first clean one,
    retimed to 50 steps (the JAX package's vmapped ``plan_pair``)."""
    neutral = _table("NEUTRAL_Q", q_start)
    mid = (q_start + q_goal) / 2
    candidates = torch.stack([
        min_jerk_interp(q_start, q_goal, DENSE_STEPS),
        via_point_path(q_start, neutral.expand_as(q_start), q_goal, DENSE_STEPS),
        via_point_path(q_start, 0.5 * mid + 0.5 * neutral, q_goal, DENSE_STEPS),
        via_point_path(q_start, 0.75 * mid + 0.25 * neutral, q_goal, DENSE_STEPS),
    ], dim=1)                                                           # [P, 4, T, 7]
    ok_dense = _dense_ok(verify_trajectory(candidates, target_rot[:, None], target_trans[:, None],
                                           scene))                      # [P, 4]
    which = torch.argmax(ok_dense.to(torch.int32), dim=-1)              # first True
    traj = constant_velocity_retime(_rows(candidates, which))
    final = verify_trajectory(traj, target_rot, target_trans, scene)
    return PlanResult(traj, ok_dense.any(-1) & final.valid, which.to(torch.int32),
                      _severity(final))


def plan_pairs_batch(q_starts, q_goals, target_rots, target_transs, scene) -> PlanResult:
    """:func:`plan_pair` over a batch sharing one scene (the port's
    ``plan_pair`` takes the batch itself)."""
    return plan_pair(q_starts, q_goals, target_rots, target_transs, scene)


# ---------------------------------------------------------------------------
# Scene-aware trajectory optimization (the batched planner)
# ---------------------------------------------------------------------------
# A CHOMP-style optimizer in the role of the reference's AIT* + fabric
# pipeline (gen_data.py:106-307): the whole path is the decision variable,
# the collision cost is the sphere model against the scene SDF, and autograd
# differentiates through the batched FK, so every (pair, restart) row
# optimizes in lockstep.

#: collision clearance margin for the optimizer's hinge cost (m)
OPT_MARGIN = 0.02
OPT_STEPS = 120
OPT_PATH_LEN = 50


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``, whose gradient is a half at 0."""
    return torch.maximum(x, torch.zeros_like(x))


def _path_cost(interior: torch.Tensor, q_start: torch.Tensor, q_goal: torch.Tensor,
               scene: SceneSet, collision_weight: float = 40.0,
               smooth_weight: float = 4.0) -> torch.Tensor:
    """Cost of each path, interior waypoints [R, T-2, 7] between q_start and
    q_goal [R, 7] -> [R]: squared second differences (CHOMP's prior), the
    squared hinge on sphere clearance (``OPT_MARGIN``) and a joint-limit
    barrier."""
    traj = torch.cat([q_start[..., None, :], interior, q_goal[..., None, :]], dim=-2)
    acc = traj[..., 2:, :] - 2.0 * traj[..., 1:-1, :] + traj[..., :-2, :]
    smooth = (acc * acc).sum((-2, -1))
    d = sphere_sdf(traj, scene)                                         # [R, T, 56]
    pen = _relu(_table("SCENE_SPHERE_RADII", traj) + OPT_MARGIN - d)
    collision = (pen * pen).sum((-2, -1))
    lim = _table("REAL_JOINT_LIMITS", traj)
    over = _relu(traj - lim[:, 1]) + _relu(lim[:, 0] - traj)
    limits = (over * over).sum((-2, -1))
    return smooth_weight * smooth + collision_weight * collision + 100.0 * limits


def optimize_trajectory(q_start: torch.Tensor, q_goal: torch.Tensor, scene: SceneSet,
                        init: Optional[torch.Tensor] = None, steps: int = OPT_STEPS,
                        lr: float = 0.02) -> torch.Tensor:
    """Gradient trajectory optimization from q_start to q_goal [R, 7]:
    ``steps`` heavy-ball steps (m = 0.9 m + g; x -= lr m) on
    :func:`_path_cost`, each followed by a clamp, not differentiated, to the
    real limits shrunk by 1e-4. Rows are independent, so the gradient of the
    summed cost is each row's own. Runs under ``torch.enable_grad()`` (the
    rollout's caller may be in ``no_grad``); no step syncs with the host.
    -> [R, OPT_PATH_LEN, 7]."""
    if init is None:
        init = min_jerk_interp(q_start, q_goal, OPT_PATH_LEN)
    lim = _table("REAL_JOINT_LIMITS", q_start)
    # waypoints clamped exactly to a limit would fail the strict check
    lo, hi = lim[:, 0] + 1e-4, lim[:, 1] - 1e-4
    interior = init[..., 1:-1, :].detach()
    m = torch.zeros_like(interior)
    with torch.enable_grad():
        for _ in range(steps):
            x = interior.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(_path_cost(x, q_start, q_goal, scene).sum(), x)
            m = 0.9 * m + g
            interior = torch.clamp(interior - lr * m, lo, hi)
    return torch.cat([q_start[..., None, :], interior, q_goal[..., None, :]], dim=-2)


def _via_init(q_start: torch.Tensor, via: torch.Tensor, q_goal: torch.Tensor) -> torch.Tensor:
    """Two-segment min-jerk seed through a via configuration, [..., 50, 7]."""
    half = OPT_PATH_LEN // 2 + 1
    a = min_jerk_interp(q_start, via, half)
    b = min_jerk_interp(via, q_goal, OPT_PATH_LEN - half + 1)
    return torch.cat([a, b[..., 1:, :]], dim=-2)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

#: sampled-via global stage: candidate count and survivors
VIA_SAMPLES = 48
VIA_KEEP = 2

#: PRM node count (excluding start/goal), edge fan-out, interior edge
#: samples, max path hops, edge length cap (rad, 7-D L2), node margin.
PRM_NODES = 126
PRM_KNN = 14
PRM_EDGE_SAMPLES = 6
PRM_MAX_HOPS = 12
PRM_EDGE_CAP = 2.8
PRM_MARGIN = 0.01


class PrmDraws(NamedTuple):
    """The random numbers behind one roadmap per pair."""

    uniform: torch.Tensor  # [P, n_nodes // 2, 7] in [0, 1): uniform nodes
    anchor: torch.Tensor   # [P, n_nodes - n_nodes // 2] in {0, 1, 2}: start, goal, midpoint
    normal: torch.Tensor   # [P, n_nodes - n_nodes // 2, 7] standard normal around the anchor


class PlanDraws(NamedTuple):
    """The random numbers behind :func:`plan_pair_optimized`, per pair."""

    via_uniform: torch.Tensor  # [P, n_samples // 2, 7] in [0, 1)
    via_normal: torch.Tensor   # [P, n_samples - n_samples // 2, 7] standard normal
    prm: Tuple[PrmDraws, ...] = ()   # one per PRM seed


def pair_seeds(q_start: torch.Tensor, q_goal: torch.Tensor) -> np.ndarray:
    """The integer the JAX package folds into ``PRNGKey(0x5EED)`` for each
    pair q [P, 7]: int32(sum(q_start 1e4 + q_goal 1e3)) in f32."""
    qs = q_start.detach().to("cpu", torch.float32)
    qg = q_goal.detach().to("cpu", torch.float32)
    return (qs * 1e4 + qg * 1e3).sum(-1).to(torch.int32).numpy()


def _mix(*parts: int) -> int:
    return int(np.random.SeedSequence([p & 0xFFFFFFFF for p in parts])
               .generate_state(1, np.uint64)[0] >> 1)


def draw_plan(q_start: torch.Tensor, q_goal: torch.Tensor, n_prm: int = 0,
              n_samples: int = VIA_SAMPLES, n_nodes: int = PRM_NODES,
              device=None) -> PlanDraws:
    """Draws for the pairs q [P, 7], made on the CPU from one generator a
    pair seeded with :func:`pair_seeds` (PRM seed i: that integer mixed
    with 1000 + i), then moved to ``device`` (default q_start's). The same
    pairs get the same draws on any device; they are not JAX's bits."""
    device = q_start.device if device is None else device
    n_u, n_v = n_samples // 2, n_nodes // 2
    vias_u, vias_n, prm = [], [], [[] for _ in range(n_prm)]
    for seed in pair_seeds(q_start, q_goal).tolist():
        g = torch.Generator().manual_seed(seed)
        vias_u.append(torch.rand((n_u, franka.DOF), generator=g))
        vias_n.append(torch.randn((n_samples - n_u, franka.DOF), generator=g))
        for i in range(n_prm):
            g = torch.Generator().manual_seed(_mix(seed, 1000 + i))
            prm[i].append((torch.rand((n_v, franka.DOF), generator=g),
                           torch.randint(0, 3, (n_nodes - n_v,), generator=g),
                           torch.randn((n_nodes - n_v, franka.DOF), generator=g)))
    stack = lambda xs: torch.stack(xs).to(device)  # noqa: E731
    return PlanDraws(stack(vias_u), stack(vias_n),
                     tuple(PrmDraws(*(stack(list(x)) for x in zip(*p))) for p in prm))


# ---------------------------------------------------------------------------
# Global stages: sampled vias and the lazy PRM
# ---------------------------------------------------------------------------

def sample_via_configs(q_start: torch.Tensor, q_goal: torch.Tensor, scene: SceneSet,
                       uniform: torch.Tensor, normal: torch.Tensor,
                       n_keep: int = VIA_KEEP) -> torch.Tensor:
    """Coarse global stage feeding the optimizer: via configurations, half
    uniform in the joint limits (``uniform`` [P, K1, 7]) and half Gaussian
    around the start/goal midpoint (``normal`` [P, K2, 7], sigma a quarter of
    the span), ranked by the collision + length cost of the two-segment path
    through each (1e6 more where the via is not free by 1 cm); the best
    ``n_keep`` of each pair, lowest index first on ties -> [P, n_keep, 7]."""
    lim = _table("REAL_JOINT_LIMITS", q_start)
    span = lim[:, 1] - lim[:, 0]
    vias_u = lim[:, 0] + uniform.to(q_start.dtype) * span
    mid = 0.5 * (q_start + q_goal)
    vias_m = mid[:, None] + normal.to(q_start.dtype) * (0.25 * span)
    vias = torch.clamp(torch.cat([vias_u, vias_m], dim=1), lim[:, 0], lim[:, 1])  # [P, K, 7]
    free = free_space(vias, scene, margin=0.01)

    paths = via_point_path(q_start[:, None], vias, q_goal[:, None], 24)          # [P, K, 24, 7]
    pen = _relu(_table("SCENE_SPHERE_RADII", paths) + OPT_MARGIN - sphere_sdf(paths, scene))
    pen_per_path = (pen * pen).sum((-2, -1))
    length = _norm(torch.diff(paths, dim=-2)).sum(-1)
    score = 100.0 * pen_per_path + length + torch.where(free, 0.0, 1e6)
    top = torch.sort(score, dim=-1, stable=True).indices[:, :n_keep]
    return torch.take_along_dim(vias, top[..., None], dim=1)


class Roadmap(NamedTuple):
    """One lazy PRM per pair and its shortest path."""

    nodes: torch.Tensor      # [P, V, 7]: start, goal, then the sampled nodes
    node_free: torch.Tensor  # [P, V] bool (start and goal set free)
    dist: torch.Tensor       # [P, V, V] 7-D L2 distances
    nbr: torch.Tensor        # [P, V, knn] nearest neighbours, nearest first
    edge_ok: torch.Tensor    # [P, V, knn] bool
    cost_to: torch.Tensor    # [P, V] shortest distance from the start within max_hops
    path_idx: torch.Tensor   # [P, max_hops + 2] node indices, start-padded
    found: torch.Tensor      # [P] bool
    waypoints: torch.Tensor  # [P, max_hops + 2, 7]


def prm_roadmap(q_start: torch.Tensor, q_goal: torch.Tensor, scene: SceneSet,
                draws: PrmDraws, knn: int = PRM_KNN, n_edge_samples: int = PRM_EDGE_SAMPLES,
                max_hops: int = PRM_MAX_HOPS) -> Roadmap:
    """The reference's sampling-based global planner (AIT*,
    ``gen_data.py:106-153``) as fixed-shape batched algebra: sample nodes,
    check nodes and k-NN edges with the sphere model, run ``max_hops``
    min-plus relaxations over the dense [V, V] cost matrix and backtrack by
    argmin (first index on ties). The edge checks run one k-NN column at a
    time, as the JAX package's ``lax.map``: a column of P pairs holds
    P x V x n_edge_samples configurations. Where no path exists, ``found``
    is False and the waypoints are the straight a->b chain."""
    dt = q_start.dtype
    lim = _table("REAL_JOINT_LIMITS", q_start)
    span = lim[:, 1] - lim[:, 0]
    p = q_start.shape[0]
    nodes_u = lim[:, 0] + draws.uniform.to(dt) * span
    anchors = torch.stack([q_start, q_goal, 0.5 * (q_start + q_goal)], dim=1)     # [P, 3, 7]
    nodes_n = (torch.take_along_dim(anchors, draws.anchor.long()[..., None], dim=1)
               + draws.normal.to(dt) * (0.22 * span))
    nodes = torch.cat([q_start[:, None], q_goal[:, None],
                       torch.clamp(torch.cat([nodes_u, nodes_n], dim=1), lim[:, 0], lim[:, 1])],
                      dim=1)                                                       # [P, V, 7]
    v = nodes.shape[1]

    node_free = free_space(nodes, scene, margin=PRM_MARGIN)
    # start and goal passed candidate IK: keep them even at a borderline contact
    node_free[:, :2] = True

    dist = _norm(nodes[:, :, None] - nodes[:, None])                              # [P, V, V]
    eye = torch.eye(v, dtype=torch.bool, device=nodes.device)
    dist_ = dist + torch.where(eye, torch.inf, 0.0).to(dt)
    nbr = torch.sort(dist_, dim=-1, stable=True).indices[..., :knn]               # [P, V, knn]

    t = linspace(1.0, n_edge_samples + 2, nodes)[1:-1]                       # [S]
    a = nodes[:, :, None, :]                                                       # [P, V, 1, 7]
    free = torch.stack([
        free_space(a + t[:, None] * (_rows_at(nodes, nbr[..., j])[:, :, None] - a), scene,
                   margin=PRM_MARGIN)
        for j in range(knn)
    ], dim=2)                                                                      # [P, V, knn, S]
    edge_len = torch.take_along_dim(dist_, nbr, dim=-1)
    nbr_free = torch.gather(node_free, 1, nbr.reshape(p, -1)).reshape(nbr.shape)
    edge_ok = free.all(-1) & node_free[..., None] & nbr_free & (edge_len <= PRM_EDGE_CAP)

    inf = torch.full((), torch.inf, dtype=dt, device=nodes.device)
    w = torch.full((p, v, v), torch.inf, dtype=dt, device=nodes.device)
    w = w.scatter_reduce(-1, nbr, torch.where(edge_ok, edge_len, inf), reduce="amin")
    w = torch.minimum(w, w.transpose(-1, -2))

    d = torch.full((p, v), torch.inf, dtype=dt, device=nodes.device)
    d[:, 0] = 0.0
    for _ in range(max_hops):
        d = torch.minimum(d, (d[:, :, None] + w).amin(dim=1))
    found = torch.isfinite(d[:, 1])

    # greedy backtrack from the goal: prev(v) = argmin_u d[u] + w[u, v]
    cur = torch.ones((p,), dtype=torch.long, device=nodes.device)
    rev = []
    for _ in range(max_hops + 2):
        rev.append(cur)
        col = torch.take_along_dim(w, cur[:, None, None].expand(p, v, 1), dim=-1)[..., 0]
        cur = torch.where(cur == 0, 0, torch.argmin(d + col, dim=-1))
    path_idx = torch.stack(rev[::-1], dim=1)              # start-padded, start -> goal
    straight = torch.cat([q_start[:, None], min_jerk_interp(q_start, q_goal, max_hops),
                          q_goal[:, None]], dim=1)
    waypoints = torch.where(found[:, None, None], _rows_at(nodes, path_idx), straight)
    return Roadmap(nodes, node_free, dist, nbr, edge_ok, d, path_idx, found, waypoints)


def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P, V, c] at indices idx [P, ...] of each pair -> [P, ..., c]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.take_along_dim(x, flat[..., None], dim=1)
    return out.reshape(idx.shape + x.shape[-1:])


def prm_waypoints(q_start, q_goal, scene, draws: PrmDraws, knn: int = PRM_KNN,
                  n_edge_samples: int = PRM_EDGE_SAMPLES, max_hops: int = PRM_MAX_HOPS):
    """(waypoints [P, max_hops + 2, 7], found [P]) of :func:`prm_roadmap`."""
    road = prm_roadmap(q_start, q_goal, scene, draws, knn, n_edge_samples, max_hops)
    return road.waypoints, road.found


def prm_seed(q_start, q_goal, scene, draws: PrmDraws) -> torch.Tensor:
    """Optimizer seed from the PRM path: the waypoint polyline resampled to
    ``OPT_PATH_LEN`` at constant speed (duplicate padding nodes collapse:
    zero-length segments get zero arc-length weight)."""
    waypoints, _ = prm_waypoints(q_start, q_goal, scene, draws)
    return constant_velocity_retime(waypoints, OPT_PATH_LEN)


# ---------------------------------------------------------------------------
# The full planner
# ---------------------------------------------------------------------------

def _try_optimized(q_start, q_goal, target_rot, target_trans, scene, init,
                   opt_steps: int = OPT_STEPS):
    """Optimizer restarts [R]: optimize, dense-verify, retime, final-verify.
    -> (traj [R, SEQUENCE_LENGTH, 7], valid [R], severity [R])."""
    opt = optimize_trajectory(q_start, q_goal, scene, init=init, steps=opt_steps)
    t = linspace(OPT_PATH_LEN - 1.0, DENSE_STEPS, opt)
    lo = torch.clamp(torch.floor(t).long(), 0, OPT_PATH_LEN - 2)
    frac = (t - lo)[:, None]
    dense = opt[:, lo] * (1.0 - frac) + opt[:, lo + 1] * frac
    ok = _dense_ok(verify_trajectory(dense, target_rot, target_trans, scene))
    traj = constant_velocity_retime(dense)
    final = verify_trajectory(traj, target_rot, target_trans, scene)
    return traj, ok & final.valid, _severity(final)


def plan_pair_optimized(q_start: torch.Tensor, q_goal: torch.Tensor, target_rot: torch.Tensor,
                        target_trans: torch.Tensor, scene: SceneSet,
                        draws: Optional[PlanDraws] = None, opt_steps: int = OPT_STEPS,
                        n_vias: int = VIA_KEEP, n_prm: int = 0) -> PlanResult:
    """Full planning attempt for pairs q [P, 7]: the smooth family first,
    then multi-restart SDF-cost optimization from 3 + ``n_vias`` + ``n_prm``
    seeds (straight, via neutral, via a retract, the sampled vias, the PRM
    paths). Every (pair, restart) row runs as one optimizer batch.

    Selection as the JAX package's loop: the family where it is valid, else
    the first valid restart in seed order, else the best attempt by
    severity (strict <, the family first), so that failure tallies diagnose
    a real trajectory (``gen_data.py:419-430``). ``which``: the family's
    code 0-3, or 99 + the restart's index. ``draws`` default to
    :func:`draw_plan` of the pairs."""
    p = q_start.shape[0]
    family = plan_pair(q_start, q_goal, target_rot, target_trans, scene)
    neutral = _table("NEUTRAL_Q", q_start)
    # a retract via: shoulder and elbow pulled toward neutral, wrist averaged
    retract = 0.5 * (q_start + q_goal)
    retract[:, 1] = neutral[1]
    retract[:, 3] = neutral[3]
    if draws is None:
        draws = draw_plan(q_start, q_goal, n_prm)
    vias = sample_via_configs(q_start, q_goal, scene, draws.via_uniform, draws.via_normal,
                              n_keep=n_vias)
    seeds = ([min_jerk_interp(q_start, q_goal, OPT_PATH_LEN),
              _via_init(q_start, neutral.expand_as(q_start), q_goal),
              _via_init(q_start, retract, q_goal)]
             + [_via_init(q_start, vias[:, i], q_goal) for i in range(n_vias)]
             + [prm_seed(q_start, q_goal, scene, draws.prm[i]) for i in range(n_prm)])
    r = len(seeds)
    rep = lambda x: x.repeat_interleave(r, dim=0)  # noqa: E731
    scene_r = SceneSet(*map(rep, scene)) if _per_row(scene) else scene
    traj, ok, score = _try_optimized(rep(q_start), rep(q_goal), rep(target_rot),
                                     rep(target_trans), scene_r,
                                     torch.stack(seeds, dim=1).flatten(0, 1), opt_steps)
    traj, ok, score = traj.unflatten(0, (p, r)), ok.unflatten(0, (p, r)), score.unflatten(0, (p, r))

    valid_opt = torch.zeros_like(family.valid)
    which_opt = torch.full_like(family.which, 99)
    traj_opt = torch.zeros_like(family.trajectory)
    best_traj, best_score, best_which = family.trajectory, family.score, family.which
    for i in range(r):
        take = ok[:, i] & ~valid_opt
        traj_opt = torch.where(take[:, None, None], traj[:, i], traj_opt)
        which_opt = torch.where(take, 99 + i, which_opt)
        valid_opt = valid_opt | ok[:, i]
        better = score[:, i] < best_score
        best_traj = torch.where(better[:, None, None], traj[:, i], best_traj)
        best_score = torch.where(better, score[:, i], best_score)
        best_which = torch.where(better, 99 + i, best_which)

    use_family = family.valid
    valid = family.valid | valid_opt
    chosen = torch.where(valid_opt[:, None, None], traj_opt, best_traj)
    out = torch.where(use_family[:, None, None], family.trajectory, chosen)
    which = torch.where(use_family, family.which, torch.where(valid_opt, which_opt, best_which))
    score = torch.where(valid, torch.zeros_like(best_score), best_score)
    return PlanResult(out, valid, which.to(torch.int32), score)
