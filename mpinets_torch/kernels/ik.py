"""Batched inverse kinematics: damped-least-squares (DLS) Gauss-Newton on
the Franka chain, over every (seed, target) pair at once.

Port of ``mpinets_tpu/kernels/ik.py``, the stand-in for the reference's
IKFast + collision check (``FrankaRobot.collision_free_ik``). A batch of
targets is solved from ``num_seeds`` random seeds each: the [S, B] pairs are
flattened into one batch and run ``iters`` DLS steps
``dq = J^T (J J^T + lambda^2 I)^-1 e``, clipped to the real joint limits.

The Jacobian is analytic: the geometric Jacobian of the end effector (joint
axis z_k and origin o_k from :func:`kinematics.fk_frames`), chained through
the residual's orientation term by hand. It is the forward-mode derivative
the JAX package takes with ``jax.jacfwd``, including its subgradients where a
``clip`` ties (half each side). The 6x6 system is solved with
``cholesky_ex`` and two triangular solves, which never check on the host,
and the chain's constants are made on the device once, so the iterations
make no host sync.

Random seeds are split from the computation. :func:`draw_uniforms` makes the
[S, B, 7] uniforms from a CPU ``torch.Generator`` seeded with an integer,
where the JAX package calls ``jax.random.uniform(jax.random.PRNGKey(k))``
with the same integer; the draws then move to the device, so the card and
the CPU start from the same seeds. :func:`solve_ik` and
:func:`collision_free_ik` take the integer or the draws themselves (a test
hands them JAX's). Seed 0 is replaced by ``NEUTRAL_Q``, and seed 1 by
``q_init`` where one is given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpinets_torch.kernels import kinematics, sdf
from mpinets_torch.robot import franka

#: Convergence tolerances: 1 mm position, ~0.6 deg orientation.
POS_TOL = 1e-3
ORI_TOL = 1e-2  # radians

# the residual's clip of cos(theta) and of theta / sin(theta)
_COS_LIM = 1.0 - 1e-6
_FACTOR_LO, _FACTOR_HI = 1.0, 16.0


class IKResult(NamedTuple):
    q: torch.Tensor          # [..., 7] best solution per target
    converged: torch.Tensor  # [...] bool
    pos_err: torch.Tensor    # [...]
    ori_err: torch.Tensor    # [...] radians


def _vee(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]: the skew part's axis, m - m^T unscaled."""
    return torch.stack([m[..., 2, 1] - m[..., 1, 2],
                        m[..., 0, 2] - m[..., 2, 0],
                        m[..., 1, 0] - m[..., 0, 1]], dim=-1)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]


def _rot_log(r: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: rotation matrix [..., 3, 3] -> rotation vector [..., 3].

    The skew-part formula with a small-angle branch; accurate for
    |theta| < pi - eps, which holds along a converging IK path.
    """
    cos = torch.clamp((_trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    factor = torch.where(theta < 1e-6, 0.5,
                         theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12))
    return _vee(r) * factor[..., None]


def _orientation(r: torch.Tensor):
    """The residual's orientation term of the error rotation r [..., 3, 3]
    and what its derivative needs: the sin-axis vector rescaled toward the
    log map by clip(theta / sin(theta), 1, 16), so that the antipodal flip
    is no Gauss-Newton plateau and the derivative stays bounded."""
    skew = 0.5 * _vee(r)
    half = (_trace(r) - 1.0) / 2.0
    cos = torch.clamp(half, -_COS_LIM, _COS_LIM)
    theta = torch.arccos(cos)
    # 1 - cos^2 as (1 - cos)(1 + cos): no cancellation near 0 and pi in
    # f32. It is >= 2e-6 after the clip, so the floor of 1e-12 never binds
    sin = torch.sqrt(torch.clamp((1.0 - cos) * (1.0 + cos), min=1e-12))
    ratio = theta / sin
    factor = torch.clamp(ratio, _FACTOR_LO, _FACTOR_HI)
    return skew, half, cos, theta, sin, ratio, factor


def pose_residual(q: torch.Tensor, target_rot: torch.Tensor,
                  target_trans: torch.Tensor) -> torch.Tensor:
    """6D task-space error for the solver, [..., 6]: position, then the
    skew part of the error rotation rescaled toward the log map."""
    rot, trans = kinematics.eff_pose(q)
    r = torch.einsum("...ij,...kj->...ik", target_rot, rot)
    skew, *_, factor = _orientation(r)
    return torch.cat([target_trans - trans, skew * factor[..., None]], dim=-1)


def pose_errors(q: torch.Tensor, target_rot: torch.Tensor, target_trans: torch.Tensor):
    """(pos_err [...], ori_err_rad [...]): the true geodesic metrics the
    acceptance tests use. The angle comes from arccos((tr - 1) / 2), which
    sees exactly-pi flips where the residual's skew part vanishes."""
    rot, trans = kinematics.eff_pose(q)
    pos = torch.linalg.vector_norm(target_trans - trans, dim=-1)
    tr = torch.einsum("...ij,...ij->...", target_rot, rot)   # tr(Rt^T R)
    return pos, torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def _clip_slope(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d clip(x, lo, hi) / dx as ``jnp.clip`` (max, then min) gives it: 1
    inside, 0 outside, a half at each bound that ties."""
    m = torch.clamp(x, min=lo)
    below = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    above = torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))
    return below * above


def residual_and_jacobian(q: torch.Tensor, target_rot: torch.Tensor,
                          target_trans: torch.Tensor):
    """(e [..., 6], de/dq [..., 6, 7]): :func:`pose_residual` and its
    Jacobian, from one pass of the FK chain."""
    rots, transs = kinematics.fk_frames(q)
    rot = rots[..., franka.EFF_FRAME, :, :]
    trans = transs[..., franka.EFF_FRAME, :]
    # joint k turns about the z axis of frame k + 1, through its origin
    axes = rots[..., 1:franka.DOF + 1, :, 2]       # [..., 7, 3]
    origins = transs[..., 1:franka.DOF + 1, :]     # [..., 7, 3]

    r = torch.einsum("...ij,...kj->...ik", target_rot, rot)
    skew, half, cos, theta, sin, ratio, factor = _orientation(r)
    e = torch.cat([target_trans - trans, skew * factor[..., None]], dim=-1)

    # d trans / dq_k = z_k x (p - o_k); d rot / dq_k = [z_k]x rot, so
    # d r / dq_k = -r [z_k]x, whose column j is -r (z_k x e_j).
    d_trans = torch.linalg.cross(axes, trans[..., None, :] - origins, dim=-1)  # [..., 7, 3]
    z0, z1, z2 = axes[..., 0], axes[..., 1], axes[..., 2]
    zero = torch.zeros_like(z0)
    zx = torch.stack([torch.stack([zero, -z2, z1], -1),
                      torch.stack([z2, zero, -z0], -1),
                      torch.stack([-z1, z0, zero], -1)], dim=-2)   # [..., 7, 3, 3]
    d_r = -torch.einsum("...il,...klj->...kij", r, zx)            # [..., 7, 3, 3]

    d_skew = 0.5 * _vee(d_r)                                      # [..., 7, 3]
    d_cos = _clip_slope(half, -_COS_LIM, _COS_LIM) * 0.5
    # d (theta / sin) / d cos = -(sin - theta cos) / sin^3; at small angles
    # sin - theta cos cancels in f32, so it takes its series there
    t2 = theta * theta
    num = torch.where(theta < 0.3, theta * t2 * (1.0 / 3.0 - t2 * (1.0 / 30.0 - t2 / 840.0)),
                      sin - theta * cos)
    d_ratio = -num / (sin * sin * sin) * d_cos * _clip_slope(ratio, _FACTOR_LO, _FACTOR_HI)
    d_factor = d_ratio[..., None] * _trace(d_r)                   # [..., 7]
    d_ori = d_skew * factor[..., None, None] + skew[..., None, :] * d_factor[..., None]

    jac = torch.cat([-d_trans, d_ori], dim=-1).transpose(-1, -2)  # [..., 6, 7]
    return e, jac


def _limits(dtype: torch.dtype, device: torch.device):
    """(low [7], high [7]): the real joint limits on the device."""
    limits = kinematics.franka_table("REAL_JOINT_LIMITS", dtype, device)
    return limits[:, 0], limits[:, 1]


def dls_step(q: torch.Tensor, target_rot: torch.Tensor, target_trans: torch.Tensor,
             damping: float = 0.05) -> torch.Tensor:
    """One DLS step from q [N, 7] toward targets [N, 3, 3], [N, 3], clipped
    to the real joint limits. The residual's Jacobian is the NEGATIVE
    manipulator Jacobian, so j = -de/dq (the unnegated form ascends).

    J J^T + lambda^2 I is factored by ``cholesky_ex`` and solved by two
    triangular solves: neither checks on the host, and on the card
    ``cholesky_solve`` may take a library path that waits for it."""
    e, de = residual_and_jacobian(q, target_rot, target_trans)
    j = -de
    jjt = j @ j.transpose(-1, -2) + (damping ** 2) * torch.eye(6, dtype=q.dtype, device=q.device)
    chol, _ = torch.linalg.cholesky_ex(jjt)
    y = torch.linalg.solve_triangular(chol, e[..., None], upper=False)
    x = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
    low, high = _limits(q.dtype, q.device)
    return torch.clamp(q + (j.transpose(-1, -2) @ x)[..., 0], low, high)


def dls_solve(q0: torch.Tensor, target_rot: torch.Tensor, target_trans: torch.Tensor,
              iters: int = 30, damping: float = 0.05) -> torch.Tensor:
    """``iters`` DLS steps from seeds q0 [S, B, 7] toward targets [B, ...]:
    the [S, B] pairs run as one flat batch. No host sync."""
    s, b = q0.shape[:2]
    rot = target_rot.expand(s, b, 3, 3).reshape(s * b, 3, 3)
    trans = target_trans.expand(s, b, 3).reshape(s * b, 3)
    q = q0.reshape(s * b, franka.DOF)
    for _ in range(iters):
        q = dls_step(q, rot, trans, damping)
    return q.reshape(s, b, franka.DOF)


def draw_uniforms(seed: int, num_seeds: int, batch: int, device=None) -> torch.Tensor:
    """[num_seeds, batch, 7] uniforms in [0, 1) from a CPU generator seeded
    with ``seed`` (the integer the JAX package makes its ``PRNGKey`` from),
    moved to ``device``: the same seeds on the card and on the CPU."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand((num_seeds, batch, franka.DOF), generator=gen).to(device)


def seeds_from_draws(u: torch.Tensor, q_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniforms [S, B, 7] -> seeds inside the real limits; seed 0 is the
    neutral pose (a reliable basin for front-of-robot targets) and seed 1
    the warm start, where given."""
    low, high = _limits(u.dtype, u.device)
    seeds = low + u * (high - low)
    seeds[0] = kinematics.franka_table("NEUTRAL_Q", u.dtype, u.device)
    if q_init is not None:
        seeds[1 % seeds.shape[0]] = q_init
    return seeds


def _uniforms(seed, draws, num_seeds, target_trans):
    if draws is None:
        if seed is None:
            raise ValueError("give the seed or the draws")
        draws = draw_uniforms(seed, num_seeds, target_trans.shape[0], target_trans.device)
    return draws.to(device=target_trans.device, dtype=target_trans.dtype)


def _take(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x [S, B, ...] at the seed ``best`` [B] of each target -> [B, ...]."""
    idx = best.reshape((1, -1) + (1,) * (x.dim() - 2)).expand((1,) + x.shape[1:])
    return torch.take_along_dim(x, idx, dim=0)[0]


def solve_ik(seed: Optional[int], target_rot: torch.Tensor, target_trans: torch.Tensor,
             q_init: Optional[torch.Tensor] = None, num_seeds: int = 16, iters: int = 30,
             damping: float = 0.05, draws: Optional[torch.Tensor] = None) -> IKResult:
    """Multi-seed batched IK for targets [B, 3, 3], [B, 3]; the best seed
    per target by pos + 0.1 ori, with its convergence flag.

    :param seed: integer behind the seeds' uniforms (:func:`draw_uniforms`).
    :param q_init: optional [B, 7] warm start, taken as seed 1.
    :param draws: [num_seeds, B, 7] uniforms used in place of ``seed``'s.
    """
    seeds = seeds_from_draws(_uniforms(seed, draws, num_seeds, target_trans), q_init)
    qs = dls_solve(seeds, target_rot, target_trans, iters, damping)
    # accept on the geodesic angle: the residual's |sin(theta)| is ~0 at pi
    pos_err, ori_err = pose_errors(qs, target_rot, target_trans)   # [S, B]
    best = torch.argmin(pos_err + 0.1 * ori_err, dim=0)
    pos_best, ori_best = _take(pos_err, best), _take(ori_err, best)
    return IKResult(_take(qs, best), (pos_best < POS_TOL) & (ori_best < ORI_TOL),
                    pos_best, ori_best)


def franka_free_space(q: torch.Tensor, scene, margin: float = 0.0) -> torch.Tensor:
    """True where the sphere model at q [..., 7] clears the scene and
    itself. The scene checks leave out the base link's sphere; ``scene`` is a
    SceneSet batched like q or unbatched (broadcast). -> bool [...]."""
    centers = kinematics.scene_collision_spheres(q)   # [..., 56, 3]
    radii = kinematics.franka_table("SCENE_SPHERE_RADII", q.dtype, q.device)
    d = sdf.scene_sdf(centers, scene)
    env_clear = torch.all(d > radii + margin, dim=-1)
    return env_clear & ~kinematics.self_collision(q)


def collision_free_ik(seed: Optional[int], target_rot: torch.Tensor,
                      target_trans: torch.Tensor, scene, num_seeds: int = 16,
                      iters: int = 30, margin: float = 0.0,
                      draws: Optional[torch.Tensor] = None) -> IKResult:
    """IK with free-space acceptance (``FrankaRobot.collision_free_ik``'s
    counterpart): each seed's solution is checked against the scene and
    itself before the best is picked, so a colliding basin does not shadow a
    clear one. ``converged`` is accurate AND free. Among seeds, the lowest
    pos + 0.1 ori + 1e6 (not ok) wins, the lowest index at a tie."""
    seeds = seeds_from_draws(_uniforms(seed, draws, num_seeds, target_trans))
    qs = dls_solve(seeds, target_rot, target_trans, iters, 0.05)
    pos_err, ori_err = pose_errors(qs, target_rot, target_trans)   # [S, B]
    ok = (pos_err < POS_TOL) & (ori_err < ORI_TOL) & franka_free_space(qs, scene, margin)
    score = pos_err + 0.1 * ori_err + torch.where(ok, 0.0, 1e6)
    best = torch.argmin(score, dim=0)
    return IKResult(_take(qs, best), _take(ok, best), _take(pos_err, best),
                    _take(ori_err, best))
