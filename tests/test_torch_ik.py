"""Port parity: the batched DLS IK of ``mpinets_torch.kernels.ik`` against
``mpinets_tpu.kernels.ik``.

Inputs come from numpy seeds; the seeds' uniforms are JAX's
(``jax.random.uniform`` of the key the JAX function would use), handed to
the port as draws.

Tolerances. In f64 (JAX under ``enable_x64``) the residual and the geodesic
errors agree within 1e-6, the analytic Jacobian with ``jax.jacfwd`` within
1e-5 and one DLS step within 1e-5. In f32, the dtype that runs, the position
terms agree within 1e-6; the orientation terms, the Jacobian and the step
go through arccos near 0 and pi and a 6x6 solve whose condition reaches
~1e3, so each is held to the f64 truth no further than 4 times the JAX
package's own f32 error on the same inputs, plus the f64 tolerance.

Thirty DLS iterations from random seeds are chaotic: a rounding difference
of 1e-16 sends a few percent of the seeds to another point of the 7-DOF
arm's self-motion manifold, and the best seed of a target is a tie at
rounding level whenever two seeds converge. So the end-to-end solver is
held seed by seed (97% of the seeds within 1e-4 in f64), its acceptance and
selection on JAX's own per-seed solutions (flags equal away from the
tolerances, the pick a tie of JAX's best within 1e-4 of the score), and
its own results by what they must satisfy: each accepted q reaches its
target and is free by JAX's measures.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.geom import scene as tsc  # noqa: E402
from mpinets_torch.kernels import ik as tik  # noqa: E402
from mpinets_torch.kernels import kinematics as tkin  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.kernels import ik as jik  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.robot import franka as jfranka  # noqa: E402

torch.set_float32_matmul_precision("highest")

S = 16   # seeds per target, as the environments run it
EDGE = 1e-5   # a flag is compared only where its errors lie this far from the tolerances


def _t(a):
    return torch.from_numpy(np.array(a))


def _regime(name, n, seed, dtype):
    """(q, target_rot, target_trans) with targets at the FK poses of random
    in-limit configurations; q is another random configuration ("far"), the
    target's configuration moved by 0.01 rad ("near") or that configuration
    itself ("exact")."""
    rng = np.random.default_rng(seed)
    lim = franka.REAL_JOINT_LIMITS
    q_far = rng.uniform(lim[:, 0], lim[:, 1], (n, 7))
    q_t = rng.uniform(lim[:, 0], lim[:, 1], (n, 7))
    q = {"far": q_far, "near": q_t + rng.normal(0.0, 0.01, q_t.shape), "exact": q_t}[name]
    q, q_t = q.astype(dtype), q_t.astype(dtype)
    rot, trans = jkin.eff_pose(jnp.asarray(q_t))
    return q, np.asarray(rot), np.asarray(trans)


# jitted once, so that each shape compiles once in the file
_jax_solve = jax.jit(jax.vmap(jax.vmap(lambda q, r, t: jik._dls_solve(q, r, t, 30, 0.05)),
                              in_axes=(0, None, None)))
_jax_errors = jax.jit(jax.vmap(jik.pose_errors, in_axes=(0, None, None)))
_jax_free = jax.jit(jax.vmap(jik.franka_free_space, in_axes=(0, None, None)))


_jax_jac = jax.jit(jax.vmap(jax.jacfwd(jik.pose_residual)))
_jax_step = jax.jit(jax.vmap(lambda q, r, t: jik._dls_solve(q, r, t, 1, 0.05)))


def _jax_terms(q, rot, trans):
    q = jnp.asarray(q)
    pos, ori = jik.pose_errors(q, rot, trans)
    return {
        "resid": np.asarray(jik.pose_residual(q, rot, trans)),
        "pos": np.asarray(pos), "ori": np.asarray(ori),
        "jac": np.asarray(_jax_jac(q, rot, trans)),
        "step": np.asarray(_jax_step(q, rot, trans)),
        "log": np.asarray(jik._rot_log(jnp.einsum("...ij,...kj->...ik", rot,
                                                  jkin.eff_pose(q)[0]))),
    }


def _port_terms(q, rot, trans):
    q, rot, trans = _t(q), _t(rot), _t(trans)
    pos, ori = tik.pose_errors(q, rot, trans)
    e, jac = tik.residual_and_jacobian(q, rot, trans)
    np.testing.assert_array_equal(e.numpy(), tik.pose_residual(q, rot, trans).numpy())
    return {
        "resid": e.numpy(), "pos": pos.numpy(), "ori": ori.numpy(), "jac": jac.numpy(),
        "step": tik.dls_step(q, rot, trans).numpy(),
        "log": tik._rot_log(torch.einsum("...ij,...kj->...ik", rot,
                                         tkin.eff_pose(q)[0])).numpy(),
    }


F64_TOL = {"resid": 1e-6, "pos": 1e-6, "ori": 1e-6, "jac": 1e-5, "step": 1e-5, "log": 1e-6}


@pytest.mark.parametrize("regime", ["far", "near", "exact"])
def test_residual_errors_jacobian_and_step_match_in_f64(regime):
    """The formulas: residual, geodesic errors, the analytic Jacobian
    against ``jax.jacfwd`` (with the sign of the r2 fix: the step uses
    ``-jacfwd``), the log map, and one DLS step (Cholesky solve)."""
    with jax.enable_x64(True):
        q, rot, trans = _regime(regime, 128, 0, np.float64)
        ref = _jax_terms(q, rot, trans)
    got = _port_terms(q, rot, trans)
    assert got["jac"].dtype == np.float64
    for k, tol in F64_TOL.items():
        if regime == "exact" and k == "ori":
            # arccos at 1 - 1e-16: only the cosine is well-conditioned
            np.testing.assert_allclose(np.cos(got[k]), np.cos(ref[k]), atol=1e-12)
            continue
        np.testing.assert_allclose(got[k], ref[k], atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("regime", ["far", "near", "exact"])
def test_residual_errors_jacobian_and_step_in_f32_within_the_references_rounding(regime):
    q, rot, trans = _regime(regime, 128, 1, np.float32)
    ref32 = _jax_terms(q, rot, trans)
    got = _port_terms(q, rot, trans)
    with jax.enable_x64(True):
        truth = _jax_terms(q.astype(np.float64), rot.astype(np.float64),
                           trans.astype(np.float64))
    np.testing.assert_allclose(got["pos"], ref32["pos"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["resid"][:, :3], ref32["resid"][:, :3], atol=1e-6, rtol=0)
    # the log map is accurate for |theta| < pi - eps (its docstring)
    inside = np.linalg.norm(truth["log"], axis=-1) < np.pi - 0.1
    for k, tol in F64_TOL.items():
        rows = inside if k == "log" else slice(None)
        own = np.abs(ref32[k] - truth[k])[rows].max()
        port = np.abs(got[k] - truth[k])[rows].max()
        assert port <= 4.0 * own + tol, (k, port, own)


def _jax_uniforms(key, b):
    return np.asarray(jax.random.uniform(key, (S, b, franka.DOF)))


def _jax_per_seed(u, rot, trans, q_init=None):
    """The JAX package's seeds and per-seed DLS solutions (its solve_ik's
    body up to the selection)."""
    limits = jnp.asarray(jfranka.REAL_JOINT_LIMITS, trans.dtype)
    seeds = limits[:, 0] + jnp.asarray(u) * (limits[:, 1] - limits[:, 0])
    seeds = seeds.at[0].set(jnp.asarray(jfranka.NEUTRAL_Q, seeds.dtype))
    if q_init is not None:
        seeds = seeds.at[1].set(q_init)
    return np.asarray(seeds), np.asarray(_jax_solve(seeds, rot, trans))


def _targets(b, seed, dtype=np.float32):
    """Poses at the FK of random in-limit configurations, every fourth moved
    by 5 cm (often out of reach)."""
    rng = np.random.default_rng(seed)
    lim = franka.REAL_JOINT_LIMITS
    rot, trans = jkin.eff_pose(jnp.asarray(rng.uniform(lim[:, 0], lim[:, 1], (b, 7)), dtype))
    trans = np.asarray(trans) + (rng.normal(0.0, 0.05, (b, 3)) * (np.arange(b) % 4 == 0)[:, None])
    return np.asarray(rot), trans.astype(dtype)


def _boxes(seed, n_boxes):
    """A scene of n_boxes boxes and one cylinder around the arm, both
    packages' SceneSets, unbatched."""
    rng = np.random.default_rng(seed)
    cubs = []
    for _ in range(n_boxes):
        yaw = rng.uniform(0, np.pi)
        cubs.append((np.r_[rng.uniform(0.3, 0.7), rng.uniform(-0.5, 0.5), rng.uniform(0.0, 0.5)],
                     rng.uniform(0.1, 0.3, 3), np.r_[np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)]))
    cyls = [(np.r_[0.4, -0.4, 0.2], 0.08, 0.4, np.r_[1.0, 0, 0, 0])]
    jscene = jax.tree_util.tree_map(lambda x: x[0], jsc.pack_scenes([cubs], [cyls]))
    tscene = tsc.SceneSet(*(t[0] for t in tsc.pack_scenes([cubs], [cyls])))
    return jscene, tscene


def test_dls_solve_matches_seed_by_seed_in_f64():
    """30 iterations from the same seeds: 97% of the seeds end within 1e-4
    of JAX's; the rest moved to another solution (the chaos above)."""
    with jax.enable_x64(True):
        rot, trans = _targets(32, 2, np.float64)
        u = _jax_uniforms(jax.random.PRNGKey(4), 32)
        seeds, qj = _jax_per_seed(u, rot, trans)
    st = tik.seeds_from_draws(_t(u))
    np.testing.assert_array_equal(st.numpy(), seeds)
    qt = tik.dls_solve(st, _t(rot), _t(trans)).numpy()
    close = np.abs(qt - qj).max(-1) <= 1e-4
    assert close.mean() >= 0.97, (close.mean(), np.abs(qt - qj).max(-1)[~close])


def _near_tolerance(pos, ori):
    return (np.abs(pos - tik.POS_TOL) < EDGE) | (np.abs(ori - tik.ORI_TOL) < EDGE)


def _seed_of(q_best, qs):
    """Index of the seed [S, B, 7] whose solution each pick [B, 7] is."""
    match = (qs == q_best[None]).all(-1)
    assert match.any(0).all()
    return match.argmax(0)


@pytest.mark.parametrize("n_boxes", [2, 4])
def test_acceptance_and_selection_match_on_jaxs_solutions(monkeypatch, n_boxes):
    """solve_ik and collision_free_ik with the DLS iterations replaced by
    JAX's per-seed solutions, against JAX's acceptance functions on those
    solutions and its ranking (pos + 0.1 ori, + 1e6 where not ok for the
    free-space IK): the flags equal away from the tolerances, the pick's
    errors JAX's for that seed, and the pick a tie of JAX's best (its score
    within 1e-4, the f32 arccos at small angles, plus one ulp of 1e6 where
    no seed is ok)."""
    b = 48
    rot, trans = _targets(b, 3 + n_boxes)
    jscene, tscene = _boxes(n_boxes, n_boxes)
    u = _jax_uniforms(jax.random.PRNGKey(n_boxes), b)
    q_init = np.float32(franka.NEUTRAL_Q + 0.3)[None].repeat(b, 0)
    cols = np.arange(b)
    for free_ik in (False, True):
        _, qs = _jax_per_seed(u, rot, trans, None if free_ik else q_init)
        monkeypatch.setattr(tik, "dls_solve", lambda *a, **k: _t(qs))
        pos, ori = map(np.asarray, _jax_errors(qs, rot, trans))
        ok = (pos < jik.POS_TOL) & (ori < jik.ORI_TOL)
        score = pos + np.float32(0.1) * ori
        if free_ik:
            ok &= np.asarray(_jax_free(qs, jscene, 0.0))
            score = score + np.where(ok, np.float32(0.0), np.float32(1e6))
            got = tik.collision_free_ik(None, _t(rot), _t(trans), tscene, draws=_t(u))
        else:
            got = tik.solve_ik(None, _t(rot), _t(trans), q_init=_t(q_init), draws=_t(u))
        got = [x.numpy() for x in got]
        best = score.argmin(0)
        pick = _seed_of(got[0], qs)
        away = ~_near_tolerance(pos[best, cols], ori[best, cols]) & ~_near_tolerance(got[2], got[3])
        np.testing.assert_array_equal(got[1][away], ok[best, cols][away])
        np.testing.assert_allclose(got[2], pos[pick, cols], atol=1e-6, rtol=0)
        np.testing.assert_allclose(np.cos(got[3]), np.cos(ori[pick, cols]), atol=1e-6, rtol=0)
        low = score[best, cols]
        assert np.all(score[pick, cols] <= low + 1e-4 + np.where(low >= 1e6, 0.0625, 0.0))
        assert 0 < got[1].sum() < b


def _body_flags(qs, rot, trans, jscene=None):
    """Flags of the JAX package's IK from its per-seed solutions and its
    ranking, unjitted: what its jitted function computes, rounded apart."""
    pos, ori = map(np.asarray, _jax_errors(qs, rot, trans))
    ok = (pos < jik.POS_TOL) & (ori < jik.ORI_TOL)
    score = pos + np.float32(0.1) * ori
    if jscene is not None:
        ok &= np.asarray(_jax_free(qs, jscene, 0.0))
        score = score + np.where(ok, np.float32(0.0), np.float32(1e6))
    best = score.argmin(0)
    cols = np.arange(qs.shape[1])
    return ok[best, cols], pos[best, cols], ori[best, cols]


@pytest.mark.parametrize("n_boxes", [2, 3])
def test_solve_ik_and_collision_free_ik_end_to_end(n_boxes):
    """The port's own solver in f32 on JAX's draws. Its flags equal the JAX
    package's unjitted body's on 97% of the targets away from the
    tolerances, and differ from the jitted function's on no more targets
    than that body's own do, plus 3%: the jitted and unjitted JAX runs
    round apart and part ways on a few targets too. Every accepted q
    reaches its target and is free by JAX's FK and SDF (within 1e-5 of the
    tolerances: the f32 arccos at ORI_TOL)."""
    b = 48
    rot, trans = _targets(b, 10 + n_boxes)
    jscene, tscene = _boxes(20 + n_boxes, n_boxes)
    key = jax.random.PRNGKey(7 + n_boxes)
    u = _jax_uniforms(key, b)
    _, qs = _jax_per_seed(u, rot, trans)
    for scene in (None, tscene):
        if scene is None:
            ref = jik.solve_ik(key, rot, trans)
            got = tik.solve_ik(None, _t(rot), _t(trans), draws=_t(u))
            body = _body_flags(qs, rot, trans)
        else:
            ref = jik.collision_free_ik(key, rot, trans, jscene)
            got = tik.collision_free_ik(None, _t(rot), _t(trans), tscene, draws=_t(u))
            body = _body_flags(qs, rot, trans, jscene)
        ref = [np.asarray(x) for x in ref]
        got = [x.numpy() for x in got]
        away = (~_near_tolerance(ref[2], ref[3]) & ~_near_tolerance(got[2], got[3])
                & ~_near_tolerance(body[1], body[2]))
        to_body = int((got[1] != body[0])[away].sum())
        to_jit, body_to_jit = int((got[1] != ref[1])[away].sum()), int((body[0] != ref[1])[away].sum())
        assert to_body <= 0.03 * b and to_jit <= body_to_jit + 0.03 * b, (to_body, to_jit,
                                                                          body_to_jit)
        q = got[0][got[1]]
        pos, ori = map(np.asarray, jik.pose_errors(jnp.asarray(q), rot[got[1]], trans[got[1]]))
        assert np.all(pos < jik.POS_TOL + EDGE) and np.all(ori < jik.ORI_TOL + EDGE)
        if scene is not None:
            assert np.asarray(jik.franka_free_space(jnp.asarray(q), jscene, -EDGE)).all()


@pytest.mark.parametrize("margin", [0.0, 0.01])
def test_franka_free_space_matches(margin):
    """Equal wherever no sphere clearance or self-collision pair distance
    lies within 1e-5 of its threshold; batched [S, B] and unbatched scene."""
    from mpinets_tpu.kernels import sdf as jsdf

    rng = np.random.default_rng(5)
    lim = franka.REAL_JOINT_LIMITS
    q = rng.uniform(lim[:, 0], lim[:, 1], (4, 64, 7)).astype(np.float32)
    q[:, :16] = (franka.NEUTRAL_Q + rng.normal(0, 0.3, (4, 16, 7))).astype(np.float32)
    jscene, tscene = _boxes(9, 4)
    ref = np.asarray(_jax_free(jnp.asarray(q), jscene, margin))
    got = tik.franka_free_space(_t(q), tscene, margin).numpy()
    centers = jkin.scene_collision_spheres(jnp.asarray(q))
    clear = np.asarray(jsdf.scene_sdf(centers.reshape(-1, 56, 3), jscene)).reshape(4, 64, 56)
    clear = clear - franka.SCENE_SPHERE_RADII - margin
    spheres = np.asarray(jkin.collision_spheres(jnp.asarray(q)))
    pairs = franka.SELF_COLLISION_PAIRS
    gap = (np.linalg.norm(spheres[..., pairs[:, 0], :] - spheres[..., pairs[:, 1], :], axis=-1)
           - franka.SELF_COLLISION_THRESH)
    edge = (np.abs(clear) < EDGE).any(-1) | (np.abs(gap) < EDGE).any(-1)
    assert 0 < ref.sum() < ref.size and edge.mean() < 0.05
    np.testing.assert_array_equal(got[~edge], ref[~edge])


def test_draws_seeds_and_validation():
    """The draws come from a CPU generator seeded with the integer, whatever
    the device; seed 0 is the neutral pose, seed 1 the warm start; the
    seeds cover the real limits."""
    u = tik.draw_uniforms(123, S, 5)
    assert u.shape == (S, 5, 7) and u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), tik.draw_uniforms(123, S, 5, "cpu").numpy())
    assert not torch.equal(u, tik.draw_uniforms(124, S, 5))
    q_init = torch.full((5, 7), 0.5)
    seeds = tik.seeds_from_draws(u, q_init)
    np.testing.assert_array_equal(seeds[0].numpy(), np.float32(franka.NEUTRAL_Q)[None].repeat(5, 0))
    np.testing.assert_array_equal(seeds[1].numpy(), q_init.numpy())
    lim = torch.as_tensor(franka.REAL_JOINT_LIMITS, dtype=torch.float32)
    assert torch.all((seeds[2:] >= lim[:, 0]) & (seeds[2:] <= lim[:, 1]))
    with pytest.raises(ValueError):
        tik.solve_ik(None, torch.eye(3)[None], torch.zeros(1, 3))


# ---- tests/test_ik.py, on the port ------------------------------------------

@pytest.fixture(scope="module")
def reachable_targets():
    rng = np.random.default_rng(0)
    lim = franka.REAL_JOINT_LIMITS
    qs = rng.uniform(lim[:, 0], lim[:, 1], (16, 7)).astype(np.float32)
    rot, tr = tkin.eff_pose(_t(qs))
    return _t(qs), rot, tr


def test_solve_ik_converges_on_reachable(reachable_targets):
    _, rot, tr = reachable_targets
    res = tik.solve_ik(1, rot, tr, num_seeds=16, iters=30)
    assert int(res.converged.sum()) >= 14, res.pos_err
    conv = res.converged
    assert torch.all(res.pos_err[conv] < tik.POS_TOL)
    assert torch.all(res.ori_err[conv] < tik.ORI_TOL)


def test_geodesic_gate_rejects_antipodal(reachable_targets):
    """A solution flipped 180 degrees about the approach axis has
    |sin(theta)| ~ 0 but geodesic angle pi: pose_errors sees the flip, the
    residual's skew part does not."""
    qs, rot, tr = reachable_targets
    flipped_rot = rot @ torch.diag(torch.tensor([-1.0, -1.0, 1.0]))
    pos_err, ori_err = tik.pose_errors(qs, flipped_rot, tr)
    assert torch.all(pos_err < 1e-5)
    assert torch.all(ori_err > 3.0), "geodesic must see the pi flip"
    skew = 0.5 * tik._vee(torch.einsum("...ij,...kj->...ik", flipped_rot,
                                       tkin.eff_pose(qs)[0]))
    assert torch.all(torch.linalg.vector_norm(skew, dim=-1) < 1e-5)


def test_collision_free_ik_empty_scene(reachable_targets):
    _, rot, tr = reachable_targets
    scene = tsc.SceneSet(*(t[0] for t in tsc.pack_scenes([[]], [[]])))
    res = tik.collision_free_ik(2, rot[:8], tr[:8], scene)
    assert int(res.converged.sum()) >= 6


def test_real_joint_limits_golden():
    """The port's copy of the transcribed robofin FrankaRealRobot limits."""
    expected = np.array(
        [
            (-2.8773, 2.8773),
            (-1.7428, 1.7428),
            (-2.8773, 2.8773),
            (-3.0518, -0.0898),
            (-2.8773, 2.8773),
            (0.0025, 3.7325),
            (-2.8773, 2.8773),
        ]
    )
    np.testing.assert_allclose(franka.REAL_JOINT_LIMITS, expected, atol=1e-12)
    np.testing.assert_allclose(
        franka.JOINT_LIMITS[:, 0] + 0.02, franka.REAL_JOINT_LIMITS[:, 0]
    )
