"""Port parity: the expert pipeline, ``mpinets_torch.pipeline.expert``
against ``mpinets_tpu.pipeline.expert``.

The JAX package plans one pair and is vmapped here; the port takes the
batch. Where the JAX package draws random numbers (``sample_via_configs``,
``prm_waypoints``, ``plan_pair_optimized``'s key), the test makes the same
draws with ``jax.random`` and hands them to the port. Tolerances:

* ``linspace``: bit-equal to ``jnp.linspace`` at every length the pipeline
  uses, f32 and f64;
* ``min_jerk_interp``, ``via_point_path``, the retiming and the jerk: 1e-6
  (f32);
* ``verify_trajectory`` and ``_severity`` on the same trajectories (clean,
  colliding with a box or a cylinder, missing the target, over a joint
  limit, jerky): each predicate equal wherever its value is more than 1e-6
  from its threshold; miss and jerk 1e-6, severity 1e-5 relative;
* ``_path_cost`` and its gradient: 1e-10 relative in f64, on paths through
  cuboids and cylinders;
* ``optimize_trajectory``: 1e-9 in f64 at 5 steps; at 120 steps in f32 the
  drift is bounded by ``OPT_F32_DRIFT`` (measured 1.67e-6 on this input);
* the via stage and the PRM on JAX's draws: ``node_free``, the k-NN index
  sets, ``edge_ok``, the path indices, ``found`` and the picked vias equal;
  distances 1e-6 relative, waypoints 1e-6;
* ``plan_pair_optimized`` (2 optimizer steps, one via, one PRM seed at the
  full PRM size): ``valid`` and ``which`` equal, trajectories 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.geom import scene as tsc  # noqa: E402
from mpinets_torch.pipeline import expert as te  # noqa: E402
from mpinets_torch.robot import franka  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.kernels import ik as jik  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402
from mpinets_tpu.pipeline import expert as je  # noqa: E402

EDGE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs files in
    parallel workers, where more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
OPT_F32_DRIFT = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _scenes(cubs, cyls):
    """Both packages' unbatched scenes of the given primitives."""
    jscene = jax.tree_util.tree_map(lambda x: x[0], jsc.pack_scenes([cubs], [cyls]))
    return jscene, tsc.SceneSet(*(_t(x) for x in jscene))


WALL = ([0.32, 0.0, 0.35], [0.25, 0.12, 0.7], [1.0, 0.0, 0.0, 0.0])
BOX = ([0.0, 0.0, 0.4], [4.0, 4.0, 4.0], [1.0, 0.0, 0.0, 0.0])   # seals the robot in
YAWED = ([0.55, 0.25, 0.25], [0.2, 0.3, 0.25], [np.cos(0.3), 0.0, 0.0, np.sin(0.3)])
CYL = ([0.45, -0.3, 0.3], 0.09, 0.5, [1.0, 0.0, 0.0, 0.0])
SIDE = ([-0.1, 0.6, 0.5], [0.3, 0.1, 0.6], [1.0, 0.0, 0.0, 0.0])


def _pairs(n, seed, sigma=0.4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lim = franka.REAL_JOINT_LIMITS
    q = franka.NEUTRAL_Q + rng.normal(0.0, sigma, (2, n, 7))
    q = np.clip(q, lim[:, 0] + 0.01, lim[:, 1] - 0.01).astype(dtype)
    return q[0], q[1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linspace_is_xlas(dtype):
    like = torch.zeros(1, dtype=torch.float64 if dtype == np.float64 else torch.float32)
    with jax.enable_x64(dtype == np.float64):
        for stop, num in [(1.0, 150), (1.0, 76), (1.0, 75), (1.0, 50), (1.0, 26), (1.0, 25),
                          (1.0, 24), (1.0, 12), (1.0, 13), (1.0, 8), (1.0, 6), (49.0, 150)]:
            ref = np.asarray(jax.jit(lambda: jnp.linspace(0.0, stop, num))())
            assert ref.dtype == dtype
            np.testing.assert_array_equal(te.linspace(stop, num, like).numpy(), ref,
                                          err_msg=f"{stop}, {num}")


def test_smooth_family_retime_and_jerk_match():
    qa, qb = _pairs(6, 0)
    qv = _pairs(6, 1)[0]
    mj = jax.jit(jax.vmap(lambda a, b: je.min_jerk_interp(a, b, 150)))(qa, qb)
    np.testing.assert_allclose(te.min_jerk_interp(_t(qa), _t(qb), 150).numpy(), mj, atol=1e-6)
    via = jax.jit(jax.vmap(lambda a, v, b: je.via_point_path(a, v, b, 24)))(qa, qv, qb)
    np.testing.assert_allclose(te.via_point_path(_t(qa), _t(qv), _t(qb), 24).numpy(), via,
                               atol=1e-6)
    # retime dense paths, and start-padded waypoint chains with repeated points
    chain = np.concatenate([np.repeat(qa[:, None], 4, 1), np.asarray(via)[:, ::3]], axis=1)
    for paths, length in ((np.asarray(mj), 50), (chain, 50), (np.asarray(via), 13)):
        ref = jax.jit(jax.vmap(lambda p: je.constant_velocity_retime(p, length)))(paths)
        got = te.constant_velocity_retime(_t(paths), length)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
        np.testing.assert_allclose(te.trajectory_max_jerk(got).numpy(),
                                   jax.vmap(je.trajectory_max_jerk)(ref), atol=1e-6)
    zero = np.repeat(qa[:1, None], 5, 1)            # a path that does not move
    np.testing.assert_array_equal(te.constant_velocity_retime(_t(zero), 7).numpy(),
                                  je.constant_velocity_retime(jnp.asarray(zero[0]), 7)[None])


def _verify_cases():
    """Trajectories [10, 50, 7] for the predicates and targets: clean,
    through a box or a cylinder, missing, over a joint limit, jerky."""
    qa, qb = _pairs(10, 2, sigma=0.6)
    qa[:2], qb[:2] = _pairs(2, 9, sigma=0.1)          # clean
    traj = np.array(jax.vmap(lambda a, b: je.constant_velocity_retime(
        je.min_jerk_interp(a, b, 150)))(qa, qb))
    rot, trans = (np.asarray(x) for x in jkin.eff_pose(jnp.asarray(qb)))
    trans = trans.copy()
    trans[2] += np.float32(0.2)                       # misses its target
    trans[3] += np.float32(0.04)                      # inside the tolerance
    lim = franka.REAL_JOINT_LIMITS
    traj[4, 20:30, 3] = lim[3, 1] + 0.05              # over a limit (and jerky)
    traj[5, 25, 1] += 0.2                             # jerky only
    traj[6, 10:40] = franka.NEUTRAL_Q                 # parks at neutral
    traj[6, 10:40, 0] = -0.3
    # primitives where rows 7 and 8 pass: a yawed box and a cylinder
    _, hit = jkin.eff_pose(jnp.asarray(traj[7:9, 25]))
    box = (np.asarray(hit[0]), [0.1, 0.1, 0.1], YAWED[2])
    cyl = (np.asarray(hit[1]), 0.05, 0.1, CYL[3])
    return traj.astype(np.float32), rot, trans, _scenes([box, SIDE], [cyl])


def _jax_verify(traj, rot, trans, scene):
    res = jax.jit(jax.vmap(je.verify_trajectory, in_axes=(0, 0, 0, None)))(traj, rot, trans,
                                                                           scene)
    return res, np.asarray(je._severity(res))


def _assert_predicates_equal(got, ref):
    away_miss = np.abs(np.asarray(ref.miss) - je.MISS_TOLERANCE) > EDGE
    away_jerk = np.abs(np.asarray(ref.max_jerk) - je.MAX_JERK) > EDGE
    np.testing.assert_allclose(got.miss.numpy(), ref.miss, atol=1e-6)
    np.testing.assert_allclose(got.max_jerk.numpy(), ref.max_jerk, atol=1e-6)
    for name in ("has_self_collision", "has_env_collision", "within_limits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ref, name), name)
    away = away_miss & away_jerk
    np.testing.assert_array_equal(got.valid.numpy()[away], np.asarray(ref.valid)[away])


def test_verify_trajectory_and_severity_match():
    traj, rot, trans, (jscene, tscene) = _verify_cases()
    ref, sev = _jax_verify(traj, rot, trans, jscene)
    got = te.verify_trajectory(_t(traj), _t(rot), _t(trans), tscene)
    _assert_predicates_equal(got, ref)
    np.testing.assert_allclose(te._severity(got).numpy(), sev, rtol=1e-5, atol=1e-6)
    # every predicate fails somewhere and holds somewhere
    for name in ("valid", "has_env_collision", "within_limits"):
        assert 0 < np.asarray(getattr(ref, name)).sum() < len(traj), name
    assert (np.asarray(ref.miss) > je.MISS_TOLERANCE).any()
    assert (np.asarray(ref.max_jerk) > je.MAX_JERK).any()
    # env_collision_any alone, and a scene given per row
    per_row = tsc.SceneSet(*(t.expand((len(traj),) + t.shape) for t in tscene))
    np.testing.assert_array_equal(te.env_collision_any(_t(traj), per_row).numpy(),
                                  ref.has_env_collision)


def test_chunked_sdf_equals_one_call(monkeypatch):
    traj, rot, trans, (_, tscene) = _verify_cases()
    whole = te.sphere_sdf(_t(traj), tscene)
    per_row = tsc.SceneSet(*(t.expand((len(traj),) + t.shape) for t in tscene))
    monkeypatch.setattr(te, "SDF_CHUNK_BYTES", 3 * 50 * 56 * 4 * 4)   # 3 rows a chunk
    for scene in (tscene, per_row):
        np.testing.assert_allclose(te.sphere_sdf(_t(traj), scene).numpy(), whole.numpy(),
                                   atol=1e-6)


def test_plan_pair_family_matches():
    qa, qb = _pairs(8, 3, sigma=0.5)
    rot, trans = jkin.eff_pose(jnp.asarray(qb))
    jscene, tscene = _scenes([WALL], [CYL])
    ref = jax.jit(jax.vmap(je.plan_pair, in_axes=(0, 0, 0, 0, None)))(qa, qb, rot, trans, jscene)
    got = te.plan_pairs_batch(_t(qa), _t(qb), _t(rot), _t(trans), tscene)
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.which.numpy(), ref.which)
    assert got.which.dtype == torch.int32
    np.testing.assert_allclose(got.trajectory.numpy(), ref.trajectory, atol=1e-5)
    np.testing.assert_allclose(got.score.numpy(), ref.score, rtol=1e-5, atol=1e-6)
    assert 0 < np.asarray(ref.valid).sum() < len(qa)


def _touching_paths(dtype):
    """Paths of 12 waypoints that pass through a yawed box and a cylinder."""
    qa, qb = _pairs(4, 4, sigma=0.5, dtype=dtype)
    qa[:, 0], qb[:, 0] = -1.0, 1.0
    rng = np.random.default_rng(5)
    init = np.asarray(jax.vmap(lambda a, b: je.min_jerk_interp(a, b, 12))(qa, qb))
    init = init + rng.normal(0, 0.05, init.shape)
    return qa, qb, init[:, 1:-1].astype(dtype)


def test_path_cost_and_gradient_match_in_f64():
    with jax.enable_x64(True):
        qa, qb, interior = _touching_paths(np.float64)
        jscene, tscene = _scenes([YAWED, WALL], [CYL])
        jscene = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jscene)
        tscene = tsc.SceneSet(*(t.double() for t in tscene))
        cost = jax.jit(jax.vmap(je._path_cost, in_axes=(0, 0, 0, None)))
        grad = jax.jit(jax.vmap(jax.grad(je._path_cost), in_axes=(0, 0, 0, None)))
        ref_c = np.asarray(cost(interior, qa, qb, jscene))
        ref_g = np.asarray(grad(interior, qa, qb, jscene))
    x = _t(interior).requires_grad_(True)
    c = te._path_cost(x, _t(qa), _t(qb), tscene)
    (g,) = torch.autograd.grad(c.sum(), x)
    assert c.dtype == torch.float64
    np.testing.assert_allclose(c.detach().numpy(), ref_c, rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-10, atol=1e-10 * np.abs(ref_g).max())
    # the paths touch the primitives: the collision term is live
    pen = te.sphere_sdf(te.torch.cat([_t(qa)[:, None], _t(interior), _t(qb)[:, None]], 1), tscene)
    assert (pen < _t(franka.SCENE_SPHERE_RADII) + te.OPT_MARGIN).any()


_jax_optimize = jax.jit(jax.vmap(lambda a, b, s, n: je.optimize_trajectory(a, b, s, steps=n),
                                 in_axes=(0, 0, None, None)), static_argnums=3)


def test_optimize_trajectory_matches():
    """5 steps in f64 within 1e-9; 120 steps in f32 within OPT_F32_DRIFT."""
    qa, qb = _pairs(4, 6, sigma=0.5)
    qa[:, 0], qb[:, 0] = -1.0, 1.0
    with jax.enable_x64(True):
        jscene, tscene = _scenes([WALL], [CYL])
        j64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jscene)
        ref = _jax_optimize(qa.astype(np.float64), qb.astype(np.float64), j64, 5)
        ref = np.asarray(ref)
    t64 = tsc.SceneSet(*(t.double() for t in tscene))
    got = te.optimize_trajectory(_t(qa).double(), _t(qb).double(), t64, steps=5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-9, rtol=0)
    assert np.abs(ref - np.asarray(je.min_jerk_interp(qa[0], qb[0], 50), np.float64)).max() > 1e-3

    ref32 = np.asarray(_jax_optimize(qa, qb, jscene, 120))
    got32 = te.optimize_trajectory(_t(qa), _t(qb), tscene, steps=120).numpy()
    drift = np.abs(got32 - ref32).max()
    print(f"optimize_trajectory, 120 steps, f32: port - JAX {drift:.3g}")
    assert drift <= OPT_F32_DRIFT, drift
    # under no_grad (as after a rollout) the optimizer still descends
    with torch.no_grad():
        again = te.optimize_trajectory(_t(qa).double(), _t(qb).double(), t64, steps=5)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# The global stages on JAX's draws
# ---------------------------------------------------------------------------

def _jax_via_draws(key, n_samples=je.VIA_SAMPLES):
    ku, kn = jax.random.split(key)
    n_u = n_samples // 2
    return (jax.random.uniform(ku, (n_u, 7)), jax.random.normal(kn, (n_samples - n_u, 7)))


def _jax_prm_draws(key, n_nodes):
    ku, kn, km = jax.random.split(key, 3)
    n_u = n_nodes // 2
    return (jax.random.uniform(ku, (n_u, 7)), jax.random.randint(km, (n_nodes - n_u,), 0, 3),
            jax.random.normal(kn, (n_nodes - n_u, 7)))


def _stack_draws(per_pair):
    return [_t(np.stack([np.asarray(d[i]) for d in per_pair])) for i in range(len(per_pair[0]))]


def test_sample_via_configs_on_jaxs_draws():
    qa, qb = _pairs(5, 7, sigma=0.5)
    jscene, tscene = _scenes([WALL, YAWED], [CYL])
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    ref = jax.jit(jax.vmap(lambda k, a, b, s: je.sample_via_configs(k, a, b, s, n_keep=3),
                           in_axes=(0, 0, 0, None)))(keys, qa, qb, jscene)
    u, n = _stack_draws([_jax_via_draws(k) for k in keys])
    got = te.sample_via_configs(_t(qa), _t(qb), tscene, u, n, n_keep=3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def _jax_roadmap(key, q_start, q_goal, scene, n_nodes, knn, n_edge_samples, max_hops):
    """The body of ``mpinets_tpu.pipeline.expert.prm_waypoints`` up to its
    result, keeping the intermediates (the test checks that it returns what
    the function returns)."""
    lim = jnp.asarray(franka.REAL_JOINT_LIMITS, q_start.dtype)
    span = lim[:, 1] - lim[:, 0]
    ku, kn, km = jax.random.split(key, 3)
    n_u = n_nodes // 2
    nodes_u = lim[:, 0] + jax.random.uniform(ku, (n_u, 7), dtype=q_start.dtype) * span
    anchors = jnp.stack([q_start, q_goal, 0.5 * (q_start + q_goal)])
    pick = jax.random.randint(km, (n_nodes - n_u,), 0, 3)
    nodes_n = anchors[pick] + jax.random.normal(kn, (n_nodes - n_u, 7),
                                                dtype=q_start.dtype) * (0.22 * span)
    nodes = jnp.concatenate([q_start[None], q_goal[None],
                             jnp.clip(jnp.concatenate([nodes_u, nodes_n]), lim[:, 0], lim[:, 1])])
    v = nodes.shape[0]
    node_free = jik.franka_free_space(nodes, scene, margin=je.PRM_MARGIN)
    node_free = node_free.at[0].set(True).at[1].set(True)
    dist = jnp.linalg.norm(nodes[:, None, :] - nodes[None, :, :], axis=-1)
    dist_ = dist + jnp.where(jnp.eye(v, dtype=bool), jnp.inf, 0.0)
    _, nbr = jax.lax.top_k(-dist_, knn)
    t = jnp.linspace(0.0, 1.0, n_edge_samples + 2)[1:-1]
    a = nodes[:, None, None, :]
    b = nodes[nbr][:, :, None, :]
    pts = a + t[None, None, :, None] * (b - a)
    free = jik.franka_free_space(pts.reshape(-1, 7), scene,
                                 margin=je.PRM_MARGIN).reshape(v, knn, n_edge_samples)
    edge_len = jnp.take_along_axis(dist_, nbr, axis=1)
    edge_ok = (jnp.all(free, axis=-1) & node_free[:, None] & node_free[nbr]
               & (edge_len <= je.PRM_EDGE_CAP))
    w = jnp.full((v, v), jnp.inf, q_start.dtype)
    rows = jnp.broadcast_to(jnp.arange(v)[:, None], (v, knn))
    w = w.at[rows, nbr].min(jnp.where(edge_ok, edge_len, jnp.inf))
    w = jnp.minimum(w, w.T)
    d = jnp.full((v,), jnp.inf, q_start.dtype).at[0].set(0.0)
    for _ in range(max_hops):
        d = jnp.minimum(d, jnp.min(d[:, None] + w, axis=0))
    cur, rev = jnp.asarray(1), []
    for _ in range(max_hops + 2):
        rev.append(cur)
        cur = jnp.where(cur == 0, 0, jnp.argmin(d + w[:, cur]))
    path_idx = jnp.stack(rev[::-1])
    found = jnp.isfinite(d[1])
    straight = jnp.concatenate([q_start[None], je.min_jerk_interp(q_start, q_goal, max_hops),
                                q_goal[None]])
    waypoints = jnp.where(found, nodes[path_idx], straight)
    return nodes, node_free, dist, nbr, edge_ok, d, path_idx, found, waypoints


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _jax_roadmaps(keys, qa, qb, scene, n_nodes, knn, n_s, hops):
    return jax.vmap(lambda k, a, b: _jax_roadmap(k, a, b, scene, n_nodes, knn, n_s, hops))(
        keys, qa, qb)


PRM_CASES = {   # scene, (n_nodes, knn, n_edge_samples, max_hops), found
    "empty": (BOX[:1] + ([0.0, 0.0, 0.0],) + BOX[2:], (30, 8, 4, 8), True),  # zero volume
    "wall": (WALL, (126, 14, 6, 12), True),
    "sealed": (BOX, (30, 8, 4, 8), False),
}


@pytest.mark.parametrize("case", list(PRM_CASES))
def test_prm_on_jaxs_draws(case):
    """``tests/test_prm.py``'s cases: an empty scene connects, a wall is
    routed around, a sealed box finds no path (straight fallback)."""
    cub, (n_nodes, knn, n_s, hops), found = PRM_CASES[case]
    qa = np.tile(np.asarray(franka.NEUTRAL_Q, np.float32), (2, 1))
    qb = qa.copy()
    qa[:, 0], qb[:, 0] = -1.2, 1.2
    qa[1, 0], qb[1, 2] = -1.0, 0.4
    jscene, tscene = _scenes([cub], [])
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    ref = [np.asarray(x) for x in _jax_roadmaps(keys, qa, qb, jscene, n_nodes, knn, n_s, hops)]
    if case == "wall":   # the replica is the function
        wps, fnd = jax.jit(jax.vmap(lambda k, a, b, s: je.prm_waypoints(
            k, a, b, s, n_nodes=n_nodes, knn=knn, n_edge_samples=n_s, max_hops=hops),
            in_axes=(0, 0, 0, None)))(keys, qa, qb, jscene)
        np.testing.assert_array_equal(ref[-1], wps)
        np.testing.assert_array_equal(ref[-2], fnd)
    draws = te.PrmDraws(*_stack_draws([_jax_prm_draws(k, n_nodes) for k in keys]))
    got = te.prm_roadmap(_t(qa), _t(qb), tscene, draws, knn, n_s, hops)
    nodes, node_free, dist, nbr, edge_ok, d, path_idx, fnd, wps = ref
    np.testing.assert_allclose(got.nodes.numpy(), nodes, atol=1e-6)
    np.testing.assert_array_equal(got.node_free.numpy(), node_free)
    np.testing.assert_allclose(got.dist.numpy(), dist, rtol=1e-6)
    np.testing.assert_array_equal(np.sort(got.nbr.numpy(), -1), np.sort(nbr, -1))
    order = np.argsort(nbr, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(got.edge_ok.numpy(), np.argsort(got.nbr.numpy(), -1), -1),
        np.take_along_axis(edge_ok, order, -1))
    np.testing.assert_allclose(got.cost_to.numpy(), d, rtol=1e-6)
    np.testing.assert_array_equal(got.path_idx.numpy(), path_idx)
    np.testing.assert_array_equal(got.found.numpy(), fnd)
    np.testing.assert_allclose(got.waypoints.numpy(), wps, atol=1e-6)
    assert fnd.all() == found and fnd.any() == found
    if case == "wall":   # a path of more than one hop, on a roadmap with refused edges
        assert (path_idx[:, -3] != 0).any() and 0 < edge_ok.mean() < 1
    seed = te.prm_seed(_t(qa), _t(qb), tscene, draws)
    ref_seed = jax.vmap(lambda w: je.constant_velocity_retime(w, je.OPT_PATH_LEN))(wps)
    np.testing.assert_allclose(seed.numpy(), ref_seed, atol=1e-6)


def test_plan_pair_optimized_on_jaxs_draws():
    """Two optimizer steps, one via and one PRM seed at the full PRM size,
    on a wall and a cylinder: ``valid`` and ``which`` equal (a restart, the
    family, and an invalid pair's best attempt occur)."""
    n = np.asarray(franka.NEUTRAL_Q, np.float32)
    qa, qb = np.tile(n, (3, 1)), np.tile(n, (3, 1))
    qa[:, 0], qb[:, 0] = [-1.2, -1.2, -1.3], [1.2, 0.3, 1.3]
    qb[2, 3] = -0.3
    rot, trans = jkin.eff_pose(jnp.asarray(qb))
    jscene, tscene = _scenes([WALL], [CYL])
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    ref = jax.jit(jax.vmap(lambda a, b, r, t, k, s: je.plan_pair_optimized(
        a, b, r, t, s, key=k, opt_steps=2, n_vias=1, n_prm=1), in_axes=(0, 0, 0, 0, 0, None)))(
        qa, qb, rot, trans, keys, jscene)
    via = _stack_draws([_jax_via_draws(k) for k in keys])
    prm = te.PrmDraws(*_stack_draws([_jax_prm_draws(jax.random.fold_in(k, 1000), je.PRM_NODES)
                                     for k in keys]))
    got = te.plan_pair_optimized(_t(qa), _t(qb), _t(rot), _t(trans), tscene,
                                 draws=te.PlanDraws(*via, (prm,)), opt_steps=2, n_vias=1, n_prm=1)
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.which.numpy(), ref.which)
    np.testing.assert_allclose(got.trajectory.numpy(), ref.trajectory, atol=1e-5)
    np.testing.assert_allclose(got.score.numpy(), ref.score, rtol=1e-5, atol=1e-6)
    which = np.asarray(ref.which)
    assert (which < 4).any() and (which >= 99).any() and not np.asarray(ref.valid).all()


def test_port_draws_are_per_pair_and_seeded_like_jax():
    qa, qb = _pairs(3, 8)
    ref = [int(jnp.sum(jnp.asarray(a) * 1e4 + jnp.asarray(b) * 1e3).astype(jnp.int32))
           for a, b in zip(qa, qb)]
    assert te.pair_seeds(_t(qa), _t(qb)).tolist() == ref
    d = te.draw_plan(_t(qa), _t(qb), n_prm=2)
    assert d.via_uniform.shape == (3, 24, 7) and d.via_normal.shape == (3, 24, 7)
    assert len(d.prm) == 2 and d.prm[0].uniform.shape == (3, 63, 7)
    assert d.prm[0].anchor.shape == (3, 63) and set(d.prm[0].anchor.unique().tolist()) == {0, 1, 2}
    assert not torch.equal(d.prm[0].normal, d.prm[1].normal)
    one = te.draw_plan(_t(qa[1:2]), _t(qb[1:2]), n_prm=2)   # a pair's draws are its own
    assert torch.equal(one.via_normal[0], d.via_normal[1])
    assert torch.equal(one.prm[1].normal[0], d.prm[1].normal[1])
