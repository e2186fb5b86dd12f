"""Port parity: the procedural environments of ``mpinets_torch.envs``
against ``mpinets_tpu.envs``.

The numpy half is held apart from the IK: which candidates the IK accepts
decides whether a scene is kept and how much of the numpy generator is used
next, and 30 DLS iterations from random seeds round apart between any two
implementations (``tests/test_torch_ik.py``). So the parity tests patch
the port's IK entry (``mpinets_torch.envs.base.ik``) with the JAX package's
``collision_free_ik`` and ``franka_free_space``, and then require, for each
environment and numpy seed: the same scene kept or refused; obstacles
(centres, dims, quaternions, radii), demo and additional candidates (poses,
configurations, negative volumes) and the funnel bit-equal; the numpy
generator in the same state after ``gen``, ``gen_candidates`` and
``gen_neutral_candidates``; the neutral candidates' configurations equal
and their poses (the port's own FK) within 1e-6. The two packages' calls
share one JAX IK result per input, so each solve runs once.

Then each environment runs once with the port's own IK on the CPU: every
kept configuration reaches its pose within the IK tolerances (+1e-5, the
f32 arccos at ORI_TOL) and is free by the JAX package's FK and SDF (margin
-1e-5). Last, ``tests/test_envs.py``'s envelope and approach-axis tests on
the port.
"""

import types as pytypes

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch import envs as tenvs  # noqa: E402
from mpinets_torch.envs import base as tbase  # noqa: E402
from mpinets_torch.kernels import ik as tik  # noqa: E402
from mpinets_tpu import envs as jenvs  # noqa: E402
from mpinets_tpu.envs import base as jbase  # noqa: E402
from mpinets_tpu.geom import scene as jsc  # noqa: E402
from mpinets_tpu.kernels import ik as jik  # noqa: E402
from mpinets_tpu.kernels import kinematics as jkin  # noqa: E402

EDGE = 1e-5
SCENE_PAD = (48, 16)   # cuboids, cylinders: more than any environment here makes


_jax_eff_pose = jax.jit(jkin.eff_pose)
_jax_free_space = jax.jit(jik.franka_free_space)


def _jax_ik(memo):
    """The JAX package's IK, one solve per distinct input, for both
    packages' environments: the port's calls (torch tensors, an integer
    seed) and the JAX package's (numpy, a PRNG key)."""

    def solve(key, rot, trans, scene):
        rot, trans = np.asarray(rot, np.float32), np.asarray(trans, np.float32)
        scene = jsc.SceneSet(*(jnp.asarray(np.asarray(x)) for x in scene))
        k = (np.asarray(key).tobytes(), rot.tobytes(), trans.tobytes(),
             *(np.asarray(x).tobytes() for x in scene))
        if k not in memo:
            memo[k] = [np.asarray(x) for x in jik.collision_free_ik(key, rot, trans, scene)]
        return memo[k]

    def port_solve(seed, rot, trans, scene):
        res = solve(jax.random.PRNGKey(seed), rot.numpy(), trans.numpy(),
                    [t.numpy() for t in scene])
        return tik.IKResult(*(torch.from_numpy(x.copy()) for x in res))

    def port_free(q, scene, margin=0.0):
        scene = jsc.SceneSet(*(jnp.asarray(t.numpy()) for t in scene))
        return torch.from_numpy(np.array(_jax_free_space(jnp.asarray(q.numpy()), scene, margin)))

    def jax_solve(key, rot, trans, scene):
        return jik.IKResult(*solve(key, rot, trans, scene))

    common = dict(POS_TOL=jik.POS_TOL, ORI_TOL=jik.ORI_TOL)
    return (pytypes.SimpleNamespace(collision_free_ik=port_solve, franka_free_space=port_free,
                                    **common),
            pytypes.SimpleNamespace(collision_free_ik=jax_solve, franka_free_space=_jax_free_space,
                                    **common))


@pytest.fixture(scope="module")
def memo():
    return {}


@pytest.fixture
def jax_ik(memo, monkeypatch):
    """Both packages' environments on the JAX IK, every scene padded to one
    shape (``SCENE_PAD``), so that the JAX IK compiles once per batch size;
    the JAX environments' FK jitted, for the same reason."""
    port, ref = _jax_ik(memo)
    monkeypatch.setattr(tbase, "ik", port)
    monkeypatch.setattr(jbase, "ik", ref)
    monkeypatch.setattr(tbase.Environment, "SCENE_PAD", SCENE_PAD)
    monkeypatch.setattr(jbase.Environment, "SCENE_PAD", SCENE_PAD)
    monkeypatch.setattr(jkin, "eff_pose", _jax_eff_pose)


def _assert_primitives_equal(a, b):
    assert [type(x).__name__ for x in a] == [type(x).__name__ for x in b]
    for x, y in zip(a, b):
        assert vars(x).keys() == vars(y).keys()
        for k, v in vars(x).items():
            np.testing.assert_array_equal(v, vars(y)[k], err_msg=k)


def _assert_candidates_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__
        np.testing.assert_array_equal(x.pose.position, y.pose.position)
        np.testing.assert_array_equal(x.pose.quaternion, y.pose.quaternion)
        np.testing.assert_array_equal(x.config, y.config)
        _assert_primitives_equal(x.negative_volumes, y.negative_volumes)


def test_environments_registry_and_device():
    assert list(tenvs.ENVIRONMENTS) == list(jenvs.ENVIRONMENTS)
    for name, cls in tenvs.ENVIRONMENTS.items():
        assert cls.__name__ == jenvs.ENVIRONMENTS[name].__name__
        assert cls(device="cpu").device == torch.device("cpu")


def test_environment_without_a_card_raises(monkeypatch):
    """No device means cuda, and no card means an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in tenvs.ENVIRONMENTS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(jenvs.ENVIRONMENTS))
def test_numpy_half_bit_equal_with_jaxs_ik(jax_ik, name, seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    je, te = jenvs.ENVIRONMENTS[name](), tenvs.ENVIRONMENTS[name](device="cpu")
    kept = te.gen(rt)
    assert je.gen(rj) == kept
    assert rj.bit_generator.state == rt.bit_generator.state
    _assert_primitives_equal(je.obstacles, te.obstacles)
    if kept:
        _assert_candidates_equal(je.demo_candidates, te.demo_candidates)
        _assert_candidates_equal(je.gen_candidates(rj, 10), te.gen_candidates(rt, 10))
        nj, nt = je.gen_neutral_candidates(5, rj), te.gen_neutral_candidates(5, rt)
        assert len(nj) == len(nt)
        for x, y in zip(nj, nt):
            np.testing.assert_array_equal(x.config, y.config)
            np.testing.assert_allclose(x.pose.position, y.pose.position, atol=1e-6, rtol=0)
            np.testing.assert_allclose(x.pose.quaternion, y.pose.quaternion, atol=1e-6, rtol=0)
        assert rj.bit_generator.state == rt.bit_generator.state
    assert je.funnel == te.funnel


ROWS = 32   # candidates are checked in one padded batch: one JAX compile per scene shape
_jax_errors = jax.jit(jik.pose_errors)


def _padded(rows):
    rows = np.asarray(rows, np.float32)
    assert len(rows) <= ROWS
    return jnp.asarray(np.concatenate([rows, rows[:1].repeat(ROWS - len(rows), 0)]))


def _free(cands, scene, margin):
    return np.asarray(_jax_free_space(_padded([c.config for c in cands]), scene, margin))[:len(cands)]


@pytest.mark.parametrize("name", list(jenvs.ENVIRONMENTS))
def test_port_ik_end_to_end(name):
    """The port's own IK on the CPU: every kept configuration reaches its
    pose; the additional and neutral candidates, solved in the final scene,
    are free there (a dresser's start candidate is solved before the target
    drawer opens, in both packages, so only its pose is checked); two demo
    candidates; the funnel adds up."""
    rng = np.random.default_rng(100)
    env = tenvs.ENVIRONMENTS[name](device="cpu")
    for _ in range(10):   # a dresser with one drawer, or no free candidate, is refused
        if env.gen(rng):
            break
    assert len(env.demo_candidates) == 2
    extra = env.gen_candidates(rng, 4)
    f = env.funnel
    assert f["poses"] >= f["ik_solved"] >= f["free"] >= f["kept"] >= len(extra) + 2
    cands = env.demo_candidates + extra
    rot = np.stack([c.pose.matrix[:3, :3] for c in cands]).astype(np.float32)
    trans = np.stack([c.pose.position for c in cands]).astype(np.float32)
    pos, ori = map(np.asarray, _jax_errors(_padded([c.config for c in cands]), _padded(rot),
                                           _padded(trans)))
    assert np.all(pos < jik.POS_TOL + EDGE) and np.all(ori < jik.ORI_TOL + EDGE)
    scene = jsc.SceneSet(*(jnp.asarray(t[0].numpy()) for t in env.scene_set()))
    if extra:
        assert _free(extra, scene, -EDGE).all()
    neutral = env.gen_neutral_candidates(5, rng)
    if neutral:
        assert _free(neutral, scene, 0.01 - EDGE).all()


# ---- tests/test_envs.py, on the port ----------------------------------------

def _axes(pose):
    m = pose.matrix
    return m[:3, 0], m[:3, 1], m[:3, 2]


def test_cubby_candidates_horizontal_approach():
    """Cubby approach axis z = [cos t, sin t, 0], |t| <= pi/4, finger axis
    x = [0, 0, -1] (cubby_environment.py:532-541)."""
    from mpinets_torch.envs.cubby import CubbyEnvironment

    rng = np.random.default_rng(0)
    env = CubbyEnvironment(device="cpu")
    env.params = env.params or None
    from mpinets_torch.envs.cubby import CubbyParams

    env.params = CubbyParams.random(rng)
    env._build()
    poses = env.sample_candidate_poses(rng, 32)
    for p in poses:
        x, y, z = _axes(p)
        assert abs(z[2]) < 1e-9, "approach must be horizontal"
        assert z[0] >= np.cos(np.pi / 4) - 1e-6, "approach within +-45 deg of +x"
        np.testing.assert_allclose(x, [0.0, 0.0, -1.0], atol=1e-9)


def test_dresser_candidates_downward_approach():
    """Dresser approach z = [0, 0, -1], finger axis horizontal with
    |theta| <= pi/4 (dresser_environment.py:481-491)."""
    from mpinets_torch.envs.dresser import DresserEnvironment

    rng = np.random.default_rng(1)
    env = DresserEnvironment(device="cpu")
    env._sample(rng)
    if not env.open_drawers():
        env.drawers[0].open_frac = 0.8
    env._assemble()
    poses = env.sample_candidate_poses(rng, 32)
    assert poses
    for p in poses:
        x, y, z = _axes(p)
        np.testing.assert_allclose(z, [0.0, 0.0, -1.0], atol=1e-9)
        assert abs(x[2]) < 1e-9
        assert x[0] >= np.cos(np.pi / 4) - 1e-6


def test_tabletop_candidates_offset_distribution():
    """Tabletop candidate z-offsets above the support surface lie in
    [0.01, 0.12] with decreasing density (tabletop_environment.py:386)."""
    from mpinets_torch.envs.tabletop import TabletopEnvironment

    rng = np.random.default_rng(2)
    env = TabletopEnvironment(device="cpu")
    env._setup_tables(rng)
    env._place_objects(rng, 5)
    poses = env.sample_candidate_poses(rng, 256)
    # compare against table/object top heights: offset bounds
    table_top = max(
        t.center[2] + t.dims[2] / 2 for t in env.task_tables
    )
    zs = np.array([p.position[2] for p in poses])
    tops = []
    for o in env._objects:
        if hasattr(o, "dims"):
            tops.append(o.center[2] + o.dims[2] / 2)
        else:
            tops.append(o.center[2] + o.height / 2)
    max_top = max([table_top] + tops)
    assert np.all(zs >= table_top + 0.01 - 1e-9)
    assert np.all(zs <= max_top + 0.12 + 1e-9)
    # linearly-decreasing offset density: the mean offset of the points on
    # the bare table must sit below the uniform midpoint
    bare = zs[zs <= table_top + 0.12]
    off = bare - table_top
    assert off.mean() < 0.01 + (0.12 - 0.01) * 0.45
    # roll distribution: downward-pointing gripper family
    down = [(_axes(p)[2] @ np.array([0, 0, -1])) for p in poses]
    assert np.mean(np.array(down) > 0.5) > 0.9


def test_tabletop_scene_distribution_envelopes():
    """Reference distribution envelopes (tabletop_environment.py:215-330,
    404-441): table heights, front-table extents, task/clear split, object
    counts/dims, mount table presence."""
    from mpinets_torch.envs.tabletop import TabletopEnvironment

    rng = np.random.default_rng(7)
    heights, side_count, obj_counts = [], 0, []
    for _ in range(20):
        env = TabletopEnvironment(device="cpu")
        env._setup_tables(rng)
        n = int(rng.integers(3, 15))
        env._place_objects(rng, n)
        front = env.task_tables[0]
        surface_z = front.center[2] + front.dims[2] / 2
        heights.append(surface_z)
        # slab is a solid block from z=-0.02 to the surface
        assert abs((front.center[2] - front.dims[2] / 2) - (-0.02)) < 1e-9
        # front table x extent: [0.275..0.375, 1.275..1.375]
        x0 = front.center[0] - front.dims[0] / 2
        x1 = front.center[0] + front.dims[0] / 2
        assert 0.275 - 1e-9 <= x0 <= 0.375 + 1e-9
        assert 1.275 - 1e-9 <= x1 <= 1.375 + 1e-9
        # task region is 55-65% of the full front-table y extent
        clear = env.clear_tables[0]
        total_y = front.dims[1] + clear.dims[1]
        assert 0.55 - 1e-6 <= front.dims[1] / total_y <= 0.65 + 1e-6
        if len(env.task_tables) == 2:
            side_count += 1
        # mount table under the robot: last clear slab, contains the origin
        mount = env.clear_tables[-1]
        assert abs(mount.center[0]) < mount.dims[0] / 2
        assert abs(mount.center[1]) < mount.dims[1] / 2
        obj_counts.append(len(env._objects))
        for o in env._objects:
            if hasattr(o, "dims"):
                assert 0.05 - 1e-6 <= o.dims[0] <= 0.15 + 1e-6
                assert 0.05 - 1e-6 <= o.dims[2] <= 0.35 + 1e-6
            else:
                assert 0.05 - 1e-6 <= o.radius <= 0.15 + 1e-6
                assert 0.05 - 1e-6 <= o.height <= 0.35 + 1e-6
    # height mix: 0 w.p. 0.35, else U(0, 0.4)
    heights = np.array(heights)
    assert np.all((heights >= -1e-9) & (heights <= 0.4 + 1e-9))
    assert (heights < 1e-9).sum() >= 2  # some flat-floor tables
    assert (heights > 0.05).sum() >= 5  # some raised tables
    # L-shape roughly half the time
    assert 3 <= side_count <= 17
    assert min(obj_counts) >= 1 and max(obj_counts) <= 14


def test_cubby_scene_distribution_envelopes():
    """Reference cubby geometry envelopes (cubby_environment.py:62-72,
    124-264): extents, panel count, asymmetric splits, center-pivot yaw."""
    from mpinets_torch.envs.cubby import CubbyEnvironment, CubbyParams

    rng = np.random.default_rng(11)
    for _ in range(20):
        env = CubbyEnvironment(device="cpu")
        p = CubbyParams.random(rng)
        env.params = p
        env._build()
        assert 0.6 <= p.left <= 0.8 and -0.8 <= p.right <= -0.6
        assert 0.45 <= p.front <= 0.65
        assert 0.15 - 1e-9 <= p.back - p.front <= 0.55 + 1e-9
        assert 0.35 <= p.mid_h_z <= 0.55 and -0.1 <= p.mid_v_y <= 0.1
        assert abs(p.rotation) <= np.pi / 18 + 1e-9
        # full cubby: back + 2 shelves + 2 side walls + wall + shelf = 7
        assert len(env.obstacles) == 7
        assert len(env.support_volumes()) == 4
        # center-pivot rotation: the cabinet center is a fixed point
        np.testing.assert_allclose(p.world_point(p.center), p.center,
                                   atol=1e-12)
        # pocket index layout: {0,1} share a z level, {0,2} share a y side
        sv = env.support_volumes()
        assert abs(sv[0].center[2] - sv[1].center[2]) < 1e-9
        assert sv[2].center[2] > sv[0].center[2]


def test_merged_cubby_drops_dividers():
    """MergedCubbyEnvironment zeroes the divider(s) separating the two
    chosen pockets (cubby_environment.py:660-704)."""
    from mpinets_torch.envs.cubby import MergedCubbyEnvironment

    rng = np.random.default_rng(3)
    done = False
    for _ in range(8):
        env = MergedCubbyEnvironment(device="cpu")
        if not env.gen(rng):
            continue
        done = True
        i, j = env._pockets_chosen
        p = env.params
        if (i in (0, 1)) != (j in (0, 1)):
            assert p.middle_shelf_thickness == 0.0
        if (i in (0, 2)) != (j in (0, 2)):
            assert p.center_wall_thickness == 0.0
        # fewer panels than the full 7
        assert len(env.obstacles) < 7
        assert len(env.support_volumes()) < 4
        break
    assert done, "merged cubby never generated"


def test_dresser_recursive_split_envelopes():
    """Reference dresser distributions (dresser_environment.py:198-223,
    967-1085): dims, recursive midpoint splits, leaf sizes, wall budget."""
    from mpinets_torch.envs.dresser import DresserEnvironment, MIN_CELL

    rng = np.random.default_rng(5)
    leaf_counts = []
    for _ in range(30):
        env = DresserEnvironment(device="cpu")
        env._sample(rng)
        assert 0.8 <= env.width <= 1.2
        assert 0.2 <= env.depth <= 0.4
        assert 0.55 <= env.height <= 0.85
        assert abs(env.yaw - np.pi) <= np.pi / 3 + 1e-9
        leaf_counts.append(len(env.drawers))
        for dr in env.drawers:
            w = dr.y1 - dr.y0
            h = dr.z1 - dr.z0
            # a leaf is only produced when it cannot be split further or the
            # split coin failed; either way halving stops near MIN_CELL
            assert w > MIN_CELL / 2 - 0.02 and h > MIN_CELL / 8
            assert w <= env.width + 1e-9 and h <= env.height + 1e-9
    counts = np.array(leaf_counts)
    # recursion produces a spread of drawer counts, frequently > 2
    assert counts.min() >= 1
    assert counts.max() >= 4
    assert (counts >= 2).mean() > 0.6


def test_dresser_gen_opens_start_and_target():
    """gen() pulls exactly the two chosen drawers fully open
    (dresser_environment.py:83-176,410-421)."""
    from mpinets_torch.envs.dresser import DresserEnvironment

    rng = np.random.default_rng(9)
    ok = False
    for _ in range(6):
        env = DresserEnvironment(device="cpu")
        if env.gen(rng):
            ok = True
            opened = env.open_drawers()
            assert len(opened) == 2
            assert all(d.open_frac == 1.0 for d in opened)
            assert len(env.demo_candidates) == 2
            # each candidate lies inside one of the two support volumes
            sv = env.support_volumes()
            for cand in env.demo_candidates:
                assert any(s.sdf(cand.pose.position) < 0 for s in sv)
            break
    assert ok, "dresser never generated"
