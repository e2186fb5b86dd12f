"""Port parity: the evaluation extras -- ``mpinets_torch.eval.hull_proxy``,
``calibration``, ``visualize``, ``compare`` and ``pipeline.gen``'s
``--visualize-scene`` -- against ``mpinets_tpu``'s.

* hull proxy: a synthetic binary STL (a box hand and two box fingers at
  the real gripper's extents) stands in for the reference's mesh, with
  ``GRIPPER_STL`` pointed at it in both packages and both caches cleared in
  both; the mesh, the samples, ``hull_bank(2048)`` and ``inflate_bank`` at
  0.9 and 1.1 are bit-equal.
* calibration on JAX's draws (``_batch``'s key split replayed): the flags of
  the sphere, bank and hull checks equal JAX's except where a clearance is
  within 1e-5 of its threshold (those rows are counted and printed); the
  summary dict equals JAX's given equal flags.
* viewer: the page outside ``DATA`` equal, ``DATA``'s keys equal and its
  arrays within 1e-4: at most one unit of the 4th decimal apart (a tie
  there can round either way).
* compare: equal reports from both packages on the same dicts and pickles,
  but for the JAX package's NaN-against-NaN entries (a mean over no
  successes), which the port counts as agreement.
* gen: tabletop, seed 0, JAX's IK and JAX's planner draws: the demo plan
  within 1e-5 of JAX's ``visualize_scene`` plan, the page's ``DATA`` within
  1e-4.
"""

import functools
import json
import pickle
import struct

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_envs import _jax_ik, memo  # noqa: E402,F401  (tests dir is on sys.path)
from test_torch_eval import CASES, _evaluate_both  # noqa: E402
from test_torch_expert import _jax_via_draws  # noqa: E402

from mpinets_torch import types as T  # noqa: E402
from mpinets_torch.envs import base as tbase  # noqa: E402
from mpinets_torch.eval import calibration as tcal  # noqa: E402
from mpinets_torch.eval import compare as tcmp  # noqa: E402
from mpinets_torch.eval import hull_proxy as thp  # noqa: E402
from mpinets_torch.eval import visualize as tvis  # noqa: E402
from mpinets_torch.geom.scene import SceneSet  # noqa: E402
from mpinets_torch.pipeline import expert as te  # noqa: E402
from mpinets_torch.pipeline import gen as tgen  # noqa: E402
from mpinets_tpu import types as JT  # noqa: E402
from mpinets_tpu.data.synthetic import random_configuration, random_scene  # noqa: E402
from mpinets_tpu.envs import base as jbase  # noqa: E402
from mpinets_tpu.eval import calibration as jcal  # noqa: E402
from mpinets_tpu.eval import compare as jcmp  # noqa: E402
from mpinets_tpu.eval import hull_proxy as jhp  # noqa: E402
from mpinets_tpu.eval import visualize as jvis  # noqa: E402
from mpinets_tpu.pipeline import expert as je  # noqa: E402
from mpinets_tpu.pipeline import gen as jgen  # noqa: E402

NEAR = 1e-5  # clearance band where float rounding may flip a flag


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# A synthetic gripper mesh
# ---------------------------------------------------------------------------

def _box(lo, hi):
    """12 triangles of an axis-aligned box."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    v = np.array([[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    return [v[[a, b, c]] for a, b, c, d in quads] + [v[[a, c, d]] for a, b, c, d in quads]


def write_stl(path):
    """A binary STL in the right_gripper frame at the real gripper's
    extents: hand z in [-0.126, -0.05], fingers up to z = 0.012, y to ±0.1."""
    tris = (_box((-0.03, -0.1, -0.126), (0.03, 0.1, -0.05))
            + _box((-0.01, 0.06, -0.05), (0.01, 0.1, 0.012))
            + _box((-0.01, -0.1, -0.05), (0.01, -0.06, 0.012)))
    with open(path, "wb") as f:
        f.write(b"synthetic gripper".ljust(80, b"\0") + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<12fH", 0.0, 0.0, 0.0, *np.asarray(t, np.float32).ravel(), 0))
    return str(path)


def _clear_caches():
    for mod in (thp, jhp):
        mod.load_gripper_mesh.cache_clear()
        mod.hull_bank.cache_clear()
    tcal._hull_table.cache_clear()


@pytest.fixture
def stl(tmp_path, monkeypatch):
    path = write_stl(tmp_path / "gripper.stl")
    monkeypatch.setattr(thp, "GRIPPER_STL", path)
    monkeypatch.setattr(jhp, "GRIPPER_STL", path)
    _clear_caches()
    yield path
    _clear_caches()


# ---------------------------------------------------------------------------
# hull_proxy
# ---------------------------------------------------------------------------

def test_mesh_and_samples_bit_equal(stl):
    tri = thp.load_gripper_mesh()
    np.testing.assert_array_equal(tri, jhp.load_gripper_mesh())
    assert tri.shape == (36, 3, 3) and tri.dtype == np.float32
    np.testing.assert_array_equal(thp.sample_mesh_surface(tri, 500, np.random.default_rng(3)),
                                  jhp.sample_mesh_surface(tri, 500, np.random.default_rng(3)))
    assert thp.ARM_CAPSULES == jhp.ARM_CAPSULES
    for _, p0, p1, r in thp.ARM_CAPSULES:
        np.testing.assert_array_equal(
            thp.sample_capsule_surface(np.array(p0), np.array(p1), r, 300,
                                       np.random.default_rng(4)),
            jhp.sample_capsule_surface(np.array(p0), np.array(p1), r, 300,
                                       np.random.default_rng(4)))


def test_hull_bank_and_inflate_bit_equal(stl):
    ours, ref = thp.hull_bank(2048), jhp.hull_bank(2048)
    np.testing.assert_array_equal(ours.points, ref.points)
    np.testing.assert_array_equal(ours.frames, ref.frames)
    for inflate in (0.9, 1.1):
        a, b = thp.inflate_bank(ours, inflate), jhp.inflate_bank(ref, inflate)
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.frames, b.frames)
    # the path argument reads the same file without the module global
    np.testing.assert_array_equal(thp.hull_bank(2048, path=stl).points, ours.points)


def test_missing_mesh_raises_naming_the_path(tmp_path):
    absent = str(tmp_path / "absent.stl")
    with pytest.raises(FileNotFoundError, match="absent.stl"):
        thp.load_gripper_mesh(absent)
    with pytest.raises(FileNotFoundError, match="absent.stl"):
        tcal.calibrate(256, proxy="hull", device="cpu", path=absent)


def test_real_gripper_mesh_extents():
    import os

    if not os.path.exists(thp.GRIPPER_STL):
        pytest.skip(f"the reference's gripper mesh is absent: {thp.GRIPPER_STL}")
    pts = thp.load_gripper_mesh().reshape(-1, 3)
    assert -0.14 < pts[:, 2].min() < -0.11 and 0.0 < pts[:, 2].max() < 0.03
    assert 0.09 < pts[:, 1].max() < 0.12


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _jax_draws(seed, i):
    """``mpinets_tpu.eval.calibration._batch``'s draws of batch i."""
    ks, kq = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), i))
    scenes = jax.vmap(random_scene)(jax.random.split(ks, 256))
    qs = random_configuration(kq, (256,))
    return tcal.CalibrationDraws(SceneSet(*(torch.from_numpy(np.array(x)) for x in scenes)),
                                 torch.from_numpy(np.array(qs)))


@pytest.mark.parametrize("proxy,inflate", [("bank", 1.0), ("hull", 0.9), ("hull", 1.0),
                                           ("hull", 1.1)])
def test_calibration_flags_on_jaxs_draws(stl, proxy, inflate):
    draws = _jax_draws(0, 0)
    sph_gap, srf_gap = tcal.clearances([draws], proxy, inflate)
    ref_sph, ref_srf = map(np.asarray, jcal._batch(jax.random.fold_in(jax.random.PRNGKey(0), 0),
                                                   proxy, inflate))
    far_sph, far_srf = np.abs(sph_gap) > NEAR, np.abs(srf_gap) > NEAR
    np.testing.assert_array_equal((sph_gap < 0)[far_sph], ref_sph[far_sph])
    np.testing.assert_array_equal((srf_gap < 0)[far_srf], ref_srf[far_srf])
    print(f"{proxy} {inflate}: rows within {NEAR} of the threshold: "
          f"sphere {int((~far_sph).sum())}, surface {int((~far_srf).sum())} of 256")
    assert 0 < ref_srf.sum() < 256 and 0 < ref_sph.sum() < 256  # both outcomes occur
    # given equal flags, the summary is JAX's
    assert tcal.summarize(ref_sph, ref_srf, proxy, inflate) == jcal.calibrate(
        256, 0, proxy, inflate)


def test_calibration_entry_point_on_the_cpu(stl, capsys, monkeypatch):
    tcal.main(["--samples", "256", "--proxy", "bank", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["samples"] == 256 and out["proxy"] == "bank"
    assert out.keys() == jcal.calibrate(256, 0, "bank").keys()
    draws = tcal.draw_batches(256, 0, "cpu")
    assert len(draws) == 1 and draws[0].q.shape == (256, 7)
    assert tcal.calibrate(draws=draws) == out  # the same draws from the same seed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.main(["--samples", "256"])


# ---------------------------------------------------------------------------
# visualize
# ---------------------------------------------------------------------------

def split_page(html):
    """(page without DATA, DATA)."""
    head, rest = html.split("const DATA = ", 1)
    data, tail = rest.split(";\nconst views", 1)
    return head + tail, json.loads(data)


def assert_data_close(ours, ref):
    """Keys equal; arrays at most one unit of their 4th decimal apart."""
    assert ours.keys() == ref.keys()
    for k in ref:
        if k in ("spheres", "radii", "ee"):
            units = np.abs(np.round(np.asarray(ours[k]) * 1e4) - np.round(np.asarray(ref[k]) * 1e4))
            assert units.max() <= 1, (k, units.max())
        else:
            assert ours[k] == ref[k], k


def test_write_html_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    traj = rng.uniform(-1.5, 1.5, (12, 7)).astype(np.float32)
    cub, cyl = ((0.6, 0.0, 0.2), (0.4, 0.6, 0.4), (1, 0, 0, 0)), ((0.4, 0.3, 0.3), 0.05, 0.2,
                                                                  (1, 0, 0, 0))
    target = [0.5, 0.1, 0.4]
    tvis.write_html(tmp_path / "t.html", torch.from_numpy(traj), cuboids=[T.Cuboid(*cub)],
                    cylinders=[T.Cylinder(*cyl)], target_position=target)
    jvis.write_html(tmp_path / "j.html", traj, cuboids=[JT.Cuboid(*cub)],
                    cylinders=[JT.Cylinder(*cyl)], target_position=target)
    ours, ref = (split_page((tmp_path / f"{x}.html").read_text()) for x in "tj")
    assert ours[0] == ref[0]
    assert_data_close(ours[1], ref[1])
    assert len(ours[1]["spheres"]) == 12 and len(ours[1]["spheres"][0]) == 57
    # an array trajectory runs on the device asked for
    tvis.write_html(tmp_path / "a.html", traj, device="cpu")


def test_visualize_demo_entry_point(tmp_path, monkeypatch, capsys):
    tvis.main([str(tmp_path / "demo.html"), "--demo", "--device", "cpu"])
    page, data = split_page((tmp_path / "demo.html").read_text())
    assert len(data["spheres"]) == 50 and data["target"] is not None
    assert "wrote" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.main([str(tmp_path / "x.html"), "--demo"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.write_html(tmp_path / "x.html", np.zeros((2, 7), np.float32))


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

def _without_nan_pairs(report):
    """The JAX package's report less its NaN-against-NaN entries, which
    the port counts as agreement."""
    return {g: bad if g == "__missing_groups__" else
            [x for x in bad if not (np.isnan(x[2]) and np.isnan(x[3]))]
            for g, bad in report.items()}


def test_compare_reports_match_jax(tmp_path, capsys):
    ev, jev = _evaluate_both(CASES)
    ev.save(tmp_path, "port")
    jev.save(tmp_path, "jax")
    port, ref = tmp_path / "port_metrics.pkl", tmp_path / "jax_metrics.pkl"
    for a, b in ((port, ref), (ref, port), (port, port)):
        ours, theirs = tcmp.compare_files(a, b), jcmp.compare_files(a, b)
        assert ours == _without_nan_pairs(theirs)
        assert set(ours) == set(CASES) and not any(ours.values())
        assert any(theirs.values())  # JAX's flags NaN against NaN
    # a drifted copy, as metric dicts: flagged alike by both packages
    metrics = {k: ev.metrics(g) for k, g in ev.groups.items()}
    drift = {k: dict(m) for k, m in metrics.items()}
    drift["success"].update(total=metrics["success"]["total"] + 1,
                            success=metrics["success"]["success"] - 1.0)
    drift["success"]["eff position path length"] = (
        1.2 * np.asarray(metrics["success"]["eff position path length"]))
    del drift["frozen_tail"]
    with open(tmp_path / "drift.pkl", "wb") as f:
        pickle.dump(drift, f)
    for a, b in ((tmp_path / "drift.pkl", port), (port, tmp_path / "drift.pkl")):
        ours = tcmp.compare_files(a, b)
        assert ours == _without_nan_pairs(jcmp.compare_files(a, b)) and any(ours.values())
    bad = tcmp.compare_metric_dicts(drift["success"], metrics["success"])
    assert bad == _without_nan_pairs(
        {"g": jcmp.compare_metric_dicts(drift["success"], metrics["success"])})["g"]
    assert {(k, tier) for k, tier, _, _ in bad} == {
        ("total", "exact"), ("success", "rate"), ("eff position path length", "value")}
    for args, code in (([port, ref], 0), ([tmp_path / "drift.pkl", port], 1)):
        with pytest.raises(SystemExit) as exc:
            tcmp.main([str(a) for a in args])
        assert exc.value.code == code
    out = capsys.readouterr().out
    assert "MISSING GROUPS: ['frozen_tail']" in out and "success: 3 disagreements" in out


# ---------------------------------------------------------------------------
# gen --visualize-scene
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_ik(memo, monkeypatch):  # noqa: F811
    port, ref = _jax_ik(memo)
    monkeypatch.setattr(tbase, "ik", port)
    monkeypatch.setattr(jbase, "ik", ref)
    pad = (48, 16)
    monkeypatch.setattr(tbase.Environment, "SCENE_PAD", pad)
    monkeypatch.setattr(jbase.Environment, "SCENE_PAD", pad)


PLAN = dict(opt_steps=2, n_vias=1)


def test_visualize_scene_matches_jax(jax_ik, tmp_path, monkeypatch, capsys):
    seen = {}
    plan = jax.jit(functools.partial(je.plan_pair_optimized, **PLAN))

    def jax_planner(q_start, q_goal, rot, trans, scene):
        seen["q"] = (np.asarray(q_start), np.asarray(q_goal))
        seen["res"] = plan(q_start, q_goal, rot, trans, scene)
        return seen["res"]

    monkeypatch.setattr(je, "plan_pair_optimized", jax_planner)
    jgen.visualize_scene("tabletop", tmp_path / "j.html", seed=0)
    ref = seen["res"]
    qa, qb = seen["q"]
    # the JAX planner's default key for this pair, and its via draws
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED),
                             jnp.sum(jnp.asarray(qa) * 1e4 + jnp.asarray(qb) * 1e3)
                             .astype(jnp.int32))
    u, n = (torch.from_numpy(np.array(x))[None] for x in _jax_via_draws(key))
    res = tgen.visualize_scene("tabletop", tmp_path / "t.html", seed=0, device="cpu",
                               plan_kwargs=dict(draws=te.PlanDraws(u, n), **PLAN))
    assert bool(res.valid[0]) == bool(ref.valid) and int(res.which[0]) == int(ref.which)
    np.testing.assert_allclose(res.trajectory[0].numpy(), ref.trajectory, atol=1e-5, rtol=0)
    ours, theirs = (split_page((tmp_path / f"{x}.html").read_text()) for x in "tj")
    assert ours[0] == theirs[0]
    assert_data_close(ours[1], theirs[1])
    out = capsys.readouterr().out
    assert out.count(f"demo plan valid={bool(ref.valid)} (family code {int(ref.which)})") == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["tabletop", "--output", str(tmp_path), "--visualize-scene", "x.html"])
