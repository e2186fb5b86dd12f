"""The one traffic generator: planning problems drawn from a seed, with the
parameters of a traffic file (``benchmark/traffic/<name>.json``).

A frozen copy of the tabletop draws of ``mpinets_torch/data/synthetic.py``
(``random_scene``, ``random_configuration``, ``random_problem_batch``; the
same distributions, after the reference's ``TabletopEnvironment``), with
every range read from the file's ``scene`` group, so that a later traffic
mix is a new data file. Targets are the end-effector poses of uniform goal
configurations, by the reference's forward kinematics. Everything is drawn
on the device from one ``torch.Generator``.
"""

from __future__ import annotations

import hashlib
import math

import torch

from benchmark.reference import robot

def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed, so that uses never share
    draws and every whole number is a valid run seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(subseed(seed, tag))


def _uniform(g, shape, lo, hi, device):
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    return lo + torch.rand(tuple(shape), generator=g, device=device) * (hi - lo)


def configurations(g, batch, device):
    lo, hi = robot.limits(device)
    return lo + torch.rand((batch, robot.DOF), generator=g, device=device) * (hi - lo)


def scenes(g, batch, p, device):
    """A batch of tabletop scenes: a table slab and, on it, 1 to
    ``max_cuboids - 1`` boxes and 0 to ``max_cylinders`` cylinders, axis
    aligned; unused slots are zero-volume padding. -> dict of SceneSet
    fields."""
    b = batch
    centre = (torch.tensor(p["table_center"], device=device)
              + _uniform(g, (b, 3), -1.0, 1.0, device) * torch.tensor(p["table_center_jitter"],
                                                                       device=device))
    dims = torch.tensor(p["table_dims"], device=device) + _uniform(
        g, (b, 3), 0.0, p["table_dims_extra"], device)
    top = centre[:, 2] + dims[:, 2] / 2
    m1, m2 = p["max_cuboids"], p["max_cylinders"]
    n_cub = torch.randint(1, m1, (b,), generator=g, device=device)
    n_cyl = torch.randint(0, m2 + 1, (b,), generator=g, device=device)
    m = m1 - 1
    cub_xy = _uniform(g, (b, m, 2), p["xy_lo"], p["xy_hi"], device)
    live = (torch.arange(m, device=device) < n_cub[:, None]).float()
    cub_dims = _uniform(g, (b, m, 3), *p["cuboid_side"], device) * live[..., None]
    cub_centres = torch.cat([cub_xy, (top[:, None] + cub_dims[..., 2] / 2)[..., None]], -1)
    cyl_xy = _uniform(g, (b, m2, 2), p["xy_lo"], p["xy_hi"], device)
    cyl_live = (torch.arange(m2, device=device) < n_cyl[:, None]).float()[..., None]
    cyl_r = _uniform(g, (b, m2, 1), *p["cylinder_radius"], device) * cyl_live
    cyl_h = _uniform(g, (b, m2, 1), *p["cylinder_height"], device) * cyl_live
    ident = lambda k: torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).expand(b, k, 4).clone()
    return {
        "cuboid_centers": torch.cat([centre[:, None], cub_centres], 1),
        "cuboid_dims": torch.cat([dims[:, None], cub_dims], 1),
        "cuboid_quats": ident(m1),
        "cylinder_centers": torch.cat([cyl_xy, top[:, None, None] + cyl_h / 2], -1),
        "cylinder_radii": cyl_r,
        "cylinder_heights": cyl_h,
        "cylinder_quats": ident(m2),
    }


def problems(g, traffic, device):
    """One batch of ``traffic["batch"]`` planning problems: scenes, start
    configurations, and targets at the pose of uniform goal configurations.
    -> dict (the scene fields, q0, target_rot, target_trans)."""
    b = traffic["batch"]
    out = scenes(g, b, traffic["scene"], device)
    out["q0"] = configurations(g, b, device)
    out["target_rot"], out["target_trans"] = robot.eff_pose(configurations(g, b, device))
    return out


def _categorical(weights, num, g):
    """``num`` draws per row of [..., K] weights by the inverse CDF."""
    cdf = torch.cumsum(weights.movedim(-1, 0), dim=0).movedim(0, -1)
    u = torch.rand(weights.shape[:-1] + (num,), generator=g, dtype=weights.dtype,
                   device=weights.device)
    pick = torch.searchsorted(cdf.contiguous(), (u * cdf[..., -1:]).contiguous(), right=True)
    return torch.clamp(pick, max=weights.shape[-1] - 1)


def obstacle_draws(g, scene, num):
    """The random numbers behind an obstacle cloud, one entry per point: the
    primitive by surface area, the face (or cap against side) by area, and
    uniform surface coordinates. A frozen copy of
    ``mpinets_torch/geom/scene.py::draw_obstacle_samples``. -> dict of
    ObstacleDraws fields."""
    dims = scene["cuboid_dims"]
    m1, m2 = dims.shape[1], scene["cylinder_radii"].shape[1]
    nonzero = torch.all(dims.abs() > 1e-8, dim=-1)
    cub_area = 2.0 * (dims[..., 0] * dims[..., 1] + dims[..., 0] * dims[..., 2]
                      + dims[..., 1] * dims[..., 2])
    r, h = scene["cylinder_radii"][..., 0], scene["cylinder_heights"][..., 0]
    cyl_area = 2.0 * math.pi * r * h + 2.0 * math.pi * r * r
    areas = torch.cat([torch.where(nonzero, cub_area, torch.zeros_like(cub_area)),
                       torch.where((r.abs() > 1e-8) & (h.abs() > 1e-8), cyl_area,
                                   torch.zeros_like(cyl_area))], -1)
    which = _categorical(areas + 1e-12, num, g)
    pick = lambda t, i: torch.take_along_dim(t, i[..., None], dim=-2)
    d = pick(dims, torch.clamp(which, 0, m1 - 1))
    face_areas = torch.stack([d[..., 1] * d[..., 2], d[..., 0] * d[..., 2],
                              d[..., 0] * d[..., 1]], -1)
    cyl = torch.clamp(which - m1, 0, m2 - 1)
    rr = pick(scene["cylinder_radii"], cyl)[..., 0]
    hh = pick(scene["cylinder_heights"], cyl)[..., 0]
    region = torch.stack([2.0 * math.pi * rr * hh, 2.0 * math.pi * rr * rr], -1)
    rand = lambda *tail: torch.rand(dims.shape[:1] + (num,) + tail, generator=g,
                                    dtype=dims.dtype, device=dims.device)
    return {
        "which": which,
        "cuboid_face": _categorical(face_areas + 1e-12, 1, g)[..., 0],
        "cuboid_positive": rand() < 0.5,
        "cuboid_uv": rand(3) * 2.0 - 1.0,
        "cylinder_on_cap": _categorical(region + 1e-12, 1, g)[..., 0] == 1,
        "cylinder_theta": rand() * (2.0 * math.pi),
        "cylinder_z": rand() - 0.5,
        "cylinder_r": rand(),
        "cylinder_top": rand() < 0.5,
    }


def training_draws(g, traffic, cfg, device):
    """The draws behind one training batch (a frozen copy of
    ``mpinets_torch/data/synthetic.py::draw_training_batch``): scenes, the
    trajectory's start and goal, the timestep, the joint noise, the robot
    points' bank indices and the obstacle draws. -> dict of TrainingDraws
    fields, the scene as a dict."""
    b = traffic["batch"]
    scene = scenes(g, b, traffic["scene"], device)
    q0 = configurations(g, b, device)
    q_goal = configurations(g, b, device)
    t = torch.randint(0, traffic["sequence_length"], (b,), generator=g, device=device)
    noise = torch.randn((b, robot.DOF), generator=g, device=device)
    robot_indices = torch.randint(0, traffic["robot_bank"], (b, cfg["points"]["robot"]),
                                  generator=g, device=device)
    obstacle = obstacle_draws(g, scene, cfg["points"]["obstacle"])
    return {"scene": scene, "q0": q0, "q_goal": q_goal, "t": t, "noise": noise,
            "robot_indices": robot_indices, "obstacle": obstacle}
