"""Collision-checker calibration: quantify the 57-sphere model's divergence
from a mesh-accurate checker.

Port of ``mpinets_tpu/eval/calibration.py``. The reference's Evaluator
declares environment collision from PyBullet MESH checks (low-def AND
high-def robots, ``mpinets/metrics.py:270-291``); the evaluator here uses the
57-sphere model (the reference's own training-time checker,
``mpinets/model.py:300-312``) against scene SDFs. Spheres circumscribe the
links, so the sphere check is CONSERVATIVE, and (57-sphere coverage being
imperfect) can in principle miss thin-feature contacts.

Two proxies of the true surface are tested for scene-SDF penetration: the
dense robot surface bank (``bank``, FK-posed samples derived from the
spheres) and the independent hull bank (``hull``, capsules + the gripper
mesh, :mod:`mpinets_torch.eval.hull_proxy`). Both run with the sphere check
over random configurations in random procedural scenes; the confusion
matrix bounds the eval-metric drift.

Draws are split from the construction: :func:`draw_batches` makes each
batch's 256 scenes and configurations from one ``torch.Generator`` seeded
with ``seed``, on the device; :func:`batch_clearances` maps a batch to each
configuration's clearance under both checks (a flag is clearance < 0, which
is the JAX package's ``any(d < threshold)``), all rows at once through
:func:`mpinets_torch.kernels.sdf.scene_sdf`. The draws follow the JAX
package's distributions, not its bits; the tests hand the construction
JAX's own draws.

Run: ``python -m mpinets_torch.eval.calibration [--samples 2048] [--seed 0]
[--proxy {bank,hull}] [--device cuda]`` (``cuda`` unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpinets_torch.data.synthetic import random_configuration, random_scene
from mpinets_torch.eval import hull_proxy
from mpinets_torch.geom.scene import SceneSet
from mpinets_torch.kernels import kinematics, sdf
from mpinets_torch.robot import sampler
from mpinets_torch.utils.device import resolve_device

#: Configurations (each in its own scene) per batch, as the JAX package's.
BATCH = 256
#: Points of the dense surface and hull banks.
BANK_POINTS = 4096
#: Rows per SDF call: a [rows, 4096, 8, 3] point-to-primitive intermediate
#: stays at 100 MB.
ROWS_PER_CALL = 64


class CalibrationDraws(NamedTuple):
    """One batch: a scene per configuration."""

    scene: SceneSet   # [BATCH] rows
    q: torch.Tensor   # [BATCH, 7]

    def to(self, device) -> "CalibrationDraws":
        return CalibrationDraws(self.scene.to(device), self.q.to(device))


def draw_batches(samples: int = 2048, seed: int = 0, device=None) -> List[CalibrationDraws]:
    """``max(samples // 256, 1)`` batches from one generator on ``device``."""
    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(seed)
    out = []
    for _ in range(max(samples // BATCH, 1)):
        scene = random_scene(g, BATCH, device=device)
        out.append(CalibrationDraws(scene, random_configuration(g, (BATCH,), device)))
    return out


def sphere_clearance(q: torch.Tensor, scene) -> torch.Tensor:
    """min over the scene spheres of SDF - radius; q [..., 7] -> [...]."""
    radii = kinematics.franka_table("SCENE_SPHERE_RADII", q.dtype, q.device)
    d = sdf.scene_sdf(kinematics.scene_collision_spheres(q), scene)
    return (d - radii).amin(-1)


def surface_clearance(q: torch.Tensor, scene, num_points: int = BANK_POINTS) -> torch.Tensor:
    """min SDF over the dense surface bank ("full", derived from the 57
    spheres, so it cannot see sphere-coverage misses)."""
    return sdf.scene_sdf(sampler.bank_point_cloud(q, "full", num_points), scene).amin(-1)


@functools.lru_cache(maxsize=None)
def _hull_table(inflate: float, dtype: torch.dtype, device: torch.device, path):
    """Frame-sorted hull points on the device, made once per (inflate,
    dtype, device, mesh): a copy from the host waits for the card."""
    bank = hull_proxy.inflate_bank(hull_proxy.hull_bank(BANK_POINTS, path=path), inflate)
    order, groups = sampler._group_slices(bank.frames)
    return torch.as_tensor(bank.points[order], dtype=dtype, device=device), groups


def _posed_hull(q: torch.Tensor, inflate: float, path=None) -> torch.Tensor:
    """World positions of the hull bank. q: [..., 7] -> [..., P, 3]."""
    pts, groups = _hull_table(float(inflate), q.dtype, q.device, path)
    rots, transs = kinematics.fk_frames(q)
    return torch.cat([torch.einsum("...ij,pj->...pi", rots[..., f, :, :], pts[a:b])
                      + transs[..., f, None, :] for f, a, b in groups], dim=-2)


def hull_clearance(q: torch.Tensor, scene, inflate: float = 1.0, path=None) -> torch.Tensor:
    """min SDF over the independent hull bank (shares no geometry with the
    57-sphere table)."""
    return sdf.scene_sdf(_posed_hull(q, inflate, path), scene).amin(-1)


def sphere_collision(q, scene, margin: float = 0.0) -> torch.Tensor:
    """Evaluator semantics: any collision sphere penetrates the scene."""
    return sphere_clearance(q, scene) < margin


def surface_collision(q, scene, num_points: int = BANK_POINTS, margin: float = 0.0):
    """Sphere-bank proxy: any dense surface sample penetrates the scene."""
    return surface_clearance(q, scene, num_points) < margin


def hull_collision(q, scene, inflate: float = 1.0, margin: float = 0.0, path=None):
    """Independent-proxy semantics: any hull-bank sample penetrates."""
    return hull_clearance(q, scene, inflate, path) < margin


def batch_clearances(draws: CalibrationDraws, proxy: str = "bank", inflate: float = 1.0,
                     path=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sphere clearance [BATCH], surface or hull clearance [BATCH]) of one
    batch, on its device, ``ROWS_PER_CALL`` rows an SDF call."""
    if proxy not in ("bank", "hull"):
        raise ValueError(f"proxy must be 'bank' or 'hull', got {proxy!r}")
    sph, srf = [], []
    for lo in range(0, len(draws.q), ROWS_PER_CALL):
        rows = slice(lo, lo + ROWS_PER_CALL)
        q, scene = draws.q[rows], SceneSet(*(t[rows] for t in draws.scene))
        sph.append(sphere_clearance(q, scene))
        srf.append(hull_clearance(q, scene, inflate, path) if proxy == "hull"
                   else surface_clearance(q, scene))
    return torch.cat(sph), torch.cat(srf)


def clearances(draws: List[CalibrationDraws], proxy: str = "bank", inflate: float = 1.0,
               path=None) -> Tuple[np.ndarray, np.ndarray]:
    """Every batch's clearances, on the host: (sphere [n], surface [n])."""
    with torch.no_grad():
        out = [batch_clearances(d, proxy, inflate, path) for d in draws]
    return (torch.cat([a for a, _ in out]).cpu().numpy(),
            torch.cat([b for _, b in out]).cpu().numpy())


def summarize(sph: np.ndarray, srf: np.ndarray, proxy: str = "bank",
              inflate: float = 1.0) -> dict:
    """The confusion matrix of two flag vectors (the JAX package's keys
    and formulas)."""
    n = len(sph)
    both = int(np.sum(sph & srf))
    sphere_only = int(np.sum(sph & ~srf))   # conservative false alarms
    surface_only = int(np.sum(~sph & srf))  # sphere-coverage misses
    return {
        "proxy": proxy,
        "inflate": inflate,
        "samples": n,
        "surface_collision_rate": float(srf.mean()),
        "sphere_collision_rate": float(sph.mean()),
        "agree_rate": float(np.mean(sph == srf)),
        "both": both,
        "sphere_only": sphere_only,
        "surface_only": surface_only,
        # Of true (surface) collisions, how many the sphere check catches:
        "sphere_recall": float(both / max(srf.sum(), 1)),
        # Of sphere alarms, how many are true surface collisions:
        "sphere_precision": float(both / max(sph.sum(), 1)),
    }


def calibrate(samples: int = 2048, seed: int = 0, proxy: str = "bank", inflate: float = 1.0,
              device=None, draws: Optional[List[CalibrationDraws]] = None,
              path=None) -> dict:
    """Draw (or take ``draws``), check and summarize on ``device`` (default
    ``cuda``; given ``draws`` run on theirs). ``path``: the gripper mesh for
    the hull proxy (default :data:`hull_proxy.GRIPPER_STL`)."""
    if draws is None:
        draws = draw_batches(samples, seed, device)
    sph, srf = clearances(draws, proxy, inflate, path)
    return summarize(sph < 0, srf < 0, proxy, inflate)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--proxy", choices=("bank", "hull"), default="hull")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    draws = draw_batches(args.samples, args.seed, args.device)
    if args.proxy == "hull":
        for inflate in (0.9, 1.0, 1.1):
            print(json.dumps(calibrate(proxy="hull", inflate=inflate, draws=draws), indent=2))
    else:
        print(json.dumps(calibrate(draws=draws), indent=2))


if __name__ == "__main__":
    main()
