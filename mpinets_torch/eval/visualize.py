"""Trajectory visualization: self-contained HTML export.

Port of ``mpinets_tpu/eval/visualize.py`` (the same page, the same ``DATA``
keys, the same 4-decimal rounding). The reference visualizes evaluation
rollouts with Meshcat / PyBullet GUIs (``mpinets/run_inference.py:310-420``);
the stand-in renders to a dependency-free HTML file: three orthographic
views (top / front / side) with the scene primitives, the target, and an
animated robot trajectory drawn from the 57-sphere collision model. The
spheres and the end-effector path come from batched FK on the device.

Usage::

    python -m mpinets_torch.eval.visualize out.html --demo [--device cpu]
    # or from code:
    write_html(path, trajectory [T, 7], cuboids=[...], cylinders=[...],
               target_position=[x, y, z])
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from mpinets_torch import types as T
from mpinets_torch.data.synthetic import min_jerk_trajectory, random_configuration
from mpinets_torch.kernels import kinematics
from mpinets_torch.robot import franka
from mpinets_torch.utils.device import resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mpinets-tpu rollout</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #ddd; margin: 1em; }}
 canvas {{ background: #1b1b1f; border: 1px solid #333; margin: 4px; }}
 .row {{ display: flex; flex-wrap: wrap; }}
</style></head><body>
<h3>mpinets-tpu rollout ({T} steps)</h3>
<div class="row">
 <canvas id="top" width="420" height="420"></canvas>
 <canvas id="front" width="420" height="420"></canvas>
 <canvas id="side" width="420" height="420"></canvas>
</div>
<input type="range" id="t" min="0" max="{Tm1}" value="0" style="width:420px">
<button id="play">play</button> <span id="lbl"></span>
<script>
const DATA = {data};
const views = {{
  top:   {{ ax: 0, ay: 1, name: "top (x-y)" }},
  front: {{ ax: 0, ay: 2, name: "front (x-z)" }},
  side:  {{ ax: 1, ay: 2, name: "side (y-z)" }},
}};
const L = 2.4, OFF = 1.2;  // world window [-1.2, 1.2]
function px(c, v) {{ return (v + OFF) / L * c.width; }}
function py(c, v) {{ return c.height - (v + OFF) / L * c.height; }}
function drawView(id, t) {{
  const cv = document.getElementById(id), g = cv.getContext("2d");
  const {{ ax, ay, name }} = views[id];
  g.clearRect(0, 0, cv.width, cv.height);
  g.fillStyle = "#888"; g.fillText(name, 8, 14);
  g.strokeStyle = "#444";
  g.strokeRect(px(cv, -1.2), py(cv, 1.2), cv.width, cv.height);
  g.fillStyle = "#3a6ea5";
  for (const b of DATA.cuboids) {{
    const w = b.dims[ax] / L * cv.width, h = b.dims[ay] / L * cv.height;
    g.globalAlpha = 0.5;
    g.fillRect(px(cv, b.center[ax]) - w / 2, py(cv, b.center[ay]) - h / 2, w, h);
  }}
  g.fillStyle = "#3aa56e";
  for (const b of DATA.cylinders) {{
    const w = (ax === 2 ? b.height : 2 * b.radius) / L * cv.width;
    const h = (ay === 2 ? b.height : 2 * b.radius) / L * cv.height;
    g.fillRect(px(cv, b.center[ax]) - w / 2, py(cv, b.center[ay]) - h / 2, w, h);
  }}
  g.globalAlpha = 1.0;
  if (DATA.target) {{
    g.strokeStyle = "#e6c229"; g.lineWidth = 2;
    const x = px(cv, DATA.target[ax]), y = py(cv, DATA.target[ay]);
    g.beginPath(); g.moveTo(x - 6, y); g.lineTo(x + 6, y);
    g.moveTo(x, y - 6); g.lineTo(x, y + 6); g.stroke();
  }}
  // EE path
  g.strokeStyle = "#777"; g.lineWidth = 1; g.beginPath();
  DATA.ee.forEach((p, i) => {{
    const x = px(cv, p[ax]), y = py(cv, p[ay]);
    if (i === 0) g.moveTo(x, y); else g.lineTo(x, y);
  }});
  g.stroke();
  // robot spheres at time t
  const fr = DATA.spheres[t];
  g.fillStyle = "#d95f4c";
  for (let i = 0; i < fr.length; i++) {{
    const s = fr[i], r = DATA.radii[i] / L * cv.width;
    g.beginPath();
    g.arc(px(cv, s[ax]), py(cv, s[ay]), Math.max(r, 1.5), 0, 6.284);
    g.fill();
  }}
}}
function draw(t) {{
  for (const id of Object.keys(views)) drawView(id, t);
  document.getElementById("lbl").textContent = "step " + t;
}}
const slider = document.getElementById("t");
slider.oninput = () => draw(+slider.value);
let timer = null;
document.getElementById("play").onclick = () => {{
  if (timer) {{ clearInterval(timer); timer = null; return; }}
  timer = setInterval(() => {{
    slider.value = (+slider.value + 1) % {T}; draw(+slider.value);
  }}, 80);
}};
draw(0);
</script></body></html>
"""


def write_html(
    path,
    trajectory,
    cuboids=(),
    cylinders=(),
    target_position=None,
    device=None,
) -> Path:
    """Render a [T, 7] trajectory + primitive scene to a standalone HTML.

    ``trajectory``: a tensor (FK runs on its device) or an array (FK runs
    on ``device``, default ``cuda``). ``cuboids``: iterables with
    .center/.dims; ``cylinders``: .center/.radius/.height (the
    :mod:`mpinets_torch.types` primitives).
    """
    if not isinstance(trajectory, torch.Tensor):
        trajectory = torch.as_tensor(np.asarray(trajectory, np.float32),
                                     device=resolve_device(device))
    traj = trajectory.to(torch.float32)
    with torch.no_grad():
        centers = kinematics.collision_spheres(traj)  # [T, 57, 3]
        _, ee = kinematics.eff_pose(traj)
    data = {
        "spheres": np.round(centers.cpu().numpy(), 4).tolist(),
        "radii": np.round(np.asarray(franka.SPHERE_RADII), 4).tolist(),
        "ee": np.round(ee.cpu().numpy(), 4).tolist(),
        "cuboids": [
            {"center": list(map(float, c.center)), "dims": list(map(float, c.dims))}
            for c in cuboids
        ],
        "cylinders": [
            {
                "center": list(map(float, c.center)),
                "radius": float(c.radius),
                "height": float(c.height),
            }
            for c in cylinders
        ],
        "target": list(map(float, target_position))
        if target_position is not None
        else None,
    }
    t = traj.shape[0]
    html = _PAGE.format(T=t, Tm1=t - 1, data=json.dumps(data))
    path = Path(path)
    path.write_text(html)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("output")
    ap.add_argument("--demo", action="store_true",
                    help="render a synthetic rollout demo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.demo:
        ap.error("only --demo is supported without a problems file")
    device = resolve_device(args.device)
    g = torch.Generator(device).manual_seed(0)
    q0 = random_configuration(g, device=device)
    q1 = random_configuration(g, device=device)
    traj = min_jerk_trajectory(q0, q1)
    cub = T.Cuboid((0.6, 0.0, 0.2), (0.4, 0.6, 0.4), (1, 0, 0, 0))
    _, ee = kinematics.eff_pose(traj[-1])
    out = write_html(args.output, traj, cuboids=[cub],
                     target_position=ee.cpu().numpy())
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
