"""The Franka Panda as the plain reference sees it: the kinematic chain, the
57-sphere surface model, the joint limits, forward kinematics, and the
checks that a point lies on the robot's, the gripper's or a scene's
surface.

The tables are public data, written down here once and frozen: the joint
origins of the ``franka_description`` Panda URDF, the empirical joint
limits of robofin's ``FrankaRealRobot``, and the collision spheres of
NVlabs/motion-policy-networks ``config/franka_robot_description.yaml:57-182``.
The chain's fixed frames (link8, hand, fingertips, the right_gripper TCP)
follow the conventions the system under test documents for the same robot.
Plain PyTorch in float32; nothing here reads the system under test.
"""

from __future__ import annotations

import math

import torch

DOF = 7
REAL_JOINT_LIMITS = (
    (-2.8773, 2.8773), (-1.7428, 1.7428), (-2.8773, 2.8773), (-3.0518, -0.0898),
    (-2.8773, 2.8773), (0.0025, 3.7325), (-2.8773, 2.8773),
)
FINGER_OPEN = 0.025
FINGER_MOUNT_Z = 0.0584
FINGERTIP_Z = 0.045
_HPI = math.pi / 2.0
# (xyz, rpy) of panda_joint1..7
JOINTS = (
    ((0.0, 0.0, 0.333), (0.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (-_HPI, 0.0, 0.0)),
    ((0.0, -0.316, 0.0), (_HPI, 0.0, 0.0)),
    ((0.0825, 0.0, 0.0), (_HPI, 0.0, 0.0)),
    ((-0.0825, 0.384, 0.0), (-_HPI, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (_HPI, 0.0, 0.0)),
    ((0.088, 0.0, 0.0), (_HPI, 0.0, 0.0)),
)
LINK8 = ((0.0, 0.0, 0.107), (0.0, 0.0, 0.0))          # from link7
HAND = ((0.0, 0.0, 0.0), (0.0, 0.0, -math.pi / 4.0))   # from link8
RIGHT_GRIPPER = ((0.0, 0.0, 0.1), (0.0, 0.0, 3.0 * math.pi / 4.0))  # from link8

# frame ids: 0 link0 .. 7 link7, 8 link8, 9 hand, 12 left fingertip, 13 right
# fingertip, 14 right_gripper (10, 11 are the fingers, which carry no sphere)
HAND_ID, LEFT_TIP, RIGHT_TIP, EFF_ID = 9, 12, 13, 14
NUM_FRAMES = 15


def _spheres():
    s = [(0, (0.0, 0.0, 0.05), 0.08)]
    s += [(1, c, 0.06) for c in ((0.0, -0.08, 0.0), (0.0, -0.03, 0.0), (0.0, 0.0, -0.12),
                                 (0.0, 0.0, -0.17))]
    s += [(2, c, 0.06) for c in ((0.0, 0.0, 0.03), (0.0, 0.0, 0.08), (0.0, -0.12, 0.0),
                                 (0.0, -0.17, 0.0))]
    s += [(3, (0.0, 0.0, -0.06), 0.05), (3, (0.0, 0.0, -0.1), 0.06),
          (3, (0.08, 0.06, 0.0), 0.055), (3, (0.08, 0.02, 0.0), 0.055)]
    s += [(4, (0.0, 0.0, 0.02), 0.055), (4, (0.0, 0.0, 0.06), 0.055),
          (4, (-0.08, 0.095, 0.0), 0.06), (4, (-0.08, 0.06, 0.0), 0.055)]
    s += [(5, (0.0, 0.055, 0.0), 0.06), (5, (0.0, 0.075, 0.0), 0.06),
          (5, (0.0, 0.0, -0.22), 0.06), (5, (0.0, 0.05, -0.18), 0.05)]
    for x in (0.01, -0.01):
        s += [(5, (x, 0.08, -0.14), 0.025), (5, (x, 0.085, -0.11), 0.025),
              (5, (x, 0.09, -0.08), 0.025), (5, (x, 0.095, -0.05), 0.025)]
    s += [(6, (0.0, 0.0, 0.0), 0.06), (6, (0.08, 0.03, 0.0), 0.06),
          (6, (0.08, -0.01, 0.0), 0.06)]
    s += [(7, (0.0, 0.0, 0.07), 0.05), (7, (0.02, 0.04, 0.08), 0.025),
          (7, (0.04, 0.02, 0.08), 0.025), (7, (0.04, 0.06, 0.085), 0.02),
          (7, (0.06, 0.04, 0.085), 0.02)]
    for z, r in ((0.01, 0.028), (0.03, 0.026), (0.05, 0.024)):
        s += [(HAND_ID, (0.0, y, z), r) for y in (-0.075, -0.045, -0.015, 0.015, 0.045, 0.075)]
    s += [(LEFT_TIP, (0.0, 0.0075, 0.0), 0.0108), (RIGHT_TIP, (0.0, -0.0075, 0.0), 0.0108)]
    return s


SPHERES = _spheres()
assert len(SPHERES) == 57
GRIPPER_FRAMES = (HAND_ID, LEFT_TIP, RIGHT_TIP)


def _rpy(roll, pitch, yaw):
    cr, sr, cp, sp = math.cos(roll), math.sin(roll), math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rz = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)
    ry = torch.tensor([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]], dtype=torch.float64)
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]], dtype=torch.float64)
    return rz @ ry @ rx


def _transform(xyz, rpy):
    t = torch.eye(4, dtype=torch.float64)
    t[:3, :3] = _rpy(*rpy)
    t[:3, 3] = torch.tensor(xyz, dtype=torch.float64)
    return t


def limits(device, dtype=torch.float32):
    t = torch.tensor(REAL_JOINT_LIMITS, dtype=dtype, device=device)
    return t[:, 0], t[:, 1]


def normalize(q):
    lo, hi = limits(q.device, q.dtype)
    return (q - lo) / (hi - lo) * 2.0 - 1.0


def unnormalize(q_norm):
    lo, hi = limits(q_norm.device, q_norm.dtype)
    return (q_norm + 1.0) * (hi - lo) / 2.0 + lo


def _apply(rot, trans, t, dtype):
    """(rot, trans) @ the fixed transform t."""
    t = t.to(dtype=dtype, device=rot.device)
    return rot @ t[:3, :3], trans + (rot @ t[:3, 3:4])[..., 0]


def fk(q):
    """Every frame's pose: q [..., 7] -> (rots [..., 15, 3, 3], trans [..., 15, 3]).
    Frames 10 and 11 (the fingers) are left as the hand's pose."""
    dt, dev = q.dtype, q.device
    rot = torch.eye(3, dtype=dt, device=dev).expand(q.shape[:-1] + (3, 3))
    trans = torch.zeros(q.shape[:-1] + (3,), dtype=dt, device=dev)
    rots, transs = [rot], [trans]
    c, s = torch.cos(q), torch.sin(q)
    for i, (xyz, rpy) in enumerate(JOINTS):
        rot, trans = _apply(rot, trans, _transform(xyz, rpy), dt)
        z = torch.zeros_like(c[..., i])
        o = torch.ones_like(c[..., i])
        rz = torch.stack([torch.stack([c[..., i], -s[..., i], z], -1),
                          torch.stack([s[..., i], c[..., i], z], -1),
                          torch.stack([z, z, o], -1)], -2)
        rot = rot @ rz
        rots.append(rot)
        transs.append(trans)
    r8, t8 = _apply(rot, trans, _transform(*LINK8), dt)
    rh, th = _apply(r8, t8, _transform(*HAND), dt)
    mount = th + rh[..., :, 2] * FINGER_MOUNT_Z
    left = mount + FINGER_OPEN * rh[..., :, 1]
    right = mount - FINGER_OPEN * rh[..., :, 1]
    tip = FINGERTIP_Z * rh[..., :, 2]
    rg, tg = _apply(r8, t8, _transform(*RIGHT_GRIPPER), dt)
    rots += [r8, rh, rh, rh, rh, rh, rg]
    transs += [t8, th, left, right, left + tip, right + tip, tg]
    return torch.stack(rots, -3), torch.stack(transs, -2)


def eff_pose(q):
    rots, trans = fk(q)
    return rots[..., EFF_ID, :, :], trans[..., EFF_ID, :]


def gripper_frames(eff_rot, eff_trans):
    """Hand and fingertip poses for a right_gripper pose: (rots [..., 15, 3, 3],
    trans [..., 15, 3]) with only frames 9, 12 and 13 filled."""
    dt = eff_rot.dtype
    rel = torch.linalg.inv(_transform(*RIGHT_GRIPPER)) @ _transform(*HAND)
    rh, th = _apply(eff_rot, eff_trans, rel, dt)
    mount = th + rh[..., :, 2] * FINGER_MOUNT_Z
    tip = FINGERTIP_Z * rh[..., :, 2]
    rots = torch.zeros(eff_rot.shape[:-2] + (NUM_FRAMES, 3, 3), dtype=dt, device=eff_rot.device)
    trans = torch.zeros(eff_trans.shape[:-1] + (NUM_FRAMES, 3), dtype=dt,
                        device=eff_trans.device)
    rots[..., HAND_ID, :, :] = rh
    rots[..., LEFT_TIP, :, :] = rh
    rots[..., RIGHT_TIP, :, :] = rh
    trans[..., HAND_ID, :] = th
    trans[..., LEFT_TIP, :] = mount + FINGER_OPEN * rh[..., :, 1] + tip
    trans[..., RIGHT_TIP, :] = mount - FINGER_OPEN * rh[..., :, 1] + tip
    return rots, trans


def sphere_centres(rots, trans, frames=None):
    """World centres and radii of the spheres on ``frames`` (default all)."""
    rows = [s for s in SPHERES if frames is None or s[0] in frames]
    idx = torch.tensor([s[0] for s in rows], device=rots.device)
    local = torch.tensor([s[1] for s in rows], dtype=rots.dtype, device=rots.device)
    radii = torch.tensor([s[2] for s in rows], dtype=rots.dtype, device=rots.device)
    r = rots.index_select(-3, idx)
    t = trans.index_select(-2, idx)
    return (r @ local[..., None])[..., 0] + t, radii


def surface_gap(points, centres, radii):
    """Distance of each point [B, P, 3] to the nearest sphere surface of a
    sphere set ([B, S, 3], [S]): how far it lies off the union's skin."""
    d = torch.cdist(points.double(), centres.double()) - radii.double()
    return d.abs().amin(-1)


def success(q, target_rot, target_trans, pos_tol=0.01, ori_tol_deg=15.0):
    """(reached [...], margin [...]): the EE within 1 cm and 15 degrees of the
    target, and how far the nearer threshold is (in units of each tolerance),
    so that a caller can set aside cases that rounding could flip."""
    rot, trans = eff_pose(q)
    pos = torch.linalg.norm(trans - target_trans, dim=-1)
    tr = (rot * target_rot).sum((-1, -2))
    ori = torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))
    reached = (pos < pos_tol) & (ori < ori_tol_deg)
    margin = torch.minimum((pos - pos_tol).abs() / pos_tol, (ori - ori_tol_deg).abs() / ori_tol_deg)
    return reached, margin


def _quat_matrix(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _safe_norm(x):
    """2-norm over the last axis whose gradient stays finite at 0."""
    return torch.sqrt((x * x).sum(-1).clamp(min=1e-30))


def primitive_sdf(points, scene):
    """Signed distance [B, P, M1 + M2] of points [B, P, 3] to each cuboid,
    then each cylinder, of a scene (dict of SceneSet fields, wxyz quats);
    zero-volume padding gives +inf."""
    out = []
    for kind in ("cuboid", "cylinder"):
        rot = _quat_matrix(scene[f"{kind}_quats"].to(points.dtype))
        centres = scene[f"{kind}_centers"].to(points.dtype)
        local = torch.einsum("bmji,bpmj->bpmi", rot, points[:, :, None, :] - centres[:, None])
        if kind == "cuboid":
            dims = scene["cuboid_dims"].to(points.dtype)
            q = local.abs() - dims[:, None] / 2
            live = (dims.abs() > 1e-8).all(-1)
        else:
            r = scene["cylinder_radii"].to(points.dtype)[..., 0]
            h = scene["cylinder_heights"].to(points.dtype)[..., 0]
            q = torch.stack([_safe_norm(local[..., :2]) - r[:, None],
                             local[..., 2].abs() - h[:, None] / 2], -1)
            live = (r.abs() > 1e-8) & (h.abs() > 1e-8)
        sdf = _safe_norm(q.clamp(min=0)) + q.amax(-1).clamp(max=0)
        out.append(torch.where(live[:, None], sdf, torch.full_like(sdf, math.inf)))
    return torch.cat(out, -1)


def scene_surface_gap(points, scene):
    """|SDF| of each point [B, P, 3] to the nearest live primitive's surface."""
    return primitive_sdf(points.double(), scene).abs().amin(-1)


def sphere_union_bank(num_points, seed, frames=None, by_frame=True):
    """Points on the union surface of the spheres on ``frames`` (default
    all), as robofin-style link-local banks are drawn for the sphere model:
    points spread over the spheres in proportion to their area, from
    ``numpy.random.default_rng(seed)``, those strictly inside a sibling
    sphere of the same frame rejected; with ``by_frame`` sorted by frame
    (stably), as a robot cloud is gathered, else in draw order, as a
    gripper cloud is. -> (points [P, 3] f32 link-local, frames [P])."""
    import numpy as np

    rows = [s for s in SPHERES if frames is None or s[0] in frames]
    fid = np.array([s[0] for s in rows], np.int32)
    centres = np.array([s[1] for s in rows], np.float64)
    radii = np.array([s[2] for s in rows], np.float64)
    rng = np.random.default_rng(seed)
    probs = 4.0 * np.pi * radii**2
    probs = probs / probs.sum()
    pts_out = np.empty((num_points, 3), np.float64)
    fr_out = np.empty((num_points,), np.int32)
    filled = 0
    while filled < num_points:
        n = 2 * (num_points - filled) + 256
        which = rng.choice(len(radii), size=n, p=probs)
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts = centres[which] + radii[which, None] * dirs
        keep = np.ones(n, bool)
        for s in range(len(radii)):
            inside = np.linalg.norm(pts - centres[s], axis=1) < radii[s] - 1e-9
            keep &= ~((fid[which] == fid[s]) & (which != s) & inside)
        pts, which = pts[keep], which[keep]
        take = min(len(pts), num_points - filled)
        pts_out[filled:filled + take] = pts[:take]
        fr_out[filled:filled + take] = fid[which[:take]]
        filled += take
    order = np.argsort(fr_out, kind="stable") if by_frame else np.arange(num_points)
    return pts_out.astype(np.float32)[order], fr_out[order]


def bank_world(q, bank):
    """World positions of a bank's points at configurations q [..., 7]."""
    points, frames = bank
    rots, trans = fk(q)
    idx = torch.as_tensor(frames, dtype=torch.long, device=q.device)
    local = torch.as_tensor(points, dtype=q.dtype, device=q.device)
    return (rots.index_select(-3, idx) @ local[..., None])[..., 0] + trans.index_select(-2, idx)


def gripper_bank_world(eff_rot, eff_trans, bank):
    """World positions of a gripper bank's points at right_gripper poses."""
    points, frames = bank
    rots, trans = gripper_frames(eff_rot, eff_trans)
    idx = torch.as_tensor(frames, dtype=torch.long, device=eff_rot.device)
    local = torch.as_tensor(points, dtype=eff_rot.dtype, device=eff_rot.device)
    return (rots.index_select(-3, idx) @ local[..., None])[..., 0] + trans.index_select(-2, idx)


def scene_sdf(points, scene):
    """Signed distance [B, P] of points [B, P, 3] to a scene: the least over
    its live cuboids and cylinders."""
    return primitive_sdf(points, scene).amin(-1)
