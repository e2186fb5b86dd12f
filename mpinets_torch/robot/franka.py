"""Static Franka Emika Panda model: kinematic chain, joint limits, collision
spheres, and self-collision pair table.

PyTorch-port copy of ``mpinets_tpu/robot/franka.py`` (the tables are plain
numpy and must stay bit-identical to it). It is the replacement for the
reference's external ``robofin`` dependency (used throughout
``motion-policy-networks/mpinets``, e.g.
``mpinets/utils.py:27``, ``mpinets/model.py:25``). Everything here is a plain
numpy constant table -- the batched math lives in
:mod:`mpinets_torch.kernels.kinematics`.

Sources of the numeric constants (all public):
  * Kinematic frame origins: the standard ``franka_description`` Panda URDF
    (joint origins / axes for panda_joint1..7, panda_hand, fingers).
  * Joint limits: Franka's published datasheet limits. The "real robot"
    limits follow the reference's convention of an empirically-shrunk range
    (see ``motion-policy-networks/mpinets/utils.py:44-47``); we derive them by
    shrinking each published limit by ``REAL_LIMIT_MARGIN`` radians per side.
    This margin is a single calibration constant.
  * Collision spheres: transcribed from the reference's Lula robot
    description (``motion-policy-networks/config/franka_robot_description.yaml:57-182``,
    57 spheres over 11 frames) into a flat SoA table.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

DOF = 7

# ---------------------------------------------------------------------------
# Joint limits
# ---------------------------------------------------------------------------

#: Published joint limits [7, 2] (low, high), radians.
JOINT_LIMITS = np.array(
    [
        (-2.8973, 2.8973),
        (-1.7628, 1.7628),
        (-2.8973, 2.8973),
        (-3.0718, -0.0698),
        (-2.8973, 2.8973),
        (-0.0175, 3.7525),
        (-2.8973, 2.8973),
    ],
    dtype=np.float64,
)

#: Empirical ("real robot") joint limits — the default normalization range in
#: the reference (``FrankaRealRobot.JOINT_LIMITS`` selected at
#: ``mpinets/utils.py:50,84``). Transcribed from the public robofin package
#: (fishbotics/robofin, ``robofin/robots.py`` class ``FrankaRealRobot``):
#: each published limit pulled in by 0.02 rad ("unpublished — just found by
#: monkeying around with the robot", ``mpinets/utils.py:44-47``). Every q the
#: policy sees is normalized against THIS table, so these values are part of
#: the checkpoint contract; ``tests/test_fk.py`` pins them as goldens.
REAL_JOINT_LIMITS = np.array(
    [
        (-2.8773, 2.8773),
        (-1.7428, 1.7428),
        (-2.8773, 2.8773),
        (-3.0518, -0.0898),
        (-2.8773, 2.8773),
        (0.0025, 3.7325),
        (-2.8773, 2.8773),
    ],
    dtype=np.float64,
)

VELOCITY_LIMITS = np.array(
    [2.1750, 2.1750, 2.1750, 2.1750, 2.6100, 2.6100, 2.6100], dtype=np.float64
)

#: Neutral configuration used by the reference's Lula config
#: (``config/franka_robot_description.yaml:44-46``).
NEUTRAL_Q = np.array([0.0, -1.3, 0.0, -2.87, 0.0, 2.0, 0.75], dtype=np.float64)

#: Fixed prismatic finger opening used everywhere in the reference
#: (``config/franka_robot_description.yaml:52-53``, ``metrics.py:74-78``).
FINGER_OPEN = 0.025


# ---------------------------------------------------------------------------
# Kinematic chain
# ---------------------------------------------------------------------------
# The chain is expressed as URDF-style fixed origins: each joint i has a fixed
# parent->joint transform (xyz translation + rpy rotation) followed by a
# rotation about local z by q_i (all Panda joints are revolute about local z).

def _rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Rotation matrix from URDF-convention fixed-axis rpy angles."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return rz @ ry @ rx


def _origin(xyz, rpy) -> np.ndarray:
    """Homogeneous transform from a URDF joint origin."""
    t = np.eye(4)
    t[:3, :3] = _rpy_matrix(*rpy)
    t[:3, 3] = xyz
    return t


_HPI = math.pi / 2.0

#: Fixed parent->joint transforms for the 7 revolute joints, [7, 4, 4].
#: (standard franka_description Panda URDF joint origins)
JOINT_ORIGINS = np.stack(
    [
        _origin((0.0, 0.0, 0.333), (0.0, 0.0, 0.0)),      # panda_joint1
        _origin((0.0, 0.0, 0.0), (-_HPI, 0.0, 0.0)),      # panda_joint2
        _origin((0.0, -0.316, 0.0), (_HPI, 0.0, 0.0)),    # panda_joint3
        _origin((0.0825, 0.0, 0.0), (_HPI, 0.0, 0.0)),    # panda_joint4
        _origin((-0.0825, 0.384, 0.0), (-_HPI, 0.0, 0.0)),  # panda_joint5
        _origin((0.0, 0.0, 0.0), (_HPI, 0.0, 0.0)),       # panda_joint6
        _origin((0.088, 0.0, 0.0), (_HPI, 0.0, 0.0)),     # panda_joint7
    ]
)

# Fixed frames hanging off the chain. Offsets below are expressed relative to
# the frame named in FIXED_FRAME_PARENTS.
LINK8_OFFSET = _origin((0.0, 0.0, 0.107), (0.0, 0.0, 0.0))
HAND_OFFSET = _origin((0.0, 0.0, 0.0), (0.0, 0.0, -math.pi / 4.0))
#: End-effector frame used as the policy/planning target frame
#: ("right_gripper" in the reference, ``run_inference.py:51``; defined in the
#: robofin URDF). Position: +0.1 m along the hand/link8 z axis (between the
#: fingertip pads -- the TCP). Orientation: the reference's candidate-pose
#: constructions (``cubby_environment.py:532-541``: x = palm/down axis,
#: y = finger-opening axis, z = approach axis) force right_gripper y to be
#: parallel to panda_hand y and z to hand z, i.e. the frame equals the hand
#: frame up to a z-rotation of 0 or pi -- a net link8 yaw of -pi/4 or +3pi/4.
#: We use +3pi/4. RESIDUAL PARITY RISK: the pi flip is unresolvable with the
#: artifacts this repository has. Investigated (r3): the one shipped mesh,
#: ``interactive_demo/mpinets_ros/meshes/half_open_gripper.stl``, IS in the
#: right_gripper frame (z=0 at the fingertip pads, body in -z, finger spread
#: along y) and is measurably asymmetric -- the hand body bulges toward
#: +y_rg (triangle-centroid mean y = +0.036 over z in [-0.13,-0.06]; fingers
#: and fingertips are exactly symmetric) -- so the flip IS observable the
#: moment a franka_description hand mesh (hand-frame geometry) is available
#: to locate that bulge, or via one FK evaluation against a
#: hindsight-revised target in the Zenodo problem sets. The 57-sphere table
#: is y-symmetric at the hand and cannot settle it. Flipping means swapping
#: this constant's yaw to -pi/4.
RIGHT_GRIPPER_OFFSET = _origin((0.0, 0.0, 0.1), (0.0, 0.0, 3.0 * math.pi / 4.0))
#: Finger mount point on the hand (franka_description hand URDF).
FINGER_MOUNT_Z = 0.0584
#: Fingertip frame offset along the finger's local z (calibration constant;
#: places the Lula fingertip spheres near the pad tips).
FINGERTIP_Z = 0.045

# Frame index table for the stacked FK output.
FRAMES = (
    "panda_link0",       # 0
    "panda_link1",       # 1
    "panda_link2",       # 2
    "panda_link3",       # 3
    "panda_link4",       # 4
    "panda_link5",       # 5
    "panda_link6",       # 6
    "panda_link7",       # 7
    "panda_link8",       # 8
    "panda_hand",        # 9
    "panda_leftfinger",  # 10
    "panda_rightfinger",  # 11
    "panda_leftfingertip",   # 12
    "panda_rightfingertip",  # 13
    "right_gripper",     # 14
)
FRAME_INDEX = {name: i for i, name in enumerate(FRAMES)}
NUM_FRAMES = len(FRAMES)
EFF_FRAME = FRAME_INDEX["right_gripper"]


# ---------------------------------------------------------------------------
# Collision-sphere model (57 spheres over 11 frames)
# ---------------------------------------------------------------------------
# Transcribed from motion-policy-networks/config/franka_robot_description.yaml:57-182
# into (frame, center, radius) rows.

_S = []


def _sph(frame: str, center, radius: float) -> None:
    _S.append((FRAME_INDEX[frame], center, radius))


_sph("panda_link0", (0.0, 0.0, 0.05), 0.08)
for c in ((0.0, -0.08, 0.0), (0.0, -0.03, 0.0), (0.0, 0.0, -0.12), (0.0, 0.0, -0.17)):
    _sph("panda_link1", c, 0.06)
for c in ((0.0, 0.0, 0.03), (0.0, 0.0, 0.08), (0.0, -0.12, 0.0), (0.0, -0.17, 0.0)):
    _sph("panda_link2", c, 0.06)
_sph("panda_link3", (0.0, 0.0, -0.06), 0.05)
_sph("panda_link3", (0.0, 0.0, -0.1), 0.06)
_sph("panda_link3", (0.08, 0.06, 0.0), 0.055)
_sph("panda_link3", (0.08, 0.02, 0.0), 0.055)
_sph("panda_link4", (0.0, 0.0, 0.02), 0.055)
_sph("panda_link4", (0.0, 0.0, 0.06), 0.055)
_sph("panda_link4", (-0.08, 0.095, 0.0), 0.06)
_sph("panda_link4", (-0.08, 0.06, 0.0), 0.055)
_sph("panda_link5", (0.0, 0.055, 0.0), 0.06)
_sph("panda_link5", (0.0, 0.075, 0.0), 0.06)
_sph("panda_link5", (0.0, 0.0, -0.22), 0.06)
_sph("panda_link5", (0.0, 0.05, -0.18), 0.05)
for x in (0.01, -0.01):
    _sph("panda_link5", (x, 0.08, -0.14), 0.025)
    _sph("panda_link5", (x, 0.085, -0.11), 0.025)
    _sph("panda_link5", (x, 0.09, -0.08), 0.025)
    _sph("panda_link5", (x, 0.095, -0.05), 0.025)
_sph("panda_link6", (0.0, 0.0, 0.0), 0.06)
_sph("panda_link6", (0.08, 0.03, 0.0), 0.06)
_sph("panda_link6", (0.08, -0.01, 0.0), 0.06)
_sph("panda_link7", (0.0, 0.0, 0.07), 0.05)
_sph("panda_link7", (0.02, 0.04, 0.08), 0.025)
_sph("panda_link7", (0.04, 0.02, 0.08), 0.025)
_sph("panda_link7", (0.04, 0.06, 0.085), 0.02)
_sph("panda_link7", (0.06, 0.04, 0.085), 0.02)
for y in (-0.075, -0.045, -0.015, 0.015, 0.045, 0.075):
    _sph("panda_hand", (0.0, y, 0.01), 0.028)
for y in (-0.075, -0.045, -0.015, 0.015, 0.045, 0.075):
    _sph("panda_hand", (0.0, y, 0.03), 0.026)
for y in (-0.075, -0.045, -0.015, 0.015, 0.045, 0.075):
    _sph("panda_hand", (0.0, y, 0.05), 0.024)
_sph("panda_leftfingertip", (0.0, 0.0075, 0.0), 0.0108)
_sph("panda_rightfingertip", (0.0, -0.0075, 0.0), 0.0108)

#: Frame index of each collision sphere, [57].
SPHERE_FRAMES = np.array([s[0] for s in _S], dtype=np.int32)
#: Local-frame center of each collision sphere, [57, 3].
SPHERE_CENTERS = np.array([s[1] for s in _S], dtype=np.float64)
#: Radius of each collision sphere, [57].
SPHERE_RADII = np.array([s[2] for s in _S], dtype=np.float64)

#: Scene-collision subset: the reference's sphere checks against scene
#: geometry exclude the base link (``FrankaCollisionSampler(...,
#: with_base_link=False)``, ``mpinets/model.py:270``, ``loss.py:146`` --
#: the base is not controllable and its circumscribing sphere dips below
#: z=0, so it would permanently "collide" with the mount table every
#: tabletop scene places under the robot).
SCENE_SPHERE_MASK = SPHERE_FRAMES != FRAME_INDEX["panda_link0"]
SCENE_SPHERE_FRAMES = SPHERE_FRAMES[SCENE_SPHERE_MASK]
SCENE_SPHERE_CENTERS = SPHERE_CENTERS[SCENE_SPHERE_MASK]
SCENE_SPHERE_RADII = SPHERE_RADII[SCENE_SPHERE_MASK]
NUM_SPHERES = len(_S)
assert NUM_SPHERES == 57, NUM_SPHERES
del _S

#: Unique radii groups (the reference's FrankaCollisionSampler iterates by
#: radius group, ``model.py:300-303``).
UNIQUE_RADII = np.unique(SPHERE_RADII)


# ---------------------------------------------------------------------------
# Self-collision pair table
# ---------------------------------------------------------------------------
# Sphere-model self collision (replacement for robofin's
# FrankaSelfCollisionChecker, used at ``metrics.py:31,266``): a pair of
# collision spheres on sufficiently-separated links collides when their
# world-frame distance drops below the sum of radii. Neighboring links in the
# chain always overlap and are excluded, mirroring the standard Franka SRDF
# adjacency exclusions.

def _self_collision_pairs() -> np.ndarray:
    # Map each sphere frame to a "link index" along the chain for adjacency.
    chain_pos = {
        FRAME_INDEX["panda_link0"]: 0,
        FRAME_INDEX["panda_link1"]: 1,
        FRAME_INDEX["panda_link2"]: 2,
        FRAME_INDEX["panda_link3"]: 3,
        FRAME_INDEX["panda_link4"]: 4,
        FRAME_INDEX["panda_link5"]: 5,
        FRAME_INDEX["panda_link6"]: 6,
        FRAME_INDEX["panda_link7"]: 7,
        FRAME_INDEX["panda_hand"]: 8,
        FRAME_INDEX["panda_leftfingertip"]: 9,
        FRAME_INDEX["panda_rightfingertip"]: 9,
    }
    # SRDF-style extra exclusions (links that are adjacent in space despite
    # being >1 apart in the chain; the Panda SRDF disables these checks).
    # r3 calibration against the independent capsule proxy
    # (scripts/selfcc_calibration.py) showed the r2 set wrongly excluded
    # link4/5-vs-hand/fingertips -- the hand folding onto the forearm is the
    # Panda's MOST COMMON physical self-collision mode (15% of uniform
    # random configs per the proxy) and the real SRDF keeps those checks.
    extra_excluded = {
        (0, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 7), (6, 8), (6, 9),
        (7, 9),
    }
    pairs = []
    for i in range(NUM_SPHERES):
        for j in range(i + 1, NUM_SPHERES):
            a = chain_pos[int(SPHERE_FRAMES[i])]
            b = chain_pos[int(SPHERE_FRAMES[j])]
            lo, hi = min(a, b), max(a, b)
            if hi - lo <= 1:
                continue
            if (lo, hi) in extra_excluded:
                continue
            pairs.append((i, j))
    return np.array(pairs, dtype=np.int32)


#: [P, 2] indices into the sphere table for allowed self-collision checks.
SELF_COLLISION_PAIRS = _self_collision_pairs()
#: [P] squared contact distances for each pair.
SELF_COLLISION_THRESH = (
    SPHERE_RADII[SELF_COLLISION_PAIRS[:, 0]] + SPHERE_RADII[SELF_COLLISION_PAIRS[:, 1]]
)


@dataclasses.dataclass(frozen=True)
class FrankaConstants:
    """The limit, origin and sphere tables in one bundle (numpy arrays), as
    ``mpinets_tpu/robot/franka.py:317`` bundles them."""

    joint_limits: np.ndarray = dataclasses.field(default_factory=lambda: JOINT_LIMITS)
    real_joint_limits: np.ndarray = dataclasses.field(
        default_factory=lambda: REAL_JOINT_LIMITS
    )
    joint_origins: np.ndarray = dataclasses.field(default_factory=lambda: JOINT_ORIGINS)
    sphere_frames: np.ndarray = dataclasses.field(default_factory=lambda: SPHERE_FRAMES)
    sphere_centers: np.ndarray = dataclasses.field(
        default_factory=lambda: SPHERE_CENTERS
    )
    sphere_radii: np.ndarray = dataclasses.field(default_factory=lambda: SPHERE_RADII)
