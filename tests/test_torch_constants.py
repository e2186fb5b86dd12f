"""Port parity: constant tables, point banks, normalization, rotations and
the numpy types of ``mpinets_torch`` against ``mpinets_tpu``.

Tables and banks must be bit-identical (same numpy code, same seeds);
elementwise float32 maths agrees to 1e-6.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch import types as tt  # noqa: E402
from mpinets_torch.kernels import rotations as trot  # noqa: E402
from mpinets_torch.robot import franka as tfr  # noqa: E402
from mpinets_torch.robot import point_banks as tpb  # noqa: E402
from mpinets_torch.utils import normalization as tnorm  # noqa: E402
from mpinets_tpu import types as jt  # noqa: E402
from mpinets_tpu.kernels import rotations as jrot  # noqa: E402
from mpinets_tpu.robot import franka as jfr  # noqa: E402
from mpinets_tpu.robot import point_banks as jpb  # noqa: E402
from mpinets_tpu.utils import normalization as jnorm  # noqa: E402

torch.set_float32_matmul_precision("highest")

TABLES = [
    "JOINT_LIMITS", "REAL_JOINT_LIMITS", "VELOCITY_LIMITS", "NEUTRAL_Q",
    "JOINT_ORIGINS", "LINK8_OFFSET", "HAND_OFFSET", "RIGHT_GRIPPER_OFFSET",
    "SPHERE_FRAMES", "SPHERE_CENTERS", "SPHERE_RADII", "SCENE_SPHERE_FRAMES",
    "SCENE_SPHERE_CENTERS", "SCENE_SPHERE_RADII", "UNIQUE_RADII",
    "SELF_COLLISION_PAIRS", "SELF_COLLISION_THRESH",
]


@pytest.mark.parametrize("name", TABLES)
def test_franka_tables_bit_identical(name):
    np.testing.assert_array_equal(getattr(tfr, name), getattr(jfr, name))
    assert getattr(tfr, name).dtype == getattr(jfr, name).dtype


def test_franka_scalars_and_frames_identical():
    for name in ("DOF", "FINGER_OPEN", "FINGER_MOUNT_Z", "FINGERTIP_Z", "FRAMES",
                 "FRAME_INDEX", "EFF_FRAME", "NUM_FRAMES", "NUM_SPHERES"):
        assert getattr(tfr, name) == getattr(jfr, name), name


@pytest.mark.parametrize("bank", ["full_robot_bank", "loss_bank", "gripper_bank"])
def test_point_banks_bit_identical(bank):
    a, b = getattr(tpb, bank)(), getattr(jpb, bank)()
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.frames, b.frames)
    assert tpb.DEFAULT_BANK_SIZE == jpb.DEFAULT_BANK_SIZE


def test_point_bank_override_shared(tmp_path, monkeypatch):
    """Both packages read a mesh bank from MPINETS_TPU_POINT_BANK."""
    bank = tmp_path / "bank.npz"
    rng = np.random.default_rng(3)
    np.savez(bank, points=rng.normal(size=(50, 3)), frames=rng.integers(0, 15, 50))
    out = subprocess.run(
        [sys.executable, "-c", "from mpinets_torch.robot import point_banks as p; "
         "print(p.BANK_OVERRIDE_PATH)"],
        env={**os.environ, "MPINETS_TPU_POINT_BANK": str(bank)},
        capture_output=True, text=True, check=True, cwd=Path(__file__).parent.parent,
    )
    assert out.stdout.strip() == str(bank)
    monkeypatch.setattr(tpb, "BANK_OVERRIDE_PATH", str(bank))
    monkeypatch.setattr(jpb, "BANK_OVERRIDE_PATH", str(bank))
    a, b = tpb.full_robot_bank(50, 9), jpb.full_robot_bank(50, 9)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.frames, b.frames)
    np.testing.assert_array_equal(a.points, np.load(bank)["points"].astype(np.float32))


@pytest.mark.parametrize("real", [True, False])
def test_normalization_matches(real):
    rng = np.random.default_rng(0)
    q = rng.uniform(-3.5, 3.5, (16, 7)).astype(np.float32)
    for fn in ("normalize_franka_joints", "unnormalize_franka_joints"):
        ours = getattr(tnorm, fn)(torch.from_numpy(q), use_real_constraints=real)
        ref = getattr(jnorm, fn)(jnp.asarray(q), use_real_constraints=real)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    ours = tnorm.clamp_to_limits(torch.from_numpy(q), real)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jnorm.clamp_to_limits(jnp.asarray(q), real)))


def test_rotations_match():
    rng = np.random.default_rng(1)
    qa = rng.normal(size=(32, 4)).astype(np.float32)
    qb = rng.normal(size=(32, 4)).astype(np.float32)
    ta, tb = torch.from_numpy(qa), torch.from_numpy(qb)
    ja, jb = jnp.asarray(qa), jnp.asarray(qb)
    rot = trot.quat_to_matrix(ta)
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot.quat_to_matrix(ja)), atol=1e-6)
    np.testing.assert_allclose(trot.matrix_to_quat(rot).numpy(),
                               np.asarray(jrot.matrix_to_quat(jrot.quat_to_matrix(ja))),
                               atol=1e-6)
    np.testing.assert_allclose(trot.quat_multiply(ta, tb).numpy(),
                               np.asarray(jrot.quat_multiply(ja, jb)), atol=1e-6)
    np.testing.assert_allclose(trot.quat_angle(ta / ta.norm(dim=-1, keepdim=True),
                                               tb / tb.norm(dim=-1, keepdim=True)).numpy(),
                               np.asarray(jrot.quat_angle(ja / jnp.linalg.norm(ja, axis=-1, keepdims=True),
                                                          jb / jnp.linalg.norm(jb, axis=-1, keepdims=True))),
                               atol=1e-5)
    pts = rng.normal(size=(32, 5, 3)).astype(np.float32)
    trans = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trot.transform_points(rot, torch.from_numpy(trans), torch.from_numpy(pts)).numpy(),
        np.asarray(jrot.transform_points(jrot.quat_to_matrix(ja), jnp.asarray(trans),
                                         jnp.asarray(pts))),
        atol=1e-5)
    inv_rot, inv_trans = trot.inverse_transform(rot, torch.from_numpy(trans))
    jinv = jrot.inverse_transform(jrot.quat_to_matrix(ja), jnp.asarray(trans))
    np.testing.assert_allclose(inv_rot.numpy(), np.asarray(jinv[0]), atol=1e-6)
    np.testing.assert_allclose(inv_trans.numpy(), np.asarray(jinv[1]), atol=1e-5)


def test_types_match():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(8, 4))
    np.testing.assert_array_equal(tt.quat_to_matrix_np(q), jt.quat_to_matrix_np(q))
    for m in tt.quat_to_matrix_np(q):
        np.testing.assert_array_equal(tt.matrix_to_quat_np(m), jt.matrix_to_quat_np(m))
    cub = tt.Cuboid([0.1, 0.2, 0.3], [0.4, 0.5, 0.6], q[0])
    jcub = jt.Cuboid([0.1, 0.2, 0.3], [0.4, 0.5, 0.6], q[0])
    cyl = tt.Cylinder([0.1, 0.2, 0.3], 0.1, 0.4, q[1])
    jcyl = jt.Cylinder([0.1, 0.2, 0.3], 0.1, 0.4, q[1])
    p = rng.normal(size=3)
    assert cub.sdf(p) == jcub.sdf(p) and cub.surface_area == jcub.surface_area
    assert cyl.sdf(p) == jcyl.sdf(p) and cyl.surface_area == jcyl.surface_area
    np.testing.assert_array_equal(tt.Pose.from_matrix(jt.Pose(p, q[2]).matrix).quaternion,
                                  jt.Pose.from_matrix(jt.Pose(p, q[2]).matrix).quaternion)
