"""The environment step's constant tables on the device
(``kinematics.franka_table``, ``sampler._bank_table``,
``sampler._gripper_table``, all through ``utils.device.host_table``).

Each table is copied from the host once per (table, dtype, device) and then
reused, so a warm rollout or train step makes no copy from the host (on a
card each would drain the queue). Outputs are bit-identical to those from a
table copied afresh, and a table first made under ``torch.no_grad`` or
``torch.inference_mode`` still serves a later backward. The file imports no
JAX.
"""

import pytest
import torch

from mpinets_torch.data import synthetic
from mpinets_torch.geom.assembly import PointCloudSizes
from mpinets_torch.kernels import kinematics
from mpinets_torch.model.fused import make_fused_apply
from mpinets_torch.model.policy import MotionPolicyNetwork
from mpinets_torch.robot import franka, point_banks, sampler
from mpinets_torch.rollout import engine
from mpinets_torch.train import learner, loss
from mpinets_torch.utils import normalization, trace

CPU = torch.device("cpu")
DTYPES = [torch.float32, torch.bfloat16, torch.float64]
NPOINTS = (16, 8)
SIZES = PointCloudSizes(64, 48, 16)

#: Each cached table by the arguments its callers give it.
TABLES = {
    "real_joint_limits": lambda dt: kinematics.franka_table("REAL_JOINT_LIMITS", dt, CPU),
    "joint_limits": lambda dt: kinematics.franka_table("JOINT_LIMITS", dt, CPU),
    "full_bank": lambda dt: sampler._bank_table("full", point_banks.DEFAULT_BANK_SIZE, 0, dt, CPU),
    "loss_bank": lambda dt: sampler._bank_table("loss", loss.NUM_LOSS_POINTS, 1, dt, CPU),
    "gripper_bank": lambda dt: sampler._gripper_table(SIZES.target, 2, dt, CPU),
}

#: The same tables as the host holds them.
SOURCES = {
    "real_joint_limits": lambda: franka.REAL_JOINT_LIMITS,
    "joint_limits": lambda: franka.JOINT_LIMITS,
    "full_bank": lambda: sampler._prepared_bank("full", point_banks.DEFAULT_BANK_SIZE, 0)[0],
    "loss_bank": lambda: sampler._prepared_bank("loss", loss.NUM_LOSS_POINTS, 1)[0],
    "gripper_bank": lambda: sampler._gripper_bank_eff_local(SIZES.target, 2),
}


def clear_tables():
    kinematics.franka_table.cache_clear()
    sampler._bank_table.cache_clear()
    sampler._gripper_table.cache_clear()


def configurations(dtype, n=5, seed=0):
    return synthetic.random_configuration(torch.Generator().manual_seed(seed), (n,)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("table", sorted(TABLES))
def test_table_is_made_once_per_dtype(table, dtype):
    first = TABLES[table](dtype)
    assert TABLES[table](dtype) is first
    assert first.dtype == dtype and first.device == CPU
    assert torch.equal(first, torch.as_tensor(SOURCES[table](), dtype=dtype))
    other = torch.float64 if dtype != torch.float64 else torch.float32
    assert TABLES[table](other) is not first


def _fresh_franka(name, dtype, device):
    return torch.as_tensor(getattr(franka, name), dtype=dtype, device=device)


def _fresh_bank(bank_key, num_points, seed, dtype, device):
    return torch.as_tensor(sampler._prepared_bank(bank_key, num_points, seed)[0],
                           dtype=dtype, device=device)


def _fresh_gripper(num_points, seed, dtype, device):
    return torch.as_tensor(sampler._gripper_bank_eff_local(num_points, seed),
                           dtype=dtype, device=device)


def _end_effector(q):
    rot, trans = kinematics.eff_pose(q)
    return sampler.sample_end_effector(rot, trans, SIZES.target)


USERS = {
    "normalize": lambda q: normalization.normalize_franka_joints(q),
    "unnormalize": lambda q: normalization.unnormalize_franka_joints(q.clamp(-1, 1)),
    "unnormalize_joint_limits": lambda q: normalization.unnormalize_franka_joints(
        q.clamp(-1, 1), use_real_constraints=False),
    "clamp_to_limits": lambda q: normalization.clamp_to_limits(1.2 * q),
    "bank_point_cloud_full": lambda q: sampler.bank_point_cloud(q, "full"),
    "bank_point_cloud_loss": lambda q: sampler.fixed_robot_points(q, loss.NUM_LOSS_POINTS),
    "sample_end_effector": _end_effector,
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("user", sorted(USERS))
def test_cached_tables_give_bit_identical_outputs(user, dtype, monkeypatch):
    q = configurations(dtype)
    cached = USERS[user](q)
    assert torch.equal(USERS[user](q), cached)
    monkeypatch.setattr(kinematics, "franka_table", _fresh_franka)
    monkeypatch.setattr(sampler, "_bank_table", _fresh_bank)
    monkeypatch.setattr(sampler, "_gripper_table", _fresh_gripper)
    fresh = USERS[user](q)
    assert fresh.dtype == cached.dtype == dtype
    assert torch.equal(fresh, cached)


def small_rollout():
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(0)).eval()
    run = engine.make_rollout_fn(model, max_steps=3, sizes=SIZES, device="cpu",
                                 apply_fn=make_fused_apply(torch.float32))
    problem = synthetic.random_problem_batch(torch.Generator().manual_seed(1), 2, device="cpu")
    return lambda: run(problem, torch.Generator().manual_seed(2))


def batch_and_loss():
    draws = synthetic.draw_training_batch(torch.Generator().manual_seed(3), 2, SIZES)

    def run():
        batch = synthetic.training_batch(sizes=SIZES, draws=draws)
        return loss.bc_losses(batch["configuration"], batch["supervision"],
                              learner.scene_from_batch(batch))
    return run


@pytest.mark.parametrize("make", [small_rollout, batch_and_loss], ids=lambda f: f.__name__)
def test_warm_step_copies_no_table(make, monkeypatch):
    run = make()
    sites = []
    wait = trace.h2d_wait
    monkeypatch.setattr(trace, "h2d_wait", lambda site, device: sites.append(site)
                        or wait(site, device))
    clear_tables()
    run()
    assert sites, "a cold step copies its tables"
    sites.clear()
    run()
    assert sites == []


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode],
                         ids=lambda m: m.__name__)
def test_table_made_without_grad_serves_a_later_backward(mode):
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    state = learner.init_state(model)
    step = learner.make_train_step()
    draws = synthetic.draw_training_batch(torch.Generator().manual_seed(3), 2, SIZES)
    clear_tables()
    with mode():
        batch = synthetic.training_batch(sizes=SIZES, draws=draws)
        loss.bc_losses(batch["configuration"], batch["supervision"],
                       learner.scene_from_batch(batch))
    batch = synthetic.training_batch(sizes=SIZES, draws=draws)
    before = [p.detach().clone() for p in model.parameters()]
    _, metrics = step(state, batch)
    assert torch.isfinite(metrics["val_loss"])
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
