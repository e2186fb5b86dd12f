"""Port parity: the JAX package's small public names and their
counterparts -- ``pallas_ops.furthest_point_sample`` (indices only),
``policy.make_policy``, ``franka.FrankaConstants`` and
``engine.VAL_ROLLOUT_LENGTH``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.kernels import ops  # noqa: E402
from mpinets_torch.model import checkpoint  # noqa: E402
from mpinets_torch.model import policy as tpolicy  # noqa: E402
from mpinets_torch.robot import franka as tfr  # noqa: E402
from mpinets_torch.rollout import engine as teng  # noqa: E402
from mpinets_tpu.kernels import pallas_ops  # noqa: E402
from mpinets_tpu.model import policy as jpolicy  # noqa: E402
from mpinets_tpu.robot import franka as jfr  # noqa: E402
from mpinets_tpu.rollout import engine as jeng  # noqa: E402

import torch_fps_cases as cases  # noqa: E402  (tests dir is on sys.path under pytest)


@pytest.mark.parametrize("kind", cases.KINDS)
def test_furthest_point_sample_indices_match_pallas(kind):
    xyz = cases.cloud(kind, 2, 300, seed=7)
    idx = ops.furthest_point_sample(torch.from_numpy(xyz), 150)
    assert idx.dtype == torch.int32 and idx.shape == (2, 150)
    ref = pallas_ops.furthest_point_sample(jnp.asarray(xyz), 150, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))


def test_franka_constants_fields_equal():
    ours, theirs = tfr.FrankaConstants(), jfr.FrankaConstants()
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(theirs)]
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.joint_limits = None


def test_val_rollout_length_is_69_on_both_sides():
    assert teng.VAL_ROLLOUT_LENGTH == jeng.VAL_ROLLOUT_LENGTH == 69


def test_make_policy_is_f32_with_the_jax_policy_parameters():
    model = tpolicy.make_policy(device="cpu")
    assert model.compute_dtype == torch.float32
    assert jpolicy.make_policy().compute_dtype == jnp.float32
    assert tpolicy.make_policy(torch.bfloat16, device="cpu").compute_dtype == torch.bfloat16
    state = model.state_dict()
    assert list(state) == list(tpolicy.MotionPolicyNetwork(device="cpu").state_dict())
    # the JAX policy's parameter tree, by shape only (no compile), in the port's names
    shapes = jax.eval_shape(jpolicy.make_policy().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 600, 4)), jnp.zeros((1, 7)))
    theirs = checkpoint.params_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    assert sorted(theirs) == sorted(state)
    for key, t in state.items():
        assert t.dtype == torch.float32 and tuple(t.shape) == tuple(theirs[key].shape), key
