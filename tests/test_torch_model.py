"""Port parity: the policy module and the kernel-backed forward.

Weights come from the JAX package's ``model.init`` and go through
:func:`mpinets_torch.model.checkpoint.params_from_flax`. In f32 the port's
plain policy must equal ``model.apply``, and the kernel-backed forward (its
plain versions, on the CPU) the port's policy, to atol 2e-5 / rtol 1e-4 --
the tolerance of ``tests/test_pallas_sa.py:131``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.model import checkpoint  # noqa: E402
from mpinets_torch.model.fused import fused_policy_apply, make_fused_apply  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402

torch.set_float32_matmul_precision("highest")

NPOINTS = (16, 8)


def _inputs(seed=0, b=2, n=256):
    rng = np.random.default_rng(seed)
    pc = np.concatenate([rng.uniform(-0.7, 0.7, (b, n, 3)),
                         rng.integers(0, 3, (b, n, 1))], -1).astype(np.float32)
    q = rng.uniform(-1, 1, (b, 7)).astype(np.float32)
    return pc, q


@pytest.fixture(scope="module")
def flax_and_port():
    pc, q = _inputs()
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(pc), jnp.asarray(q))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu")
    model.load_state_dict(checkpoint.params_from_flax(variables))
    return jmodel, variables, model.eval()


def test_params_from_flax_roundtrip(flax_and_port):
    _, variables, model = flax_and_port
    back = checkpoint.flax_from_params(model.state_dict())
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(back), flat(dict(variables))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert model.state_dict()["point_cloud_encoder.sa1.mlp.conv0.weight"].shape == (128, 67)


def test_flax_npz_roundtrip(flax_and_port, tmp_path):
    _, variables, model = flax_and_port
    checkpoint.save_flax_npz(tmp_path / "w.npz", variables)
    state = checkpoint.params_from_flax(checkpoint.load_flax_npz(tmp_path / "w.npz"))
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("seed", [0, 1])
def test_policy_matches_flax(flax_and_port, seed):
    jmodel, variables, model = flax_and_port
    pc, q = _inputs(seed)
    ref = jmodel.apply(variables, jnp.asarray(pc), jnp.asarray(q))
    with torch.no_grad():
        ours = model(torch.from_numpy(pc), torch.from_numpy(q))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("fast_grouping", [0, 2])
def test_fused_matches_policy(flax_and_port, fast_grouping):
    """fast_grouping=2 covers both chunks of a 256-point cloud, so the
    relaxed SA0 selects the exact sets here."""
    _, _, model = flax_and_port
    pc, q = (torch.from_numpy(a) for a in _inputs(3))
    with torch.no_grad():
        ref = model(pc, q)
    ours = fused_policy_apply(model, pc, q, compute_dtype=torch.float32, sa_npoints=NPOINTS,
                              fast_grouping=fast_grouping)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)
    apply = make_fused_apply(torch.float32, sa_npoints=NPOINTS, fast_grouping=fast_grouping)
    assert torch.equal(apply(model, pc, q), ours)


def test_fused_apply_follows_weight_changes(flax_and_port):
    """make_fused_apply prepares the SA weights once, and again after the
    model's weights change in place."""
    _, _, model = flax_and_port
    pc, q = (torch.from_numpy(a) for a in _inputs(6))
    other = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu",
                                generator=torch.Generator().manual_seed(4)).eval()
    apply = make_fused_apply(torch.float32, sa_npoints=NPOINTS)
    before = apply(other, pc, q)
    other.load_state_dict(model.state_dict())
    after = apply(other, pc, q)
    assert not torch.equal(before, after)
    assert torch.equal(after, fused_policy_apply(model, pc, q, compute_dtype=torch.float32,
                                                 sa_npoints=NPOINTS))


def test_fused_bf16_close_to_f32(flax_and_port):
    _, _, model = flax_and_port
    pc, q = (torch.from_numpy(a) for a in _inputs(4))
    f32 = fused_policy_apply(model, pc, q, compute_dtype=torch.float32, sa_npoints=NPOINTS)
    bf16 = fused_policy_apply(model, pc, q, compute_dtype=torch.bfloat16, sa_npoints=NPOINTS)
    assert bf16.dtype == torch.float32 and bf16.shape == (2, 7)
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), atol=2e-2 * f32.abs().max().item())


def test_unported_knobs_raise(flax_and_port):
    _, _, model = flax_and_port
    pc, q = (torch.from_numpy(a) for a in _inputs(5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_policy_apply(model, pc, q, sa_npoints=NPOINTS, sa_impl="v5")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_policy_apply(model, pc, q, sa_npoints=NPOINTS, bf16_cloud=True)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MotionPolicyNetwork()


def test_random_init_is_seeded():
    a = MotionPolicyNetwork(device="cpu", generator=torch.Generator().manual_seed(3))
    b = MotionPolicyNetwork(device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
