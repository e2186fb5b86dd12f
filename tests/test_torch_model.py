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


def test_fused_follows_the_models_radii(flax_and_port):
    """The kernel path takes each stage's radius from the model, not from
    the reference sizes."""
    _, _, model = flax_and_port
    wide = MotionPolicyNetwork(sa_npoints=NPOINTS, sa_radii=(0.15, 0.45), device="cpu").eval()
    wide.load_state_dict(model.state_dict())
    pc, q = (torch.from_numpy(a) for a in _inputs(5))
    with torch.no_grad():
        ref = wide(pc, q)
        assert not torch.allclose(ref, model(pc, q), atol=1e-4)
    ours = fused_policy_apply(wide, pc, q, compute_dtype=torch.float32, sa_npoints=NPOINTS)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


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
    """Every knob of the JAX fused forward is ported now: the v3/v5 stages
    (same value as v8 on FPS centroids, which are cloud members) and
    ``bf16_cloud``, which no longer raises (its parity:
    ``test_bf16_cloud_matches_pallas_interpret``)."""
    _, _, model = flax_and_port
    pc, q = (torch.from_numpy(a) for a in _inputs(5))
    v8 = fused_policy_apply(model, pc, q, compute_dtype=torch.float32, sa_npoints=NPOINTS)
    for sa_impl in ("v3", "v5"):
        assert torch.equal(fused_policy_apply(model, pc, q, compute_dtype=torch.float32,
                                              sa_npoints=NPOINTS, sa_impl=sa_impl), v8)
    out = fused_policy_apply(model, pc, q, sa_npoints=NPOINTS, bf16_cloud=True)
    assert out.shape == (2, 7) and torch.isfinite(out).all()


@pytest.mark.parametrize("fast", [0, 4], ids=["exact", "fast4"])
def test_bf16_cloud_matches_pallas_interpret(flax_and_port, fast):
    """``bf16_cloud=True`` against ``make_fused_apply(bf16_cloud=True,
    interpret=True)``, bf16: FPS on the bf16-rounded cloud picks the same
    indices as the Pallas kernel (interpret mode), and dq agrees within the
    bf16 forward tolerance, 2e-2 x max|dq|."""
    from mpinets_torch.kernels import ops
    from mpinets_tpu.kernels import pallas_ops
    from mpinets_tpu.model.fused import make_fused_apply as jax_fused

    jmodel, variables, model = flax_and_port
    pc, q = _inputs(6, n=300)
    ref = np.asarray(jax_fused(jnp.bfloat16, interpret=True, sa_npoints=NPOINTS,
                               bf16_cloud=True, fast_grouping=fast)(
        variables, jnp.asarray(pc), jnp.asarray(q)))
    ours = fused_policy_apply(model, torch.from_numpy(pc), torch.from_numpy(q),
                              compute_dtype=torch.bfloat16, sa_npoints=NPOINTS,
                              bf16_cloud=True, fast_grouping=fast).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-2 * np.abs(ref).max(), rtol=0)
    if fast:
        return
    xyz = pc[..., :3]
    jidx, jc = pallas_ops.furthest_point_sample_with_coords(
        jnp.asarray(xyz).astype(jnp.bfloat16), NPOINTS[0], interpret=True)
    idx, c = ops.furthest_point_sample_with_coords(
        torch.from_numpy(xyz).to(torch.bfloat16), NPOINTS[0])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert c.dtype == torch.bfloat16
    np.testing.assert_array_equal(c.float().numpy(), np.asarray(jc.astype(jnp.float32)))


def test_fps_impl_v2_matches_v1_and_the_jax_fused_forward(flax_and_port):
    """``fps_impl="v2"`` reaches both FPS calls (as
    ``mpinets_tpu/model/fused.py:109,132``): it equals v1 and the JAX
    fused forward with ``fps_impl="v2"`` in interpret mode, f32, at the f32
    forward tolerance (atol 2e-5, rtol 1e-4)."""
    from mpinets_tpu.model.fused import fused_policy_apply as jax_fused

    _, variables, model = flax_and_port
    pc, q = _inputs(7)
    v1 = fused_policy_apply(model, torch.from_numpy(pc), torch.from_numpy(q),
                            compute_dtype=torch.float32, sa_npoints=NPOINTS)
    v2 = fused_policy_apply(model, torch.from_numpy(pc), torch.from_numpy(q),
                            compute_dtype=torch.float32, sa_npoints=NPOINTS, fps_impl="v2")
    assert torch.equal(v1, v2)
    apply = make_fused_apply(torch.float32, sa_npoints=NPOINTS, fps_impl="v2")
    assert torch.equal(apply(model, torch.from_numpy(pc), torch.from_numpy(q)), v2)
    ref = jax_fused(variables, jnp.asarray(pc), jnp.asarray(q), compute_dtype=jnp.float32,
                    interpret=True, sa_npoints=NPOINTS, fps_impl="v2")
    np.testing.assert_allclose(v2.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="FPS impl"):
        fused_policy_apply(model, torch.from_numpy(pc), torch.from_numpy(q),
                           compute_dtype=torch.float32, sa_npoints=NPOINTS, fps_impl="v9")


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
