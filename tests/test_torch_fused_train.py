"""Port parity: the differentiable kernel-backed forward
(:mod:`mpinets_torch.model.fused_train`) against the JAX package.

On the CPU the port's SA stages run their plain versions; the JAX side runs
its Pallas kernels in interpret mode, or its plain ``model.apply``.

* f32, whole policy, ``sa_impl`` v8 and v3: value and parameter gradients
  of ``sum(sin(dq))`` against ``jax.value_and_grad`` of ``model.apply``,
  weights perturbed off the init as ``tests/test_fused_train.py:33-42``
  does; value atol 1e-5 / rtol 1e-4, gradients atol 2e-5 + 1e-4 max|g|
  (``test_fused_train.py:62-75``).
* one SA stage, f32 and bf16, v8 and v3: the stage's value and the
  gradients of its features and MLP against ``make_sa_stage_train``'s VJP
  (interpret mode) within 1e-2 max|g| (1e-5 in f32). The port's bf16 v8
  backward differentiates the v8 kernel's own arithmetic (raw rows rounded,
  the recentring folded into layer 1's bias, f32 pre-activations), where
  the package's VJP replays the stage with recentred rows and bf16 matmul
  outputs, whose maxima and ties differ at bf16 resolution. So its
  gradients are held twice: to the package's VJP tensor by tensor, as the
  whole bf16 policy is below (relative L2 within sqrt(2) times the VJP's
  own bf16-to-f32 distance, plus 1e-3; measured 0.22-0.88 times it), and
  within 1e-2 max|g| to ``jax.vjp`` of the kernel's arithmetic on the
  Pallas kernel's selection.
* bf16, whole policy, against ``make_fused_train_apply(jnp.bfloat16,
  interpret=True)``: value within 1e-2 relative. Element-wise gradients
  cannot hold 1e-2 max|g| in either package: rounding every activation to
  bf16 moves JAX's own bf16 gradients off its f32 gradients by up to 0.4
  max|g| per tensor (relative L2 from 5e-4 to 0.40 per tensor on this
  input). The test holds each of the port's bf16 gradient tensors to JAX's
  by that measure, tensor by tensor: two bf16 computations that round in
  different places are each about the bf16-to-f32 distance from the f32
  gradients, so no more than sqrt(2) times it from each other, plus a floor
  of 1e-3 (measured: at most 1.05 times it, feature_encoder_1's bias; the
  SA stages' tensors 0.12-0.37 times it).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.model import checkpoint  # noqa: E402
from mpinets_torch.model.fused_train import (  # noqa: E402
    make_fused_train_apply,
    make_sa_stage_train,
)
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_tpu.kernels import pallas_ops  # noqa: E402
from mpinets_tpu.model import fused_train as jfused_train  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402

torch.set_float32_matmul_precision("highest")

NPOINTS = (16, 8)
BF16_GRAD_FLOOR = 1e-3  # relative L2, for tensors whose bf16 and f32 gradients agree


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    pc = np.concatenate([rng.uniform(-0.7, 0.7, (2, 256, 3)),
                         rng.integers(0, 3, (2, 256, 1))], -1).astype(np.float32)
    q = rng.uniform(-1, 1, (2, 7)).astype(np.float32)
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(pc), jnp.asarray(q))
    # off the init: its all-zero biases put activations at exact ties
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    leaves = [np.asarray(leaf) + 0.01 * rng.normal(size=leaf.shape).astype(np.float32)
              for leaf in leaves]
    variables = jax.tree_util.tree_unflatten(treedef, leaves)
    loss = lambda fwd: lambda v: jnp.sum(jnp.sin(fwd(v, jnp.asarray(pc), jnp.asarray(q))))
    v_ref, g_ref = jax.jit(jax.value_and_grad(loss(jmodel.apply)))(variables)
    return dict(pc=pc, q=q, variables=variables, loss=loss, value=float(v_ref),
                grads=_flat(g_ref))


def _port_value_and_grads(setup, compute_dtype, sa_impl="v8"):
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu")
    model.load_state_dict(checkpoint.params_from_flax(setup["variables"]))
    apply = make_fused_train_apply(compute_dtype, sa_impl=sa_impl)
    value = torch.sin(apply(model, torch.from_numpy(setup["pc"]),
                            torch.from_numpy(setup["q"]))).sum()
    value.backward()
    grads = checkpoint.flax_from_params({k: p.grad for k, p in model.named_parameters()})
    return float(value.detach()), _flat(grads)


@pytest.mark.parametrize("sa_impl", ["v8", "v3"])
def test_fused_train_f32_matches_flax_value_and_grads(setup, sa_impl):
    value, grads = _port_value_and_grads(setup, torch.float32, sa_impl)
    np.testing.assert_allclose(value, setup["value"], atol=1e-5, rtol=1e-4)
    g_ref = setup["grads"]
    assert grads.keys() == g_ref.keys()
    for name, ref in g_ref.items():
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(grads[name], ref, atol=2e-5 + 1e-4 * scale,
                                   err_msg=f"grad mismatch at {name}")


def _stage_inputs(seed, b=2, n=256, s=16, c=8):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.6, 0.6, (b, n, 3)).astype(np.float32)
    feat = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    dims = (3 + c, 32, 32, 48)
    weights = []
    for i in range(3):
        weights.append((rng.normal(size=(dims[i], dims[i + 1])) * 0.2).astype(np.float32))
        weights.append((rng.normal(size=(dims[i + 1],)) * 0.2).astype(np.float32))
    cot = rng.normal(size=(b, s, dims[-1])).astype(np.float32)
    return xyz, feat, xyz[:, :s].copy(), weights, cot


def _rel(a, b):
    """Relative L2 distance of two arrays: |a - b| / |b|."""
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _v8_bf16_stage(xyz, cent, idx):
    """(features, *mlp) -> the v8 kernel's bf16 stage on the selection idx,
    in its arithmetic (``pallas_ops.py:928-953``), plain JAX."""
    rnd = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    valid = jnp.concatenate([jnp.ones_like(idx[..., :1], bool), idx[..., 1:] != idx[..., :1]],
                            axis=-1)[..., None]

    def stage(feat, w1, b1, w2, b2, w3, b3):
        flat = idx.reshape(idx.shape[0], -1)[..., None]
        raw = jnp.concatenate([jnp.take_along_axis(xyz, flat, 1),
                               jnp.take_along_axis(feat, flat, 1)], -1)
        raw = jnp.where(valid, raw.reshape(idx.shape + (-1,)), 0.0)
        u1 = mm(rnd(raw), rnd(w1)) + b1 - mm(cent, w1[:3])[:, :, None, :]
        h1 = rnd(jax.nn.relu(u1))
        h2 = rnd(jax.nn.relu(mm(h1, rnd(w2)) + b2))
        z = jax.nn.relu(mm(h2, rnd(w3)) + b3)
        return jnp.max(jnp.where(valid, z, -jnp.inf), axis=2)

    return stage


@pytest.mark.parametrize("sa_impl, dtype", [("v8", torch.float32), ("v8", torch.bfloat16),
                                            ("v3", torch.bfloat16)])
def test_sa_stage_train_matches_pallas_vjp(sa_impl, dtype):
    xyz, feat, cent, weights, cot = _stage_inputs(12)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jsa = jfused_train.make_sa_stage_train(0.3, 128, jdt, interpret=True, tile_s=8,
                                           sa_impl=sa_impl)
    ref, vjp = jax.vjp(lambda f, *w: jsa(jnp.asarray(xyz), f, jnp.asarray(cent), *w),
                       jnp.asarray(feat), *map(jnp.asarray, weights))
    ref_grads = vjp(jnp.asarray(cot))
    sa = make_sa_stage_train(0.3, 128, dtype, sa_impl)
    f = torch.from_numpy(feat).requires_grad_()
    w = [torch.from_numpy(a).requires_grad_() for a in weights]
    out = sa(torch.from_numpy(xyz), f, torch.from_numpy(cent), *w)
    grads = torch.autograd.grad(out, [f, *w], torch.from_numpy(cot))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol)
    if (sa_impl, dtype) == ("v8", torch.bfloat16):
        jsa32 = jfused_train.make_sa_stage_train(0.3, 128, jnp.float32, interpret=True, tile_s=8,
                                                 sa_impl=sa_impl)
        _, vjp32 = jax.vjp(lambda f, *w: jsa32(jnp.asarray(xyz), f, jnp.asarray(cent), *w),
                           jnp.asarray(feat), *map(jnp.asarray, weights))
        for ours, theirs, f32 in zip(grads, ref_grads, vjp32(jnp.asarray(cot))):
            theirs, f32 = np.asarray(theirs), np.asarray(f32)
            bound = np.sqrt(2) * _rel(theirs, f32) + BF16_GRAD_FLOOR
            assert _rel(ours.numpy(), theirs) <= bound, (_rel(ours.numpy(), theirs), bound)
        _, idx, _ = pallas_ops.sa_stage(jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(cent),
                                        *map(jnp.asarray, weights), radius=0.3,
                                        compute_dtype=jnp.bfloat16, interpret=True, tile_s=8,
                                        impl="v8", centroids_in_cloud=True, return_raw=True)
        _, vjp = jax.vjp(_v8_bf16_stage(jnp.asarray(xyz), jnp.asarray(cent), idx),
                         jnp.asarray(feat), *map(jnp.asarray, weights))
        ref_grads = vjp(jnp.asarray(cot))
    for ours, theirs in zip(grads, ref_grads):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, atol=tol * np.abs(theirs).max())
    # SA0 takes no feature cotangent
    sa0 = make_sa_stage_train(0.3, 128, dtype, sa_impl, features_grad=False)
    out = sa0(torch.from_numpy(xyz), f, torch.from_numpy(cent), *w)
    assert torch.autograd.grad(out.sum(), f, allow_unused=True)[0] is None


def test_fused_train_bf16_matches_pallas_interpret(setup):
    jfused = jfused_train.make_fused_train_apply(jnp.bfloat16, interpret=True,
                                                 sa_npoints=NPOINTS)
    v_ref, g_ref = jax.jit(jax.value_and_grad(setup["loss"](jfused)))(setup["variables"])
    g_f32 = setup["grads"]
    value, grads = _port_value_and_grads(setup, torch.bfloat16)
    np.testing.assert_allclose(value, float(v_ref), rtol=1e-2)
    g_ref = _flat(g_ref)
    assert grads.keys() == g_ref.keys()

    for name, ref in g_ref.items():
        bound = np.sqrt(2) * _rel(ref, g_f32[name]) + BF16_GRAD_FLOOR
        assert _rel(grads[name], ref) <= bound, (name, _rel(grads[name], ref), bound)
