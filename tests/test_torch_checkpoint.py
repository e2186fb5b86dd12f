"""Real-weight parity: the committed ``checkpoints/r5_ft_best_ema`` (flax,
bf16) read on the JAX side, converted with
:func:`mpinets_torch.model.checkpoint.params_from_flax`, and run through the
port's policy against ``model.apply`` in f32 (the bf16 weights upcast,
which is exact) at a small cloud: atol 2e-5, rtol 1e-4. The port reads the
same directory without JAX (``cli.infer.load_params``,
:mod:`mpinets_torch.model.orbax`) bit for bit, and a bf16 tree round-trips
through ``save_flax_npz`` as its bits.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")
import jax.numpy as jnp  # noqa: E402

from mpinets_torch.model import checkpoint  # noqa: E402
from mpinets_torch.model.fused import fused_policy_apply  # noqa: E402
from mpinets_torch.model.policy import MotionPolicyNetwork  # noqa: E402
from mpinets_tpu.cli.infer import load_params  # noqa: E402
from mpinets_tpu.model.policy import MotionPolicyNetwork as JaxPolicy  # noqa: E402

torch.set_float32_matmul_precision("highest")

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "r5_ft_best_ema"
NPOINTS = (32, 16)


@pytest.fixture(scope="module")
def bf16_tree():
    """The committed checkpoint as the JAX package restores it (bf16)."""
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    return jmodel, load_params(str(CKPT), jmodel)


@pytest.fixture(scope="module")
def real_weights(bf16_tree):
    jmodel, variables = bf16_tree
    f32 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables)
    model = MotionPolicyNetwork(sa_npoints=NPOINTS, device="cpu")
    model.load_state_dict(checkpoint.params_from_flax(f32))
    return jmodel, f32, model.eval()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pc = np.concatenate([rng.uniform(-0.5, 1.0, (2, 512, 3)),
                         rng.integers(0, 3, (2, 512, 1))], -1).astype(np.float32)
    return pc, rng.uniform(-1, 1, (2, 7)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_real_weights_policy_matches_flax(real_weights, seed):
    jmodel, variables, model = real_weights
    pc, q = _inputs(seed)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(pc), jnp.asarray(q)))
    with torch.no_grad():
        ours = model(torch.from_numpy(pc), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)
    fused = fused_policy_apply(model, torch.from_numpy(pc), torch.from_numpy(q),
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(fused.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_real_weights_convert_exactly(real_weights, tmp_path):
    _, variables, model = real_weights
    n_params = sum(v.numel() for v in model.state_dict().values())
    assert 19_000_000 < n_params < 19_300_000  # 19.1M (checkpoints/README.md)
    checkpoint.save_flax_npz(tmp_path / "r5.npz", variables)
    from mpinets_torch.cli.serve import load_model

    loaded = load_model(str(tmp_path / "r5.npz"), None, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_port_reads_the_committed_orbax_checkpoint(real_weights):
    """``cli.infer.load_params`` on the orbax directory, with no JAX: the
    converted tree of the JAX package's restore, key by key, bit for bit."""
    from mpinets_torch.cli.infer import load_params as port_load_params

    _, _, model = real_weights
    ours = port_load_params(CKPT)
    ref = model.state_dict()
    assert ours.keys() == ref.keys() and len(ours) == 46
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and torch.equal(ours[k], v), k
    assert torch.equal(port_load_params(CKPT, use_ema=True)["decoder_0.bias"],
                       ref["decoder_0.bias"])  # the tree is the EMA tree itself


def test_bf16_tree_round_trips_as_its_bits(bf16_tree, real_weights, tmp_path):
    _, variables = bf16_tree
    _, f32, model = real_weights
    tree = jax.tree_util.tree_map(np.asarray, variables)
    checkpoint.save_flax_npz(tmp_path / "bf16.npz", tree)
    checkpoint.save_flax_npz(tmp_path / "f32.npz", f32)
    with np.load(tmp_path / "bf16.npz") as data:
        assert {data[k].dtype for k in data.files} == {np.dtype(np.uint16)}
    assert (tmp_path / "bf16.npz").stat().st_size < 0.5 * (tmp_path / "f32.npz").stat().st_size
    from mpinets_torch.cli.infer import load_params as port_load_params

    for name in ("bf16.npz", "f32.npz"):
        loaded = port_load_params(tmp_path / name)
        for k, v in model.state_dict().items():
            assert torch.equal(loaded[k], v), (name, k)
