"""Real-weight parity: the committed ``checkpoints/r5_ft_best_ema`` (flax,
bf16) read on the JAX side, converted with
:func:`mpinets_torch.model.checkpoint.params_from_flax`, and run through the
port's policy against ``model.apply`` in f32 (the bf16 weights upcast,
which is exact) at a small cloud: atol 2e-5, rtol 1e-4.
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
def real_weights():
    jmodel = JaxPolicy(sa_npoints=NPOINTS)
    variables = load_params(str(CKPT), jmodel)
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
                               compute_dtype=torch.float32, sa_npoints=NPOINTS)
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
