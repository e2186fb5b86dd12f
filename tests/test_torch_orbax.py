"""The port's reader of the JAX package's orbax checkpoints, without JAX:
``mpinets_torch.utils.zstd`` against the ``zstandard`` library (every
block, literal and sequence-table mode its levels produce, several frames
at once, a skippable frame), and ``mpinets_torch.model.orbax`` against
tensorstore's OCDBT key-value store and zarr arrays (B+tree interior nodes, several
versions, chunk grids with partial edge chunks, a scalar, f32, int and
bf16). Bytes and values are equal exactly. The committed checkpoint itself
is held against the JAX package's ``load_params`` in
``tests/test_torch_checkpoint.py``.
"""

import shutil

import numpy as np
import pytest

from mpinets_torch.model import orbax
from mpinets_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")


def _payloads(rng, n):
    """Random, repetitive, skewed, half-float and constant bytes."""
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
            (b"abcabcabd" * (n // 9 + 1))[:n],
            rng.choice(np.frombuffer(b"aaaaabbbcde\0", np.uint8), n).tobytes(),
            rng.normal(size=n // 2).astype(np.float16).tobytes(),
            bytes(n)]


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_zstd_matches_zstandard(level):
    rng = np.random.default_rng(level + 10)
    data = [p for n in (0, 1, 5, 100, 3000, 150_000) for p in _payloads(rng, n)]
    frames = [zstandard.ZstdCompressor(level=level, write_checksum=bool(i % 2),
                                       write_content_size=bool(i % 3)).compress(d)
              for i, d in enumerate(data)]
    assert zstd.decompress_many(frames) == data


def test_zstd_frames_in_a_row_and_skippable_frames():
    rng = np.random.default_rng(0)
    a, b = _payloads(rng, 5000)[2:4]
    c = zstandard.ZstdCompressor(level=3)
    skippable = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"xyz"
    assert zstd.decompress(c.compress(a) + skippable + c.compress(b)) == a + b
    with pytest.raises(zstd.ZstdError, match="no zstd frame"):
        zstd.decompress(b"not a frame")
    with pytest.raises(zstd.ZstdError):
        good = c.compress(a)
        zstd.decompress(good[:-9] + bytes(9))


@pytest.fixture
def tensorstore():
    return pytest.importorskip("tensorstore")


def test_ocdbt_interior_nodes_and_versions(tensorstore, tmp_path):
    kv = tensorstore.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                                   "config": {"max_decoded_node_bytes": 300,
                                              "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(1)
    ref = {}
    for batch in range(3):  # three versions; the newest holds every key
        txn = tensorstore.Transaction()
        for i in range(100 * batch, 100 * batch + 100):
            ref[f"params.layer_{i:03d}.kernel/0.0"] = rng.integers(
                0, 256, rng.integers(1, 40)).astype(np.uint8).tobytes()
            kv.with_transaction(txn).write(f"params.layer_{i:03d}.kernel/0.0",
                                           ref[f"params.layer_{i:03d}.kernel/0.0"]).result()
        txn.commit_async().result()
    store = orbax.Store(tmp_path)
    assert store.root_node[3] > 0  # the root is an interior node
    assert {k: store.value(v) for k, v in store.items().items()} == ref


def test_zarr_arrays_in_ocdbt(tensorstore, tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
          "config": {"max_decoded_node_bytes": 400}}
    rng = np.random.default_rng(0)
    arrays = {"params.a.kernel": (rng.normal(size=(37, 19)).astype(np.float32), [16, 8]),
              "params.a.bias": (rng.normal(size=(19,)).astype(ml_dtypes.bfloat16), [19]),
              "step": (np.array(7, np.int32), []),
              "opt_state.mu.x": (rng.integers(-5, 5, (5, 6, 7)), [2, 6, 3])}
    for name, (a, chunks) in arrays.items():
        dtype = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else a.dtype.str
        t = tensorstore.open({"driver": "zarr", "kvstore": {**kv, "path": name + "/"},
                              "metadata": {"shape": list(a.shape), "chunks": chunks,
                                           "dtype": dtype,
                                           "compressor": {"id": "zstd", "level": 3}}},
                             create=True).result()
        t.write(a).result()
    tree = orbax.load_tree(tmp_path)
    assert sorted(tree) == ["opt_state", "params", "step"]
    np.testing.assert_array_equal(tree["params"]["a"]["kernel"], arrays["params.a.kernel"][0])
    bias = tree["params"]["a"]["bias"]
    assert bias.dtype == np.float32
    np.testing.assert_array_equal(bias, arrays["params.a.bias"][0].astype(np.float32))
    assert tree["step"].shape == () and tree["step"] == 7
    np.testing.assert_array_equal(tree["opt_state"]["mu"]["x"], arrays["opt_state.mu.x"][0])


def test_not_an_ocdbt_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        orbax.Store(tmp_path)
    shutil.copy(__file__, tmp_path / "manifest.ocdbt")
    with pytest.raises(ValueError, match="not an OCDBT manifest"):
        orbax.load_tree(tmp_path)
