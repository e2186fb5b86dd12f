"""Read the JAX package's orbax checkpoints without JAX.

An orbax ``StandardCheckpointer`` directory in the OCDBT layout is a
key-value store (tensorstore's OCDBT format): a manifest names the root
node of a B+tree whose leaves map each key to a value held inline or as a
byte range of a data file. The keys are zarr v2 arrays, one per leaf of the
saved tree (``params.decoder_0.kernel/.zarray`` for the metadata,
``params.decoder_0.kernel/0.0`` for a chunk), each chunk a zstd frame
(:mod:`mpinets_torch.utils.zstd`). :func:`load_tree` returns the saved tree
as nested dicts of numpy arrays, bfloat16 leaves widened to float32
(exactly: a bf16 value is the top half of its f32).

Read here: the single-file manifest of one version, B+tree nodes of any
height, inline and indirect values, zarr v2 arrays with the ``zstd``
compressor or none, C order, any chunk grid, little-endian numeric dtypes
and ``bfloat16``. Anything else raises ``ValueError``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from mpinets_torch.utils import zstd

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE


class _Reader:
    def __init__(self, data: bytes):
        self.d, self.p = data, 0

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.d[self.p]
            self.p += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return v

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        self.p += n
        return bytes(self.d[self.p - n:self.p])


def _body(raw: bytes, magic: int, what: str) -> _Reader:
    """Header (magic, length, version, compression), body, CRC-32C."""
    if len(raw) < 16 or int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"{what}: not an OCDBT {what}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"{what}: truncated")
    r = _Reader(raw)
    r.p = 12
    version, compression = r.varint(), r.varint()
    if version != 0 or compression not in (0, 1):
        raise ValueError(f"{what}: OCDBT version {version}, compression {compression}")
    body = raw[r.p:len(raw) - 4]
    return _Reader(zstd.decompress(body) if compression else body)


def _data_files(r: _Reader) -> List[str]:
    """The data file table: prefix-compressed paths (base + relative)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the path is used whole
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1] if paths else ""
        paths.append(prev[:prefix[i]] + r.take(suffix[i]).decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool):
    """Prefix-compressed keys; an interior node's also give each child's
    common prefix length (which its keys leave out)."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: List[bytes] = []
    for i in range(n):
        keys.append((keys[-1][:prefix[i]] if keys else b"") + r.take(suffix[i]))
    return keys, common


class Store:
    """The key-value pairs of an OCDBT directory."""

    def __init__(self, root):
        self.root = Path(root)
        r = _body((self.root / "manifest.ocdbt").read_bytes(), _MANIFEST_MAGIC, "manifest")
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{self.root}: numbered OCDBT manifests are not read")
        r.varint()
        r.varint()  # max inline value bytes, max decoded node bytes
        r.take(1)  # version tree arity
        if r.varint():
            r.take(4)  # compression level
        files = _data_files(r)
        n = r.varint()
        r.varints(n)  # generation numbers
        heights = list(r.take(n))
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        if not n:
            raise ValueError(f"{self.root}: the manifest holds no version")
        # the newest version's root node (an empty tree has length 0)
        self.root_node = (files[ids[-1]] if lengths[-1] else "", offsets[-1], lengths[-1],
                          heights[-1])
        self._files: Dict[str, bytes] = {}

    def _range(self, name: str, offset: int, length: int) -> bytes:
        if name not in self._files:
            self._files[name] = (self.root / name).read_bytes()
        return self._files[name][offset:offset + length]

    def items(self) -> Dict[str, object]:
        """key -> value bytes (inline) or (file, offset, length)."""
        out: Dict[str, object] = {}
        if self.root_node[2]:
            self._walk(self.root_node, b"", out)
        return out

    def _walk(self, ref, prefix: bytes, out: Dict[str, object]) -> None:
        name, offset, length, height = ref
        r = _body(self._range(name, offset, length), _NODE_MAGIC, "B+tree node")
        if r.take(1)[0] != height:
            raise ValueError(f"{self.root}: B+tree node height mismatch")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            ids = r.varints(len(indirect))
            offs = r.varints(len(indirect))
            ref_of = {i: (files[f], o, lengths[i]) for i, f, o in zip(indirect, ids, offs)}
            for i in range(n):
                key = (prefix + keys[i]).decode()
                if kinds[i] == 1:
                    out[key] = ref_of[i]
                elif kinds[i] == 0:
                    out[key] = r.take(lengths[i])
                else:
                    raise ValueError(f"{self.root}: unknown value kind {kinds[i]}")
            return
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        for i in range(n):
            self._walk((files[ids[i]], offs[i], lens[i], height - 1),
                       prefix + keys[i][:common[i]], out)

    def value(self, v) -> bytes:
        return v if isinstance(v, bytes) else self._range(*v)


def _dtype(spec: str):
    """(storage dtype, widen to f32?) of a zarr v2 dtype string."""
    if spec == "bfloat16":
        return np.dtype("<u2"), True
    dt = np.dtype(spec)
    if dt.byteorder == ">" or dt.kind not in "biuf":
        raise ValueError(f"zarr dtype {spec!r} is not read")
    return dt, False


def load_tree(directory) -> Dict:
    """An orbax OCDBT checkpoint directory -> its tree (nested dicts keyed
    by the path's names, numpy leaves; bf16 as f32)."""
    store = Store(directory)
    metas, chunks = {}, []
    for key, v in store.items().items():
        name, _, tail = key.rpartition("/")
        if tail == ".zarray":
            metas[name] = json.loads(store.value(v))
        else:
            chunks.append((name, tail, store.value(v)))
    if not metas:
        raise ValueError(f"{directory}: no zarr arrays in the checkpoint")
    for name, meta in metas.items():
        if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
            raise ValueError(f"{name}: only C-order zarr v2 arrays without filters are read")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"{name}: compressor {comp.get('id')!r} is not read")
    packed = [metas[name].get("compressor") is not None for name, _, _ in chunks]
    raw = iter(zstd.decompress_many([c for (_, _, c), z in zip(chunks, packed) if z]))
    arrays = {}
    for (name, tail, data), z in zip(chunks, packed):
        meta = metas[name]
        dt, _ = _dtype(meta["dtype"])
        shape, cshape = tuple(meta["shape"]), tuple(meta["chunks"])
        if name not in arrays:
            arrays[name] = np.full(shape, meta.get("fill_value") or 0, dt)
        idx = [int(i) for i in tail.split(meta.get("dimension_separator", "."))] if shape else []
        block = np.frombuffer(next(raw) if z else data, dt).reshape(cshape)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, cshape, shape))
        arrays[name][sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    tree: Dict = {}
    for name, meta in metas.items():
        dt, bf16 = _dtype(meta["dtype"])
        arr = arrays.get(name, np.full(tuple(meta["shape"]), meta.get("fill_value") or 0, dt))
        if bf16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def is_ocdbt_checkpoint(directory) -> bool:
    return (Path(directory) / "manifest.ocdbt").is_file()
