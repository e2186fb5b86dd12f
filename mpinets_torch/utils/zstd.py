"""Zstandard decompression in Python and numpy (RFC 8878).

The JAX package's orbax checkpoints store every chunk as a zstd frame, and
the card's machine has no zstd library, so the port carries its own
decoder. Frames are parsed in Python (block headers, Huffman and FSE
tables, the sequences); the Huffman-coded literals, which are nearly all of
a weight checkpoint's bytes, are decoded for every stream of every frame at
once: one numpy step a symbol position, each step decoding that position of
all streams (:func:`_decode_huffman_streams`). Dictionaries are not
supported, and the optional content checksum is not verified.

    decompress(frame_bytes) -> bytes
    decompress_many([frame_bytes, ...]) -> [bytes, ...]
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50  # 0x184D2A50..0x184D2A5F

# Literal-length and match-length codes: (baseline, extra bits), RFC 8878
# 3.1.1.3.2.1.1
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# Predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3] + [2] * 11 + [1] * 3 + [2] * 9 + [3, 2] + [1] * 5 + [-1] * 4, 6)
_ML_DEFAULT = ([1, 4, 3] + [2] * 6 + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1] * 6 + [2] * 3 + [1] * 15 + [-1] * 5, 5)
# (max symbol, max accuracy log) of each sequence table
_LIMITS = {"ll": (35, 9), "of": (31, 8), "ml": (52, 9)}


class ZstdError(ValueError):
    """The input is not a zstd frame this decoder reads."""


class _Backward:
    """A bitstream read from its end (RFC 8878 4.1): the last byte's
    highest set bit marks the start; bits past the stream's start read as
    zeros. ``p`` is the number of unread bits (negative once over-read)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("a backward bitstream must end in a marker bit")
        self.d = data
        self.p = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.p -= n
        p, hi = self.p, self.p + n
        if hi <= 0:
            return 0
        lo = max(p, 0)
        v = int.from_bytes(self.d[lo >> 3:(hi + 7) >> 3], "little") >> (lo & 7)
        v &= (1 << (hi - lo)) - 1
        return v << (lo - p)


class _Fse(NamedTuple):
    """An FSE decoding table: per state its symbol, bits to read and the
    baseline of the next state."""

    symbol: List[int]
    nbits: List[int]
    base: List[int]
    log: int


def _read_counts(data: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description (RFC 8878 4.1.1) -> (normalized counts,
    accuracy log, position after it)."""
    x = int.from_bytes(data[pos:pos + 2 * (max_symbol + 2) + 2], "little")
    log = (x & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    b = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    zero = False
    while remaining > 1 and len(counts) <= max_symbol:
        if zero:
            while True:
                r = (x >> b) & 3
                b += 2
                counts.extend([0] * r)
                if r != 3:
                    break
            if len(counts) > max_symbol:
                raise ZstdError("FSE zero run past the last symbol")
        most = (2 * threshold - 1) - remaining
        low = (x >> b) & (threshold - 1)
        if low < most:
            count = low
            b += nbits - 1
        else:
            count = (x >> b) & (2 * threshold - 1)
            if count >= threshold:
                count -= most
            b += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdError("FSE counts do not fill the table")
    return counts, log, pos + ((b + 7) >> 3)


def _fse_table(counts: Sequence[int], log: int) -> _Fse:
    """Spread the symbols over the states (RFC 8878 4.1.1)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    following = []
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            following.append(1)
        else:
            following.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        n = following[symbol[u]]
        following[symbol[u]] += 1
        nbits[u] = log - (n.bit_length() - 1)
        base[u] = (n << nbits[u]) - size
    return _Fse(symbol, nbits, base, log)


_PREDEFINED = {k: _fse_table(*v) for k, v in
               (("ll", _LL_DEFAULT), ("of", _OF_DEFAULT), ("ml", _ML_DEFAULT))}


class _Huffman(NamedTuple):
    """A literal decoding table indexed by the next ``bits`` bits (entry
    ``symbol | nbits << 8``)."""

    table: np.ndarray
    bits: int


def _read_huffman(data: bytes, pos: int):
    """A Huffman tree description (RFC 8878 4.2.1) -> (table, position
    after it)."""
    head = data[pos]
    pos += 1
    if head < 128:
        end = pos + head
        counts, log, start = _read_counts(data[:end], pos, 255, 6)
        fse = _fse_table(counts, log)
        bs = _Backward(data[start:end])
        states = [bs.read(log), bs.read(log)]
        weights: List[int] = []
        i = 0
        while True:
            s = states[i]
            weights.append(fse.symbol[s])
            states[i] = fse.base[s] + bs.read(fse.nbits[s])
            i ^= 1
            if bs.p < 0:
                weights.append(fse.symbol[states[i]])
                break
            if len(weights) > 255:
                raise ZstdError("too many Huffman weights")
        pos = end
    else:
        n = head - 127
        weights = [(data[pos + i // 2] >> (0 if i & 1 else 4)) & 15 for i in range(n)]
        pos += (n + 1) // 2
    total = sum(1 << (w - 1) for w in weights if w)
    bits = total.bit_length()
    rest = (1 << bits) - total
    if bits > 11 or rest & (rest - 1):
        raise ZstdError("malformed Huffman weights")
    weights.append(rest.bit_length())
    start = [0] * (bits + 2)
    for w in weights:
        if w:
            start[w + 1] += 1 << (w - 1)
    for w in range(1, bits + 2):
        start[w] += start[w - 1]
    table = np.zeros(1 << bits, np.int32)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            table[start[w]:start[w] + n] = s | ((bits + 1 - w) << 8)
            start[w] += n
    return _Huffman(table, bits), pos


class _Stream(NamedTuple):
    data: bytes
    table: _Huffman
    count: int
    dst: int  # offset in the literal buffer


class _Block(NamedTuple):
    kind: str              # "raw" | "cmp"
    data: bytes            # raw: the block's bytes
    lit: int = 0           # cmp: literals at lit_buffer[lit:lit + n_lit]
    n_lit: int = 0
    seqs: tuple = ()       # cmp: (literal length, offset value, match length)


class _FrameState:
    """Tables a block may repeat from the frame's previous blocks."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.fse = {"ll": None, "of": None, "ml": None}


class _Parser:
    """First pass: every block parsed, every sequence decoded, literals
    queued (raw and RLE literals copied, Huffman streams listed)."""

    def __init__(self):
        self.streams: List[_Stream] = []
        self.direct: List[tuple] = []  # (dst, bytes)
        self.n_lit = 0

    def _literals(self, data: bytes, pos: int, st: _FrameState):
        b0 = data[pos]
        kind, fmt = b0 & 3, (b0 >> 2) & 3
        if kind < 2:  # raw or RLE
            if fmt in (0, 2):
                size, pos = b0 >> 3, pos + 1
            elif fmt == 1:
                size, pos = int.from_bytes(data[pos:pos + 2], "little") >> 4, pos + 2
            else:
                size, pos = int.from_bytes(data[pos:pos + 3], "little") >> 4, pos + 3
            lit = bytes(data[pos:pos + size]) if kind == 0 else bytes([data[pos]]) * size
            self.direct.append((self.n_lit, lit))
            dst = self.n_lit
            self.n_lit += size
            return dst, size, pos + (size if kind == 0 else 1)
        head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
        width = {3: 10, 4: 14, 5: 18}[head]
        v = int.from_bytes(data[pos:pos + head], "little") >> 4
        size, csize = v & ((1 << width) - 1), v >> width
        pos += head
        end = pos + csize
        if kind == 2:
            st.huffman, pos = _read_huffman(data, pos)
        elif st.huffman is None:
            raise ZstdError("treeless literals without a previous Huffman table")
        dst = self.n_lit
        if fmt == 0:
            self.streams.append(_Stream(bytes(data[pos:end]), st.huffman, size, dst))
        else:
            sizes = [int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3)]
            pos += 6
            sizes.append(end - pos - sum(sizes))
            each = (size + 3) // 4
            for i, n in enumerate(sizes):
                count = each if i < 3 else size - 3 * each
                self.streams.append(_Stream(bytes(data[pos:pos + n]), st.huffman, count,
                                            dst + i * each))
                pos += n
        self.n_lit += size
        return dst, size, end

    @staticmethod
    def _sequences(data: bytes, pos: int, end: int, st: _FrameState):
        b0 = data[pos]
        if b0 == 0:
            return ()
        if b0 < 128:
            n, pos = b0, pos + 1
        elif b0 < 255:
            n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
        else:
            n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
        modes = data[pos]
        pos += 1
        for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
            mode = (modes >> shift) & 3
            if mode == 0:
                st.fse[name] = _PREDEFINED[name]
            elif mode == 1:
                st.fse[name] = _Fse([data[pos]], [0], [0], 0)
                pos += 1
            elif mode == 2:
                counts, log, pos = _read_counts(data[:end], pos, *_LIMITS[name])
                st.fse[name] = _fse_table(counts, log)
            elif st.fse[name] is None:
                raise ZstdError("repeated sequence table without a previous one")
        ll_t, of_t, ml_t = st.fse["ll"], st.fse["of"], st.fse["ml"]
        bs = _Backward(data[pos:end])
        sll, sof, sml = bs.read(ll_t.log), bs.read(of_t.log), bs.read(ml_t.log)
        seqs = []
        for i in range(n):
            ofc, mlc, llc = of_t.symbol[sof], ml_t.symbol[sml], ll_t.symbol[sll]
            if llc >= len(_LL) or mlc >= len(_ML) or ofc > 31:
                raise ZstdError("sequence code out of range")
            offset = (1 << ofc) + bs.read(ofc)
            ml = _ML[mlc][0] + bs.read(_ML[mlc][1])
            ll = _LL[llc][0] + bs.read(_LL[llc][1])
            seqs.append((ll, offset, ml))
            if i < n - 1:
                sll = ll_t.base[sll] + bs.read(ll_t.nbits[sll])
                sml = ml_t.base[sml] + bs.read(ml_t.nbits[sml])
                sof = of_t.base[sof] + bs.read(of_t.nbits[sof])
        if bs.p > 0:
            raise ZstdError("sequence bitstream not consumed")
        return tuple(seqs)

    def frames(self, data: bytes) -> List[List[_Block]]:
        """All frames of ``data`` -> their blocks."""
        out = []
        pos = 0
        while pos < len(data):
            magic = int.from_bytes(data[pos:pos + 4], "little")
            if magic & 0xFFFFFFF0 == _SKIPPABLE:
                pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
                continue
            if magic != MAGIC:
                raise ZstdError(f"no zstd frame at byte {pos}")
            fhd = data[pos + 4]
            single, checksum, dict_flag = (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
            if dict_flag and int.from_bytes(
                    data[pos + 5 + (not single):pos + 5 + (not single) + (1, 2, 4)[dict_flag - 1]],
                    "little"):
                raise ZstdError("zstd dictionaries are not supported")
            pos += 5 + (not single) + (0, 1, 2, 4)[dict_flag] + (
                (1 if single else 0), 2, 4, 8)[fhd >> 6]
            st, blocks = _FrameState(), []
            while True:
                head = int.from_bytes(data[pos:pos + 3], "little")
                last, kind, size = head & 1, (head >> 1) & 3, head >> 3
                pos += 3
                if kind == 0:
                    blocks.append(_Block("raw", bytes(data[pos:pos + size])))
                    pos += size
                elif kind == 1:
                    blocks.append(_Block("raw", bytes([data[pos]]) * size))
                    pos += 1
                elif kind == 2:
                    end = pos + size
                    lit, n_lit, p = self._literals(data, pos, st)
                    blocks.append(_Block("cmp", b"", lit, n_lit,
                                         self._sequences(data, p, end, st)))
                    pos = end
                else:
                    raise ZstdError("reserved block type")
                if last:
                    break
            pos += 4 * checksum
            out.append(blocks)
        return out


def _decode_huffman_streams(streams: Sequence[_Stream], lit: np.ndarray) -> None:
    """Decode every stream into ``lit``, all streams in lockstep: step k
    decodes the k-th symbol of each stream still running (streams sorted
    longest first, so the running ones are a prefix)."""
    if not streams:
        return
    streams = sorted(streams, key=lambda s: -s.count)
    tables, offsets = {}, []
    for s in streams:
        if id(s.table) not in tables:
            tables[id(s.table)] = (sum(len(t.table) for _, t in tables.values()), s.table)
        offsets.append(tables[id(s.table)][0])
    entry = np.concatenate([t.table for _, t in tables.values()])
    pad = 4  # zero bytes before each stream: bits read past its start are 0
    chunks, base, start = [], [], pad
    for s in streams:
        chunks += [bytes(pad), s.data]
        base.append(start)
        start += pad + len(s.data)
    buf = b"".join(chunks) + bytes(pad)
    words = np.ndarray((len(buf) - 3,), "<u4", buffer=buf, strides=(1,))
    n = len(streams)
    bits = np.array([s.table.bits for s in streams], np.int64)
    mask = (1 << bits) - 1
    for s in streams:
        if not s.data or s.data[-1] == 0:
            raise ZstdError("a Huffman stream must end in a marker bit")
    p = np.array([8 * (len(s.data) - 1) + s.data[-1].bit_length() - 1 for s in streams],
                 np.int64)
    lo0 = 8 * np.array(base, np.int64) - bits
    toff = np.array(offsets, np.int64)
    dst = np.array([s.dst for s in streams], np.int64)
    counts = [s.count for s in streams]
    a = n
    for k in range(counts[0]):
        while counts[a - 1] <= k:
            a -= 1
        lo = lo0[:a] + p[:a]
        e = entry[toff[:a] + ((words[lo >> 3] >> (lo & 7)) & mask[:a])]
        lit[dst[:a] + k] = e & 255
        p[:a] -= e >> 8
    if (p != 0).any():
        raise ZstdError("a Huffman stream was not consumed exactly")


def _execute(blocks: List[_Block], lit: np.ndarray) -> bytes:
    """Third pass: literals and matches into the frame's content."""
    out = bytearray()
    rep = [1, 4, 8]
    for blk in blocks:
        if blk.kind == "raw":
            out += blk.data
            continue
        lits = lit[blk.lit:blk.lit + blk.n_lit].tobytes()
        i = 0
        for ll, ov, ml in blk.seqs:
            out += lits[i:i + ll]
            i += ll
            if ov > 3:
                off = ov - 3
                rep = [off, rep[0], rep[1]]
            else:
                idx = ov - 1 + (ll == 0)
                if idx == 0:
                    off = rep[0]
                elif idx == 3:
                    off = rep[0] - 1
                    rep = [off, rep[0], rep[1]]
                else:
                    off = rep[idx]
                    rep = [off, rep[0], rep[2] if idx == 1 else rep[1]]
            if not 0 < off <= len(out):
                raise ZstdError("match offset outside the decoded data")
            start = len(out) - off
            if off >= ml:
                out += out[start:start + ml]
            else:
                out += (out[start:] * (ml // off + 1))[:ml]
        if i > len(lits):
            raise ZstdError("sequences use more literals than the block has")
        out += lits[i:]
    return bytes(out)


def decompress_many(items: Sequence[bytes]) -> List[bytes]:
    """Decompress each item (one or more frames), decoding the literals of
    all of them in one lockstep pass."""
    parser = _Parser()
    parsed = [parser.frames(memoryview(bytes(x))) for x in items]
    lit = np.zeros(parser.n_lit, np.uint8)
    for dst, data in parser.direct:
        lit[dst:dst + len(data)] = np.frombuffer(data, np.uint8)
    _decode_huffman_streams(parser.streams, lit)
    return [b"".join(_execute(blocks, lit) for blocks in frames) for frames in parsed]


def decompress(data: bytes) -> bytes:
    return decompress_many([data])[0]
