"""A Zstandard decompressor (RFC 8878) in Python and numpy.

The JAX package's orbax checkpoints store every array chunk and every
OCDBT node as a zstd frame, and the GPU machine has no zstd module, so the
port carries its own decoder. `decompress` takes any sequence of frames:
zstd frames (every frame-header form; the content checksum, when present,
is verified) and skippable frames. Blocks may be raw, RLE or compressed;
literals raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the
frame's previous Huffman table); sequences with predefined, RLE,
FSE-compressed or repeated tables, and the three repeat offsets.
Dictionaries are not supported: a frame that names one raises ValueError.
Malformed input raises ValueError; a result is never returned short.

Speed is what checkpoints need, no more: Huffman streams are decoded from a
table indexed by the longest code length, peeked at every bit position at
once with numpy, so only the walk from one symbol to the next is a Python
loop; raw blocks, RLE blocks and match copies are bytes slices.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE = 0x184D2A50             # ... 0x184D2A5F: the low 4 bits are free
BLOCK_MAX = 128 << 10
HUF_MAX_BITS = 11
M64 = (1 << 64) - 1

# literal-length and match-length codes: (baseline, extra bits)
LL_CODES = ([(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)])
ML_CODES = ([(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)])
# the predefined distributions (RFC 8878 3.1.1.3.2.2) and accuracy logs
LL_DEFAULT = ([4, 3] + [2] * 11 + [1] * 3 + [2] * 9 + [3, 2] + [1] * 5
              + [-1] * 4, 6)
ML_DEFAULT = ([1, 4, 3] + [2] * 6 + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1] * 6 + [2] * 3 + [1] * 15 + [-1] * 5, 5)
# (max symbol, max accuracy log) of the three sequence tables
LL_LIMITS, OF_LIMITS, ML_LIMITS = (35, 9), (31, 8), (52, 9)


def _fail(what: str):
    raise ValueError(f"zstd: {what}")


# ---------------------------------------------------------------- xxh64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & M64
    return (((acc << 31) | (acc >> 33)) & M64) * _P1 & M64


def xxh64(data: bytes) -> int:
    """XXH64 of data with seed 0 (a frame's checksum is its low 32
    bits)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1, v2, v3, v4 = (_P1 + _P2) & M64, _P2, 0, (-_P1) & M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", stripes * 4).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & M64
        pos = stripes * 32
    else:
        h = _P5
    h = (h + n) & M64
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & M64
        pos += 8
    if pos + 4 <= n:
        h ^= int.from_bytes(data[pos:pos + 4], "little") * _P1 & M64
        h = (_rotl(h, 23) * _P2 + _P3) & M64
        pos += 4
    for b in data[pos:]:
        h ^= b * _P5 & M64
        h = _rotl(h, 11) * _P1 & M64
    h ^= h >> 33
    h = h * _P2 & M64
    h ^= h >> 29
    h = h * _P3 & M64
    return h ^ (h >> 32)


# ------------------------------------------------------------ bitstreams

class _Backward:
    """A backward bitstream (RFC 8878 4.1): the bytes are one little-endian
    number whose highest set bit marks its start; reads take bits from the
    top down. `pos` counts the bits not yet read; reading past the bottom
    yields zeros and leaves `pos` negative (an overflow)."""

    PAD = 8                        # zero bytes below the stream

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            _fail("a bitstream lacks its end mark")
        self.data = bytes(self.PAD) + bytes(data) + bytes(8)
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos = p = self.pos - n
        q = p + 8 * self.PAD
        if q < 0:
            _fail("a bitstream was read far past its start")
        b = q >> 3
        return (int.from_bytes(self.data[b:b + 8], "little")
                >> (q & 7)) & ((1 << n) - 1)


def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int
                 ) -> tuple[list[int], int, int]:
    """An FSE table description (RFC 8878 4.1.1) at data[pos:]: the
    normalized counts, the accuracy log and the position after it."""
    # a description never exceeds (max_symbol + 1) * (max_log + 2) bits
    size = min(len(data) - pos, (max_symbol + 1) * (max_log + 2) // 8 + 8)
    word = int.from_bytes(data[pos:pos + size], "little")
    bit = 0

    def peek(n):
        return (word >> bit) & ((1 << n) - 1)

    def take(n):
        nonlocal bit
        v = peek(n)
        bit += n
        return v

    log = take(4) + 5
    if log > max_log:
        _fail(f"an FSE accuracy log {log} exceeds {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts: list[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:                  # a run of zero counts, 2 bits at a time
            n0 = len(counts)
            while True:
                r = take(2)
                n0 += r
                if r != 3:
                    break
            counts.extend([0] * (n0 - len(counts)))
        if len(counts) > max_symbol:
            _fail("an FSE table description names too many symbols")
        high = 2 * threshold - 1 - remaining
        low = peek(nb - 1)
        if low < high:
            c = low
            bit += nb - 1
        else:
            c = take(nb)
            if c >= threshold:
                c -= high
        c -= 1                     # -1: a "less than 1" probability
        remaining -= abs(c)
        counts.append(c)
        prev0 = c == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
        if bit > 8 * size:
            _fail("an FSE table description is truncated")
    if remaining != 1:
        _fail("an FSE table description does not sum to its size")
    return counts, log, pos + ((bit + 7) >> 3)


def _fse_table(counts: list[int], log: int):
    """The decoding table of normalized counts: per state, its symbol, the
    bits to read and the baseline of the next state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        _fail("an FSE distribution does not spread over its table")
    nxt = [1 if c == -1 else c for c in counts]
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return sym, nbits, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


# -------------------------------------------------------------- literals

def _huffman_weights(data: bytes, pos: int) -> tuple[list[int], int]:
    """A Huffman tree description (RFC 8878 4.2.1): the weights of all
    symbols, the last one derived, and the position after it."""
    if pos >= len(data):
        _fail("a Huffman tree description is missing")
    head = data[pos]
    pos += 1
    if head >= 128:                # direct: 4 bits a weight
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            _fail("a Huffman tree description is truncated")
        weights = [(raw[i // 2] >> (4 if i % 2 == 0 else 0)) & 15
                   for i in range(n)]
        pos += (n + 1) // 2
    else:                          # FSE-compressed, two interleaved states
        end = pos + head
        if end > len(data):
            _fail("a Huffman tree description is truncated")
        counts, log, start = _read_ncount(data[:end], pos,
                                          HUF_MAX_BITS + 1, 6)
        if start >= end:
            _fail("a Huffman tree description has no weights")
        sym, nbits, base, log = _fse_table(counts, log)
        bs = _Backward(data[start:end])
        s1, s2 = bs.read(log), bs.read(log)
        weights = []
        while True:                # until a state update overflows
            if len(weights) > 253:
                _fail("a Huffman tree description has too many weights")
            weights.append(sym[s1])
            s1 = base[s1] + bs.read(nbits[s1])
            if bs.pos < 0:
                weights.append(sym[s2])
                break
            if len(weights) > 253:
                _fail("a Huffman tree description has too many weights")
            weights.append(sym[s2])
            s2 = base[s2] + bs.read(nbits[s2])
            if bs.pos < 0:
                weights.append(sym[s1])
                break
        pos = end
    if any(w > HUF_MAX_BITS for w in weights):
        _fail("a Huffman weight exceeds the longest code")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _fail("a Huffman tree has no symbols")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if max_bits > HUF_MAX_BITS or left & (left - 1):
        _fail("a Huffman tree is not complete")
    weights.append(left.bit_length())
    return weights, pos


def _huffman_table(weights: list[int]):
    """(symbols, code lengths) indexed by the next max_bits bits, and
    max_bits. Codes go out from the lowest weight up, symbols in order
    within a weight, so each symbol fills the next 2^(max_bits - bits)
    entries."""
    max_bits = sum(1 << (w - 1) for w in weights if w).bit_length() - 1
    size = 1 << max_bits
    syms = np.zeros(size, np.uint8)
    lens = np.zeros(size, np.int64)
    p = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                span = 1 << (w - 1)
                syms[p:p + span] = s
                lens[p:p + span] = max_bits + 1 - w
                p += span
    return syms, lens, max_bits


def _huffman_stream(data, table, count: int) -> np.ndarray:
    """count symbols of one backward Huffman stream, which they must use
    up exactly.

    Every bit position p (the bits not yet read) gets its symbol and the
    position after it from the table, all at once; the walk from the top
    then takes 64 symbols a step through nxt^64 (six squarings of nxt)
    and fills the steps between with 63 gathers."""
    syms, lens, max_bits = table
    if not data or data[-1] == 0:
        if count == 0 and not data:
            return np.zeros(0, np.uint8)
        _fail("a Huffman stream lacks its end mark")
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    top = 8 * (len(data) - 1) + data[-1].bit_length() - 1
    # peek[p]: the max_bits bits below position p (zeros past the start)
    padded = np.concatenate([np.zeros(max_bits, np.uint16),
                             bits[:top].astype(np.uint16)])
    peek = np.zeros(top + 1, np.uint16)
    for k in range(max_bits):
        peek |= padded[k:k + top + 1] << k
    sink = top + 1                 # where a read past the start leads
    nxt = np.arange(top + 2, dtype=np.int64)
    nxt[:-1] -= lens[peek]
    nxt[nxt < 0] = sink
    nxt[sink] = sink
    jump = nxt
    for _ in range(6):
        jump = jump[jump]
    rows = -(-count // 64)
    at = np.empty((rows, 64), np.int64)
    p = top
    for r in range(rows):
        at[r, 0] = p
        p = int(jump[p])
    for k in range(1, 64):
        at[:, k] = nxt[at[:, k - 1]]
    at = at.reshape(-1)[:count]
    end = int(nxt[at[-1]]) if count else top
    if end != 0:
        _fail("a Huffman stream is not used up exactly")
    return syms[peek[at]]


class _Frame:
    """What persists from block to block within a frame."""

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]      # LL, OF, ML
        self.reps = [1, 4, 8]
        self.out = bytearray()


def _literals(fr: _Frame, data: bytes, pos: int) -> tuple[bytes, int]:
    if pos + 5 > len(data):        # the longest header, or the shortest
        data = data + bytes(5)     # header and its sequences section
    kind = data[pos] & 3
    size_format = (data[pos] >> 2) & 3
    if kind < 2:                   # raw or RLE
        if size_format in (0, 2):
            regen, pos = data[pos] >> 3, pos + 1
        elif size_format == 1:
            regen, pos = (data[pos] >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            regen = ((data[pos] >> 4) + (data[pos + 1] << 4)
                     + (data[pos + 2] << 12))
            pos += 3
        if regen > BLOCK_MAX:
            _fail("literals exceed a block")
        if kind == 0:
            if pos + regen > len(data):
                _fail("raw literals are truncated")
            return data[pos:pos + regen], pos + regen
        if pos >= len(data):
            _fail("RLE literals are truncated")
        return bytes([data[pos]]) * regen, pos + 1
    nh = (3, 3, 4, 5)[size_format]
    h = int.from_bytes(data[pos:pos + nh], "little")
    bits = (10, 10, 14, 18)[size_format]
    regen = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if size_format == 0 else 4
    pos += nh
    end = pos + csize
    if end > len(data):
        _fail("compressed literals are truncated")
    if regen > BLOCK_MAX:
        _fail("literals exceed a block")
    if kind == 2:
        weights, pos = _huffman_weights(data[:end], pos)
        fr.huffman = _huffman_table(weights)
    elif fr.huffman is None:
        _fail("treeless literals without a previous Huffman table")
    if streams == 1:
        return _huffman_stream(data[pos:end], fr.huffman,
                               regen).tobytes(), end
    if pos + 6 > end:
        _fail("a literals jump table is truncated")
    s1, s2, s3 = (int.from_bytes(data[pos + i:pos + i + 2], "little")
                  for i in (0, 2, 4))
    pos += 6
    bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, end]
    if bounds[3] > end:
        _fail("a literals jump table overruns its streams")
    seg = (regen + 3) // 4
    if 3 * seg > regen:
        _fail("four literal streams for too few literals")
    counts = [seg, seg, seg, regen - 3 * seg]
    return b"".join(
        _huffman_stream(data[bounds[i]:bounds[i + 1]], fr.huffman,
                        counts[i]).tobytes() for i in range(4)), end


# ------------------------------------------------------------- sequences

def _seq_table(fr: _Frame, i: int, mode: int, data: bytes, pos: int,
               default, limits):
    if mode == 0:
        table = _fse_table(*default)
    elif mode == 1:
        if pos >= len(data):
            _fail("an RLE sequence table is truncated")
        if data[pos] > limits[0]:
            _fail("an RLE sequence code is out of range")
        table, pos = _rle_table(data[pos]), pos + 1
    elif mode == 2:
        counts, log, pos = _read_ncount(data, pos, *limits)
        table = _fse_table(counts, log)
    else:
        table = fr.tables[i]
        if table is None:
            _fail("a repeated sequence table without a previous one")
    fr.tables[i] = table
    return table, pos


def _block(fr: _Frame, data: bytes) -> None:
    """Decodes one compressed block onto fr.out."""
    if not data:
        _fail("an empty compressed block")
    lits, pos = _literals(fr, data, 0)
    if pos >= len(data):
        _fail("a block lacks its sequences section")
    n = data[pos]
    if n < 128:
        pos += 1
    elif n < 255:
        if pos + 2 > len(data):
            _fail("a sequence count is truncated")
        n, pos = ((n - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > len(data):
            _fail("a sequence count is truncated")
        n = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00
        pos += 3
    out = fr.out
    if n == 0:
        if pos != len(data):
            _fail("bytes after a block's last section")
        out += lits
        return
    if pos >= len(data):
        _fail("a block lacks its sequence modes")
    modes = data[pos]
    if modes & 3:
        _fail("reserved bits set in the sequence modes")
    pos += 1
    ll_t, pos = _seq_table(fr, 0, modes >> 6, data, pos, LL_DEFAULT,
                           LL_LIMITS)
    of_t, pos = _seq_table(fr, 1, (modes >> 4) & 3, data, pos, OF_DEFAULT,
                           OF_LIMITS)
    ml_t, pos = _seq_table(fr, 2, (modes >> 2) & 3, data, pos, ML_DEFAULT,
                           ML_LIMITS)
    if pos >= len(data):
        _fail("a block lacks its sequence bitstream")
    bs = _Backward(data[pos:])
    read = bs.read
    ll_sym, ll_nb, ll_base, ll_log = ll_t
    of_sym, of_nb, of_base, of_log = of_t
    ml_sym, ml_nb, ml_base, ml_log = ml_t
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    r1, r2, r3 = fr.reps
    lp = 0
    nlits = len(lits)
    lview = memoryview(lits)
    start = len(out)
    for i in range(n):
        of_code = of_sym[of_s]
        if of_code > 31:
            _fail("an offset code is out of range")
        ml_code, ll_code = ml_sym[ml_s], ll_sym[ll_s]
        ofv = (1 << of_code) + read(of_code)
        mb, mx = ML_CODES[ml_code]
        ml = mb + read(mx)
        lb, lx = LL_CODES[ll_code]
        ll = lb + read(lx)
        if ofv > 3:
            r1, r2, r3 = ofv - 3, r1, r2
        else:
            if ll == 0:
                ofv += 1
            if ofv == 2:
                r1, r2 = r2, r1
            elif ofv == 3:
                r1, r2, r3 = r3, r1, r2
            elif ofv == 4:
                r1, r2, r3 = r1 - 1, r1, r2
                if r1 == 0:
                    _fail("a repeat offset of 0")
        if i + 1 < n:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > nlits:
            _fail("sequences use more literals than the block has")
        out += lview[lp:lp + ll]
        lp += ll
        have = len(out)
        if r1 > have:
            _fail("a match reaches before the frame's start")
        src = have - r1
        if r1 >= ml:
            out += out[src:src + ml]
        else:
            reps, rest = divmod(ml, r1)
            out += out[src:have] * reps + out[src:src + rest]
        if len(out) - start > BLOCK_MAX:
            _fail("a block decodes past its maximum size")
    if bs.pos != 0:
        _fail("a sequence bitstream is not used up exactly")
    out += lview[lp:]
    if len(out) - start > BLOCK_MAX:
        _fail("a block decodes past its maximum size")
    fr.reps = [r1, r2, r3]


# ---------------------------------------------------------------- frames

def _frame(data: bytes, pos: int) -> tuple[bytes, int]:
    """One zstd frame at data[pos:] (past its magic): its content and the
    position after it."""
    if pos >= len(data):
        _fail("a frame header is truncated")
    desc = data[pos]
    pos += 1
    fcs_flag, single = desc >> 6, (desc >> 5) & 1
    if desc & 8:
        _fail("the frame header's reserved bit is set")
    checksum, did_flag = (desc >> 2) & 1, desc & 3
    did_size = (0, 1, 2, 4)[did_flag]
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    pos += 1 - single              # the window descriptor (not needed)
    if pos + did_size + fcs_size > len(data):
        _fail("a frame header is truncated")
    if int.from_bytes(data[pos:pos + did_size], "little"):
        _fail("frames that need a dictionary are not supported")
    pos += did_size
    size = None
    if fcs_size:
        size = int.from_bytes(data[pos:pos + fcs_size], "little")
        size += 256 if fcs_size == 2 else 0
        pos += fcs_size
    fr = _Frame()
    while True:
        if pos + 3 > len(data):
            _fail("a block header is truncated")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, bsize = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            _fail("a block of the reserved type")
        if kind == 1:
            if bsize > BLOCK_MAX or pos >= len(data):
                _fail("an RLE block is malformed")
            fr.out += bytes([data[pos]]) * bsize
            pos += 1
        else:
            if bsize > BLOCK_MAX or pos + bsize > len(data):
                _fail("a block is truncated or too large")
            if kind == 0:
                fr.out += data[pos:pos + bsize]
            else:
                _block(fr, data[pos:pos + bsize])
            pos += bsize
        if size is not None and len(fr.out) > size:
            _fail("a frame decodes past its content size")
        if last:
            break
    out = bytes(fr.out)
    if size is not None and len(out) != size:
        _fail(f"a frame decoded to {len(out)} bytes, its header says {size}")
    if checksum:
        if pos + 4 > len(data):
            _fail("a frame's checksum is truncated")
        if int.from_bytes(data[pos:pos + 4], "little") != \
                xxh64(out) & 0xFFFFFFFF:
            _fail("a frame's content checksum does not match")
        pos += 4
    return out, pos


def decompress(data: bytes | bytearray | memoryview) -> bytes:
    """The content of every frame in data, concatenated; skippable frames
    are passed over. Empty input gives empty output."""
    data = bytes(data)
    out = []
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            _fail("trailing bytes that are not a frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic == MAGIC:
            content, pos = _frame(data, pos)
            out.append(content)
        elif magic & 0xFFFFFFF0 == SKIPPABLE:
            if pos + 4 > len(data):
                _fail("a skippable frame is truncated")
            n = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4 + n
            if pos > len(data):
                _fail("a skippable frame is truncated")
        else:
            _fail(f"unknown frame magic {magic:#010x}")
    return b"".join(out)
