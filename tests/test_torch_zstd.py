"""The port's zstd decoder (nafae_torch.utils.zstd) against `zstandard`.

Frames written by the zstandard package (levels 1, 3, 9 and 19, with and
without content size and checksum) decode to their input: random bytes
(raw blocks, Huffman literals), text (sequences, repeat offsets, repeated
tables), a float32 array like a checkpoint's w_v, and long runs (RLE);
of 0 B, 1 B, 128 KiB +- 1 and 1 MiB. Also: several frames and a skippable
frame in one buffer, empty input, a corpus that reaches every literals
and sequence-table mode, a hypothesis search over short inputs, and
corrupt frames (truncated, a flipped byte, a bad checksum) that raise
ValueError wherever zstandard fails, and agree where it does not.
"""

import collections
import itertools

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from nafae_torch.utils import zstd

LEVELS = (1, 3, 9, 19)
SIZES = (0, 1, (128 << 10) - 1, (128 << 10) + 1)
MIB = 1 << 20


def _text(rng, n: int) -> bytes:
    words = [b"grounding", b"region", b"frame", b"video", b"word", b"box",
             b"the", b"of", b"a", b"tensor"]
    out = bytearray()
    while len(out) < n:
        out += words[rng.randint(len(words))] + (
            b" " if rng.rand() < 0.9 else b"\n")
        if rng.rand() < 0.01:
            out += str(rng.randint(10 ** 6)).encode()
    return bytes(out[:n])


KINDS = {
    "random": lambda rng, n: rng.bytes(n),
    "text": _text,
    "float32": lambda rng, n: (rng.randn(n // 4 + 1) * 0.02).astype(
        np.float32).tobytes()[:n],
    "runs": lambda rng, n: b"".join(
        bytes([rng.randint(256)]) * rng.randint(1, 4000)
        for _ in range(n // 1000 + 1))[:n],
}


def _oracle(frames: bytes) -> bytes:
    return zstandard.ZstdDecompressor().decompressobj(
        read_across_frames=True).decompress(frames)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_matches_zstandard(level, kind):
    rng = np.random.RandomState(level)
    sizes = SIZES + ((MIB,) if level <= 3 or kind == "float32" else ())
    for n, (size_flag, check) in zip(
            sizes, itertools.cycle(itertools.product((True, False),
                                                     repeat=2))):
        data = KINDS[kind](rng, n)
        frame = zstandard.ZstdCompressor(
            level=level, write_content_size=size_flag,
            write_checksum=check).compress(data)
        assert zstd.decompress(frame) == data == _oracle(frame), (n,)


def test_frames_skippable_and_empty():
    rng = np.random.RandomState(1)
    parts = [_text(rng, 5000), b"", rng.bytes(300), _text(rng, 1)]
    frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=True
                                       ).compress(p)
              for lvl, p in zip((1, 3, 9, 19), parts)]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    buf = frames[0] + skip + b"".join(frames[1:]) + skip
    assert zstd.decompress(buf) == b"".join(parts) == _oracle(buf)
    assert zstd.decompress(b"") == b""
    assert zstd.decompress(memoryview(frames[0])) == parts[0]


def _rle_literals_frame(byte: int, n: int) -> bytes:
    """A frame zstandard does not write but decodes: one compressed block
    of RLE literals (n <= 31) and no sequences."""
    block = bytes([1 | (n << 3), byte, 0])
    head = (len(block) << 3) | (2 << 1) | 1
    return ((0xFD2FB528).to_bytes(4, "little") + bytes([0x20, n])
            + head.to_bytes(3, "little") + block)


def _block_types(frame: bytes) -> list[int]:
    """The type of each block of one frame (0 raw, 1 RLE, 2 compressed),
    read from the block headers."""
    desc = frame[4]
    single, fcs = (desc >> 5) & 1, desc >> 6
    pos = 6 - single + (0, 1, 2, 4)[desc & 3] + (single, 2, 4, 8)[fcs]
    types = []
    while True:
        h = int.from_bytes(frame[pos:pos + 3], "little")
        types.append((h >> 1) & 3)
        pos += 3 + (1 if types[-1] == 1 else h >> 3)
        if h & 1:
            return types


def test_corpus_reaches_every_mode(monkeypatch):
    """Small inputs over small alphabets reach raw, RLE, 1- and 4-stream
    Huffman and treeless literals, direct and FSE Huffman weights, raw
    and RLE blocks, and all four modes of each sequence table."""
    seen = collections.Counter()
    real_lit, real_w, real_seq = (zstd._literals, zstd._huffman_weights,
                                  zstd._seq_table)

    def lit(fr, data, pos):
        kind = data[pos] & 3               # Huffman's: in 1 or 4 streams
        seen[("lit", kind) if kind < 2 else
             ("lit", kind, 1 if (data[pos] >> 2) & 3 == 0 else 4)] += 1
        return real_lit(fr, data, pos)

    def weights(data, pos):
        seen["weights", "direct" if data[pos] >= 128 else "fse"] += 1
        return real_w(data, pos)

    def seq(fr, i, mode, data, pos, default, limits):
        seen["seq", i, mode] += 1
        return real_seq(fr, i, mode, data, pos, default, limits)

    monkeypatch.setattr(zstd, "_literals", lit)
    monkeypatch.setattr(zstd, "_huffman_weights", weights)
    monkeypatch.setattr(zstd, "_seq_table", seq)
    rng = np.random.RandomState(0)
    gens = {
        "acgt": lambda n: bytes(rng.choice(list(b"acgt"), n)),
        "skew": lambda n: bytes(np.minimum(rng.geometric(0.3, n), 255
                                           ).astype(np.uint8)),
        "text": lambda n: _text(rng, n)}
    for (name, gen), n, level in itertools.product(
            gens.items(), (20, 100, 300, 1000, 40000), (1, 3, 19)):
        data = gen(n)
        frame_ = zstandard.ZstdCompressor(level=level,
                                          write_content_size=False
                                          ).compress(data)
        assert zstd.decompress(frame_) == data
        seen.update(("block", t) for t in _block_types(frame_))
    for data in (rng.bytes(3000), rng.bytes(9) + bytes(300000)):
        frame_ = zstandard.ZstdCompressor(level=1).compress(data)
        assert zstd.decompress(frame_) == data    # raw, then RLE blocks
        seen.update(("block", t) for t in _block_types(frame_))
    rle = _rle_literals_frame(ord("q"), 29)
    assert zstd.decompress(rle) == b"q" * 29 == _oracle(rle)
    want = {("lit", 0), ("lit", 1), ("lit", 2, 1), ("lit", 2, 4),
            ("lit", 3, 4)}
    want |= {("weights", "direct"), ("weights", "fse")}
    want |= {("seq", i, m) for i in range(3) for m in range(4)}
    want |= {("block", 0), ("block", 1), ("block", 2)}
    assert want <= set(seen), sorted(want - set(seen))


@settings(max_examples=60, deadline=None)
@given(data=st.one_of(st.binary(max_size=400),
                      st.text(alphabet="ab c\n", max_size=2000).map(
                          str.encode)),
       level=st.sampled_from((1, 3, 9, 19)), check=st.booleans())
def test_short_inputs_match(data, level, check):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=check
                                     ).compress(data)
    assert zstd.decompress(frame) == data


def _frame_with_checksum() -> bytes:
    rng = np.random.RandomState(4)
    data = _text(rng, 6000) + rng.bytes(800)
    return zstandard.ZstdCompressor(level=3, write_checksum=True
                                    ).compress(data)


def test_truncated_frames_raise():
    frame = _frame_with_checksum()
    for n in list(range(1, 40)) + list(range(40, len(frame), 97)) + [
            len(frame) - 1]:
        with pytest.raises(ValueError):
            zstd.decompress(frame[:n])


def test_bad_checksum_raises():
    frame = bytearray(_frame_with_checksum())
    frame[-1] ^= 0x40
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_flipped_bytes_raise_where_zstandard_fails():
    """A flip anywhere in a checksummed frame: where zstandard fails, the
    port raises ValueError; where zstandard decodes, the port gives the
    same bytes. It never returns other data."""
    frame = _frame_with_checksum()
    rng = np.random.RandomState(5)
    raised = 0
    for pos in sorted(set(rng.randint(4, len(frame), 150).tolist())):
        bad = bytearray(frame)
        bad[pos] ^= 1 << rng.randint(8)
        try:
            want = zstandard.ZstdDecompressor().decompress(
                bytes(bad), max_output_size=1 << 20)
        except zstandard.ZstdError:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                zstd.decompress(bytes(bad))
            raised += 1
        else:
            assert zstd.decompress(bytes(bad)) == want
    assert raised > 100


def test_unsupported_frames_raise():
    frame = bytearray(zstandard.ZstdCompressor(level=3).compress(b"x" * 99))
    frame[4] |= 1                      # a 1-byte dictionary id follows
    frame[6:6] = b"\x07"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes(frame))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00\x01\x02\x03rest")
    with pytest.raises(ValueError, match="not a frame"):
        zstd.decompress(bytes(frame[:0]) + b"ab")
