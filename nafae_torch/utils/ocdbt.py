"""A read-only OCDBT key-value store.

OCDBT ("optionally-cooperative distributed B+tree") is tensorstore's
key-value database, and orbax writes each checkpoint's arrays into one
(`<step>/default/`, `use_ocdbt: true`). The GPU machine has neither orbax
nor tensorstore, so the port reads the format itself, with numpy and its
own zstd decoder. `OcdbtStore(root).list()` gives the keys and
`read(key)` a value, of the newest version or of the generation asked for.

The format, as tensorstore writes it (all integers varints unless said):
- Files: `manifest.ocdbt`, and data files `d/<hex>` that hold values,
  B+tree nodes and version-tree nodes end to end. A manifest or node is a
  magic (u32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de B+tree node,
  0x0cdb1234 version-tree node), its whole length (u64 little-endian), a
  format version (0), a compression (0 none, 1 zstd), the body
  (zstd-compressed when 1), and a crc32c of everything before it (u32le).
- A data file table lists the files a body refers to by index: count,
  then the lengths each path shares with the one before (from the second
  on), the lengths of the rest, the base-path lengths, and the path bytes.
  A path is relative to the database root after the base path of the file
  the body was read from ("transitive" base path) is put before it: orbax
  merges each process's database (`ocdbt.process_<i>/`) into the root
  one, whose nodes then name `ocdbt.process_0/d/<hex>`.
- The manifest body: the config (uuid[16], manifest kind (0 single),
  max_inline_value_bytes, max_decoded_node_bytes, version-tree arity log2
  (a byte), compression (0 none, 1 zstd + level int32le)); a data file
  table; the newest versions inline (count, then arrays of generation,
  root height (bytes), root file id, offset, length, num_keys,
  num_tree_bytes, num_indirect_value_bytes, commit time (u64le)); then
  references to version-tree nodes holding the older ones (count, then
  generation, file id, offset, length, num_generations, commit time,
  height (bytes)). A root whose offset and length are 2^64 - 1 is an empty
  tree.
- A version-tree node: arity log2 and height (bytes), a data file table,
  count, then versions as in the manifest (height 0) or references as in
  the manifest without their heights (height > 0, each child one lower).
- A B+tree node: height (a byte), a data file table, count, the lengths
  each key shares with the one before (from the second on), the lengths
  of the rest, then
  - interior (height > 0): each child's subtree common prefix length, the
    key bytes, each child's file id, offset and length, and its num_keys,
    num_tree_bytes and num_indirect_value_bytes. A key is the lower bound
    of its child; the child's keys omit the first `subtree common prefix`
    bytes of it;
  - leaf: the key bytes, each value's length, each value's kind (0 inline,
    1 in a data file), the file id and offset of each kind-1 value, and the
    inline values end to end.
"""

from __future__ import annotations

import os

from nafae_torch.utils import zstd

MANIFEST_MAGIC, NODE_MAGIC, VERSION_MAGIC = 0x0CDB3A2A, 0x0CDB20DE, 0x0CDB1234
MISSING = (1 << 64) - 1            # the offset and length of an empty root


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Varints, bytes and arrays of them off a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"ocdbt: {self.what}: {msg}")

    def varint(self) -> int:
        v = shift = 0
        data, pos = self.data, self.pos
        while True:
            if pos >= len(data):
                self.fail("truncated")
            c = data[pos]
            pos += 1
            v |= (c & 0x7F) << shift
            if c < 0x80:
                break
            shift += 7
            if shift > 63:
                self.fail("a varint is too long")
        self.pos = pos
        return v

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> list[int]:
        return [int.from_bytes(self.take(8), "little") for _ in range(n)]

    def files(self, base: str) -> list[tuple[str, str]]:
        """A data file table: (path from the root, base path) each."""
        n = self.varint()
        shared = [0] + self.varints(max(n - 1, 0))
        rest = self.varints(n)
        base_len = self.varints(n)
        out, prev = [], b""
        for s, r, bl in zip(shared, rest, base_len):
            if s > len(prev) or bl > s + r:
                self.fail("a data file table is malformed")
            path = prev[:s] + self.take(r)
            prev = path
            text = path.decode()
            if ".." in text.split("/") or text.startswith("/"):
                self.fail(f"a data file path {text!r} leaves the database")
            out.append((base + text, base + text[:bl]))
        return out

    def end(self):
        if self.pos != len(self.data):
            self.fail("bytes after the end")


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, its framing checked."""
    if len(raw) < 18:
        raise ValueError(f"ocdbt: {what}: truncated")
    if int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"ocdbt: {what}: not a {magic:#010x} record")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"ocdbt: {what}: its length field does not match")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"ocdbt: {what}: checksum mismatch")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    if r.varint() != 0:
        r.fail("unknown format version")
    comp = r.varint()
    body = raw[r.pos:-4]
    if comp == 1:
        return zstd.decompress(body)
    if comp != 0:
        r.fail(f"unknown compression {comp}")
    return body


class OcdbtStore:
    """The keys and values of one version of the OCDBT database at root
    (a directory): the newest, or generation `version`. The B+tree is
    walked once, here; values are read from their files on demand.

    Keys are str (UTF-8); `read` returns bytes, or None for a key that
    is not there."""

    def __init__(self, root: str, version: int | None = None):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise ValueError(f"ocdbt: {path} is missing")
        with open(path, "rb") as f:
            r = _Reader(_unwrap(f.read(), MANIFEST_MAGIC, path), path)
        r.take(16)                                  # uuid
        if r.varint() != 0:
            r.fail("only single-file manifests are supported")
        r.varint()                                  # max_inline_value_bytes
        r.varint()                                  # max_decoded_node_bytes
        r.byte()                                    # version-tree arity log2
        comp = r.varint()
        if comp == 1:
            r.take(4)                               # zstd level
        elif comp != 0:
            r.fail(f"unknown compression {comp}")
        files = r.files("")
        versions = self._versions(r, files)
        refs = self._refs(r, files, with_height=True)
        r.end()
        self.generation, root_ref = self._find(versions, refs, version)
        self._index: dict[bytes, tuple] = {}
        if root_ref is not None:
            self._walk(root_ref, b"")

    # -- version tree

    @staticmethod
    def _versions(r: _Reader, files) -> list[tuple]:
        """Inline versions: (generation, (height, file, offset, length) of
        the root, or None for an empty tree)."""
        n = r.varint()
        gens = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                            # statistics
        r.u64s(n)                                   # commit times
        out = []
        for g, h, i, o, ln in zip(gens, heights, ids, offs, lens):
            if o == MISSING and ln == MISSING:
                out.append((g, None))
                continue
            if i >= len(files):
                r.fail("a root names a data file that is not in the table")
            out.append((g, (h, files[i], o, ln)))
        return out

    @staticmethod
    def _refs(r: _Reader, files, with_height: bool, height: int = 0
              ) -> list[tuple]:
        """References to version-tree nodes: (last generation, number of
        generations, (height, file, offset, length))."""
        n = r.varint()
        gens = r.varints(n)
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        counts = r.varints(n)
        r.u64s(n)                                   # commit times
        heights = ([r.byte() for _ in range(n)] if with_height
                   else [height - 1] * n)
        if any(i >= len(files) for i in ids):
            r.fail("a version node names a data file not in the table")
        return [(g, c, (h, files[i], o, ln)) for g, c, h, i, o, ln in
                zip(gens, counts, heights, ids, offs, lens)]

    def _find(self, versions, refs, version):
        """(generation, root) of the version asked for, descending the
        version tree where it is not inline."""
        want = version
        while True:
            if want is None and versions:
                return max(versions, key=lambda v: v[0])
            for g, root in versions:
                if g == want:
                    return g, root
            if want is None:
                if not refs:
                    raise ValueError(f"ocdbt: {self.root} holds no version")
                g, _, loc = max(refs, key=lambda x: x[0])
            else:
                cover = [x for x in refs if x[0] - x[1] < want <= x[0]]
                if not cover:
                    raise ValueError(f"ocdbt: {self.root} has no "
                                     f"generation {want}")
                loc = cover[0][2]
            height, raw, what = self._load(loc, VERSION_MAGIC)
            r = _Reader(raw, what)
            r.byte()                                # arity log2
            if r.byte() != height:
                r.fail("its height is not the one its reference gives")
            files = r.files(loc[1][1])
            if height == 0:
                versions, refs = self._versions(r, files), []
            else:
                versions, refs = [], self._refs(r, files, False, height)
            r.end()

    # -- B+tree

    def _load(self, loc, magic) -> tuple[int, bytes, str]:
        height, (path, _), offset, length = loc
        full = os.path.join(self.root, path)
        what = f"{full}@{offset}+{length}"
        try:
            with open(full, "rb") as f:
                f.seek(offset)
                raw = f.read(length)
        except OSError as e:
            raise ValueError(f"ocdbt: {what}: {e}") from None
        if len(raw) != length:
            raise ValueError(f"ocdbt: {what}: the data file is too short")
        return height, _unwrap(raw, magic, what), what

    def _walk(self, loc, prefix: bytes) -> None:
        height, raw, what = self._load(loc, NODE_MAGIC)
        r = _Reader(raw, what)
        if r.byte() != height:
            r.fail("its height is not the one its parent gives")
        files = r.files(loc[1][1])
        n = r.varint()
        shared = [0] + r.varints(max(n - 1, 0))
        rest = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for s, k in zip(shared, rest):
            if s > len(prev):
                r.fail("a key shares more than the key before it has")
            prev = prev[:s] + r.take(k)
            keys.append(prev)
        if height:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)                        # statistics
            r.end()
            for key, c, i, o, ln in zip(keys, common, ids, offs, lens):
                if c > len(key) or i >= len(files):
                    r.fail("a child reference is malformed")
                self._walk((height - 1, files[i], o, ln), prefix + key[:c])
            return
        lens = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            r.fail("unknown value kind")
        m = sum(kinds)
        ids, offs = r.varints(m), r.varints(m)
        j = 0
        for key, ln, kind in zip(keys, lens, kinds):
            if kind:
                if ids[j] >= len(files):
                    r.fail("a value names a data file not in the table")
                self._index[prefix + key] = (files[ids[j]][0], offs[j], ln)
                j += 1
            else:
                self._index[prefix + key] = r.take(ln)
        r.end()

    # -- the store

    def list(self) -> list[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._index)

    def read(self, key: str) -> bytes | None:
        ref = self._index.get(key.encode())
        if ref is None or isinstance(ref, bytes):
            return ref
        path, offset, length = ref
        full = os.path.join(self.root, path)
        try:
            with open(full, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError as e:
            raise ValueError(f"ocdbt: value of {key!r}: {e}") from None
        if len(data) != length:
            raise ValueError(f"ocdbt: value of {key!r}: {full} is too short")
        return data
