"""Zarr v2 arrays over a key-value reader: the array format of orbax
checkpoints (`use_zarr3: false`), read with numpy alone.

A store is anything with `read(key) -> bytes | None`: `ocdbt.OcdbtStore`
for a checkpoint written with `use_ocdbt: true`, `FileStore` for one
written as plain files. `read_array(store, path)` reads `path/.zarray`,
then every chunk (`path/<i>.<j>...`, a scalar's is `path/0`), stored whole
at the edges and cropped here, in C or F order, raw or zstd-compressed. A
missing chunk reads as the fill value, and a `null` fill value as zeros, as
tensorstore reads it.
"""

from __future__ import annotations

import itertools
import json
import math
import os

import numpy as np
import torch

from nafae_torch.utils import zstd

DTYPES = ("<f4", "<f2", "<f8", "<i4", "<i8", "<u4", "|i1", "|u1", "|b1",
          "bfloat16")
FILLS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


class FileStore:
    """Keys as files under a directory."""

    def __init__(self, root: str):
        self.root = root

    def read(self, key: str) -> bytes | None:
        path = os.path.join(self.root, *key.split("/"))
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


def _meta(store, path: str) -> dict:
    raw = store.read(f"{path}/.zarray")
    if raw is None:
        raise ValueError(f"zarr: {path}/.zarray is missing")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr: {path} is not a zarr v2 array")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"zarr: {path}: dtype {meta['dtype']!r} is not "
                         f"supported ({', '.join(DTYPES)})")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr: {path}: compressor {comp.get('id')!r} is "
                         "not supported (zstd or null)")
    if meta.get("filters"):
        raise ValueError(f"zarr: {path}: filters are not supported")
    if meta.get("order", "C") not in ("C", "F"):
        raise ValueError(f"zarr: {path}: order {meta['order']!r}")
    if len(meta["chunks"]) != len(meta["shape"]):
        raise ValueError(f"zarr: {path}: chunks and shape differ in rank")
    return meta


def read_array(store, path: str) -> np.ndarray | torch.Tensor:
    """The array at `path`: a numpy array, or a torch.bfloat16 tensor for
    dtype "bfloat16" (numpy has no bfloat16)."""
    meta = _meta(store, path)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])   # bf16: its bits
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if bf16 and fill is not None:
        fill = torch.tensor(FILLS.get(fill, fill), dtype=torch.bfloat16
                            ).view(torch.int16).item() & 0xFFFF
    out = np.full(shape, 0 if fill is None else FILLS.get(fill, fill), dtype)
    compressed = meta.get("compressor") is not None
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{path}/{sep.join(map(str, idx)) if idx else '0'}"
        raw = store.read(key)
        if raw is None:
            continue
        if compressed:
            raw = zstd.decompress(raw)
        if len(raw) != math.prod(chunks) * dtype.itemsize:
            raise ValueError(f"zarr: {key} holds {len(raw)} bytes, a chunk "
                             f"of {chunks} {meta['dtype']} is "
                             f"{math.prod(chunks) * dtype.itemsize}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        box = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out
