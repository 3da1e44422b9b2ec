"""The JAX package's orbax checkpoints, read without orbax.

The reference trainer saves its whole TrainState with orbax's
`CheckpointManager` (`ckpt_dir/<step>/`). Each step directory holds
`_CHECKPOINT_METADATA` and the item `default/`: `default/_METADATA` (JSON;
`tree_metadata` maps each leaf's tuple path to its keys and value type)
and the arrays as zarr v2, each at the key of its path joined by dots
(`params.w_v/.zarray`, `params.w_v/0.0`), inside an OCDBT database
(`use_ocdbt: true`, the default) or as plain files. This module reads that
layout with `ocdbt`, `zarr2` and `zstd`, which need numpy alone.
"""

from __future__ import annotations

import json
import os
import re

from nafae_torch.utils.ocdbt import OcdbtStore
from nafae_torch.utils.zarr2 import FileStore, read_array

STEP_NAME = re.compile(r"0|[1-9]\d*")
TMP_SUFFIX = ".orbax-checkpoint-tmp"
ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")


def steps(ckpt_dir: str) -> list[int]:
    """The steps orbax's CheckpointManager would restore from, ascending.

    orbax 0.11's rule (`ocp.CheckpointManager.all_steps()` /
    `latest_step()`, which tests hold this against): the directories of
    ckpt_dir named by an integer without leading zeros. A name holding
    ".orbax-checkpoint-tmp" (a save not yet committed: orbax renames the
    directory when the save ends) does not match; neither do files. A step
    directory that lacks `_CHECKPOINT_METADATA` still counts, as orbax
    counts it: reading it then fails on its missing files, and does not
    fall back to an older step or to none."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if STEP_NAME.fullmatch(n) and TMP_SUFFIX not in n
                  and os.path.isdir(os.path.join(ckpt_dir, n)))


def read_tree(step_dir: str, wanted=None) -> dict:
    """The saved tree of one step directory as nested dicts: named fields
    and sequence indices alike are str keys ('0', '1'), array leaves are
    numpy arrays (torch.bfloat16 tensors for bfloat16), and leaves saved as
    None (optax's EmptyState, an absent bank) are None.

    wanted: the top-level keys to read (say ("params", "step")); the
    others' arrays are not read or decompressed. Raises ValueError naming
    the file a step directory lacks, or the flag or encoding it does not
    support."""
    item = os.path.join(step_dir, "default")
    meta_path = os.path.join(item, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"orbax: {meta_path} is missing: {step_dir} is "
                         "not a readable orbax checkpoint")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"orbax: {meta_path}: use_zarr3: true is not "
                         "supported (zarr v2 only)")
    if "tree_metadata" not in meta:
        raise ValueError(f"orbax: {meta_path} has no tree_metadata")
    store = (OcdbtStore(item) if meta.get("use_ocdbt", True)
             else FileStore(item))
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if wanted is not None and keys[0] not in wanted:
            continue
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            leaf = None
        elif kind in ARRAY_TYPES:
            leaf = read_array(store, ".".join(keys))
        else:
            raise ValueError(f"orbax: {meta_path}: leaf {tuple(keys)} has "
                             f"value type {kind!r}, which is not supported")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree
