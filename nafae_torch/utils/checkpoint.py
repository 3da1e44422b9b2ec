"""Checkpoints of the port: save, keep the newest N, auto-resume; and the
inference-side parameter loading.

`CheckpointManager` writes the whole training state (step, params,
optimizer state, k-means centers and bank) with `torch.save` as
`<ckpt_dir>/state_<step>.pt`, and restores the newest checkpoint of two
formats: its own, and the orbax step directories `<ckpt_dir>/<step>/` the
JAX package's trainer writes (read without orbax, `utils.orbax_read`). A
run of the reference therefore resumes on the card, and its params serve
and evaluate there (`load_eval_params`).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import resolve_device
from nafae_torch.models.grounding import (param_shapes, params_from_jax,
                                          state_from_jax)
from nafae_torch.utils import orbax_read

_NAME = re.compile(r"state_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = os.path.abspath(ckpt_dir)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)

    def steps(self) -> list[int]:
        """Steps of the port's own checkpoints on disk, ascending."""
        return sorted(int(m.group(1)) for p in os.listdir(self.dir)
                      if (m := _NAME.match(p)))

    def latest(self) -> tuple[int, str, str] | None:
        """(step, path, format) of the newest checkpoint, "port" (a
        state_<step>.pt) or "orbax" (a step directory of the JAX package,
        as `orbax_read.steps` finds them); on a tie the port's own. None
        when there is neither."""
        found = [(s, 1, "orbax") for s in orbax_read.steps(self.dir)]
        found += [(s, 2, "port") for s in self.steps()]
        if not found:
            return None
        step, _, fmt = max(found)
        name = f"state_{step}.pt" if fmt == "port" else str(step)
        return step, os.path.join(self.dir, name), fmt

    def save(self, state) -> None:
        """Writes state.state_dict() atomically, then drops all but the
        newest `keep` of the port's checkpoints (orbax directories are
        never touched)."""
        path = os.path.join(self.dir, f"state_{int(state.step)}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        for step in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(os.path.join(self.dir, f"state_{step}.pt"))

    def restore_latest(self, template):
        """The newest checkpoint of either format as a state of template's
        type, on template's device; None when there is none. Its tensors
        must have the template's shapes and dtypes (a checkpoint of another
        model, optimizer or bank raises ValueError); an orbax step that
        cannot be read raises ValueError, it is never passed over."""
        found = self.latest()
        if found is None:
            return None
        step, path, fmt = found
        if fmt == "port":
            state = type(template).from_state_dict(
                torch.load(path, weights_only=True), template.device)
        else:
            state = state_from_jax(orbax_read.read_tree(path),
                                   template.device)
        _check_like(template, state, path)
        return state


def _layout(state) -> dict:
    """Each tensor's (shape, dtype) and each other leaf's type, by path."""
    out = {}

    def add(at, v):
        if isinstance(v, dict):
            for k, child in v.items():
                add(f"{at}.{k}", child)
        elif isinstance(v, torch.Tensor):
            out[at] = (tuple(v.shape), v.dtype)
        else:
            out[at] = type(v).__name__
    for f in dataclasses.fields(state):
        if f.name != "step":
            add(f.name, getattr(state, f.name))
    return out


def _check_like(template, state, path: str) -> None:
    """state holds what template holds, at its shapes and dtypes."""
    want, got = _layout(template), _layout(state)
    lacks = sorted(want.keys() - got.keys())
    extra = sorted(got.keys() - want.keys())
    differ = sorted(k for k in want.keys() & got.keys()
                    if want[k] != got[k])
    if lacks or extra or differ:
        parts = ([f"it lacks {', '.join(lacks[:3])}"] if lacks else []) + (
            [f"the run has no {', '.join(extra[:3])}"] if extra else []) + [
            f"{k} is {got[k]}, the run's {want[k]}" for k in differ[:3]]
        raise ValueError(f"checkpoint {path} does not fit this run: "
                         + "; ".join(parts))


def load_eval_params(cfg: Config, checkpoint: str | None = None,
                     device: str | torch.device | None = None
                     ) -> dict[str, torch.Tensor] | None:
    """checkpoint: a converted .npz, a checkpoint directory (the port's
    state_<step>.pt files, or the JAX package's orbax step directories: the
    newest of either), or None (= cfg.train.ckpt_dir). Returns params on
    `device`, or None when no checkpoint exists there. Of an orbax step only
    `params` and `step` are read, as the reference's
    `restore_params_latest` does. Shapes are validated against the config's
    model: a drifted vocab or width would otherwise give plausible-looking
    wrong numbers."""
    path = checkpoint or cfg.train.ckpt_dir
    if path.endswith(".npz"):
        with np.load(path) as z:
            np_params = {k: z[k] for k in z.files}
    elif os.path.isdir(path):
        found = CheckpointManager(path).latest()
        if found is None:
            return None
        _, where, fmt = found
        if fmt == "port":
            np_params = torch.load(where, weights_only=True)["params"]
        else:
            np_params = orbax_read.read_tree(
                where, wanted=("params", "step"))["params"]
    else:
        return None
    for k, shape in param_shapes(cfg.model).items():
        got = tuple(np_params[k].shape) if k in np_params else None
        if got != shape:
            raise ValueError(
                f"checkpoint param {k!r} has shape {got}, but the config "
                f"expects {shape} — override model.vocab_size / "
                "model.feat_dim / model.embed_dim to match the training run")
    return params_from_jax(np_params, resolve_device(device))
