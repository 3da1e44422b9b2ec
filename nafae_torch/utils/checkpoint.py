"""Checkpoints of the port: save, keep the newest N, auto-resume; and the
inference-side parameter loading.

`CheckpointManager` writes the whole training state (step, params,
optimizer state, k-means centers and bank) with `torch.save` as
`<ckpt_dir>/state_<step>.pt`. The JAX package writes orbax checkpoint
directories; the port cannot read them (there is no orbax on the GPU
machine): carry weights across as the converted `.npz` parameter file, or
a whole training state with `models.grounding.state_from_jax`.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import resolve_device
from nafae_torch.models.grounding import param_shapes, params_from_jax

_NAME = re.compile(r"state_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = os.path.abspath(ckpt_dir)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)

    def steps(self) -> list[int]:
        """Steps of the checkpoints on disk, ascending."""
        return sorted(int(m.group(1)) for p in os.listdir(self.dir)
                      if (m := _NAME.match(p)))

    def save(self, state) -> None:
        """Writes state.state_dict() atomically, then drops all but the
        newest `keep` checkpoints."""
        path = os.path.join(self.dir, f"state_{int(state.step)}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        for step in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(os.path.join(self.dir, f"state_{step}.pt"))

    def load_latest(self) -> dict | None:
        """The newest checkpoint's state dict (CPU tensors), or None."""
        steps = self.steps()
        if not steps:
            return None
        return torch.load(os.path.join(self.dir, f"state_{steps[-1]}.pt"),
                          weights_only=True)

    def restore_latest(self, template):
        """The newest checkpoint as a state of template's type, on
        template's device; None when there is none."""
        d = self.load_latest()
        return None if d is None else type(template).from_state_dict(
            d, template.device)


def load_eval_params(cfg: Config, checkpoint: str | None = None,
                     device: str | torch.device | None = None
                     ) -> dict[str, torch.Tensor] | None:
    """checkpoint: a converted .npz, a directory of the port's training
    checkpoints, or None (= cfg.train.ckpt_dir). Returns params on
    `device`, or None when no checkpoint exists there. Shapes are validated
    against the config's model: a drifted vocab or width would otherwise
    give plausible-looking wrong numbers."""
    path = checkpoint or cfg.train.ckpt_dir
    if path.endswith(".npz"):
        with np.load(path) as z:
            np_params = {k: z[k] for k in z.files}
    elif os.path.isdir(path):
        state = CheckpointManager(path).load_latest()
        if state is None:
            if glob.glob(os.path.join(path, "*", "")):
                raise NotImplementedError(
                    f"{path!r} holds no checkpoint of the port; orbax "
                    "checkpoint directories (the JAX package's format) are "
                    "not readable here — convert the params to .npz")
            return None
        np_params = state["params"]
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
