"""Inference-side parameter loading for the port.

Reads the converted `.npz` parameter file (the flat param dict, as
`nafae_tpu.utils.torch_convert` writes it and `np.savez` of the JAX params
gives it). Orbax checkpoint directories are read by the JAX package; the
port's checkpoint format comes with its training slice.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import resolve_device
from nafae_torch.models.grounding import param_shapes, params_from_jax


def load_eval_params(cfg: Config, checkpoint: str | None = None,
                     device: str | torch.device | None = None
                     ) -> dict[str, torch.Tensor] | None:
    """checkpoint: a converted .npz, or None (= cfg.train.ckpt_dir).
    Returns params on `device`, or None when no checkpoint exists there.
    Shapes are validated against the config's model: a drifted vocab or
    width would otherwise give plausible-looking wrong numbers."""
    path = checkpoint or cfg.train.ckpt_dir
    if path.endswith(".npz"):
        with np.load(path) as z:
            np_params = {k: z[k] for k in z.files}
    elif os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r} is a checkpoint directory (orbax, the JAX package's "
            "format); the port reads only the converted .npz form until its "
            "training slice adds checkpoints")
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
