"""Grounding model: word embedding + region projection into a joint space.

The port of `nafae_tpu/models/grounding.py`. The parameters are the same
flat dict as the JAX package's tree, in the same layout ({word_emb [V,E],
w_v [D,E], b_v [E]} + attn_w [E] and m_sim [E,E] when those choices are on),
so weights carry across unchanged; all math lives in `nafae_torch.ops`.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from nafae_torch.config import Config, ModelConfig
from nafae_torch.device import resolve_device
from nafae_torch.ops.grounding import ground_forward

FRAME_POOLS = ("attention", "mean", "context", "learned")
SIMILARITIES = ("cosine", "bilinear")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _validate_choices(cfg: ModelConfig) -> None:
    """Fail fast on typo'd [CHOICE] flags: frame_attention treats every
    non-"mean" pool as softmax attention, so a typo would otherwise
    silently run the default variant."""
    if cfg.frame_pool not in FRAME_POOLS:
        raise ValueError(f"unknown model.frame_pool {cfg.frame_pool!r}; "
                         f"choose one of {' | '.join(FRAME_POOLS)}")
    if cfg.similarity not in SIMILARITIES:
        raise ValueError(f"unknown model.similarity {cfg.similarity!r}; "
                         f"choose one of {' | '.join(SIMILARITIES)}")
    if cfg.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown model.dtype {cfg.dtype!r}; "
                         f"choose one of {' | '.join(COMPUTE_DTYPES)}")


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter the model config needs."""
    e = cfg.embed_dim
    shapes = {"word_emb": (cfg.vocab_size, e), "w_v": (cfg.feat_dim, e),
              "b_v": (e,)}
    if cfg.frame_pool == "learned":
        shapes["attn_w"] = (e,)
    if cfg.similarity == "bilinear":
        shapes["m_sim"] = (e, e)
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None
                ) -> dict[str, torch.Tensor]:
    """Random parameters: normal word_emb (scale 1/sqrt(E)) and w_v (scale
    1/sqrt(D)), zero b_v, normal attn_w, identity m_sim (bilinear starts at
    the cosine form). Drawn on the CPU from `generator`, then moved to
    `device` (cuda unless the caller passes "cpu"; see
    `device.resolve_device`). The
    draws differ from jax.random's for the same seed; parity tests pass
    parameters in."""
    _validate_choices(cfg)
    shapes = param_shapes(cfg)
    e, d = cfg.embed_dim, cfg.feat_dim
    params = {
        "word_emb": torch.randn(shapes["word_emb"], generator=generator)
        / e ** 0.5,
        "w_v": torch.randn(shapes["w_v"], generator=generator) / d ** 0.5,
        "b_v": torch.zeros(shapes["b_v"]),
    }
    if "attn_w" in shapes:
        params["attn_w"] = torch.randn(shapes["attn_w"],
                                       generator=generator) / e ** 0.5
    if "m_sim" in shapes:
        params["m_sim"] = torch.eye(e)
    device = resolve_device(device)
    return {k: v.to(device) for k, v in params.items()}


def load_word_vectors(path: str, vocab, embed_dim: int
                      ) -> tuple[np.ndarray, int]:
    """word_emb rows [len(vocab), embed_dim] for the vocab's classes from
    GloVe-style text ("word v1 v2 ...", one per line) or an .npz of
    {word: vector}, and how many classes the file covered; the rows are
    the reference's, in its dtype (numpy promotes them to f64 when it
    divides by sqrt(E)), so the caller casts. A class missing
    from the file keeps a row of np.random.RandomState(0).randn / sqrt(E);
    a multi-word class ("bell pepper" / "bell_pepper") takes the mean of
    its tokens' vectors when every token is there. Text lines of another
    width are skipped; a file with none of the right width raises
    ValueError (truncating a longer vector would seed meaningless
    prefixes)."""
    rng = np.random.RandomState(0)
    out = rng.randn(len(vocab), embed_dim).astype(np.float32) / np.sqrt(
        embed_dim)
    if path.endswith(".npz"):
        with np.load(path) as z:
            table = {k: z[k] for k in z.files}
    else:
        table = {}
        bad_dim = None
        with open(path) as f:
            for ln in f:
                parts = ln.rstrip().split(" ")
                if len(parts) < 2:
                    continue
                if len(parts) != embed_dim + 1:
                    bad_dim = len(parts) - 1
                    continue
                table[parts[0]] = np.asarray(parts[1:], np.float32)
        if not table and bad_dim is not None:
            raise ValueError(
                f"{path}: vectors are {bad_dim}-d but embed_dim={embed_dim} "
                "— set model.embed_dim to match the file (or convert it); "
                "refusing to truncate")
    hits = 0
    for i, cls in enumerate(vocab.classes):
        vec = table.get(cls)
        if vec is None:
            toks = [t for t in re.split(r"[\s_]+", cls) if t]
            if len(toks) > 1:
                parts = [table.get(t) for t in toks]
                if all(p is not None and len(p) == embed_dim for p in parts):
                    vec = np.mean(parts, axis=0)
        if vec is not None and len(vec) == embed_dim:
            out[i] = vec
            hits += 1
    return out, hits


def params_from_jax(np_params: dict, device: str | torch.device
                    ) -> dict[str, torch.Tensor]:
    """The JAX package's param dict (numpy or jax arrays; tensors pass
    too) -> tensors on `device`, copied, in the same layout: w_v stays
    [D,E], it is not transposed to nn.Linear's [E,D]."""
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, copy=True))).to(device)
            for k, v in np_params.items()}


def state_from_jax(jax_state, device: str | torch.device):
    """The JAX package's training state -> the port's `train.TrainState`.

    jax_state: a `nafae_tpu.train.TrainState` whose leaves are numpy arrays
    (`jax.tree.map(np.asarray, state)`): step, params, centers, the k-means
    bank, and the optax state, read by its field names — adam's `count`,
    `mu` and `nu`, or sgd's `trace` beside its schedule's `count`. Both
    packages can then start from one point: JAX's initial draws come from
    `jax.random`, which the port does not reproduce."""
    from nafae_torch.train import TrainState

    def put(x):
        return None if x is None else params_from_jax({"x": x}, device)["x"]

    opt = {}

    def walk(node):               # optax states are named tuples
        fields = getattr(node, "_fields", ())
        if "mu" in fields and "nu" in fields:
            opt.update(count=int(node.count), mu=params_from_jax(
                node.mu, device), nu=params_from_jax(node.nu, device))
        elif "trace" in fields:
            opt["trace"] = params_from_jax(node.trace, device)
        elif "count" in fields:
            opt.setdefault("count", int(node.count))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(jax_state.opt_state)
    return TrainState(step=int(jax_state.step),
                      params=params_from_jax(jax_state.params, device),
                      opt_state=opt, centers=put(jax_state.centers),
                      bank=put(jax_state.bank),
                      bank_valid=put(jax_state.bank_valid))


class GroundingModel(nn.Module):
    """Holds the parameters; `forward` is ops.grounding.ground_forward with
    the model config's choices baked in."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor],
                 ctx_window: int = 0, ctx_temp: float = 0.1):
        super().__init__()
        _validate_choices(cfg)
        missing = sorted(set(param_shapes(cfg)) - set(params))
        if missing:
            raise KeyError(f"params lack {missing} for this model config")
        self.cfg = cfg
        self.ctx_window = ctx_window
        self.ctx_temp = ctx_temp
        self.params = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})

    @classmethod
    def from_config(cls, cfg: Config,
                    params: dict[str, torch.Tensor]) -> "GroundingModel":
        """The model a full config serves: the context window is on only
        for frame_pool="context"."""
        ctx_w = (cfg.loss.ctx_window if cfg.model.frame_pool == "context"
                 else 0)
        return cls(cfg.model, params, ctx_window=ctx_w,
                   ctx_temp=cfg.loss.ctx_temp)

    def forward(self, feats: torch.Tensor, word_ids: torch.Tensor,
                frame_mask: torch.Tensor, word_mask: torch.Tensor,
                region_mask: torch.Tensor | None = None) -> dict:
        c = self.cfg
        return ground_forward(
            dict(self.params.items()), feats, word_ids, frame_mask, word_mask,
            temp=c.frame_attn_temp, pool=c.frame_pool,
            ctx_window=self.ctx_window, ctx_temp=self.ctx_temp,
            compute_dtype=COMPUTE_DTYPES[c.dtype], region_mask=region_mask)
