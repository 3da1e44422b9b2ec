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
from nafae_torch.ops.grounding import (ground_forward, int8_weight,
                                      quantize_params_int8)

FRAME_POOLS = ("attention", "mean", "context", "learned")
SIMILARITIES = ("cosine", "bilinear")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


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
    too) -> tensors on `device`, copied, in the same layout and dtype: w_v
    stays [D,E], it is not transposed to nn.Linear's [E,D], and the int8
    pair of quantize_params_int8 stays int8."""
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, copy=True))).to(device)
            for k, v in np_params.items()}


def state_from_jax(jax_state, device: str | torch.device):
    """The JAX package's training state -> the port's `train.TrainState`.

    jax_state: a `nafae_tpu.train.TrainState` whose leaves are numpy arrays
    (`jax.tree.map(np.asarray, state)`), or the nested dict of an orbax
    checkpoint (`utils.orbax_read.read_tree`, sequence indices as str
    keys): step, params, centers, the k-means bank, and the optax state,
    read by its field names — adam's `count`, `mu` and `nu`, or sgd's
    `trace` beside its schedule's `count`; EmptyState (None in the dict)
    holds nothing. Both packages can then start from one point: JAX's
    initial draws come from `jax.random`, which the port does not
    reproduce."""
    from nafae_torch.train import TrainState

    def put(x):
        return None if x is None else params_from_jax({"x": x}, device)["x"]

    def fields(node) -> dict:
        if isinstance(node, dict):
            return node
        names = getattr(node, "_fields", None)
        return dict(zip(names, node)) if names else {}

    opt = {}

    def walk(node):               # optax states: named tuples, or dicts
        f = fields(node)
        if "mu" in f and "nu" in f:
            opt.update(count=int(f["count"]), mu=params_from_jax(
                f["mu"], device), nu=params_from_jax(f["nu"], device))
        elif "trace" in f:
            opt["trace"] = params_from_jax(f["trace"], device)
        elif "count" in f:
            opt.setdefault("count", int(f["count"]))
        elif isinstance(node, dict):
            for k in sorted(node, key=int):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    def get(name):
        if isinstance(jax_state, dict):
            return jax_state.get(name)
        return getattr(jax_state, name, None)

    walk(get("opt_state"))
    return TrainState(step=int(get("step")),
                      params=params_from_jax(get("params"), device),
                      opt_state=opt, centers=put(get("centers")),
                      bank=put(get("bank")), bank_valid=put(get("bank_valid")))


def inference_params(cfg: Config, params: dict) -> dict:
    """params as the config's forward runs them: model.quantize=int8 or
    int8pre replaces "w_v" with the int8 pair, once (an already quantized
    dict passes through)."""
    if cfg.model.quantize in ("int8", "int8pre") and "w_v.q8" not in params:
        return quantize_params_int8(params)
    return params


# the int8 compute pair (ops/grounding.quantize_params_int8) under the
# reference's keys -> the dot-free buffer names the module holds them by
QUANT_BUFFERS = {"w_v.q8": "w_v_q8", "w_v.scale8": "w_v_scale8"}


class GroundingModel(nn.Module):
    """Holds the parameters; `forward` is ops.grounding.ground_forward with
    the model config's choices baked in.

    Float params live in `params` (an nn.ParameterDict, frozen). The int8
    compute pair of model.quantize=int8|int8pre ("w_v.q8" int8 [D,E],
    "w_v.scale8" f32 [1,E]), which replaces "w_v", is held as buffers
    under QUANT_BUFFERS' names (a ParameterDict refuses keys with a dot
    and int8 parameters), "w_v.q8" column-major (`int8_weight`);
    `param_dict` maps them back."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor],
                 ctx_window: int = 0, ctx_temp: float = 0.1):
        super().__init__()
        _validate_choices(cfg)
        need = set(param_shapes(cfg))
        if set(QUANT_BUFFERS) <= set(params):
            need.discard("w_v")
        missing = sorted(need - set(params))
        if missing:
            raise KeyError(f"params lack {missing} for this model config")
        self.cfg = cfg
        self.ctx_window = ctx_window
        self.ctx_temp = ctx_temp
        self.params = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False) for k, v in params.items()
            if k not in QUANT_BUFFERS})
        for key, name in QUANT_BUFFERS.items():
            if key in params:
                self.register_buffer(name, int8_weight(params[key])
                                     if key == "w_v.q8" else params[key])

    @classmethod
    def from_config(cls, cfg: Config,
                    params: dict[str, torch.Tensor]) -> "GroundingModel":
        """The model a full config serves: the context window is on only
        for frame_pool="context"."""
        ctx_w = (cfg.loss.ctx_window if cfg.model.frame_pool == "context"
                 else 0)
        return cls(cfg.model, params, ctx_window=ctx_w,
                   ctx_temp=cfg.loss.ctx_temp)

    def param_dict(self) -> dict[str, torch.Tensor]:
        """The params under the reference's keys, quantized pair included."""
        out = dict(self.params.items())
        for key, name in QUANT_BUFFERS.items():
            if hasattr(self, name):
                out[key] = getattr(self, name)
        return out

    def forward(self, feats: torch.Tensor, word_ids: torch.Tensor,
                frame_mask: torch.Tensor, word_mask: torch.Tensor,
                region_mask: torch.Tensor | None = None,
                feats_scale: torch.Tensor | None = None,
                params: dict[str, torch.Tensor] | None = None) -> dict:
        """feats_scale [B,T,R]: per-region scales of int8 feats (int8pre).
        params: run on these instead of the held ones (the exported
        program takes its params as an argument)."""
        c = self.cfg
        # bf16 at bfloat16, else f32, as the reference's serve.py chooses:
        # a float16 model trains in f16 and answers in f32
        return ground_forward(
            self.param_dict() if params is None else params, feats,
            word_ids, frame_mask, word_mask,
            temp=c.frame_attn_temp, pool=c.frame_pool,
            ctx_window=self.ctx_window, ctx_temp=self.ctx_temp,
            compute_dtype=(torch.bfloat16 if c.dtype == "bfloat16"
                           else torch.float32), region_mask=region_mask,
            feats_scale=feats_scale)
