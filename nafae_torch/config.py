"""Typed configuration tree (replaces the reference's argparse `opts` module).

The PyTorch port's own copy of `nafae_tpu/config.py`: the same dataclasses,
keys, defaults, presets, overrides and validation, so that one preset or
config file loads the same model in both packages. The port imports nothing
of the JAX package, so keep the two in step by hand. Keys whose feature the
port does not run (TPU compiler knobs) are kept so that config files
stay interchangeable; `docs/` describes what they do in the JAX package.
`mesh.*` takes effect under the CLIs' `--mesh` and the train CLI's
`--multihost` (`parallel.make_mesh`), as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    vocab_size: int = 67          # YouCook2-BB object classes
    feat_dim: int = 2048          # RoI feature dim D
    embed_dim: int = 256          # joint space dim E
    frame_pool: str = "attention"  # "attention" | "mean" | "context" |
                                   # "learned" (docs/MATH.md step 5)
    frame_attn_temp: float = 0.1   # τ_f in docs/MATH.md §Forward
    similarity: str = "cosine"     # "cosine" | "bilinear" (adds param
                                   # m_sim; docs/MATH.md step 3)
    dtype: str = "float32"         # compute dtype of the similarity and
                                   # projection products: "float32" |
                                   # "bfloat16" (bf16 operands, f32 sums)
                                   # | "float16" (f16 operands, f32 sums,
                                   # in training; serving and eval in f32)
    matmul_precision: str = "highest"  # "highest": exact f32 products;
                                   # "default": TF32 for the f32 products of
                                   # the training step's losses and their
                                   # gradient (device.matmul_precision);
                                   # k-means, the update, serving, eval,
                                   # convolutions and the kernels stay exact
    quantize: str = ""             # "" | "int8" | "int8pre": int8 inference
                                   # compute (serve and eval)
    word_vectors: str = ""         # optional GloVe-style init file for word_emb


@dataclass
class LossConfig:
    margin: float = 0.1           # Δ, ranking loss
    rank_norm: str = "pairs"      # "pairs" | "hinges" | "batch"
    ctx_weight: float = 0.0       # λ_ctx (config 3+)
    ctx_target: str = "stopgrad"  # "stopgrad" | "live" | "symmetric"
    ctx_window: int = 3           # half-width w of the temporal window
    ctx_temp: float = 0.1         # τ_a affinity temperature
    cluster_weight: float = 0.0   # λ_clu (config 4+)
    num_clusters: int = 67        # Kc
    kmeans_interval: int = 100    # steps between Lloyd refreshes
    kmeans_iters: int = 10        # Lloyd iterations per refresh
    kmeans_ema: float = 0.0       # ρ blend toward old centers
    kmeans_source: str = "batch"  # "batch" | "bank"
    bank_steps: int = 32          # ring depth W ("bank" source)
    kmeans_init: str = "random"   # "random" | "plusplus"


@dataclass
class DataConfig:
    root: str = "data/youcook2"   # directory with index.jsonl + per-segment .npz
    split: str = "train"
    classes_file: str = ""        # object-class list (one per line); "" =
                                  # the built-in 67-class stand-in
    max_frames: int = 20          # T bucket (upper bound)
    frame_buckets: tuple = ()     # optional ascending T buckets
    num_regions: int = 20         # R
    feat_dim: int = 2048          # D (must match model.feat_dim)
    max_words: int = 8            # K
    batch_size: int = 16
    shuffle_buffer: int = 1024
    prefetch: int = 2
    num_workers: int = 2
    use_native_io: bool = True
    pipeline: str = "thread"      # "thread" | "grain"
    transfer_dtype: str = "float32"
    from_videos: bool = False     # config-5 inline mode
    annotations: str = ""         # segments.jsonl for from_videos mode


@dataclass
class TrainConfig:
    steps: int = 10000
    lr: float = 1e-3
    weight_decay: float = 1e-5
    warmup_steps: int = 100
    optimizer: str = "adam"       # "adam" | "sgd"
    grad_clip: float = 1.0        # global-norm clip; <=0 disables
    seed: int = 0
    ckpt_dir: str = "ckpt"
    ckpt_every: int = 500
    keep_ckpts: int = 3
    log_every: int = 50
    eval_every: int = 1000
    use_pallas: bool = False      # legacy: True == kernels="pallas"
    kernels: str = "auto"         # "auto" | "jnp" | "pallas" | "" (legacy)
    donate: bool = True
    steps_per_call: int = 1
    scoped_vmem_kib: int = 0      # TPU compiler knob (JAX package only)
    device_cache: bool = False
    tensorboard_dir: str = ""

    def resolved_kernels(self) -> str:
        """Kernel routing with the legacy flag honored.

        An explicit kernels value ("jnp"/"pallas") wins; when kernels is
        left at its default ("auto") or at the legacy empty string,
        use_pallas=True selects "pallas".
        """
        if self.kernels not in ("auto", ""):
            return self.kernels
        if self.use_pallas:
            return "pallas"
        return self.kernels or "jnp"


@dataclass
class MeshConfig:
    data_axis: int = -1           # -1 = all devices on the data axis
    frame_axis: int = 1           # >1 shards the frame (sequence) axis
    data_axis_name: str = "data"
    frame_axis_name: str = "frame"


@dataclass
class DetectorConfig:
    """Faster R-CNN feature extractor (config 5). The port runs resnet50,
    resnet101 and vgg16, from random weights or a torch checkpoint
    (`weights`); under the four stem_* knobs (TPU layouts of the same
    sums) the ResNet runs its plain 7x7/s2 stem."""
    backbone: str = "resnet50"    # resnet50 | resnet101 | vgg16
    image_size: int = 640
    num_proposals: int = 20       # R kept after NMS
    rpn_pre_nms_topk: int = 1024
    approx_topk: bool = True
    topk_window: int = 1
    nms_impl: str = "jnp"         # "jnp" | "pallas" | "auto"
    full_pool_nms: bool = False
    nms_iou_thresh: float = 0.7
    anchor_scales: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    rpn_channels: int = 256
    dtype: str = "float32"
    stem_s2d: bool = False
    roi_impl: str = "separable"   # "separable" | "combined" | "pallas"
    stem_pad_ch: int = 0
    fold_bn: bool = False
    stem_im2col: bool = False
    stem_nminor: bool = False
    frame_rate: float = 1.0       # sampled frames / second of video
    weights: str = ""             # optional torch detector .pth: torchvision
                                  # resnet50/101 or vgg16, or faster-rcnn.pytorch


@dataclass
class Config:
    preset: str = "config2"
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {tp.__name__}.{k}")
                    ft = fields[k].type
                    sub = _DATACLASS_BY_NAME.get(ft if isinstance(ft, str) else ft.__name__)
                    kwargs[k] = build(sub, v) if sub else (tuple(v) if isinstance(v, list) else v)
                return tp(**kwargs)
            return val
        return build(cls, d)


_DATACLASS_BY_NAME = {c.__name__: c for c in
                      (ModelConfig, LossConfig, DataConfig, TrainConfig, MeshConfig,
                       DetectorConfig, Config)}


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply `section.key=value` CLI overrides (e.g. `loss.ctx_weight=1.0`)."""
    d = dataclasses.asdict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        path, _, raw = ov.partition("=")
        keys = path.split(".")
        node = d
        for k in keys[:-1]:
            if k not in node:
                raise KeyError(f"unknown config section {k!r} in override {ov!r}")
            node = node[k]
        leaf = keys[-1]
        if leaf not in node:
            raise KeyError(f"unknown config key {path!r}")
        cur = node[leaf]
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        if cur is not None and not isinstance(cur, type(val)) and not (
            isinstance(cur, float) and isinstance(val, int)
        ):
            if isinstance(cur, (list, tuple)) and isinstance(val, (list, tuple)):
                pass
            else:
                raise TypeError(
                    f"override {path}={raw!r}: expected {type(cur).__name__}, "
                    f"got {type(val).__name__}")
        node[leaf] = float(val) if isinstance(cur, float) else val
    return Config.from_dict(d)


# -- Named presets: one per acceptance config (config1..config5). ------------

def preset(name: str) -> Config:
    cfg = Config(preset=name)
    if name == "config1":      # eval-only, precomputed features
        cfg.data.split = "val"
        cfg.loss.ctx_weight = 0.0
        cfg.loss.cluster_weight = 0.0
    elif name == "config2":    # MIL + ranking training
        pass
    elif name == "config3":    # + contextual similarity loss
        cfg.loss.ctx_weight = 1.0
        cfg.model.frame_pool = "context"
    elif name == "config4":    # + visual clustering loss
        cfg.loss.ctx_weight = 1.0
        cfg.loss.cluster_weight = 1.0
        cfg.model.frame_pool = "context"
    elif name == "config5":    # end-to-end: decode + detector + fused losses
        cfg.loss.ctx_weight = 1.0
        cfg.loss.cluster_weight = 1.0
        cfg.model.frame_pool = "context"
        cfg.data.root = "data/robowatch"
        cfg.detector.full_pool_nms = True
        cfg.detector.nms_impl = "auto"
    else:
        raise ValueError(f"unknown preset {name!r}; choose config1..config5")
    return cfg


def validate(cfg: Config) -> Config:
    """Fail-fast cross-field checks (the per-field [CHOICE] validation
    lives next to the params in models/grounding._validate_choices)."""
    ctx_on = cfg.loss.ctx_weight > 0 or cfg.model.frame_pool == "context"
    if ctx_on and cfg.loss.ctx_window <= 0:
        raise ValueError(
            f"loss.ctx_window={cfg.loss.ctx_window} but the context path is "
            "on (loss.ctx_weight>0 or model.frame_pool=context) — the "
            "temporal window must be >= 1")
    if cfg.loss.kmeans_init not in ("random", "plusplus"):
        raise ValueError(
            f"unknown loss.kmeans_init {cfg.loss.kmeans_init!r}; "
            "choose random | plusplus")
    if (cfg.loss.kmeans_source == "bank" and cfg.loss.cluster_weight > 0
            and len(cfg.data.frame_buckets) > 1 and cfg.mesh.frame_axis > 1):
        raise ValueError(
            "loss.kmeans_source='bank' with multiple data.frame_buckets "
            "requires mesh.frame_axis=1 (the frame-sharded bank slot "
            "cannot pad smaller buckets consistently across SP shards)")
    if cfg.mesh.frame_axis > 1 and cfg.data.max_frames % cfg.mesh.frame_axis:
        raise ValueError(
            f"data.max_frames={cfg.data.max_frames} is not a multiple of "
            f"mesh.frame_axis={cfg.mesh.frame_axis}: each frame shard holds "
            "T / frame_axis frames")
    if cfg.detector.roi_impl not in ("separable", "combined", "pallas"):
        raise ValueError(
            f"unknown detector.roi_impl {cfg.detector.roi_impl!r}; "
            "choose separable | combined | pallas")
    if cfg.model.quantize not in ("", "int8", "int8pre"):
        raise ValueError(
            f"unknown model.quantize {cfg.model.quantize!r}; "
            "choose '' | int8 | int8pre")
    if cfg.model.matmul_precision not in ("highest", "default"):
        raise ValueError(
            f"unknown model.matmul_precision {cfg.model.matmul_precision!r};"
            " choose highest | default")
    return cfg


def load_config(path: str | None = None, preset_name: str | None = None,
                overrides: list[str] | None = None) -> Config:
    if path:
        with open(path) as f:
            cfg = Config.from_dict(json.load(f))
    elif preset_name:
        cfg = preset(preset_name)
    else:
        cfg = Config()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return validate(cfg)
