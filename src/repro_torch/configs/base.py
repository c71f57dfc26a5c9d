"""Model / run configuration substrate: a copy of ``repro.configs.base``.

Every assigned architecture is expressed as a ``ModelConfig`` built out of
*layer groups*: a short mixer/ffn pattern repeated ``repeat`` times.  Groups
hold stacked parameters on a leading layer axis; the port's model loops
over that axis.

The config is a plain frozen dataclass — no framework dependency — so the
port keeps its own copy, field for field the reference's (the parity tests
compare the two for every architecture).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# Layer specification
# --------------------------------------------------------------------------

MIXER_ATTN = "attn"
MIXER_MAMBA2 = "mamba2"
MIXER_RGLRU = "rglru"

FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """One residual block: a sequence mixer plus an optional FFN."""

    mixer: str = MIXER_ATTN
    ffn: str = FFN_DENSE
    window: Optional[int] = None  # local attention window; None = global
    cross_attn: bool = False      # decoder block with encoder cross-attention


@dataclass(frozen=True)
class LayerGroup:
    """``pattern`` repeated ``repeat`` times (scanned over ``repeat``)."""

    pattern: Tuple[LayerSpec, ...]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeat


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    # transformer trunk
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 512
    qkv_bias: bool = False
    mlp_act: str = "swiglu"   # swiglu | gelu (classic 2-matrix MLP)
    use_rope: bool = True     # whisper uses sinusoidal absolute positions
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # layer pattern; empty -> n_layers × (attn, dense)
    groups: Tuple[LayerGroup, ...] = ()

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    router_aux_coef: float = 0.01

    # Mamba-2 (SSD)
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # RG-LRU (Griffin / RecurrentGemma)
    lru_width: int = 0         # 0 -> d_model
    lru_conv_width: int = 4

    # encoder-decoder (whisper family)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_frame_dim: int = 0     # stubbed conv-frontend output dim (= d_model)

    # VLM (internvl family)
    n_vision_tokens: int = 0   # stubbed patch-embedding prefix length

    # numerics / execution
    param_dtype: str = "float32"       # huge archs use bfloat16
    compute_dtype: str = "bfloat16"
    attn_impl: str = "chunked"         # reference | chunked | pallas
    attn_chunk: int = 1024             # KV chunk for the flash-style scan
    ssm_impl: str = "chunked"          # sequential | chunked | pallas
    rglru_impl: str = "associative"    # sequential | associative | pallas
    moe_gmm_impl: str = "ragged"       # ragged | pallas | dense
    moe_impl: str = "gather"           # gather (ZeRO-3 all-gather experts) |
                                       # ep (expert-parallel over model axis)
    moe_ep_capacity: float = 2.0       # per-shard capacity factor (ep only)
    moe_token_chunks: int = 1          # ep: scan token chunks to bound VMEM/HBM
                                       # working set (dispatch buffers / chunk)
    moe_resident_serve: bool = True    # decode: keep EP weights resident (2-D
                                       # sharded model×data), move activations
                                       # instead of all-gathering weights
    use_tp: bool = True                # False: pure-DP layout (tiny archs where
                                       # TP collectives dominate the roofline)
    decode_cache_seq_shard: bool = False  # decode: shard KV cache on sequence over
                                          # the model axis (split-KV / flash-decoding)
    kv_cache_quant: bool = False       # int8 KV cache with per-(b,s,h) scales
                                       # (KIVI-style): halves decode HBM traffic
    loss_chunk: int = 0                # 0 = unchunked cross-entropy
    remat: str = "full"                # none | full | dots
    scan_layers: bool = True           # False: unroll (exact HLO cost analysis;
                                       # XLA counts a scan body once per module)
    logical_batch_axes: Tuple[str, ...] = ("pod", "data")
    fsdp_params: bool = False          # ZeRO-3: shard params and optimizer state over batch axes
    act_seq_shard: bool = False        # Megatron-SP: shard residual stream over model axis

    # optimizer defaults for this arch
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    # ------------------------------------------------------------------
    def __post_init__(self):
        if not self.groups:
            spec = LayerSpec()
            object.__setattr__(
                self, "groups", (LayerGroup(pattern=(spec,), repeat=self.n_layers),)
            )

    # Derived quantities -------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def total_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter counting (analytic; used for 6·N·D MODEL_FLOPS) ---------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        """MoE-aware: only routed-active expert params counted."""
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    dh = cfg.resolved_head_dim
    n = cfg.d_model * cfg.n_heads * dh          # wq
    n += 2 * cfg.d_model * cfg.n_kv_heads * dh  # wk, wv
    n += cfg.n_heads * dh * cfg.d_model         # wo
    if cfg.qkv_bias:
        n += (cfg.n_heads + 2 * cfg.n_kv_heads) * dh
    return n


def _ffn_params(cfg: ModelConfig) -> int:
    if cfg.mlp_act == "gelu":
        return 2 * cfg.d_model * cfg.d_ff + cfg.d_ff + cfg.d_model
    return 3 * cfg.d_model * cfg.d_ff  # SwiGLU: gate, up, down


def _moe_params(cfg: ModelConfig, active_only: bool) -> int:
    e = cfg.top_k if active_only else cfg.n_experts
    n = e * 3 * cfg.d_model * cfg.d_ff_expert
    n += cfg.d_model * cfg.n_experts  # router
    return n


def _mamba2_params(cfg: ModelConfig) -> int:
    di, g, s = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h = cfg.n_ssm_heads
    in_dim = 2 * di + 2 * g * s + h
    n = cfg.d_model * in_dim                      # in_proj
    n += cfg.ssm_conv_width * (di + 2 * g * s)    # conv1d
    n += 2 * h + di                               # A_log, dt_bias, norm
    n += di * cfg.d_model                         # out_proj
    return n


def _rglru_params(cfg: ModelConfig) -> int:
    w = cfg.resolved_lru_width
    n = 2 * cfg.d_model * w            # x branch + gate branch in-proj
    n += cfg.lru_conv_width * w        # temporal conv
    n += 2 * w * w // 1                # recurrence/input gate projections
    n += w                             # Lambda
    n += w * cfg.d_model               # out proj
    return n


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    per_spec = 0
    for group in cfg.groups:
        for spec in group.pattern:
            block = cfg.d_model  # pre-mixer norm
            if spec.mixer == MIXER_ATTN:
                block += _attn_params(cfg)
            elif spec.mixer == MIXER_MAMBA2:
                block += _mamba2_params(cfg)
            elif spec.mixer == MIXER_RGLRU:
                block += _rglru_params(cfg)
            if spec.cross_attn:
                block += _attn_params(cfg) + cfg.d_model
            if spec.ffn != FFN_NONE:
                block += cfg.d_model  # pre-ffn norm
                if spec.ffn == FFN_DENSE:
                    block += _ffn_params(cfg)
                else:
                    block += _moe_params(cfg, active_only)
            per_spec += block * group.repeat
    n += per_spec
    n += cfg.d_model  # final norm
    if cfg.is_encdec:
        # encoder trunk: attn + dense ffn, bidirectional
        enc = cfg.n_enc_layers * (_attn_params(cfg) + _ffn_params(cfg) + 2 * cfg.d_model)
        n += enc + cfg.d_model
    return n


# --------------------------------------------------------------------------
# Input shapes assigned to the LM pool
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

# Archs allowed to run the long_500k cell (sub-quadratic sequence mixing).
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b", "gemma3-27b")


def cell_is_runnable(arch: str, shape_name: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch × shape) cell."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "long_500k requires sub-quadratic attention (skip: pure full-attention arch)"
    return True, ""
