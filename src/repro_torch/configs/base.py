"""Config dataclasses: model architecture, quantization, shapes, training
and parallelism (port of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.policy import PolicyTree


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How PANN / baseline quantization is applied to every linear layer."""
    mode: str = "none"            # none | ruq | ruq_unsigned | pann
    weight_bits: int = 8          # RUQ weight bits
    act_bits: int = 8             # RUQ activation bits
    r: float = 2.0                # PANN addition budget per input element
    act_bits_tilde: int = 8       # PANN activation bits (b~x)
    qat: bool = False             # STE fake-quant inside the train step
    acc_bits: int = 32            # accumulator width for power accounting


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv-stem layer's static geometry (NHWC, zero 'same-ish' pad).

    Geometry is CONFIG, never artifact data: the serving artifact stores a
    conv kernel flat as a (kh*kw*c_in, c_out) matrix (kernels/pann_conv
    layout contract), so the one weight store / mmap schema is untouched
    and rung views, plane packing, and the allocator all see a linear with
    fan-in kh*kw*c_in.
    """
    kh: int                       # kernel height
    kw: int                       # kernel width
    sh: int                       # stride height
    sw: int                       # stride width
    c_in: int
    c_out: int
    ph: int = 0                   # zero padding (each side), height
    pw: int = 0                   # zero padding (each side), width

    @property
    def fan_in(self) -> int:
        return self.kh * self.kw * self.c_in

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        return ((h + 2 * self.ph - self.kh) // self.sh + 1,
                (w + 2 * self.pw - self.kw) // self.sw + 1)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | encdec | hybrid | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    activation: str = "swiglu"    # swiglu | geglu | gelu | relu
    dtype: str = "float32"        # compute dtype ("bfloat16" on TPU)
    # --- attention variants ---
    sliding_window: Optional[int] = None   # mixtral-style SWA (all layers)
    local_global_period: int = 0  # gemma2: every Nth layer is global, rest local
    local_window: int = 4096
    attn_softcap: float = 0.0     # gemma2 attention-logit softcap
    logit_softcap: float = 0.0    # gemma2 final-logit softcap
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_impl: str = "scan"        # scan (dense, baseline) | capacity (§Perf)
    # --- SSM / hybrid ---
    ssm_state: int = 0            # mamba2 state size (N)
    ssm_head_dim: int = 64        # mamba2 head dim (P)
    ssm_expand: int = 2           # d_inner = expand * d_model
    ssm_conv_width: int = 4
    attn_period: int = 0          # zamba2: shared attn block every N layers
    # --- enc-dec ---
    encoder_layers: int = 0
    encoder_seq_len: int = 1024   # stubbed modality frontend output length
    # --- VLM ---
    cross_attn_period: int = 0    # llama-3.2-vision: cross-attn every Nth layer
    num_image_tokens: int = 0
    # --- modality frontend (conv stem) ---
    # When non-empty, the encoder path owns a REAL conv stem: raw (B, H, W,
    # C) pixels / (B, frames, 1, mels) features run through these layers
    # (models.layers.apply_conv -> kernels.dispatch.serving_conv) and the
    # result is flattened to the encoder/image token sequence. Empty = the
    # pre-conv behavior (data.pipeline.frontend_stub embeddings).
    conv_stem: Tuple[ConvSpec, ...] = ()
    frontend_hw: Tuple[int, int] = ()   # raw input spatial dims (H, W)
    # --- serving ---
    kv_cache_dtype: str = ""      # "" = compute dtype; "float8_e4m3fn" halves
    #                               KV-cache bytes for decode (§Perf iter. 7)
    # Serving-matmul backend for quantized (w_q) projections — None (legacy
    # float dequant) | "ref" | "fused" | "packed" (repro_torch.kernels.
    # dispatch). Static per engine: every rung runs the same step code.
    kernel_backend: Optional[str] = None
    # Quantized KV cache: when set, decode stores K/V as packed bit-plane
    # codes at this many unsigned bits (<= 7) and attention runs through the
    # bit-plane decode kernel (kernels/pann_attention via dispatch). The
    # *structure* knob only — per-rung cache bits ride as device tensors
    # (k_nlvl/v_nlvl) so one step function serves mixed cache-rung ladders.
    cache_bits: Optional[int] = None
    # --- misc ---
    tie_embeddings: bool = False
    scale_embed: bool = False     # gemma2: multiply embeddings by sqrt(d)
    post_norm: bool = False       # gemma2: extra norm on sublayer outputs
    # Cost-probe mode: unroll scans (layer groups, attention chunks, MoE
    # experts) so compiled.cost_analysis() counts every iteration — XLA
    # counts while-loop bodies once. Used by the dry-run's FLOPs probes on
    # shallow variants; never for real execution.
    unroll_loops: bool = False
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    # Per-module policy tree (repro_torch.core.policy). None = the global ``quant``
    # applies uniformly (the pre-policy behavior, bit-exact). When set, every
    # projection looks up its own ModuleQuant by module path ("attn.wq",
    # "mlp.w_down", ...) via ``layers.module_quant``.
    policy: Optional[PolicyTree] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP shards evenly."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def stem_out_hw(self) -> Tuple[int, int]:
        """Spatial dims after the conv stem (requires conv_stem set)."""
        h, w = self.frontend_hw
        for spec in self.conv_stem:
            h, w = spec.out_hw(h, w)
        return h, w

    @property
    def stem_tokens(self) -> int:
        """Token-sequence length the conv stem feeds the encoder."""
        h, w = self.stem_out_hw
        return h * w

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic attention -> the long_500k cell runs (DESIGN.md §5)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None
                or self.local_global_period > 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


# The four LM shape cells assigned to every architecture.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = False            # ZeRO-3-style param sharding over "data"
    remat: str = "block"          # none | block  (activation checkpointing)
    pipeline_stages: int = 1      # GPipe over the "pod" axis when > 1
    compress_grads: bool = False  # int8 + error-feedback gradient all-reduce
    microbatches: int = 1         # gradient-accumulation factor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    # --- power-aware QAT ---
    # Budget-annealing curriculum: "step:bits" knots, e.g. "0:fp,200:8,600:4"
    # (core/anneal.py). None = a fixed operating point for the whole run.
    budget_schedule: Optional[str] = None
    # how each annealed budget is spent across modules: uniform | layerwise
    budget_allocation: str = "layerwise"
    # EMA decay of the activation-range calibration collection
    calib_decay: float = 0.99
    # LR re-warmup after each budget-tightening knot: ramp length in steps
    # (0 = off) and the knot steps it applies at (set by the trainer from
    # the parsed schedule; consumed by optim.cosine_warmup_schedule)
    anneal_warmup_steps: int = 0
    lr_rewarmup_knots: Tuple[int, ...] = ()
