"""Analytic parameter / FLOP / MAC counting per architecture config.

Used for (a) the paper-style power accounting (MACs x bit-flips/MAC), and
(b) the roofline's MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference) yardstick
against compiled HLO FLOPs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import power as pw
from repro_torch.core.power import MacBreakdown
from repro_torch.models.transformer import group_layout


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    n = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
        + cfg.num_heads * hd * d
    if cfg.qkv_bias:
        n += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    return n


def _mlp_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * cfg.d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    proj_out = 2 * d_inner + 2 * n + h
    return cfg.d_model * proj_out + d_inner * cfg.d_model \
        + cfg.ssm_conv_width * (d_inner + 2 * n)


def _rwkv_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    return 5 * d * d + d * 64 + 64 * d + 2 * d * cfg.d_ff


def _layer_params(cfg: ModelConfig, kind: str) -> int:
    if kind == "attn":
        return _attn_params(cfg) + _mlp_params(cfg)
    if kind == "attn_moe":
        e = cfg.moe.num_experts
        return _attn_params(cfg) + e * _mlp_params(cfg) \
            + cfg.d_model * e
    if kind == "cross_attn":
        return 2 * _attn_params(cfg) + _mlp_params(cfg)
    if kind == "mamba":
        return _ssm_params(cfg)
    if kind == "mamba_attn":
        return _ssm_params(cfg)  # shared block counted once, separately
    if kind == "rwkv":
        return _rwkv_params(cfg)
    raise ValueError(kind)


def _conv_stem_params(cfg: ModelConfig) -> int:
    return sum(s.fan_in * s.c_out + s.c_out for s in cfg.conv_stem)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total (or MoE-active) parameter count."""
    pattern, n_groups, n_tail = group_layout(cfg)
    total = cfg.padded_vocab * cfg.d_model          # embedding
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.padded_vocab     # lm head
    seq = [s.kind for s in pattern] * n_groups \
        + [pattern[i].kind for i in range(n_tail)]
    for kind in seq:
        if active_only and kind == "attn_moe":
            k = cfg.moe.top_k
            total += _attn_params(cfg) + k * _mlp_params(cfg) \
                + cfg.d_model * cfg.moe.num_experts
        else:
            total += _layer_params(cfg, kind)
    if cfg.family == "hybrid":
        total += _attn_params(cfg) + _mlp_params(cfg)   # shared block
    if cfg.family == "encdec":
        total += cfg.encoder_layers * (_attn_params(cfg) + _mlp_params(cfg))
    total += _conv_stem_params(cfg)
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The roofline yardstick: 6·N·D train / 2·N·D inference, with N the
    MoE-*active* parameter count (the assignment's §Roofline definition)."""
    n = param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    # decode: one new token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# MAC counting for the power model (forward pass, per token)
# ---------------------------------------------------------------------------

def macs_per_token(cfg: ModelConfig, context_len: int = 4096) -> MacBreakdown:
    """Weight-MACs vs activation-MACs of one forward token.

    act_macs covers QK^T and attention·V (context_len keys) — products with
    no static weight operand, outside PANN's scope (DESIGN.md §4).

    A conv stem is NOT one MAC per param per token (spatial weight reuse:
    each kernel fires Ho·Wo times per item), so its param count is swapped
    out for the exact per-layer kh·kw·Cin·Cout·Ho·Wo account, amortized
    per produced frontend token — the same rows ``module_cost_profile``
    itemizes, keeping the two accounts equal to float precision.
    """
    weight = float(param_count(cfg, active_only=True))
    # embedding lookups are gathers, not MACs
    weight -= cfg.padded_vocab * cfg.d_model
    if cfg.conv_stem:
        weight -= float(_conv_stem_params(cfg))
        weight += sum(m.macs for m in conv_stem_token_costs(cfg))
    pattern, n_groups, n_tail = group_layout(cfg)
    seq = [s.kind for s in pattern] * n_groups \
        + [pattern[i].kind for i in range(n_tail)]
    hd = cfg.resolved_head_dim
    act = 0.0
    for i, kind in enumerate(seq):
        if kind in ("attn", "attn_moe", "cross_attn"):
            win = pattern[i % len(pattern)].window
            ctx = min(context_len, win) if win else context_len
            act += 2.0 * cfg.num_heads * hd * ctx   # QK^T + PV
        if kind == "mamba_attn":
            act += 2.0 * cfg.num_heads * hd * context_len
    return MacBreakdown(weight_macs=weight, act_macs=act)


# ---------------------------------------------------------------------------
# Per-module MAC profile (the layerwise allocator's input)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModuleCost:
    """One module role's aggregate forward cost per token.

    ``fan_in`` is one instance's reduction width — the d of Eq. (19)'s MSE
    and the k^2 C_in of Eq. (20)'s accumulator bound. ``macs`` sums over all
    ``instances`` of the role across the depth of the network (module paths
    are roles, not per-depth instances; see core/policy.py).
    """
    path: str
    macs: float          # weight MACs per token, all instances
    fan_in: int          # reduction width of one instance
    instances: int = 1

    def acc_bits(self, b_x: int, b_w: int) -> int:
        """Eq. (20) accumulator width for this module's fan-in, capped at
        the paper's 32-bit default (never wider than the hardware)."""
        return min(pw.DEFAULT_ACC_BITS,
                   pw.required_acc_bits(b_x, b_w, self.fan_in))


def module_cost_profile(cfg: ModelConfig) -> tuple[ModuleCost, ...]:
    """Weight-MAC profile by module path, consistent with ``macs_per_token``:
    the profile's total equals its ``weight_macs`` up to the tiny terms the
    analytic param count also ignores (qkv biases, norm vectors).

    MoE experts are counted at the *active* (top-k) rate, matching
    ``param_count(active_only=True)``. The embedding gather contributes no
    MACs and has no entry.
    """
    acc: dict[str, list] = {}     # path -> [macs, fan_in, instances]

    def add(path: str, d_in: int, d_out: int, count: float = 1.0) -> None:
        row = acc.setdefault(path, [0.0, int(d_in), 0])
        row[0] += float(d_in) * float(d_out) * count
        row[2] += max(int(round(count)), 1) if count else 0

    hd = cfg.resolved_head_dim
    d = cfg.d_model

    def add_attn(count: float = 1.0) -> None:
        add("attn.wq", d, cfg.num_heads * hd, count)
        add("attn.wk", d, cfg.num_kv_heads * hd, count)
        add("attn.wv", d, cfg.num_kv_heads * hd, count)
        add("attn.wo", cfg.num_heads * hd, d, count)

    def add_mlp(count: float = 1.0) -> None:
        if cfg.activation in ("swiglu", "geglu"):
            add("mlp.w_gate", d, cfg.d_ff, count)
        add("mlp.w_up", d, cfg.d_ff, count)
        add("mlp.w_down", cfg.d_ff, d, count)

    def add_ssm(count: float = 1.0) -> None:
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_head_dim
        n = cfg.ssm_state
        add("ssm.in_proj", d, 2 * d_inner + 2 * n + h, count)
        add("ssm.out_proj", d_inner, d, count)
        # depthwise causal conv: conv_width MACs per channel per token
        add("ssm.conv", cfg.ssm_conv_width, d_inner + 2 * n, count)

    def add_rwkv(count: float = 1.0) -> None:
        for name in ("wr", "wk", "wv", "wg", "wo"):
            add(f"rwkv.tm.{name}", d, d, count)
        add("rwkv.tm.decay_a", d, 64, count)
        add("rwkv.tm.decay_b", 64, d, count)
        add("rwkv.cm.wk", d, cfg.d_ff, count)
        add("rwkv.cm.wv", cfg.d_ff, d, count)

    pattern, n_groups, n_tail = group_layout(cfg)
    seq = [s.kind for s in pattern] * n_groups \
        + [pattern[i].kind for i in range(n_tail)]
    for kind in seq:
        if kind == "attn":
            add_attn()
            add_mlp()
        elif kind == "attn_moe":
            add_attn()
            add("moe.router", d, cfg.moe.num_experts)
            k = cfg.moe.top_k
            if cfg.activation in ("swiglu", "geglu"):
                add("moe.w_gate", d, cfg.d_ff, k)
            add("moe.w_up", d, cfg.d_ff, k)
            add("moe.w_down", cfg.d_ff, d, k)
        elif kind == "cross_attn":
            add_attn(2.0)          # self + cross projections
            add_mlp()
        elif kind in ("mamba", "mamba_attn"):
            add_ssm()              # hybrid shared block counted once below
        elif kind == "rwkv":
            add_rwkv()
    if cfg.family == "hybrid":
        add_attn()
        add_mlp()
    if cfg.family == "encdec":
        add_attn(float(cfg.encoder_layers))
        add_mlp(float(cfg.encoder_layers))
    if not cfg.tie_embeddings:
        add("lm_head", d, cfg.padded_vocab)
    # conv-stem roles, amortized per produced frontend token (see
    # macs_per_token) — present so allocate_layerwise trades conv bits
    # against attention/cache bits under ONE budget, and so the engine's
    # EnergyLedger breakdown itemizes the stem like any other role
    for m in conv_stem_token_costs(cfg):
        acc[m.path] = [m.macs, m.fan_in, m.instances]
    return tuple(ModuleCost(path=p, macs=row[0], fan_in=row[1],
                            instances=row[2])
                 for p, row in sorted(acc.items()))


# ---------------------------------------------------------------------------
# Conv stems and the encoder (per-item) account
# ---------------------------------------------------------------------------

def conv_stem_item_costs(cfg: ModelConfig) -> tuple[ModuleCost, ...]:
    """EXACT per-ITEM (image / utterance) conv MACs, one role per stem
    layer: kh·kw·Cin · Cout · Ho·Wo — the Moons-et-al.-style per-layer conv
    energy account in the repo's MAC currency. Geometry walks forward from
    ``cfg.frontend_hw`` through each ``ConvSpec``. fan_in = kh·kw·Cin is
    both the Eq.-19 sensitivity d and the Eq.-20 accumulator bound, so the
    layerwise allocator prices conv roles with zero new code."""
    if not cfg.conv_stem:
        return ()
    h, w = cfg.frontend_hw
    rows = []
    for i, spec in enumerate(cfg.conv_stem):
        ho, wo = spec.out_hw(h, w)
        rows.append(ModuleCost(
            path=f"conv.s{i}",
            macs=float(spec.fan_in) * float(spec.c_out) * float(ho * wo),
            fan_in=spec.fan_in))
        h, w = ho, wo
    return tuple(rows)


def conv_stem_token_costs(cfg: ModelConfig) -> tuple[ModuleCost, ...]:
    """Conv-stem roles amortized per PRODUCED frontend token (item MACs /
    stem token count) — the form that composes with the per-token rows of
    ``module_cost_profile`` / ``macs_per_token``."""
    rows = conv_stem_item_costs(cfg)
    if not rows:
        return ()
    n_tok = float(max(cfg.stem_tokens, 1))
    return tuple(dataclasses.replace(m, macs=m.macs / n_tok) for m in rows)


def encoder_tokens(cfg: ModelConfig) -> int:
    """Length of the token sequence one encoded item produces."""
    if cfg.conv_stem:
        return cfg.stem_tokens
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    return cfg.encoder_seq_len


def encoder_cost_profile(cfg: ModelConfig) -> tuple[ModuleCost, ...]:
    """Per-ITEM weight-MAC profile of the ENCODE path — what one image /
    utterance costs, the unit the encoder serving ladder budgets in
    (per-item power budgets instead of per-token).

    Conv rows are exact (``conv_stem_item_costs``); for an encdec family
    the bidirectional encoder stack runs every layer over every produced
    token, so its attn/mlp roles carry encoder_layers · n_tokens instances
    of the per-token MACs. A vlm's encode path is the stem alone (its
    transformer is the cross-attending DECODER, priced per decoded token
    by ``module_cost_profile``)."""
    acc: dict[str, list] = {}
    for m in conv_stem_item_costs(cfg):
        acc[m.path] = [m.macs, m.fan_in, m.instances]
    if cfg.family == "encdec" and cfg.encoder_layers:
        d = cfg.d_model
        hd = cfg.resolved_head_dim
        count = float(cfg.encoder_layers) * float(encoder_tokens(cfg))

        def add(path: str, d_in: int, d_out: int) -> None:
            row = acc.setdefault(path, [0.0, int(d_in), 0])
            row[0] += float(d_in) * float(d_out) * count
            row[2] += cfg.encoder_layers

        add("attn.wq", d, cfg.num_heads * hd)
        add("attn.wk", d, cfg.num_kv_heads * hd)
        add("attn.wv", d, cfg.num_kv_heads * hd)
        add("attn.wo", cfg.num_heads * hd, d)
        if cfg.activation in ("swiglu", "geglu"):
            add("mlp.w_gate", d, cfg.d_ff)
        add("mlp.w_up", d, cfg.d_ff)
        add("mlp.w_down", cfg.d_ff, d)
    return tuple(ModuleCost(path=p, macs=row[0], fan_in=row[1],
                            instances=row[2])
                 for p, row in sorted(acc.items()))


def encoder_macs_per_item(cfg: ModelConfig) -> MacBreakdown:
    """Weight vs act MACs of encoding ONE item. act_macs is the encoder's
    bidirectional self-attention: 2·H·hd·T per query token over T tokens
    per layer (T², not T·ctx — whole-sequence waves, no KV cache)."""
    weight = sum(m.macs for m in encoder_cost_profile(cfg))
    act = 0.0
    if cfg.family == "encdec" and cfg.encoder_layers:
        t = float(encoder_tokens(cfg))
        act = 2.0 * cfg.num_heads * cfg.resolved_head_dim * t * t \
            * cfg.encoder_layers
    return MacBreakdown(weight_macs=weight, act_macs=act)


def cache_cost_modules(cfg: ModelConfig, context_len: int = 4096
                       ) -> tuple[ModuleCost, ...]:
    """The KV-cache roles as allocator pseudo-modules: ``attn.k_cache``
    (QK^T) and ``attn.v_cache`` (PV) each carry HALF of ``macs_per_token``'s
    act_macs — the two act x act streams of decode attention — with one
    head's reduction width as fan_in. Appending these to
    ``module_cost_profile``'s output lets ``allocate_layerwise`` trade
    cache bits against weight bits under ONE budget (priced by
    ``policy.tree_power_per_token``'s cache-role split)."""
    act = macs_per_token(cfg, context_len).act_macs
    if not act:
        return ()
    hd = cfg.resolved_head_dim
    return (ModuleCost(path="attn.k_cache", macs=0.5 * act, fan_in=hd),
            ModuleCost(path="attn.v_cache", macs=0.5 * act, fan_in=hd))


def network_macs(cfg: ModelConfig, shape: ShapeConfig) -> MacBreakdown:
    tokens = shape.seq_len * shape.global_batch if shape.kind != "decode" \
        else shape.global_batch
    ctx = shape.seq_len
    return macs_per_token(cfg, ctx).scale(float(tokens))
