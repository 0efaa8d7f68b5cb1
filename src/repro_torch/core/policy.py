"""Per-module quantization policies: the layer-wise generalization of the
single global ``QuantConfig``.

The paper's central criticism of prior art is that it ignores "the precise
power consumed by each module in the network" — a uniform operating point
spends the same bit-flip budget per MAC in a 4096-fan-in MLP down-projection
and a 64-fan-in decay head, even though their Eq.-19 MSE sensitivities and
Eq.-20 accumulator widths differ wildly. This module defines the vocabulary
for spending the budget *non*-uniformly:

  ``ModuleQuant``   one module's operating point (mode, b_w, b_x / b~x, R,
                    acc_bits) — the per-module analogue of ``QuantConfig``.
  ``PolicyTree``    a mapping from module *paths* ("attn.wq", "mlp.w_down",
                    "rwkv.tm.wo", "lm_head", ...) to ``ModuleQuant``, with
                    longest-dotted-prefix lookup and a default.
  ``uniform_policy``  lift a ``QuantConfig`` into a PolicyTree that assigns
                    every module the identical point — bit-exact with the
                    pre-policy behavior by construction.

Module paths are *roles*, not per-depth instances: every layer in the
scanned stack shares one policy per projection role, which is what keeps
``lax.scan`` bodies homogeneous and lets ONE jitted decode step serve every
policy tree (the serve_engine invariant; DESIGN.md §7).

Canonical path vocabulary (must match the names used by the model forwards
and ``models/serving.py``):

  attn.wq attn.wk attn.wv attn.wo            (self- and cross-attention)
  mlp.w_gate mlp.w_up mlp.w_down             (dense FFN)
  moe.router moe.w_gate moe.w_up moe.w_down  (MoE router + experts)
  ssm.in_proj ssm.out_proj ssm.conv          (Mamba2)
  rwkv.tm.wr rwkv.tm.wk rwkv.tm.wv rwkv.tm.wg rwkv.tm.decay_a
  rwkv.tm.decay_b rwkv.tm.wo rwkv.cm.wk rwkv.cm.wv
  lm_head
  conv.s0 conv.s1 ...                        (modality-frontend conv stem
                                              layers, one role per depth —
                                              stems are shallow and their
                                              fan-ins differ per layer, so
                                              unlike the scanned stack each
                                              depth IS a role)
  attn.k_cache attn.v_cache                  (decode-time KV cache codes;
                                              mode="ruq_unsigned", b_x = the
                                              cache bits — see CACHE_PATHS)

The power/score accounting at the bottom consumes the per-module MAC
profile from ``core/costs.py`` (duck-typed: anything with .path / .macs /
.fan_in) so the allocator, the serving ladder, and the per-response energy
breakdown all price a tree the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Optional, Sequence, Tuple

from repro_torch.core import mse as mse_theory
from repro_torch.core import power as pw


@dataclasses.dataclass(frozen=True)
class ModuleQuant:
    """One module's operating point.

    Field names follow the paper (b_w, b_x, r, b_x_tilde); the properties
    below mirror ``QuantConfig``'s names so ``models/layers.qlinear`` works
    identically with either object.
    """
    mode: str = "none"            # none | ruq | ruq_unsigned | pann
    b_w: int = 8                  # RUQ weight bits
    b_x: int = 8                  # RUQ activation bits
    r: float = 2.0                # PANN addition budget per input element
    b_x_tilde: int = 8            # PANN activation bits (b~x)
    acc_bits: int = pw.DEFAULT_ACC_BITS   # accumulator width (Eq. 20-capped)

    # --- QuantConfig-compatible aliases ---
    @property
    def weight_bits(self) -> int:
        return self.b_w

    @property
    def act_bits(self) -> int:
        return self.b_x

    @property
    def act_bits_tilde(self) -> int:
        return self.b_x_tilde

    def power_per_mac(self) -> float:
        """Bit flips one weight-MAC of this module costs (Eq. 13 / 7 / 3-4)."""
        if self.mode == "pann":
            return pw.p_pann(self.r, self.b_x_tilde)
        if self.mode == "ruq_unsigned":
            return pw.p_mac_unsigned(max(self.b_w, self.b_x))
        if self.mode == "ruq":
            return pw.p_mac_mixed_signed(self.b_w, self.b_x, self.acc_bits)
        return 0.0                 # fp module: outside the quantized account

    def theory_mse(self, d: float = 1.0) -> float:
        """Eq. 18/16 output MSE of one fan-in-``d`` neuron at this point.

        ``d=1`` gives the *relative* (signal-normalized) MSE: under the
        §5.3 model both the Eq.-14 error and the output signal variance
        scale linearly with the fan-in, so their ratio is the d=1 value.
        """
        if self.mode == "pann":
            return mse_theory.mse_pann(d, self.b_x_tilde, self.r)
        if self.mode in ("ruq", "ruq_unsigned"):
            return mse_theory.mse_ruq(d, self.b_x, self.b_w)
        return 0.0


def as_module_quant(qc) -> ModuleQuant:
    """Normalize a ``QuantConfig`` (or ModuleQuant) into a ModuleQuant."""
    if isinstance(qc, ModuleQuant):
        return qc
    return ModuleQuant(mode=qc.mode, b_w=qc.weight_bits, b_x=qc.act_bits,
                       r=qc.r, b_x_tilde=qc.act_bits_tilde,
                       acc_bits=qc.acc_bits)


@dataclasses.dataclass(frozen=True)
class PolicyTree:
    """Module-path -> ModuleQuant, with longest-dotted-prefix fallback.

    ``overrides`` is a sorted tuple of (path, ModuleQuant) pairs so the tree
    is hashable (it rides on the frozen ``ModelConfig``); build trees with
    ``policy_tree`` to pass a plain dict.
    """
    default: ModuleQuant
    overrides: Tuple[Tuple[str, ModuleQuant], ...] = ()

    def lookup(self, path: str) -> ModuleQuant:
        """Exact match, else longest dotted prefix, else the default."""
        # lookup runs per projection at trace time and per module per
        # response in the serving engine's energy accounting — build the
        # dict once per tree (lazily; eq/hash only see dataclass fields)
        table = self.__dict__.get("_table")
        if table is None:
            table = dict(self.overrides)
            object.__setattr__(self, "_table", table)
        probe = path
        while probe:
            if probe in table:
                return table[probe]
            cut = probe.rfind(".")
            probe = probe[:cut] if cut > 0 else ""
        return self.default

    def items(self) -> Tuple[Tuple[str, ModuleQuant], ...]:
        return self.overrides

    def describe(self) -> str:
        rows = [f"  {p}: {m.mode} b~x={m.b_x_tilde} R={m.r:.2f} "
                f"acc={m.acc_bits}" for p, m in self.overrides]
        head = (f"PolicyTree(default {self.default.mode}, "
                f"{len(self.overrides)} overrides)")
        return "\n".join([head] + rows)


def policy_tree(default, overrides: Optional[Mapping[str, ModuleQuant]] = None
                ) -> PolicyTree:
    """Build a PolicyTree from a QuantConfig/ModuleQuant default + dict."""
    ov = tuple(sorted((overrides or {}).items()))
    return PolicyTree(default=as_module_quant(default), overrides=ov)


def uniform_policy(qc) -> PolicyTree:
    """The backward-compatibility lift: every module gets the global point.

    ``lookup`` returns a ModuleQuant with field-for-field the same values as
    ``qc``, and ``layers.qlinear`` reads the same attributes, so a forward
    under ``uniform_policy(qc)`` is bit-exact with one under ``qc`` (asserted
    in tests/test_policy_allocator.py).
    """
    return PolicyTree(default=as_module_quant(qc))


# ---------------------------------------------------------------------------
# Serving-artifact path resolution
# ---------------------------------------------------------------------------

# structural parents that anchor a module path in the param pytree
_STRUCTURAL = {"attn", "xattn", "shared_attn", "mlp", "moe", "ssm",
               "tm", "cm"}
_RWKV_SUBBLOCKS = {"tm", "cm"}


def serving_path(trail: Sequence[str]) -> str:
    """Map a param-pytree key trail to the canonical policy path.

    e.g. ("decoder", "groups", "layers", "attn", "wq") -> "attn.wq";
    ("tm", "wr") -> "rwkv.tm.wr"; ("lm_head",) -> "lm_head";
    ("conv_stem", "s0") -> "conv.s0".
    ``xattn`` and the zamba2 ``shared_attn`` block map onto ``attn`` so one
    policy entry covers every attention instance.
    """
    leaf = trail[-1]
    if "conv_stem" in trail:
        # stem layers are per-depth roles: shallow, heterogeneous fan-ins
        return f"conv.{leaf}"
    parent = next((t for t in reversed(trail[:-1]) if t in _STRUCTURAL),
                  None)
    if parent in _RWKV_SUBBLOCKS:
        return f"rwkv.{parent}.{leaf}"
    if parent in ("xattn", "shared_attn"):
        return f"attn.{leaf}"
    if parent is not None:
        return f"{parent}.{leaf}"
    return leaf


# ---------------------------------------------------------------------------
# Pricing and scoring a tree against a module cost profile
# ---------------------------------------------------------------------------

ACT_PATH = "attn.act"   # breakdown key for act x act MACs (QK^T, PV)

# Cache roles: the two act x act operand streams of decode attention. An
# EXPLICIT override on either role (not a prefix fallback from "attn") means
# the tree prices the cache at its own width; otherwise the legacy ACT_PATH
# lump applies. Cache points are unsigned codes, so mode="ruq_unsigned" with
# b_w = b_x = the cache bits is the canonical ModuleQuant.
CACHE_PATHS = ("attn.k_cache", "attn.v_cache")


def cache_module_quant(bits: int) -> ModuleQuant:
    """The canonical operating point of a ``bits``-bit quantized KV cache."""
    b = int(bits)
    return ModuleQuant(mode="ruq_unsigned", b_w=b, b_x=b, b_x_tilde=b)


def tree_cache_bits(tree: PolicyTree) -> dict:
    """{cache role: bits} for the roles the tree EXPLICITLY overrides.

    Prefix fallback is deliberately not consulted: an "attn" override is a
    weight-projection point, not an opt-in to cache quantization.
    """
    table = dict(tree.overrides)
    out = {}
    for role in CACHE_PATHS:
        mq = table.get(role)
        if mq is not None and mq.mode != "none":
            out[role] = max(mq.b_w, mq.b_x)
    return out


def tree_power_per_token(profile: Iterable, tree: PolicyTree,
                         act_macs: float = 0.0) -> Tuple[float, dict]:
    """(total bit flips per token, {path: bit flips}) of one forward token.

    Weight modules are priced at their own operating point; act x act MACs
    (outside PANN's scope, DESIGN.md §4) are charged as unsigned MACs at the
    default policy's activation width, mirroring
    ``power.network_power_bitflips(scheme="pann")``. When the tree carries
    explicit cache-role overrides (CACHE_PATHS), the act x act MACs split in
    half per role — QK^T reads the K cache, PV reads the V cache — and each
    half is priced at its role's own width instead of the default lump.
    """
    breakdown: dict[str, float] = {}
    for m in profile:
        if m.path in CACHE_PATHS:
            continue               # cache roles are priced off act_macs below
        mq = tree.lookup(m.path)
        breakdown[m.path] = m.macs * mq.power_per_mac()
    if act_macs:
        cache = tree_cache_bits(tree)
        if cache:
            d = tree.default
            b_act = d.b_x_tilde if d.mode == "pann" else d.b_x
            for role in CACHE_PATHS:
                b = cache.get(role, b_act)
                breakdown[role] = 0.5 * act_macs * pw.p_mac_unsigned(b)
        else:
            d = tree.default
            b_act = d.b_x_tilde if d.mode == "pann" else d.b_x
            breakdown[ACT_PATH] = act_macs * pw.p_mac_unsigned(b_act)
    return sum(breakdown.values()), breakdown


def tree_theory_score(profile: Iterable, tree: PolicyTree) -> float:
    """-(output-weighted relative Eq. 18/19 MSE) of a tree — higher is
    better.

    Each module contributes (its output count per token, ``macs / fan_in``)
    x (the per-output *relative* MSE at its operating point). Relative —
    not absolute — because under the §5.3 uniform model both the Eq.-14
    error and the output signal variance grow linearly with fan-in, so the
    per-output SNR is the fan-in-free ``theory_mse(1)``. This is what makes
    layer-wise allocation non-degenerate: a wide reduction (mlp.w_down's
    14336-fan-in) yields fewer outputs per MAC than a narrow one, so a bit
    flip spent there buys less output fidelity, and the allocator shifts
    budget toward the narrow modules. (With the absolute metric the fan-in
    cancels against the output count and uniform is provably optimal.)

    Uniform and layerwise trees are scored with the SAME metric so the
    allocator's "never worse than uniform" guarantee is well defined.
    """
    total = 0.0
    for m in profile:
        mq = tree.lookup(m.path)
        weight = m.macs / max(float(m.fan_in), 1.0)
        total += weight * mq.theory_mse(1.0)
    return -total


def pann_storage_bits(r: float) -> int:
    """Estimated b_R: bits storing a PANN weight code at addition budget R.

    Codes concentrate within a few multiples of R (Table 14 measures
    b_R <= 5 in practice); 2R+1 levels is the working envelope we size the
    Eq.-20 accumulator with.
    """
    return max(1, int(math.ceil(math.log2(2.0 * max(r, 0.5) + 1.0))))


def pann_module_quant(r: float, b_x_tilde: int, fan_in: int) -> ModuleQuant:
    """A PANN ModuleQuant with the Eq.-20 accumulator width for its fan-in
    (capped at the paper's 32-bit default — never wider than the hardware)."""
    b_w = pann_storage_bits(r)
    acc = min(pw.DEFAULT_ACC_BITS,
              pw.required_acc_bits(b_x_tilde, b_w, fan_in))
    return ModuleQuant(mode="pann", b_w=b_w, r=r, b_x_tilde=b_x_tilde,
                       acc_bits=acc)
