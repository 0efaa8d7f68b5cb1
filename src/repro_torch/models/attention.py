"""Self-attention with RoPE, GQA, windows and softcaps (port of
``repro.models.attention``): the chunked online-softmax attention of
prefill and ``forward`` (``_chunked_attention``, ``attend``, which also
cross-attends to an encoder's or an image's tokens), and decode over KV
caches; decode cross-attention reads K/V projected once per request
(``project_cross_kv``, ``cross_attend_cached``: fp32, no kernel, as in the
reference).

Two caches: ``KVCache`` holds K/V in floating point; ``QuantKVCache``
holds them as packed bit-plane affine codes, written by ``_cache_write``
and read by ``kernels.dispatch.decode_attention``. Unlike the JAX
package, whose arrays are immutable, the port writes each new token into
the cache IN PLACE (``index_copy_`` at the device-resident position), so a
decode step allocates no new cache; a cache belongs to one decode state.

A windowed layer's cache of at most ``window`` rows is a ring
(``is_ring``): position ``pos`` is written at row ``pos mod rows``,
computed on the device from ``length``, and attention reads every row
written so far with no window mask, since the ring holds exactly the
window's last positions. Both attention products, the softmax maximum and
the V scale are independent of row order, and the fp64 softmax
denominator is rounded once, so a ring's quantized decode equals a
decode over a cache of every position masked to the window bit for bit.
The reference sizes the cache the same (``min(max_len, window)`` rows)
but writes at the absolute position, which drops every token from
position ``window`` on (ROADMAP C2); its decode over a cache of
``max_len`` rows is the function the ring is held against. RoPE stays at
the absolute position.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.dist import constrain as C
from repro_torch.dist import local_ops
from repro_torch.kernels import dispatch as KD
from repro_torch.kernels import ref as KREF
from repro_torch.models import layers as L

Tensor = torch.Tensor

NEG_INF = -1e30


def rope_freqs(head_dim: int, theta: float, device) -> Tensor:
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / idx.new_full((), float(head_dim))))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, T, H, hd); positions: (B, T) or (T,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "wq": L.init_linear(gen, d, cfg.num_heads * hd, device,
                            bias=cfg.qkv_bias),
        "wk": L.init_linear(gen, d, cfg.num_kv_heads * hd, device,
                            bias=cfg.qkv_bias),
        "wv": L.init_linear(gen, d, cfg.num_kv_heads * hd, device,
                            bias=cfg.qkv_bias),
        "wo": L.init_linear(gen, cfg.num_heads * hd, d, device),
    }


class KVCache(NamedTuple):
    k: Tensor          # (B, S_max, K, hd)
    v: Tensor          # (B, S_max, K, hd)
    length: Tensor     # () int32 — tokens currently cached


class QuantKVCache(NamedTuple):
    """K/V as packed bit-plane affine codes, plane axis pinned at
    ``kernels.ref.CACHE_PLANES`` whatever the rung's cache bits; per
    position quantizer rows (s, z), z integer-valued fp32."""
    k_planes: Tensor   # (B, P, S_max, K, hd//8) uint8
    v_planes: Tensor   # (B, P, S_max, K, hd//8) uint8
    k_s: Tensor        # (B, S_max) f32
    k_z: Tensor        # (B, S_max) f32
    v_s: Tensor        # (B, S_max) f32
    v_z: Tensor        # (B, S_max) f32
    length: Tensor     # () int32


def _project_qkv(x: Tensor, p: dict, cfg: ModelConfig,
                 kv_src: Optional[Tensor] = None):
    """Q from x, K and V from ``kv_src`` (x itself for self-attention)."""
    hd = cfg.resolved_head_dim
    q = L.project(x, p["wq"], cfg, "attn.wq")
    shards = local_ops.current_shards()
    if shards is not None:      # the rank's query heads of a serving mesh
        q = shards.heads_of(q, shards.num_heads, shards.num_heads * hd)
    q = C.split_heads(q, cfg.num_heads, hd)
    k, v = project_cross_kv(x if kv_src is None else kv_src, p, cfg)
    return q, k, v


def project_cross_kv(src: Tensor, p: dict, cfg: ModelConfig
                     ) -> tuple[Tensor, Tensor]:
    """K and V of ``src`` (B, S, d): (B, S, KH, hd) each. Decode projects
    an encoder's or an image's tokens once per request with it."""
    hd = cfg.resolved_head_dim
    k = L.project(src, p["wk"], cfg, "attn.wk")
    v = L.project(src, p["wv"], cfg, "attn.wv")
    shards = local_ops.current_shards()
    if shards is not None:      # the rank's KV heads of a serving mesh
        return shards.kv_heads_of(k, hd), shards.kv_heads_of(v, hd)
    return (C.split_heads(k, cfg.num_kv_heads, hd),
            C.split_heads(v, cfg.num_kv_heads, hd))


def _chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                       window: Optional[int], softcap_val: float,
                       q_offset: int = 0, q_chunk: int = 512,
                       kv_chunk: int = 1024) -> Tensor:
    """Online-softmax attention over KV chunks, never more than
    (q_chunk, kv_chunk) scores a pass. q: (B, T, K, G, hd) queries grouped
    per KV head; k, v: (B, S, K, hd). A length that a chunk does not divide
    is taken in one chunk. Returns (B, T, K, G, hd) fp32. The reference's
    op order chunk by chunk (its ``unroll`` cost-probe mode has no
    counterpart here)."""
    b, t, kh, g, hd = q.shape
    s = k.shape[1]
    q = q * hd ** -0.5
    kv_chunk = min(kv_chunk, s)
    q_chunk = min(q_chunk, t)
    if s % kv_chunk:
        kv_chunk = s
    if t % q_chunk:
        q_chunk = t
    dev = q.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    outs = []
    for qi in range(0, t, q_chunk):
        qch = q[:, qi:qi + q_chunk]
        q_pos = torch.arange(qi, qi + q_chunk, device=dev) + q_offset
        m = torch.full((b, q_chunk, kh, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros((b, q_chunk, kh, g), dtype=torch.float32,
                           device=dev)
        acc = torch.zeros((b, q_chunk, kh, g, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(0, s, kv_chunk):
            kch = k[:, ki:ki + kv_chunk]
            vch = v[:, ki:ki + kv_chunk]
            k_pos = torch.arange(ki, ki + kv_chunk, device=dev)
            scores = torch.einsum("btkgh,bskh->btkgs", qch,
                                  kch).to(torch.float32)
            if softcap_val > 0:
                scores = L.softcap(scores, softcap_val)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            scores = torch.where(mask[None, :, None, None, :], scores, neg)
            m_new = torch.maximum(m, torch.amax(scores, dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("btkgs,bskh->btkgh", p.to(v.dtype),
                              vch).to(torch.float32)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(lsum[..., None], min=1e-30))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attend(x: Tensor, p: dict, cfg: ModelConfig, *,
           kv_src: Optional[Tensor] = None,
           positions: Optional[Tensor] = None, causal: bool = True,
           window: Optional[int] = None, use_rope: bool = True) -> Tensor:
    """Full (prefill / ``forward``) attention. x: (B, T, d). With
    ``kv_src`` (B, S, d) it cross-attends: K/V from the source, no RoPE,
    and not causal against the source. GQA repeats K/V to the full head
    count, as the reference does."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(x, p, cfg, kv_src)
    if positions is None:
        positions = torch.arange(t, device=x.device)
    if use_rope and kv_src is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_src is None:
        # the cache roles: post-RoPE K and V, what decode writes, so a
        # calibrated store can freeze the cache quantizers' ranges
        tap = L._active_tap()
        if tap is not None:
            tap.observe("attn.k_cache", k)
            tap.observe("attn.v_cache", v)
    g = cfg.num_heads // cfg.num_kv_heads
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    q = C.constrain_axis(q, 2)
    k = C.constrain_axis(k, 2)
    v = C.constrain_axis(v, 2)
    # heads are independent: under a mesh the core runs on each rank's
    # heads (and batch rows) alone
    out = local_ops.local_apply(_attention_core, q, k, v,
                                causal=causal and kv_src is None,
                                window=window,
                                softcap_val=cfg.attn_softcap)
    out = out.to(x.dtype).reshape(b, t, -1)
    return L.project(out, p["wo"], cfg, "attn.wo")


def _attention_core(q: Tensor, k: Tensor, v: Tensor, **kw) -> Tensor:
    """(B, T, H, hd) queries over (B, S, H, hd) K / V, one group a head:
    ``_chunked_attention``'s (B, T, H, 1, hd) output, fp32."""
    b, t, h, hd = q.shape
    return _chunked_attention(q.reshape(b, t, h, 1, hd), k, v, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    hd = cfg.resolved_head_dim
    if cfg.cache_bits:
        if hd % 8:
            raise ValueError(f"quantized KV cache packs 8 codes/byte along "
                             f"head_dim; head_dim={hd} is not a multiple of 8")
        shape = (batch, KREF.CACHE_PLANES, max_len, cfg.num_kv_heads,
                 hd // 8)

        def row():
            return torch.zeros((batch, max_len), dtype=torch.float32,
                               device=device)

        return QuantKVCache(
            k_planes=torch.zeros(shape, dtype=torch.uint8, device=device),
            v_planes=torch.zeros(shape, dtype=torch.uint8, device=device),
            k_s=row(), k_z=row(), v_s=row(), v_z=row(),
            length=torch.zeros((), dtype=torch.int32, device=device))
    if cfg.kv_cache_dtype:   # e.g. "float8_e4m3fn": half the cache bytes
        dtype = getattr(torch, cfg.kv_cache_dtype)
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def is_ring(rows: int, window: Optional[int]) -> bool:
    """A windowed layer's cache of at most ``window`` rows is a ring."""
    return window is not None and rows <= window


def _cache_row(pos: Tensor, rows: int, ring: bool) -> Tensor:
    """The (1,) int64 row position ``pos`` is written at: ``pos mod rows``
    in a ring (on the device, no host sync), else ``pos``."""
    idx = pos.reshape(1).to(torch.int64)
    return torch.remainder(idx, rows) if ring else idx


def _write_pos(buf: Tensor, idx: Tensor, new: Tensor) -> None:
    """buf[:, idx] = new cast to buf's dtype, in place; a 1-byte (float8)
    cache through its bytes, as index_copy_ has no float8 kernel."""
    new = new.to(buf.dtype)
    if buf.element_size() == 1:
        buf, new = buf.view(torch.uint8), new.view(torch.uint8)
    buf.index_copy_(1, idx, new)


def decode_attend(x: Tensor, cache, p: dict, cfg: ModelConfig, *,
                  window: Optional[int] = None, use_rope: bool = True):
    """One-token decode step. x: (B, 1, d). Returns (out, updated cache).
    Under a serving mesh (``dist.local_ops.use_shards``) ``cfg`` holds the
    rank's head counts and x its batch rows: the reference's decode
    constraints (heads on "model", batch on "data") are the layout of the
    local tensors, and the collectives are the quantizers' ranges and the
    row-parallel ``wo``'s sums (``kernels.dispatch``)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache.length
    q, k_new, v_new = _project_qkv(x, p, cfg)
    if use_rope:
        posv = pos.expand(b, 1)
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    if isinstance(cache, QuantKVCache):
        return _decode_attend_quant(x, cache, p, cfg, q, k_new, v_new,
                                    window=window)
    s_max = cache.k.shape[1]
    ring = is_ring(s_max, window)
    idx = _cache_row(pos, s_max, ring)
    _write_pos(cache.k, idx, k_new)
    _write_pos(cache.v, idx, v_new)
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, 1, cfg.num_kv_heads, g, hd) * hd ** -0.5
    scores = torch.einsum("btkgh,bskh->btkgs", qg, cache.k.to(qg.dtype))
    if cfg.attn_softcap > 0:
        scores = L.softcap(scores, cfg.attn_softcap)
    k_pos = torch.arange(s_max, device=x.device)
    valid = k_pos <= pos            # a ring: every row once it wraps
    if window is not None and not ring:
        valid &= (pos - k_pos) < window
    scores = torch.where(valid, scores, torch.full((), NEG_INF,
                                                   device=x.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskh->btkgh", probs.to(x.dtype),
                       cache.v.to(x.dtype))
    y = L.project(out.reshape(b, 1, -1), p["wo"], cfg, "attn.wo")
    return y, cache._replace(length=pos + 1)


def _cache_range(new: Tensor) -> tuple[Tensor, Tensor]:
    """Per-batch extremes of one new K or V token (B, 1, K, hd) over its
    heads and head dim, zero-extended."""
    xf = new.to(torch.float32)
    lo = torch.clamp(torch.amin(xf, dim=(1, 2, 3)), max=0.0)
    hi = torch.clamp(torch.amax(xf, dim=(1, 2, 3)), min=0.0)
    return lo, hi


def _cache_rows(new: Tensor, s_leaf, z_leaf, n_lvl,
                rng=None) -> tuple[Tensor, Tensor]:
    """Per-batch quantizer (s, z) of one new K or V token (B, 1, K, hd):
    the frozen calibration leaves broadcast, else the dynamic per-batch
    extremes (``_cache_range``, or ``rng`` when given: a serving mesh's
    range over every rank's heads)."""
    b = new.shape[0]
    if s_leaf is not None:
        return (s_leaf.to(torch.float32).reshape(()).expand(b),
                z_leaf.to(torch.float32).reshape(()).expand(b))
    lo, hi = _cache_range(new) if rng is None else rng
    return quant.affine_scale_zp(lo, hi, n_lvl)


def _mesh_cache_ranges(shards, k_new: Tensor, v_new: Tensor) -> tuple:
    """The K and V tokens' per-batch ranges over every rank's KV heads:
    one all-reduce over "model" for both."""
    (k_lo, k_hi), (v_lo, v_hi) = _cache_range(k_new), _cache_range(v_new)
    lo, hi = shards.reduce_range(torch.stack([k_lo, v_lo]),
                                 torch.stack([k_hi, v_hi]), model=True,
                                 rows=False)
    return (lo[0], hi[0]), (lo[1], hi[1])


def _cache_write(planes: Tensor, s_row: Tensor, z_row: Tensor, new: Tensor,
                 s: Tensor, z: Tensor, n_lvl, row: Tensor):
    """Encode one token and write its packed planes and quantizer row at
    cache row ``row`` (a ring's ``_cache_row``), in place."""
    codes = quant.affine_encode(new.to(torch.float32),
                                s[:, None, None, None],
                                z[:, None, None, None], n_lvl)
    codes = codes[:, 0].to(torch.int32)                     # (B, K, hd)
    tok = KREF.pack_cache_codes(codes).movedim(0, 1)        # (B, P, K, d8)
    idx = row.reshape(1).to(torch.int64)
    planes.index_copy_(2, idx, tok[:, :, None])
    s_row.index_copy_(1, idx, s[:, None].contiguous())
    z_row.index_copy_(1, idx, z[:, None].contiguous())
    return planes, s_row, z_row


def _decode_attend_quant(x: Tensor, cache: QuantKVCache, p: dict,
                         cfg: ModelConfig, q: Tensor, k_new: Tensor,
                         v_new: Tensor, *, window: Optional[int]):
    """Write this token's K/V at the rung's cache bits, then attend through
    the packed planes (``kernels.dispatch.decode_attention``). Cache bits
    come from the rung's ``kv_cache`` device leaves (``k_nlvl``/``v_nlvl``),
    else from the static ``cfg.cache_bits``. A ring attends with no window:
    the kernel reads rows [0, min(pos, rows - 1)]."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache.length
    kc = p.get("kv_cache", {})

    def nlvl(leaf):
        if leaf is not None:
            return leaf.to(torch.float32).reshape(())
        return x.new_full((), float(quant.cap_levels(int(cfg.cache_bits or 8))),
                          dtype=torch.float32)

    k_nlvl = nlvl(kc.get("k_nlvl"))
    v_nlvl = nlvl(kc.get("v_nlvl"))
    k_rng = v_rng = None
    shards = local_ops.current_shards()
    if shards is not None and (kc.get("k_s") is None
                               or kc.get("v_s") is None):
        k_rng, v_rng = _mesh_cache_ranges(shards, k_new, v_new)
    ks, kz = _cache_rows(k_new, kc.get("k_s"), kc.get("k_z"), k_nlvl, k_rng)
    vs, vz = _cache_rows(v_new, kc.get("v_s"), kc.get("v_z"), v_nlvl, v_rng)
    ring = is_ring(cache.k_s.shape[1], window)
    idx = _cache_row(pos, cache.k_s.shape[1], ring)
    _cache_write(cache.k_planes, cache.k_s, cache.k_z, k_new, ks, kz,
                 k_nlvl, idx)
    _cache_write(cache.v_planes, cache.v_s, cache.v_z, v_new, vs, vz,
                 v_nlvl, idx)
    out = KD.decode_attention(q.reshape(b, cfg.num_heads, hd), cache,
                              cfg.kernel_backend or "ref",
                              num_kv_heads=cfg.num_kv_heads,
                              window=None if ring else window,
                              softcap=cfg.attn_softcap,
                              k_nlvl=k_nlvl, v_nlvl=v_nlvl)
    y = L.project(out.to(x.dtype).reshape(b, 1, -1), p["wo"], cfg, "attn.wo")
    return y, cache._replace(length=pos + 1)


def _cross_core(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """(B, T, H, hd) queries over the source's (B, S, KH, hd) K / V, each
    KV head read by its H / KH query heads: the fp32 einsums and the
    softmax over every source token. Returns (B, T, H, hd) fp32."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, t, kh, h // kh, hd) * hd ** -0.5
    scores = torch.einsum("btkgh,bskh->btkgs", qg, k).to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskh->btkgh", probs.to(v.dtype),
                       v).to(torch.float32)
    return out.reshape(b, t, h, hd)


def cross_attend_cached(x: Tensor, enc_kv: tuple[Tensor, Tensor], p: dict,
                        cfg: ModelConfig) -> Tensor:
    """Decode cross-attention against the precomputed source K/V
    (``project_cross_kv``): fp32 einsum and softmax over every source
    token. x: (B, T, d). Under a serving mesh x holds the rank's rows, the
    source K/V its rows and KV heads: q takes the rank's query heads, as
    ``_project_qkv`` does, and ``wo`` is row-parallel."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.project(x, p["wq"], cfg, "attn.wq")
    shards = local_ops.current_shards()
    if shards is not None:      # the rank's query heads of a serving mesh
        q = shards.heads_of(q, shards.num_heads, shards.num_heads * hd)
    q = q.reshape(b, t, cfg.num_heads, hd)
    k, v = enc_kv
    if shards is None or shards.kv_gather:
        out = _cross_core(q, k, v)
    else:       # at one rank's shape: the rank's rows and heads among zeros
        h, kh = shards.num_heads, shards.num_kv_heads
        out = shards.take(_cross_core(shards.place(q, 2, h),
                                      shards.place(k, 2, kh),
                                      shards.place(v, 2, kh)), b, 2, h)
    out = out.to(x.dtype).reshape(b, t, -1)
    return L.project(out, p["wo"], cfg, "attn.wo")
