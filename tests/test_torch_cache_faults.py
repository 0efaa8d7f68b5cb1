"""The port's repairs of two faults against the reference (ROADMAP C1, C2),
on reduced llama3-8b, side by side with the JAX package on the CPU.

C1: ``kv_cache_dtype="float8_e4m3fn"`` with the fp cache (``cache_bits``
None). Both sides allocate K/V in float8 and cast each new row into it
(round to nearest even on both) and back to the compute dtype to attend.
Tolerance: teacher-forced decode logits agree within
``test_torch_slice``'s bound, 1e-5 * max|logit| per step, for the same
reasons (RMSNorm, RoPE, silu and softmax ulps between XLA-CPU and
torch-CPU; here such an ulp can also move a K/V value across a float8
rounding tie). The worst measured gap is printed by the test.

C2: a windowed layer's cache holds ``min(max_len, window)`` rows, the
size the reference allocates, in both cache kinds and at any
``max_len``, and is a ring (``models.attention.is_ring``); an unwindowed
layer's holds ``max_len``. The reference's dropped writes past the window
are not copied: ``tests/test_torch_long_context.py`` holds the ring
against the reference's decode over full-length caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RMD
from repro_torch.models import attention as A
from repro_torch.models import model as TMD
from repro_torch.models import transformer as T
from test_torch_common import port_cfg, ref_cfg
from test_torch_slice import REL_BOUND, STEPS, _views

FP8 = "float8_e4m3fn"


def _ref_run(bits, rows, kv_dtype):
    rc = dataclasses.replace(ref_cfg(), kernel_backend="ref",
                             cache_bits=None, kv_cache_dtype=kv_dtype)
    rv, _ = _views(bits, None)
    step = jax.jit(lambda p, s, t: RMD.decode_step(p, rc, s, t))
    st = RMD.init_decode_state(rv, rc, rows.shape[0], rows.shape[1])
    cache_dtypes = {str(a.dtype) for a in jax.tree_util.tree_leaves(st)
                    if a.ndim >= 4}
    out = []
    for t in range(rows.shape[1]):
        lg, st = step(rv, st, jnp.asarray(rows[:, t:t + 1]))
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out), cache_dtypes


def _port_run(bits, rows, kv_dtype, backend):
    tc = dataclasses.replace(port_cfg(), kernel_backend=backend,
                             cache_bits=None, kv_cache_dtype=kv_dtype)
    _, tv = _views(bits, None)
    st = TMD.init_decode_state(tv, tc, rows.shape[0], rows.shape[1])
    cache_dtypes = {str(t.dtype).removeprefix("torch.")
                    for c in st.caches for t in (c.k, c.v)}
    out = []
    for t in range(rows.shape[1]):
        lg, st = TMD.decode_step(tv, tc, st,
                                 torch.from_numpy(rows[:, t:t + 1]).long())
        out.append(lg[:, 0].numpy())
    return np.stack(out), cache_dtypes


@pytest.mark.parametrize("bits", [2, 6])
def test_float8_kv_cache_matches_reference(bits):
    rows = np.random.default_rng(50 + bits).integers(
        0, 512, (2, STEPS)).astype(np.int32)
    want, ref_dtypes = _ref_run(bits, rows, FP8)
    assert ref_dtypes == {FP8}
    got = {}
    for backend in ("ref", "fused", "packed"):
        got[backend], port_dtypes = _port_run(bits, rows, FP8, backend)
        assert port_dtypes == {FP8}
    assert np.array_equal(got["ref"], got["fused"])
    assert np.array_equal(got["ref"], got["packed"])
    scale = np.max(np.abs(want), axis=-1, keepdims=True)
    gap = np.abs(got["packed"] - want)
    assert np.all(gap <= REL_BOUND * scale), np.max(gap / scale)
    print(f"rung {bits}, float8 cache: worst |logit gap| / max|logit| = "
          f"{np.max(gap / scale):.3g}")
    # the field is honoured: the float8 cache moves the logits away from
    # the compute-dtype cache's
    full, full_dtypes = _port_run(bits, rows, "", "packed")
    assert full_dtypes == {"float32"}
    assert not np.array_equal(full, got["packed"])


def _rows(cache) -> int:
    return (cache.k_s if isinstance(cache, A.QuantKVCache)
            else cache.k).shape[1]


@pytest.mark.parametrize("cache_bits", [None, 4])
def test_windowed_cache_is_a_ring_of_window_rows(cache_bits):
    """A window of 16 at max_len 17: a ring of 16 rows (the fp cache, its
    float8 kind and the packed planes); within the window every position
    has its row, and an unwindowed layer holds max_len rows."""
    kinds = ([dict(kv_cache_dtype=""), dict(kv_cache_dtype=FP8)]
             if cache_bits is None else [dict()])
    for kind in kinds:
        cfg = dataclasses.replace(port_cfg(), cache_bits=cache_bits, **kind)
        spec = T.LayerSpec("attn", 16)
        ring = T.init_layer_cache(cfg, spec, 2, 17, torch.float32, "cpu")
        assert _rows(ring) == 16 and A.is_ring(_rows(ring), spec.window)
        assert _rows(T.init_layer_cache(cfg, spec, 2, 12, torch.float32,
                                        "cpu")) == 12
        whole = T.init_layer_cache(cfg, T.LayerSpec("attn"), 2, 40,
                                   torch.float32, "cpu")
        assert _rows(whole) == 40 and not A.is_ring(40, None)
        if kind.get("kv_cache_dtype") == FP8:
            assert ring.k.dtype == getattr(torch, FP8)


@pytest.mark.parametrize("cache_bits", [None, 4])
def test_windowed_decode_state_holds_window_rows(cache_bits):
    """Through a windowed config's decode state, both cache kinds: a window
    of 8 at max_len 17 and 12 gives rings of 8 rows, at max_len 8 the 8
    rows it always had."""
    cfg = port_cfg()
    _, tv = _views(2, None)
    swa = dataclasses.replace(cfg, sliding_window=8, cache_bits=cache_bits)
    for max_len in (17, 12, 8):
        state = TMD.init_decode_state(tv, swa, 2, max_len)
        assert [_rows(c) for c in state.caches] == [8] * cfg.num_layers
