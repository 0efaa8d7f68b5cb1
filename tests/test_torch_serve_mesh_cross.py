"""The port's ``ServeEngine`` and ``EncodeEngine`` serving the
cross-attending families under a device mesh on CPU gloo ranks, against
the one-process port engines and the JAX package's engines.

ONE spawned group of 4 ranks for this file
(``_torch_dist_worker.spawn_group``) serves every case on a ("data",
"model") mesh of (2, 2), (1, 4) or (4, 1): reduced seamless-m4t-medium
(a two-conv speech stem, a 2-layer bidirectional encoder, 2 decoder
layers that cross-attend; 4 heads and 4 KV heads) and reduced
llama-3.2-vision-90b widened to 8 heads and 4 KV heads (reduced it has 1)
and cut to 5 layers (one group: its cross_attn layer and 4 self-attention
layers; a shorter cut would put the cross layer in the tail, which decode
runs without cross K/V, ROADMAP C12), on 'ref', 'fused' and 'packed'.
The params are the reference's with the biases, norm scales and every
``xgate`` seeded nonzero (``test_torch_encoder._perturb``: tanh(0) = 0
would make every cross-attention check pass without cross-attending).
Each engine takes a new raw frontend input a wave. The decode stores are
the JAX package's serve engines', carried across (seamless's with cache
bits 4, vision's with "auto" and a layerwise ladder); the encode stores
its encode engines'.

On a serving mesh each rank runs the conv stem (whole on every rank) on
its rows of the wave's input, its quantizer's range reduced over "data",
the encoder at its heads, and projects each cross_attn layer's source
K / V at its KV heads into the slot. Held: rank 0's tokens and every
step's logits equal the one-process engine's bit for bit on every mesh;
the one-process tokens equal the reference engine's; each rank's store
share; the slots' shapes (caches and cross K/V) against ``slot_specs``;
every rank's encoded items equal the one-process ``EncodeEngine``'s bit
for bit, whose items are held to the reference's (vision's stem bit for
bit, seamless's encoder within 1e-5 * max|out|, as in
``test_torch_encode_engine``).
"""
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
import test_torch_serve_mesh as SM
from repro.serve_engine import EncodeEngine as REncodeEngine
from repro.serve_engine import EncodeRequest as REncodeRequest
from repro_torch.convert import weight_store_from_reference
from repro_torch.dist import sharding as SH
from repro_torch.models import model as TMD
from repro_torch.models import serving
from repro_torch.serve_engine import EncodeEngine, ServeEngine
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_common import tonp
from test_torch_encoder import REL_BOUND, _perturb

VISION = {"num_heads": 8, "num_kv_heads": 4, "num_layers": 5}
STORES = {"seamless_c4": ("seamless-m4t-medium", 4, "uniform", {}),
          "vision_auto": ("llama-3.2-vision-90b", "auto", "layerwise",
                          VISION)}
CASES = [((2, 2), "ref", "seamless_c4"), ((2, 2), "fused", "vision_auto"),
         ((2, 2), "packed", "seamless_c4"),
         ((1, 4), "packed", "vision_auto"), ((1, 4), "ref", "seamless_c4"),
         ((1, 4), "fused", "seamless_c4"),
         ((4, 1), "fused", "vision_auto"), ((4, 1), "packed", "seamless_c4"),
         ((4, 1), "ref", "vision_auto")]
NAMES = [SM.case_name(*c) for c in CASES]
ENCODE_ENGINE = {"ladder_bits": SM.LADDER, "max_batch": 4}
# five items: a full wave of 4 and a short one, padded
ENCODE_ITEMS = {"seed": 3, "n": 5}


@functools.lru_cache(maxsize=None)
def perturbed_params(arch, cfg):
    """The reference's params of ``cfg`` with the zero / one leaves seeded
    nonzero (the same tree for the decode and the encode engines)."""
    params = jax.jit(lambda k: SM.RMD.init_params(k, cfg))(
        jax.random.PRNGKey(7))
    return jax.tree_util.tree_map(jnp.asarray, _perturb(
        tonp(params), np.random.default_rng(17)))


def encode_cases(tmp):
    """An encode case beside each decode case: its mesh, backend and
    config, on the config's encode store."""
    out = []
    for mesh, backend, store in CASES:
        arch, _, _, wide = STORES[store]
        out.append({"name": SM.case_name(mesh, backend, store), "arch": arch,
                    "cfg": wide, "store": os.path.join(tmp,
                                                       f"{store}_enc.pt"),
                    "backend": backend, "mesh": list(mesh),
                    "engine": ENCODE_ENGINE, "items": ENCODE_ITEMS})
    return out


class Encode:
    """The encode side of the group: the reference's encode engines'
    stores written for the ranks (after the decode stores), then, while
    the ranks work, the one-process port engines' items and the
    reference's on the same items."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.cases = encode_cases(tmp)
        self.refs = {}

    def prepare(self):
        with open(os.path.join(self.tmp, W.ENCODE_CASES), "w") as f:
            json.dump(self.cases, f)
        for name, (arch, _, _, wide) in STORES.items():
            cfg = SM.ref_cfg(arch, wide)
            reng = REncodeEngine(cfg, perturbed_params(arch, cfg),
                                 backend="ref", **ENCODE_ENGINE)
            ws = SM._with_planes(weight_store_from_reference(
                tonp(reng.weight_store),
                {k: tonp(v) for k, v in reng.variants.items()},
                SM.port_cfg(arch, wide), "cpu"))
            path = os.path.join(self.tmp, f"{name}_enc.pt")
            torch.save(ws, path + ".tmp")
            os.replace(path + ".tmp", path)
            self.refs[name] = reng

    def meanwhile(self):
        ones = {c["name"]: W.encode_served(W.encode_engine(c), c)
                for c in self.cases}
        refs = {}
        for name, reng in self.refs.items():
            cfg = SM.port_cfg(*STORES[name][::3])
            out = reng.encode([REncodeRequest(**r) for r in
                               W.encode_requests(cfg, **ENCODE_ITEMS)])
            refs[name] = (np.stack([r.encoded for r in out]),
                          [r.rung_bits for r in out])
        return ones, refs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the rank outputs, rank 0's logits, the one-process port results by
    case, the reference's tokens by case, the whole stores' bytes, the
    encode side: each rank's items and outputs, the one-process items,
    the reference's items)."""
    tmp = str(tmp_path_factory.mktemp("serve_mesh_cross"))
    extra = Encode(tmp)
    out = SM.serve_group(tmp, STORES, CASES,
                         worker=("serve_mesh", "encode_mesh"),
                         params_fn=perturbed_params, extra=extra,
                         op_by_op=("seamless_c4",))
    ones, refs = out["extra"]
    encoded = [dict(np.load(os.path.join(tmp, f"encoded_{r}.npz")))
               for r in range(W.WORLD)]
    enc_ranks = []
    for r in range(W.WORLD):
        with open(os.path.join(tmp, f"encode_{r}.json")) as f:
            enc_ranks.append(json.load(f))
    stem = {}       # the conv stem's share of each decode store's bytes
    for name in STORES:
        ws = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
        stem[name] = serving.store_bytes(
            ws.store["conv_stem"],
            *(v["conv_stem"] for v in ws.views.values())) / \
            out["whole"][name]
    return (out["ranks"], out["logits"], out["ones"], out["ref_tokens"],
            out["whole"], {"encoded": encoded, "ranks": enc_ranks,
                           "ones": ones, "refs": refs, "stem": stem})


@pytest.mark.parametrize("name", NAMES)
def test_rank0_bit_identical_to_one_process(served, name):
    SM.check_rank0_bit_identical(served, name)


@pytest.mark.parametrize("store", list(STORES))
def test_tokens_match_reference(served, store):
    SM.check_tokens_match_reference(
        served, [n for n in NAMES if SM.store_of(n) == store])


@pytest.mark.parametrize("name", NAMES)
def test_store_bytes_per_rank(served, name):
    """Each rank's share of the store: 1/m of every split leaf and the
    whole of the rest (the norms, the scalars, the conv stem); of the
    store outside the stem, which every rank holds whole by design (12 %
    of reduced seamless's store, under 1 % at full width), at most
    1/m + 0.02."""
    rep = SM.check_store_bytes_per_rank(served, name)
    if rep is not None:
        m = SM.mesh_of(name)[1]
        stem = served[5]["stem"][SM.store_of(name)]
        share = (1 - rep) / m + rep
        assert (share - stem) / (1 - stem) <= 1 / m + 0.02, (rep, stem)


def _stand_in(d: int, m: int):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": m})


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if SM.mesh_of(n) != (4, 1)])
def test_slots_follow_slot_specs(served, name):
    """Rank 0's slot tensors have the local shapes ``slot_specs`` gives
    the whole batch's decode state: batch over "data", the KV caches' and
    the cross K/V's KV heads over "model"."""
    d, m = SM.mesh_of(name)
    arch, cache_bits, _, wide = STORES[SM.store_of(name)]
    cfg = SM.port_cfg(arch, wide)
    cfg = dataclasses.replace(
        cfg, cache_bits=7 if cache_bits == "auto" else cache_bits)
    params = TMD.init_params(cfg, 0, "meta")
    h, w = cfg.frontend_hw
    raw = torch.empty((SM.ENGINE["max_batch"], h, w, cfg.conv_stem[0].c_in),
                      device="meta")
    key = "enc_inputs" if cfg.family == "encdec" else "image_embeds"
    state = TMD.init_decode_state(params, cfg, SM.ENGINE["max_batch"],
                                  SM.ENGINE["max_len"], **{key: raw})
    specs = SH.slot_specs(state, _stand_in(d, m))
    sizes = {"data": d, "model": m}

    def local(tree, spec_tree):
        out = []
        for leaf, spec in zip(W._state_leaves(tree),
                              W._state_leaves(SM._as_tensors(spec_tree))):
            shape = list(leaf.shape)
            for i, entry in enumerate(spec.entries):
                if entry is not None:
                    shape[i] //= sizes[entry]
            out.append(shape)
        return out

    got = served[0][0][name]
    assert got["slot_shapes"] == local(state.caches, specs.caches)
    assert got["cross_shapes"] == local(state.cross_kv, specs.cross_kv)
    n_cross = sum(pair is not None for pair in state.cross_kv)
    assert n_cross and len(got["cross_shapes"]) == 2 * n_cross
    # the KV heads of the cross K/V over "model", the rows over "data"
    b, s, kh, hd = got["cross_shapes"][0]
    assert (b, kh) == (SM.ENGINE["max_batch"] // d, cfg.num_kv_heads // m)


@pytest.mark.parametrize("name", NAMES)
def test_encode_engine_bit_identical_to_one_process(served, name):
    """Every rank's encoded items (the rows of each wave gathered over
    "data") and rungs equal the one-process ``EncodeEngine``'s bit for
    bit on the same store; each rank holds its share of the encode
    store."""
    enc = served[5]
    one = enc["ones"][name]
    for r in range(W.WORLD):
        got = enc["encoded"][r][name]
        assert got.shape == one["encoded"].shape
        assert np.array_equal(got, one["encoded"]), r
        assert enc["ranks"][r][name]["rungs"] == one["rungs"]
    # the store's bytes on one rank: a (4, 1) case of the same store
    whole = next(enc["ranks"][0][n]["store_bytes"] for n in NAMES
                 if SM.store_of(n) == SM.store_of(name)
                 and SM.mesh_of(n) == (4, 1))
    nbytes = {enc["ranks"][r][name]["store_bytes"] for r in range(W.WORLD)}
    if SM.mesh_of(name)[1] == 1:
        assert nbytes == {whole}
    else:
        assert len(nbytes) == 1 and nbytes.pop() < whole


@pytest.mark.parametrize("store", list(STORES))
def test_encode_one_process_matches_reference(served, store):
    """The one-process port ``EncodeEngine``'s items and rungs against
    the reference's on the store carried across: vision's stem bit for
    bit, seamless's encoder within 1e-5 * max|out| (layernorm, RoPE and
    the bidirectional attention run in another order in XLA)."""
    enc = served[5]
    want, rungs = enc["refs"][store]
    for name in NAMES:
        if SM.store_of(name) != store:
            continue
        got = enc["ones"][name]
        assert got["rungs"] == rungs
        assert got["encoded"].shape == want.shape
        if store.startswith("vision"):
            assert np.array_equal(got["encoded"], want)
        else:
            np.testing.assert_allclose(got["encoded"], want, rtol=0,
                                       atol=REL_BOUND * np.abs(want).max())


def test_slot_specs_of_cross_kv():
    """``slot_specs`` of a whole decode state puts a cross K/V leaf's KV
    heads (dim 2 of (B, S, KH, hd)) on "model" and its batch on "data";
    the self-attention caches as before, the position replicated."""
    kv = torch.empty((4, 6, 8, 16), device="meta")
    cache = torch.empty((4, 12, 8, 16), device="meta")
    state = TMD.DecodeState(
        caches=[TMD.A.KVCache(k=cache, v=cache,
                                 length=torch.empty((), device="meta"))],
        cross_kv=[(kv, kv), None], position=torch.empty((), device="meta"))
    specs = SH.slot_specs(state, _stand_in(2, 4))
    assert specs.cross_kv[0] == (SH.P("data", None, "model", None),) * 2
    assert specs.cross_kv[1] is None
    assert specs.caches[0].k == SH.P("data", None, "model", None)
    assert specs.position == SH.P()
    # a "model" axis that does not divide the KV heads leaves them whole
    specs = SH.slot_specs(state, _stand_in(1, 16))
    assert specs.cross_kv[0][0] == SH.P(None, None, None, None)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_engines_refuse_uneven_splits(arch):
    """Both engines refuse a "model" axis that does not divide the
    cross-attending config's KV heads, FSDP and a batch the "data" axis
    does not divide, naming A10; nothing runs on one rank instead."""
    cfg = SM.port_cfg(arch, STORES["vision_auto"][3]
                      if arch.startswith("llama") else {})
    kw = dict(params={}, device="cpu")

    def mesh(d, m):
        return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=(d, m))

    for engine in (ServeEngine, EncodeEngine):
        extra = ({"frontend_kwargs_fn": lambda batch: {}}
                 if engine is ServeEngine else {})
        with pytest.raises(ValueError, match="KV heads.*A10"):
            engine(cfg, mesh=mesh(1, 8), **kw, **extra)
        with pytest.raises(ValueError, match="fsdp.*A10"):
            engine(cfg, mesh=mesh(2, 2), par=SM.ParallelConfig(fsdp=True),
                   **kw, **extra)
        with pytest.raises(ValueError, match="max_batch.*A10"):
            engine(cfg, mesh=mesh(2, 2), max_batch=3, **kw, **extra)
