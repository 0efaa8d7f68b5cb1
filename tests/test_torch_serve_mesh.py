"""The port's ``ServeEngine`` under a device mesh on CPU gloo ranks,
against the one-process port engine and the JAX package's engine.

ONE spawned group of 4 ranks for this file
(``_torch_dist_worker.spawn_group``, a ``FileStore`` under the test's
temporary directory) serves every case on a ("data", "model") mesh of
(2, 2), (1, 4) or (4, 1): reduced llama3-8b widened to 8 heads, 4 KV heads
and d_model 128 (so 4 divides the KV heads), and reduced gemma2-9b at the
same widths (tied head, softcaps, one local and one global layer,
post-norms; its window is 16, so the engines run at max_len 12), 2
layers each; one request a case, its rung cycling from case to case. The stores are the JAX
package's, quantized here and carried across (``convert.py``): gemma2's
with cache bits 4, llama3-8b's with "auto" and a layerwise ladder. Each
mesh serves on
'ref', 'fused' and 'packed' (the plain versions on the CPU).

Held: rank 0's tokens and every step's logits bit-identical to the
one-process port engine on the same store; the one-process tokens equal
to the reference engine's (these seeded requests meet no near-tie of
the fp stages, which run in another order in XLA); each rank's store at most
(1/m + 0.02) of the whole on a "model" axis of m, the whole store on
(4, 1); the slots' shapes those of ``dist.sharding.slot_specs``; and the
engines' refusals.
"""
import dataclasses
import functools
import json
import os
import time
import types

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from repro import configs as rconfigs
from repro.models import model as RMD
from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ParallelConfig
from repro_torch.convert import weight_store_from_reference
from repro_torch.dist import sharding as SH
from repro_torch.models import model as TMD
from repro_torch.models import serving
from repro_torch.serve_engine import EncodeEngine, ServeEngine
from test_torch_common import one_torch_thread  # noqa: F401

WIDE = {"num_heads": 8, "num_kv_heads": 4, "d_model": 128, "num_layers": 2}
LADDER = [2, 4, 6]
ENGINE = {"ladder_bits": LADDER, "max_batch": 4, "max_len": 12}
# one request a case, its rung cycling over the ladder from case to case
REQUESTS = {"seed": 5, "n": 1, "prompt": 3, "gen": 4}
# store name -> (arch, cache_bits, allocation)
STORES = {"llama_auto": ("llama3-8b", "auto", "layerwise"),
          "gemma_c4": ("gemma2-9b", 4, "uniform")}
# (mesh, backend, store): every backend and both stores on each mesh
CASES = [((2, 2), "ref", "llama_auto"), ((2, 2), "fused", "gemma_c4"),
         ((2, 2), "packed", "llama_auto"),
         ((1, 4), "packed", "gemma_c4"), ((1, 4), "ref", "llama_auto"),
         ((1, 4), "fused", "llama_auto"),
         ((4, 1), "fused", "llama_auto"), ((4, 1), "packed", "gemma_c4"),
         ((4, 1), "ref", "gemma_c4")]


def case_name(mesh, backend, store) -> str:
    return f"{store}_{mesh[0]}x{mesh[1]}_{backend}"


NAMES = [case_name(*c) for c in CASES]


def ref_cfg(arch):
    return dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config(arch)), **WIDE)


def port_cfg(arch):
    return dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config(arch)), **WIDE)


def _case(tmp, i, mesh, backend, store) -> dict:
    arch, cache_bits, allocation = STORES[store]
    return {"name": case_name(mesh, backend, store), "arch": arch,
            "cfg": WIDE, "store": os.path.join(tmp, f"{store}.pt"),
            "backend": backend, "cache_bits": cache_bits,
            "allocation": allocation, "mesh": list(mesh),
            "engine": ENGINE, "requests": {**REQUESTS, "first": i % 3}}


def _with_planes(ws):
    """The store with the 'packed' backend's plane leaves of its codes
    (``serving``'s own packer), shared by every view as the codes are."""
    def walk(node, views):
        if isinstance(node, dict):
            if "w_q" in node:
                planes = serving._planes_artifact(
                    node["w_q"], serving.LADDER_PLANE_COUNT)
                for n in [node] + views:
                    n.update(planes)
                return
            for k, v in node.items():
                walk(v, [view[k] for view in views])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, [view[i] for view in views])

    walk(ws.store, list(ws.views.values()))
    return ws


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the rank outputs, the one-process port results by case, the
    reference's tokens by store, the whole stores' bytes by store)."""
    tmp = str(tmp_path_factory.mktemp("serve_mesh"))
    # by store, in the order prepare() writes them
    cases = sorted((_case(tmp, i, *c) for i, c in enumerate(CASES)),
                   key=lambda c: list(STORES).index(c["name"].rsplit(
                       "_", 2)[0]))
    refs = {}

    def prepare():
        # the case list first, then each store as it is built (renamed
        # into place whole): the ranks start on a store as soon as it is
        t0 = time.monotonic()
        with open(os.path.join(tmp, W.SERVE_CASES), "w") as f:
            json.dump(cases, f)
        for name, (arch, cache_bits, allocation) in STORES.items():
            cfg = ref_cfg(arch)
            # jitted: one compile instead of one an eager op
            params = jax.jit(lambda k: RMD.init_params(k, cfg))(
                jax.random.PRNGKey(7))
            reng = RServeEngine(cfg, params, backend="ref",
                                cache_bits=cache_bits, allocation=allocation,
                                **ENGINE)
            tonp = functools.partial(jax.tree_util.tree_map, np.asarray)
            ws = _with_planes(weight_store_from_reference(
                tonp(reng.weight_store),
                {k: tonp(v) for k, v in reng.variants.items()},
                port_cfg(arch), "cpu"))
            path = os.path.join(tmp, f"{name}.pt")
            torch.save(ws, path + ".tmp")
            os.replace(path + ".tmp", path)
            refs[name] = reng
        print(f"[serve_mesh] prepare {time.monotonic() - t0:.1f} s")

    def meanwhile():
        t0 = time.monotonic()
        ones = {c["name"]: W.serve_recorded(W.serve_engine(c), c)
                for c in cases}
        t1 = time.monotonic()
        ref_tokens = {}
        for c in cases:
            reqs = [RRequest(**r) for r in W.serve_requests(**c["requests"])]
            store = c["name"].rsplit("_", 2)[0]
            ref_tokens[c["name"]] = [(r.tokens, r.rung_bits)
                                     for r in refs[store].generate(reqs)]
        print(f"[serve_mesh] one-process {t1 - t0:.1f} s, reference "
              f"{time.monotonic() - t1:.1f} s")
        whole = {}
        for name in STORES:
            ws = torch.load(os.path.join(tmp, f"{name}.pt"),
                            weights_only=False)
            whole[name] = serving.store_bytes(ws.store, *ws.views.values())
        return ones, ref_tokens, whole

    ones, ref_tokens, whole = W.spawn_group(tmp, ("serve_mesh",), prepare,
                                            meanwhile)
    ranks = []
    for r in range(W.WORLD):
        with open(os.path.join(tmp, f"serve_{r}.json")) as f:
            ranks.append(json.load(f))
    logits = {n: np.load(os.path.join(tmp, f"logits_{n}.npy"))
              for n in NAMES}
    return ranks, logits, ones, ref_tokens, whole


@pytest.mark.parametrize("name", NAMES)
def test_rank0_bit_identical_to_one_process(served, name):
    ranks, logits, ones, _, _ = served
    got, one = ranks[0][name], ones[name]
    assert got["tokens"] == one["tokens"]
    assert got["rungs"] == one["rungs"]
    assert logits[name].shape == one["logits"].shape
    assert np.array_equal(logits[name], one["logits"])
    # every rank generated the same tokens
    assert all(r[name]["tokens"] == got["tokens"] for r in ranks)
    assert got["describe"]["mesh"]["shape"] == dict(
        zip(("data", "model"), [int(x) for x in name.split("_")[-2]
                                .split("x")]))
    assert not got["describe"]["graphed"]


@pytest.mark.parametrize("store", list(STORES))
def test_tokens_match_reference(served, store):
    """The one-process port engine's tokens, and so every mesh's, equal
    the reference engine's on the store carried across."""
    _, _, ones, ref_tokens, _ = served
    for name in NAMES:
        if name.startswith(store + "_"):
            got = ones[name]
            assert [(t, b) for t, b in zip(got["tokens"], got["rungs"])] \
                == ref_tokens[name], name


@pytest.mark.parametrize("name", NAMES)
def test_store_bytes_per_rank(served, name):
    ranks, _, _, _, whole = served
    store = name.split("_")[0] + "_" + name.split("_")[1]
    m = int(name.split("_")[-2].split("x")[1])
    shares = [r[name]["store_bytes"] / whole[store] for r in ranks]
    if m == 1:
        assert shares == [1.0] * W.WORLD
    else:
        assert max(shares) <= 1 / m + 0.02, shares


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.startswith("gemma_c4")])
def test_slots_follow_slot_specs(served, name):
    """Rank 0's slot tensors have the local shapes ``slot_specs`` gives
    the whole batch's state: batch over "data", KV heads over "model"."""
    ranks, _, _, _, _ = served
    d, m = (int(x) for x in name.split("_")[-2].split("x"))
    arch, cache_bits, _ = STORES[name.split("_")[0] + "_"
                                 + name.split("_")[1]]
    cfg = port_cfg(arch)
    if cache_bits is not None:
        cfg = dataclasses.replace(cfg, cache_bits=cache_bits)
    params = TMD.init_params(cfg, 0, "meta")
    state = TMD.init_decode_state(params, cfg, ENGINE["max_batch"],
                                  ENGINE["max_len"])
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": m})
    specs = SH.slot_specs(state.caches, mesh)
    want = []
    for leaf, spec in zip(W._state_leaves(state.caches),
                          W._state_leaves(_as_tensors(specs))):
        shape = list(leaf.shape)
        for i, entry in enumerate(spec.entries):
            if entry is not None:
                shape[i] //= {"data": d, "model": m}[entry]
        want.append(shape)
    assert ranks[0][name]["slot_shapes"] == want


def _as_tensors(specs):
    """A spec tree's leaves wrapped as 0-dim tensors carrying the spec,
    so ``_state_leaves`` walks it in the state's order."""
    if isinstance(specs, SH.PartitionSpec):
        t = torch.empty(())
        t.entries = specs.entries
        return t
    if hasattr(specs, "_fields"):
        return type(specs)(*(_as_tensors(getattr(specs, f))
                             for f in specs._fields))
    if isinstance(specs, (list, tuple)):
        return type(specs)(_as_tensors(s) for s in specs)
    return specs


def _stand_in(d: int, m: int):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(d, m))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_mesh_refuses_other_families(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    with pytest.raises(ValueError, match="A10"):
        ServeEngine(cfg, params={}, device="cpu", mesh=_stand_in(1, 2))


def test_mesh_refuses_uneven_kv_heads_fsdp_and_batch():
    cfg = port_cfg("llama3-8b")
    with pytest.raises(ValueError, match="KV heads.*A10"):
        ServeEngine(cfg, params={}, device="cpu", mesh=_stand_in(1, 8))
    with pytest.raises(ValueError, match="fsdp.*A10"):
        ServeEngine(cfg, params={}, device="cpu", mesh=_stand_in(2, 2),
                    par=ParallelConfig(fsdp=True))
    with pytest.raises(ValueError, match="max_batch.*A10"):
        ServeEngine(cfg, params={}, device="cpu", max_batch=3,
                    mesh=_stand_in(2, 2))
    with pytest.raises(ValueError, match="A10"):
        EncodeEngine(tconfigs.reduced(tconfigs.get_config(
            "seamless-m4t-medium")), params={}, device="cpu",
            mesh=_stand_in(1, 2))
