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
import concurrent.futures
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
from repro_torch.serve_engine.engine import serve_shards
from test_torch_common import one_torch_thread  # noqa: F401

WIDE = {"num_heads": 8, "num_kv_heads": 4, "d_model": 128, "num_layers": 2}
LADDER = [2, 4, 6]
ENGINE = {"ladder_bits": LADDER, "max_batch": 4, "max_len": 12}
SLOTS = 2           # the port engine's default decode-state slots
# one request a case, its rung cycling over the ladder from case to case
REQUESTS = {"seed": 5, "n": 1, "prompt": 3, "gen": 4}
# store name -> (arch, cache_bits, allocation, config widths)
STORES = {"llama_auto": ("llama3-8b", "auto", "layerwise", WIDE),
          "gemma_c4": ("gemma2-9b", 4, "uniform", WIDE)}
# (mesh, backend, store): every backend and both stores on each mesh
CASES = [((2, 2), "ref", "llama_auto"), ((2, 2), "fused", "gemma_c4"),
         ((2, 2), "packed", "llama_auto"),
         ((1, 4), "packed", "gemma_c4"), ((1, 4), "ref", "llama_auto"),
         ((1, 4), "fused", "llama_auto"),
         ((4, 1), "fused", "llama_auto"), ((4, 1), "packed", "gemma_c4"),
         ((4, 1), "ref", "gemma_c4")]


def case_name(mesh, backend, store) -> str:
    return f"{store}_{mesh[0]}x{mesh[1]}_{backend}"


def store_of(name: str) -> str:
    return name.rsplit("_", 2)[0]


def mesh_of(name: str) -> tuple:
    return tuple(int(x) for x in name.rsplit("_", 2)[1].split("x"))


NAMES = [case_name(*c) for c in CASES]


def ref_cfg(arch, wide=WIDE):
    return dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config(arch)), **wide)


def port_cfg(arch, wide=WIDE):
    return dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config(arch)), **wide)


def _case(tmp, i, mesh, backend, store, stores, engine) -> dict:
    arch, cache_bits, allocation, wide = stores[store]
    return {"name": case_name(mesh, backend, store), "arch": arch,
            "cfg": wide, "store": os.path.join(tmp, f"{store}.pt"),
            "backend": backend, "cache_bits": cache_bits,
            "allocation": allocation, "mesh": list(mesh),
            "engine": engine, "requests": {**REQUESTS, "first": i % 3}}


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


def init_params(arch, cfg):
    """The reference's params of ``cfg`` (jitted: one compile instead of
    one an eager op)."""
    return jax.jit(lambda k: RMD.init_params(k, cfg))(jax.random.PRNGKey(7))


def _op_by_op(fn):
    """``fn`` under ``jax.disable_jit()``: the reference engine's wave
    start (the conv stem, the encoder, the cross K/V projections) op by
    op. Its encoder layers run in a ``lax.scan`` whose body XLA compiles
    and fuses, in another order of the fp ops than one op at a time; on
    reduced seamless at rung 2 that flips an activation code at a
    rounding tie (the cross K/V then 7-9 % of max|K/V| away), where the
    op-by-op reference and the port agree bit for bit. It costs a compile
    of each primitive (about 17 s there), so a store takes it only where
    it is asked for."""
    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def serve_group(tmp: str, stores: dict, case_list: list,
                engine: dict = ENGINE,
                worker: tuple = ("serve_mesh",), params_fn=init_params,
                extra=None, op_by_op: tuple = ()) -> dict:
    """Serve ``case_list`` ((mesh, backend, store) triples) on ONE spawned
    group of 4 gloo ranks (the worker's cases ``worker``), the JAX
    package's stores of ``stores`` carried across, beside the
    one-process port engine and the reference engine in this process.
    ``params_fn(arch, cfg)`` gives each store's reference params; a
    cross-attending config's engines take a new raw frontend a wave
    (``_torch_dist_worker.frontend_fn``, drawn afresh for each case: the
    port's engine draws one for each of its SLOTS slots at init, the
    reference's none, so the reference's starts SLOTS steps on), the
    reference's op by op (``_op_by_op``) for the stores named in
    ``op_by_op``. Each store's reference (its engine, then its tokens)
    runs in a thread of its own: JAX compiles outside the GIL, and
    ``jax.disable_jit`` holds for its own thread alone.
    ``extra`` (an object with
    ``prepare()`` and ``meanwhile()``) runs after the stores are written
    and while the ranks work. Returns {"ranks": each rank's outputs,
    "logits": rank 0's by case, "ones": the one-process results by case,
    "ref_tokens": the reference's by case, "whole": each store's bytes
    and replicated shares, "extra": ``extra.meanwhile()``'s result}."""
    # by store, in the order prepare() writes them
    cases = sorted((_case(tmp, i, *c, stores, engine)
                    for i, c in enumerate(case_list)),
                   key=lambda c: list(stores).index(store_of(c["name"])))
    names = [c["name"] for c in cases]
    pool = concurrent.futures.ThreadPoolExecutor(len(stores))
    built = {}

    def build(name):
        """The store's reference engine, its store written for the ranks
        (renamed into place whole: the ranks start on a store as soon as
        it is)."""
        arch, cache_bits, allocation, wide = stores[name]
        cfg = ref_cfg(arch, wide)
        reng = RServeEngine(
            cfg, params_fn(arch, cfg), backend="ref",
            cache_bits=cache_bits, allocation=allocation,
            frontend_kwargs_fn=W.frontend_fn(port_cfg(arch, wide)),
            **engine)
        if name in op_by_op:
            reng._init_state = _op_by_op(reng._init_state)
        tonp = functools.partial(jax.tree_util.tree_map, np.asarray)
        ws = _with_planes(weight_store_from_reference(
            tonp(reng.weight_store),
            {k: tonp(v) for k, v in reng.variants.items()},
            port_cfg(arch, wide), "cpu"))
        path = os.path.join(tmp, f"{name}.pt")
        torch.save(ws, path + ".tmp")
        os.replace(path + ".tmp", path)
        return reng

    def reference(name):
        """The reference's tokens of each case of the store (once for
        each distinct request set)."""
        reng, by_requests = built[name].result(), {}
        for c in cases:
            key = json.dumps(c["requests"])
            if store_of(c["name"]) != name or key in by_requests:
                continue
            reqs = [RRequest(**r) for r in W.serve_requests(**c["requests"])]
            if reng._frontend_kwargs_fn is not None:   # as the port's
                reng._frontend_kwargs_fn = W.frontend_fn(W.case_cfg(c),
                                                         first=SLOTS)
            by_requests[key] = [(r.tokens, r.rung_bits)
                                for r in reng.generate(reqs)]
        return by_requests

    def prepare():
        t0 = time.monotonic()
        with open(os.path.join(tmp, W.SERVE_CASES), "w") as f:
            json.dump(cases, f)
        built.update({name: pool.submit(build, name) for name in stores})
        for f in built.values():
            f.result()
        if extra is not None:
            extra.prepare()
        print(f"[serve_mesh] prepare {time.monotonic() - t0:.1f} s")

    def meanwhile():
        t0 = time.monotonic()
        tokens = {name: pool.submit(reference, name) for name in stores}
        ones = {c["name"]: W.serve_recorded(W.serve_engine(c), c)
                for c in cases}
        whole = {}
        for name in stores:
            ws = torch.load(os.path.join(tmp, f"{name}.pt"),
                            weights_only=False)
            whole[name] = serving.store_bytes(ws.store, *ws.views.values())
            for m in (2, 4):
                whole[name, m] = replicated_share(ws, m)
        more = None if extra is None else extra.meanwhile()
        t1 = time.monotonic()
        ref_tokens = {c["name"]: tokens[store_of(c["name"])].result()[
            json.dumps(c["requests"])] for c in cases}
        print(f"[serve_mesh] one-process {t1 - t0:.1f} s, reference "
              f"{time.monotonic() - t1:.1f} s after it")
        return ones, ref_tokens, whole, more

    try:
        ones, ref_tokens, whole, more = W.spawn_group(tmp, worker, prepare,
                                                      meanwhile)
    finally:
        pool.shutdown(cancel_futures=True)
    ranks = []
    for r in range(W.WORLD):
        with open(os.path.join(tmp, f"serve_{r}.json")) as f:
            ranks.append(json.load(f))
    logits = {n: np.load(os.path.join(tmp, f"logits_{n}.npy"))
              for n in names}
    return {"ranks": ranks, "logits": logits, "ones": ones,
            "ref_tokens": ref_tokens, "whole": whole, "extra": more}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the rank outputs, rank 0's logits, the one-process port results by
    case, the reference's tokens by case, the whole stores' bytes)."""
    out = serve_group(str(tmp_path_factory.mktemp("serve_mesh")), STORES,
                      CASES)
    return (out["ranks"], out["logits"], out["ones"], out["ref_tokens"],
            out["whole"])


def check_rank0_bit_identical(served, name):
    """Rank 0's tokens, rungs and every step's logits equal the
    one-process engine's bit for bit; every rank's tokens are rank 0's;
    the steps ran eagerly on the case's mesh."""
    ranks, logits, ones = served[:3]
    got, one = ranks[0][name], ones[name]
    assert got["tokens"] == one["tokens"]
    assert got["rungs"] == one["rungs"]
    assert logits[name].shape == one["logits"].shape
    assert np.array_equal(logits[name], one["logits"])
    assert all(r[name]["tokens"] == got["tokens"] for r in ranks)
    assert got["describe"]["mesh"]["shape"] == dict(
        zip(("data", "model"), mesh_of(name)))
    assert not got["describe"]["graphed"]


def check_tokens_match_reference(served, names):
    """The one-process port engine's tokens equal the reference engine's
    on the store carried across."""
    ones, ref_tokens = served[2], served[3]
    for name in names:
        got = ones[name]
        assert [(t, b) for t, b in zip(got["tokens"], got["rungs"])] \
            == ref_tokens[name], name


def replicated_share(ws, m: int) -> float:
    """The share of a whole store's bytes (``serving.store_bytes``' count:
    each storage once) in the leaves ``serving_shardings`` keeps whole on a
    "model" axis of ``m``: the norms, the scalars and per-rung leaves, a
    MoE router, the recurrent blocks' per-channel and per-head vectors."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": m})
    seen = {}

    def walk(node, sharding):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, sharding[k])
        elif isinstance(node, (list, tuple)):
            for v, sh in zip(node, sharding):
                walk(v, sh)
        elif isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            seen[st.data_ptr()] = (st.nbytes(), all(
                e is None for e in sharding.spec.entries))

    for tree in (ws.store, *ws.views.values()):
        walk(tree, serving.serving_shardings(tree, mesh))
    total = sum(n for n, _ in seen.values())
    return sum(n for n, rep in seen.values() if rep) / total


def check_store_bytes_per_rank(served, name):
    """Each rank holds its 1/m of every split leaf and the whole of the
    rest on a "model" axis of m, and at most (1/m + 0.02) of the whole
    store on the dense configs' widths; the whole store without one."""
    ranks, whole = served[0], served[4]
    m = mesh_of(name)[1]
    store = store_of(name)
    shares = [r[name]["store_bytes"] / whole[store] for r in ranks]
    if m == 1:
        assert shares == [1.0] * W.WORLD
        return
    rep = whole[store, m]
    assert shares == pytest.approx([(1 - rep) / m + rep] * W.WORLD,
                                   rel=1e-9), (shares, rep)
    return rep


def check_slots_follow_slot_specs(served, name, stores):
    """Rank 0's slot tensors have the local shapes ``slot_specs`` gives
    the whole batch's state: batch over "data", the KV caches' and the
    recurrent states' heads over "model"."""
    ranks = served[0]
    d, m = mesh_of(name)
    arch, cache_bits, _, wide = stores[store_of(name)]
    cfg = port_cfg(arch, wide)
    if cache_bits is not None:
        cfg = dataclasses.replace(
            cfg, cache_bits=7 if cache_bits == "auto" else cache_bits)
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


@pytest.mark.parametrize("name", NAMES)
def test_rank0_bit_identical_to_one_process(served, name):
    check_rank0_bit_identical(served, name)


@pytest.mark.parametrize("store", list(STORES))
def test_tokens_match_reference(served, store):
    """The one-process port engine's tokens, and so every mesh's, equal
    the reference engine's on the store carried across."""
    check_tokens_match_reference(
        served, [n for n in NAMES if store_of(n) == store])


@pytest.mark.parametrize("name", NAMES)
def test_store_bytes_per_rank(served, name):
    rep = check_store_bytes_per_rank(served, name)
    if rep is not None:
        assert (1 - rep) / mesh_of(name)[1] + rep <= \
            1 / mesh_of(name)[1] + 0.02


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.startswith("gemma_c4")])
def test_slots_follow_slot_specs(served, name):
    """Rank 0's slot tensors have the local shapes ``slot_specs`` gives
    the whole batch's state: batch over "data", KV heads over "model"."""
    check_slots_follow_slot_specs(served, name, STORES)


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


class _Coordinated:
    """A stand-in (2, 2) mesh at rank 0's coordinate, with no process
    group behind it."""
    mesh_dim_names = ("data", "model")
    shape = (2, 2)

    def get_coordinate(self):
        return [0, 0]

    def __getitem__(self, axis):
        return types.SimpleNamespace(get_group=lambda: None)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_mesh_refuses_other_families(arch):
    """No family is refused: the encoder-decoder and vision models are
    served under a mesh too (``test_torch_serve_mesh_cross``), a rank
    holding its share of the KV heads and of the batch rows."""
    cfg = port_cfg(arch, {"num_heads": 8, "num_kv_heads": 4})
    shards = serve_shards(cfg, _Coordinated(), None, 4)
    assert (shards.kv_heads, shards.rows) == (2, slice(0, 2))
    assert shards.local_cfg(cfg).num_heads == 4


@pytest.mark.parametrize("arch, model, what", [
    ("zamba2-1.2b", 3, "8 SSM heads"),
    ("rwkv6-1.6b", 2, "1 RWKV heads"),
    ("mixtral-8x7b", 3, "4 experts")])
def test_mesh_refuses_uneven_recurrent_and_expert_splits(arch, model, what):
    """A "model" axis that does not divide the SSM heads, the RWKV heads or
    the experts of a reduced config is refused, naming A10."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    with pytest.raises(ValueError, match=f"{what}.*A10"):
        ServeEngine(cfg, params={}, device="cpu", mesh=_stand_in(1, model))


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
    with pytest.raises(ValueError, match="KV heads.*A10"):
        EncodeEngine(tconfigs.reduced(tconfigs.get_config(
            "seamless-m4t-medium")), params={}, device="cpu",
            mesh=_stand_in(1, 8))
