"""One rank of a spawned group of CPU gloo ranks, for
``test_torch_dist.py`` (the compressed all-reduce, the GPipe pipeline,
the elastic checkpoint restore), ``test_torch_dist_moe.py`` (the MoE
capacity dispatch with its experts over "data"),
``test_torch_dist_tp.py`` (tensor-parallel training) and
``test_torch_serve_mesh.py``, ``test_torch_serve_mesh_moe.py``,
``test_torch_serve_mesh_recurrent.py`` and ``test_torch_serve_mesh_cross.py``
(``ServeEngine`` and ``EncodeEngine`` under a device mesh).

Each test file starts ONE group (``spawn_group``) on a ``FileStore``
under its temporary directory (no fixed port) and names the cases its
ranks run. Each case writes what it computed to that directory; the test
process holds it against the JAX package. This module imports torch and
``repro_torch`` only.
"""
import dataclasses
import json
import multiprocessing
import os
import time
import traceback

import numpy as np

WORLD = 4
PSUM_SHAPES = {"a": (64,), "b": (8, 16)}
PIPE = {"d": 16, "groups": 4, "batch": 8, "micro": 4}
TRAIN_STEPS = 1
READY = "ckpt_ready"           # the test process wrote its checkpoints
TRAIN_ARGV = ["--arch", "llama3-8b", "--reduced", "--batch", "4", "--seq",
              "16", "--steps", str(TRAIN_STEPS), "--device", "cpu"]
# one step of reduced mixtral (capacity dispatch, 4 experts) on a (4, 1)
# mesh: the experts go over "data"
MOE_ARGV = ["--arch", "mixtral-8x7b", "--reduced", "--batch", "4", "--seq",
            "16", "--steps", "1", "--device", "cpu", "--model_axis", "1"]


def reference_args(argv: list):
    """``argv`` of ``launch.train`` as the arguments the JAX package's
    ``launch.train.build`` takes: the trainer's defaults, the argv's
    values (flags the build does not read dropped)."""
    import types
    ns = types.SimpleNamespace(
        arch="llama3-8b", reduced=False, d_model=0, d_ff=0, layers=0,
        steps=100, total_steps=0, batch=8, seq=128, lr=3e-4, seed=0,
        quant="none", train_quant="", r=2.0, act_bits=8, weight_bits=8,
        budget_schedule="", allocation="layerwise", calib_decay=0.99,
        anneal_warmup=0, remat=False, microbatches=1)
    it = iter(argv)
    for flag in it:
        key = flag[2:]
        if key == "reduced":
            ns.reduced = True
        elif not hasattr(ns, key):    # a flag ``build`` does not read
            next(it)
        else:
            setattr(ns, key, type(getattr(ns, key))(next(it)))
    return ns


def psum_inputs(rank: int) -> tuple:
    """This rank's gradient and error-feedback trees (numpy, seeded)."""
    rng = np.random.default_rng(100 + rank)
    g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
         for k, s in PSUM_SHAPES.items()}
    e = {k: (rng.standard_normal(s) * 1e-5).astype(np.float32)
         for k, s in PSUM_SHAPES.items()}
    return g, e


def pipe_inputs() -> tuple:
    rng = np.random.default_rng(7)
    d = PIPE["d"]
    ws = (rng.standard_normal((PIPE["groups"], d, d))
          * d ** -0.5).astype(np.float32)
    x = rng.standard_normal((PIPE["batch"], d)).astype(np.float32)
    return ws, x


def _psum(rank: int, tmp: str) -> None:
    import torch
    from repro_torch.dist.collectives import _compress_one, \
        compressed_psum_mean
    g, e = psum_inputs(rank)
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    te = {k: torch.as_tensor(v) for k, v in e.items()}
    mean, err = compressed_psum_mean(tg, te)
    codes = {k: _compress_one(tg[k], te[k])[2] for k in tg}
    np.savez(os.path.join(tmp, f"psum_{rank}.npz"),
             **{f"mean_{k}": mean[k].numpy() for k in mean},
             **{f"err_{k}": err[k].numpy() for k in err},
             **{f"codes_{k}": codes[k].numpy() for k in codes})


def _pipeline(rank: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.dist.compat import DeviceMesh
    from repro_torch.dist.pipeline import pipeline_stack
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("pod", "data"))
    ws, x = (torch.as_tensor(a).requires_grad_(True) for a in pipe_inputs())

    def block(stage_ws, h):
        for w in stage_ws:
            h = torch.tanh(h @ w)
        return h

    out = pipeline_stack(block, ws, x, mesh=mesh, axis="pod",
                         n_micro=PIPE["micro"])
    gw, gx = torch.autograd.grad((out ** 2).sum(), (ws, x))
    group = mesh.get_group("pod")
    dist.all_reduce(gw, group=group)
    dist.all_reduce(gx, group=group)
    if rank == 0:
        np.savez(os.path.join(tmp, "pipe.npz"), out=out.detach().numpy(),
                 gw=gw.numpy(), gx=gx.numpy())


def _elastic(rank: int, tmp: str) -> None:
    """Save a (4, 1) FSDP-sharded train state; restore it onto (2, 2)
    and, without shardings, as one rank's plain arrays."""
    import torch
    from repro_torch import configs, convert
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.dist.compat import DeviceMesh, full
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    from repro_torch.models import model as MD
    cfg = configs.reduced(configs.get_config("llama3-8b"))
    tcfg = TrainConfig(seed=3)
    par = ParallelConfig(fsdp=True)
    meta = MD.init_params(cfg, 3, "meta")
    mesh41 = DeviceMesh("cpu", torch.arange(WORLD).reshape(4, 1),
                        mesh_dim_names=("data", "model"))
    mesh22 = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
    state = ST.make_train_state(
        cfg, tcfg, seed=3, device="cpu",
        shardings=TR._state_shardings(meta, cfg, mesh41, par)[0])
    want = convert.train_state_to_reference(state, cfg)
    want_flat = {k: full(v) if not hasattr(v, "parts")
                 else torch.stack([full(p) for p in v.parts])
                 for k, v in ck.flatten(want)}
    sharded41 = sum(1 for _, v in ck.flatten(want)
                    for p in getattr(v, "parts", (v,))
                    if hasattr(p, "placements")
                    and any(pl.is_shard() for pl in p.placements))
    d = os.path.join(tmp, "elastic")
    ck.save(d, 1, want)
    tmpl = convert.train_state_to_reference(ST.make_train_state(
        cfg, tcfg, seed=3, device="meta"), cfg)
    placed = TR._state_shardings(meta, cfg, mesh22, par)[1]
    on22 = dict(ck.flatten(ck.restore(d, 1, tmpl, shardings=placed)))
    plain = dict(ck.flatten(ck.restore(d, 1, tmpl)))
    diff22 = {k: bool(torch.equal(
        full(v) if isinstance(v, torch.Tensor)
        else torch.as_tensor(np.array(v)), want_flat[k]))
        for k, v in on22.items()}
    sharded22 = sum(1 for v in on22.values()
                    if hasattr(v, "placements")
                    and any(pl.is_shard() for pl in v.placements))
    diff11 = {k: bool(np.array_equal(np.asarray(v),
                                      want_flat[k].numpy()))
              for k, v in plain.items()}
    # the port's own layout restored from the (2, 2) arrays
    port22 = convert.train_state_from_reference(
        ck.restore(d, 1, tmpl, shardings=placed), cfg, "cpu")
    same_port = all(torch.equal(full(a), full(b)) for a, b in zip(
        _leaves(port22.params), _leaves(state.params)))
    if rank == 0:
        with open(os.path.join(tmp, "elastic.json"), "w") as f:
            json.dump({"equal_22": diff22, "equal_11": diff11,
                       "sharded_leaves_41": sharded41,
                       "sharded_leaves_22": sharded22,
                       "port_layout_equal": same_port}, f)


def _leaves(tree):
    from repro_torch.optim.optimizers import tree_leaves
    return tree_leaves(tree)


def _wait_file(path: str) -> None:
    deadline = time.monotonic() + 300
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the test process wrote no {path}")
        time.sleep(0.05)


def _wait_ready(tmp: str) -> None:
    _wait_file(os.path.join(tmp, READY))


def _train(rank: int, argv: list) -> dict:
    """``launch.train.main`` on the standing group, as torchrun starts
    it."""
    from repro_torch.launch import train as TR
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(WORLD),
                       "LOCAL_RANK": str(rank)})
    return TR.main(argv)


def _tp_train(rank: int, tmp: str) -> None:
    """``launch.train.main`` on the (2, 2) mesh, resumed from the
    reference's step-0 checkpoint the test wrote."""
    _wait_ready(tmp)
    summary = _train(rank, TRAIN_ARGV + ["--model_axis", "2", "--ckpt_dir",
                                         os.path.join(tmp, "tp_ckpt")])
    if rank == 0:
        with open(os.path.join(tmp, "tp.json"), "w") as f:
            json.dump(summary, f)


def _moe_ep(rank: int, tmp: str) -> None:
    """One train step of reduced mixtral on the (4, 1) mesh, resumed from
    the reference's step-0 checkpoint the test wrote; its step-1
    checkpoint (the AdamW moments hold the gradients) and summary go to
    the test, with each capacity dispatch's routes and kept routes and
    the placements of its (E, C, d) expert buffer."""
    from repro_torch.dist import moe_ep as TMOE
    from repro_torch.dist.compat import full
    _wait_ready(tmp)
    plans, placements = [], []
    real_plan, real_constrain = TMOE.dispatch_plan, TMOE._constrain

    def plan(mask, capacity):
        keep, pos = real_plan(mask, capacity)
        plans.append((int(full(mask).sum()), int(full(keep).sum())))
        return keep, pos

    def constrain(x, mesh, entries):
        out = real_constrain(x, mesh, entries)
        placements.append([f"Shard({p.dim})" if p.is_shard() else
                           "Replicate" if p.is_replicate() else str(p)
                           for p in getattr(out, "placements", ())])
        return out

    TMOE.dispatch_plan, TMOE._constrain = plan, constrain
    try:
        summary = _train(rank, MOE_ARGV + ["--ckpt_dir",
                                           os.path.join(tmp, "moe_ckpt")])
    finally:
        TMOE.dispatch_plan, TMOE._constrain = real_plan, real_constrain
    if rank == 0:
        with open(os.path.join(tmp, "moe.json"), "w") as f:
            json.dump({"summary": summary, "plans": plans,
                       "placements": placements}, f)


SERVE_CASES = "serve_cases.json"    # the test's cases of mesh serving


def serve_requests(seed: int, n: int, prompt: int, gen: int,
                   first: int = 0) -> list:
    """``n`` seeded requests whose budgets cycle over the ladder's rungs
    from rung ``first`` (as dicts of ``serve_engine.Request``'s
    fields)."""
    rng = np.random.default_rng(seed)
    budgets = (2, 4, 6)
    return [dict(uid=i, prompt=rng.integers(0, 512, prompt).astype(np.int32),
                 max_new_tokens=gen,
                 power_budget_bits=budgets[(first + i) % 3])
            for i in range(n)]


def case_cfg(case: dict):
    """The port's reduced config of a case, with the case's widths."""
    from repro_torch import configs
    return dataclasses.replace(
        configs.reduced(configs.get_config(case["arch"])), **case["cfg"])


def frontend_fn(cfg, first: int = 0):
    """``frontend_kwargs_fn`` of a cross-attending config: a new seeded
    raw input (``data.pipeline.frontend_raw_stub``, the JAX package's
    bytes) at every call, the n-th call's at step ``first + n``; None for
    a decoder-only config. Every rank of a mesh calls it as often, in
    the same order, as a one-rank engine does."""
    from repro_torch.data import pipeline
    if cfg.family not in ("encdec", "vlm"):
        return None
    key = "enc_inputs" if cfg.family == "encdec" else "image_embeds"
    calls = [first]

    def fn(batch):
        calls[0] += 1
        return {key: pipeline.frontend_raw_stub(cfg, batch, calls[0] - 1)}

    return fn


def serve_engine(case: dict, mesh=None):
    """The case's ``ServeEngine`` on the store the test wrote (loaded
    afresh: a mesh engine places its own copy of each shard)."""
    import torch
    from repro_torch.serve_engine import ServeEngine
    cfg = case_cfg(case)
    ws = torch.load(case["store"], weights_only=False)
    return ServeEngine(cfg, weight_store=ws, backend=case["backend"],
                       cache_bits=case["cache_bits"],
                       allocation=case["allocation"], device="cpu",
                       mesh=mesh, frontend_kwargs_fn=frontend_fn(cfg),
                       **case["engine"])


def serve_recorded(engine, case: dict) -> dict:
    """Serve the case's requests; every step's logits recorded."""
    import torch
    from repro_torch.serve_engine import Request
    steps = []
    run = engine._run_step

    def recorded(bits, slot):
        logits = run(bits, slot)
        steps.append(logits.clone())
        return logits

    engine._run_step = recorded
    engine.warmup()
    out = engine.generate([Request(**r) for r in serve_requests(
        **case["requests"])])
    return {"tokens": [r.tokens for r in out],
            "rungs": [r.rung_bits for r in out],
            "logits": torch.stack(steps).numpy()}


def _state_leaves(tree) -> list:
    """The tensors of a decode state (nested tuples and lists), in order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [t for node in tree for t in _state_leaves(node)]


def _serve_mesh(rank: int, tmp: str) -> None:
    """Every case of the test's list on its mesh: rank 0's tokens and
    every step's logits, and each rank's store bytes."""
    import torch
    from repro_torch.dist.compat import DeviceMesh, staged_collectives
    from repro_torch.models import serving
    _wait_file(os.path.join(tmp, SERVE_CASES))
    with open(os.path.join(tmp, SERVE_CASES)) as f:
        cases = json.load(f)
    out = {}
    for case in cases:
        _wait_file(case["store"])       # the test writes them in turn
        t0 = time.monotonic()
        d, m = case["mesh"]
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(d, m),
                          mesh_dim_names=("data", "model"))
        engine = serve_engine(case, mesh)
        res = serve_recorded(engine, case)
        res["store_bytes"] = serving.store_bytes(engine.weight_store,
                                                 *engine.variants.values())
        res["describe"] = engine.describe()
        res["slot_shapes"] = [list(t.shape) for t in _state_leaves(
            engine._slots[0].state.caches)]
        res["cross_shapes"] = [list(t.shape) for t in _state_leaves(
            engine._slots[0].state.cross_kv)]
        moe = engine._views[engine.ladder[0].bits]["layers"][0].get("moe")
        if moe is not None:     # the rank's local expert stacks
            res["moe_shapes"] = {k: list(v.shape) for k, v in moe.items()
                                 if k != "router"}
        del engine
        if rank == 0:
            np.save(os.path.join(tmp, f"logits_{case['name']}.npy"),
                    res.pop("logits"))
        else:
            res.pop("logits")
        res["seconds"] = time.monotonic() - t0
        out[case["name"]] = res
    out["staged_collectives"] = staged_collectives()
    with open(os.path.join(tmp, f"serve_{rank}.json"), "w") as f:
        json.dump(out, f, default=str)


ENCODE_CASES = "encode_cases.json"  # the test's cases of mesh encoding


def encode_requests(cfg, seed: int, n: int) -> list:
    """``n`` raw items (``frontend_raw_stub`` at step ``seed``) whose
    budgets cycle over the ladder's rungs (as dicts of
    ``EncodeRequest``'s fields)."""
    from repro_torch.data import pipeline
    items = pipeline.frontend_raw_stub(cfg, n, seed)
    return [dict(uid=i, item=items[i], power_budget_bits=(2, 4, 6)[i % 3])
            for i in range(n)]


def encode_engine(case: dict, mesh=None):
    """The case's ``EncodeEngine`` on the encode store the test wrote."""
    import torch
    from repro_torch.serve_engine import EncodeEngine
    ws = torch.load(case["store"], weights_only=False)
    return EncodeEngine(case_cfg(case), weight_store=ws,
                        backend=case["backend"], device="cpu", mesh=mesh,
                        **case["engine"])


def encode_served(engine, case: dict) -> dict:
    """Encode the case's items; (the encoded items stacked, the rungs)."""
    from repro_torch.serve_engine import EncodeRequest
    engine.warmup()
    out = engine.encode([EncodeRequest(**r) for r in encode_requests(
        engine.cfg, **case["items"])])
    engine.assert_no_recompile()
    return {"encoded": np.stack([r.encoded for r in out]),
            "rungs": [r.rung_bits for r in out]}


def _encode_mesh(rank: int, tmp: str) -> None:
    """Every encode case of the test's list on its mesh: each rank's
    encoded items (every rank returns the whole wave) and store bytes."""
    import torch
    from repro_torch.dist.compat import DeviceMesh
    from repro_torch.models import serving
    _wait_file(os.path.join(tmp, ENCODE_CASES))
    with open(os.path.join(tmp, ENCODE_CASES)) as f:
        cases = json.load(f)
    out, arrays = {}, {}
    for case in cases:
        _wait_file(case["store"])
        t0 = time.monotonic()
        d, m = case["mesh"]
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(d, m),
                          mesh_dim_names=("data", "model"))
        engine = encode_engine(case, mesh)
        res = encode_served(engine, case)
        arrays[case["name"]] = res.pop("encoded")
        res["store_bytes"] = serving.store_bytes(engine.weight_store,
                                                 *engine.variants.values())
        res["seconds"] = time.monotonic() - t0
        out[case["name"]] = res
    np.savez(os.path.join(tmp, f"encoded_{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"encode_{rank}.json"), "w") as f:
        json.dump(out, f)


# the MoE block alone under shards: (rows, tokens, d, d_ff, experts, k)
MOE_BLOCK = (4, 1, 128, 128, 4, 2)
MOE_MESHES = ((2, 2), (1, 4), (4, 1))


def moe_block_inputs():
    """The block's x, router (d, E) and expert stacks (numpy, seeded)."""
    b, t, d, ff, e, _ = MOE_BLOCK
    rng = np.random.default_rng(61)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"x": normal((b, t, d), 1.0), "router": normal((d, e), 0.3),
            "w_gate": normal((e, d, ff), d ** -0.5),
            "w_up": normal((e, d, ff), d ** -0.5),
            "w_down": normal((e, ff, d), ff ** -0.5)}


def moe_block_cfg():
    from repro_torch import configs
    from repro_torch.configs.base import MoEConfig
    b, t, d, ff, e, k = MOE_BLOCK
    return dataclasses.replace(
        configs.reduced(configs.get_config("mixtral-8x7b")), d_model=d,
        d_ff=ff, num_heads=8, num_kv_heads=4, moe=MoEConfig(e, k))


def _moe_units(rank: int, tmp: str) -> None:
    """``models.mlp.apply_moe`` under shards on each of MOE_MESHES, the
    router whole and the rank's rows: its whole experts (the serving
    layout) or its d_ff slice of every expert (the layout of a "model"
    axis that does not divide the experts). Every rank's outputs written
    for the test."""
    import torch
    from repro_torch.dist import local_ops
    from repro_torch.dist.compat import DeviceMesh
    from repro_torch.models import mlp
    out = {}
    cfg = moe_block_cfg()
    inp = {k: torch.from_numpy(v) for k, v in moe_block_inputs().items()}
    for d, m in MOE_MESHES:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(d, m),
                          mesh_dim_names=("data", "model"))
        shards = local_ops.ServeShards.for_mesh(mesh, cfg, MOE_BLOCK[0])
        r = shards.model_rank
        ff, ne = MOE_BLOCK[3] // m, MOE_BLOCK[4] // m
        cols, own = slice(r * ff, (r + 1) * ff), slice(r * ne, (r + 1) * ne)
        layouts = {
            "experts": {k: inp[k][own].contiguous()
                        for k in ("w_gate", "w_up", "w_down")},
            "dff": {"w_gate": inp["w_gate"][:, :, cols].contiguous(),
                    "w_up": inp["w_up"][:, :, cols].contiguous(),
                    "w_down": inp["w_down"][:, cols].contiguous()}}
        for layout, p in layouts.items():
            p["router"] = {"w": inp["router"]}
            with local_ops.use_shards(shards):
                y, _ = mlp.apply_moe(inp["x"][shards.rows], p, cfg)
            out[f"moe_{d}x{m}_{layout}"] = y.numpy()
    np.savez(os.path.join(tmp, f"moe_units_{rank}.npz"), **out)


CASES = {"psum": _psum, "pipeline": _pipeline, "elastic": _elastic,
         "moe_ep": _moe_ep, "tp": _tp_train, "serve_mesh": _serve_mesh,
         "moe_units": _moe_units, "encode_mesh": _encode_mesh}


def run(rank: int, tmp: str, cases: tuple) -> None:
    """The spawned rank's entry point: ``cases`` in order; a failure is
    written to ``error_<rank>.txt`` and re-raised."""
    t0 = time.monotonic()
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    seconds = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
            rank=rank, world_size=WORLD)
        seconds["start"] = time.monotonic() - t0
        try:
            for name in cases:
                t0 = time.monotonic()
                CASES[name](rank, tmp)
                seconds[name] = time.monotonic() - t0
        finally:
            dist.destroy_process_group()
        # each case's seconds on this rank, for the file's report
        with open(os.path.join(tmp, f"seconds_{rank}.json"), "w") as f:
            json.dump(seconds, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_group(tmp: str, cases: tuple, prepare=None, meanwhile=None):
    """Run ``cases`` on WORLD spawned ranks and return ``meanwhile()``.
    ``prepare()`` (the test process's checkpoints) runs while they start,
    READY tells them it is done, and ``meanwhile()`` (the test process's
    reference) runs while they work. Fails if a rank fails or hangs; no
    process group is started in the caller."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, tmp, cases))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        if prepare is not None:
            prepare()
        open(os.path.join(tmp, READY), "w").close()
        result = meanwhile() if meanwhile is not None else None
    except BaseException:
        for p in procs:
            p.kill()
            p.join()
        raise
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [open(os.path.join(tmp, f)).read() for f in sorted(
        os.listdir(tmp)) if f.startswith("error_")]
    assert not alive and not errors and all(
        p.exitcode == 0 for p in procs), errors or "a rank hung"
    return result
