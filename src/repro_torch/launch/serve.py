"""Serving CLI (port of ``repro.launch.serve``), four modes.

Ladder mode (the default; ``serve_ladder``): plan a ladder of equal-power
PANN operating points once, quantize into one weight store, then serve
requests whose rung is chosen per request from a declared power budget:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --power_ladder 2,4,6 --backend packed --cache_bits 4

``--autotune`` measures and caches the K split of every projection's
kernel before warmup (``kernels.autotune``; the CPU records the
heuristic).

Fleet mode (``--fleet_hosts N``; ``serve_fleet``): N rung-sharded decode
hosts and a prefill host serving one device copy of the artifact under a
global power cap of ``--global_budget`` Gbit-flips/s, driven by a
synthetic ``--ticks``-tick trace (``serve_engine.fleet``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --fleet_hosts 4 --global_budget 0.25 --ticks 12

Single point (``--quant`` without ``--power_ladder``; ``serve_single``):
plan one operating point for ``--power_bits`` (Algorithm 1's theory
planner), then a teacher-forced prefill and a greedy decode through
``models.model.decode_step``. ``--quant pann`` builds the single-point
artifact and serves it through the kernel backend (``packed`` unless
``--backend`` says otherwise; ``--backend ""`` serves the fp params
through the fake-quant ``qlinear`` instead, the reference's legacy path);
the other modes serve the fp params through ``qlinear``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --quant pann --power_bits 4

An encoder-decoder or vision config takes its frontend in both modes
from ``data.pipeline.frontend_stub`` (stub embeddings, as the reference).
Encode mode (``--encode``; ``serve_encode``): whole-sequence encode waves
through ``serve_engine.EncodeEngine`` under per-item budgets, each item
the raw frontend input of ``frontend_raw_stub`` (stub embeddings without
a conv stem):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --encode --power_ladder 2,4,6

Runs on the card by default (``--device cuda``; raises without one). Prints
the same ``[serve]`` JSON summaries as the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import QuantConfig
from repro_torch.core import costs, planner
from repro_torch.data.pipeline import frontend_raw_stub, frontend_stub
from repro_torch.models import model as MD
from repro_torch.models import serving
from repro_torch.serve_engine import (EncodeEngine, EncodeRequest, Request,
                                      ServeEngine)
from repro_torch.serve_engine.fleet import (Fleet, FleetConfig, TrafficSpec,
                                            make_trace)


def _config(args, quant=None):
    cfg = configs.get_config(args.arch, quant=quant)
    if args.reduced:
        cfg = configs.reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def plan_quant(args, total_macs=None) -> QuantConfig:
    """The single point's QuantConfig: PANN planned for ``--power_bits``
    (printed with the network's price), or RUQ at ``--power_bits`` bits."""
    if args.quant == "none":
        return QuantConfig(mode="none")
    if args.quant == "pann":
        plan = planner.plan_with_theory(
            planner.budget_from_bits(args.power_bits))
        print(f"[serve] {plan.describe(total_macs=total_macs)}")
        return QuantConfig(mode="pann", r=plan.r,
                           act_bits_tilde=plan.b_x_tilde)
    return QuantConfig(mode=args.quant, weight_bits=args.power_bits,
                       act_bits=args.power_bits)


def _frontend_key(cfg):
    return "enc_inputs" if cfg.family == "encdec" else "image_embeds"


def _print_rungs(engine) -> None:
    total_macs = sum(m.macs for m in engine.profile)
    for op in engine.ladder:
        if op.lw is not None:
            print(f"[serve] {op.describe()}")
        else:
            # same unit as the layerwise line: total network Gbit-flips
            print(f"[serve] rung[{op.bits}b] "
                  f"{op.plan.describe(total_macs=total_macs)}")


def serve_single(args) -> dict:
    """One operating point: teacher-forced prefill, then greedy decode,
    one ``decode_step`` a token (eager, no CUDA graph)."""
    if args.allocation != "uniform":
        raise SystemExit(
            "--allocation layerwise requires --power_ladder (the "
            "single-point path has no per-module rungs)")
    if args.cache_bits:
        raise SystemExit(
            "--cache_bits requires --power_ladder (the quantized KV cache "
            "rides in the serve-engine weight store)")
    backend = args.backend
    if backend is None:
        backend = "packed" if args.quant == "pann" else ""
    if backend and args.quant != "pann":
        raise SystemExit("--backend serves the PANN deployment artifact; "
                         "combine it with --quant pann (or use "
                         "--power_ladder)")
    cfg = _config(args)
    qc = plan_quant(args, total_macs=costs.macs_per_token(cfg).weight_macs)
    cfg = dataclasses.replace(cfg, quant=qc)
    device = MD.resolve_device(args.device)
    params = MD.init_params(cfg, seed=args.seed, device=device)
    if backend:
        params = serving.quantize_params_for_serving(
            params, cfg, spec=serving.ServingQuantSpec(
                r=qc.r, act_bits=qc.act_bits_tilde,
                pack_planes=backend == "packed"))
        cfg = dataclasses.replace(cfg, kernel_backend=backend)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=device)
    kwargs = {}
    fe = frontend_stub(cfg, args.batch, 0, args.seed)
    if fe is not None:
        kwargs[_frontend_key(cfg)] = torch.as_tensor(fe, device=device)
    state = MD.init_decode_state(params, cfg, args.batch,
                                 args.prompt_len + args.gen, **kwargs)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.monotonic()
    logits = None
    for i in range(args.prompt_len):
        logits, state = MD.decode_step(params, cfg, state,
                                       prompts[:, i:i + 1])
    sync()
    t_prefill = time.monotonic() - t0

    t0 = time.monotonic()
    tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
    out_tokens = [tok]
    for _ in range(args.gen - 1):
        logits, state = MD.decode_step(params, cfg, state, tok)
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
        out_tokens.append(tok)
    sync()
    t_decode = time.monotonic() - t0

    gen = torch.cat(out_tokens, dim=1)
    summary = {
        "arch": cfg.name,
        "quant": qc.mode,
        "backend": backend or "legacy",
        "batch": args.batch,
        "generated": int(gen.shape[1]),
        "prefill_s": round(t_prefill, 3),
        "decode_s": round(t_decode, 3),
        "tok_per_s": round(args.batch * (args.gen - 1) / max(t_decode, 1e-9),
                           1),
        "sample": gen[0, :8].tolist(),
    }
    print("[serve] " + json.dumps(summary))
    return summary


def serve_ladder(args) -> dict:
    """One ServeEngine, per-request rung selection."""
    ladder_bits = [int(b) for b in (args.power_ladder or "2,4,6").split(",")]
    budgets = ([int(b) for b in args.budgets.split(",")] if args.budgets
               else ladder_bits)
    cfg = _config(args, quant=QuantConfig(mode="none"))
    device = MD.resolve_device(args.device)
    params = MD.init_params(cfg, seed=args.seed, device=device)
    cache_bits = None
    if args.cache_bits:
        cache_bits = "auto" if args.cache_bits == "auto" \
            else int(args.cache_bits)
    fe_fn = None
    if cfg.family in ("encdec", "vlm"):
        def fe_fn(batch):
            return {_frontend_key(cfg): frontend_stub(cfg, batch, 0,
                                                      args.seed)}
    engine = ServeEngine(cfg, params, ladder_bits=ladder_bits,
                         max_batch=args.batch,
                         max_len=args.prompt_len + args.gen,
                         allocation=args.allocation,
                         backend=("packed" if args.backend is None
                                  else args.backend or None),
                         cache_bits=cache_bits,
                         device=device, frontend_kwargs_fn=fe_fn,
                         autotune=args.autotune)
    del params
    engine.warmup()
    _print_rungs(engine)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.gen,
                    power_budget_bits=budgets[i % len(budgets)])
            for i in range(args.requests or args.batch)]

    t0 = time.monotonic()
    responses = engine.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    engine.assert_no_recompile()

    n_tok = sum(len(r.tokens) for r in responses)
    summary = {
        "arch": cfg.name,
        "mode": "ladder",
        "engine": engine.describe(),
        "requests": [{"uid": r.uid, "rung_bits": r.rung_bits,
                      "sample": r.tokens[:8], **r.metadata}
                     for r in responses],
        "generated": n_tok,
        "wall_s": round(dt, 3),
        "tok_per_s": round(n_tok / max(dt, 1e-9), 1),
    }
    print("[serve] " + json.dumps(summary))
    return summary


def serve_fleet(args) -> dict:
    """N simulated hosts under one global Gbit-flips/s cap, serving one
    device copy of the artifact written to ``--artifact_dir`` (a fresh
    temporary directory by default)."""
    ladder_bits = tuple(int(b) for b in
                        (args.power_ladder or "2,4,6").split(","))
    backend = "packed" if args.backend is None else args.backend
    if not backend:
        raise SystemExit(
            "--fleet_hosts serves through a kernel backend ('ref' | "
            "'fused' | 'packed'); '' is the reference's float path, which "
            "the port's engine refuses")
    cfg = _config(args, quant=QuantConfig(mode="none"))
    device = MD.resolve_device(args.device)
    params = MD.init_params(cfg, seed=args.seed, device=device)
    fc = FleetConfig(
        n_decode_hosts=args.fleet_hosts,
        n_prefill_hosts=1,
        ladder_bits=ladder_bits,
        allocation=args.allocation,
        cap_gbitflips_per_s=args.global_budget,
        max_batch=args.batch,
        max_len=args.prompt_len + args.gen + 2,
        backend=backend,
    )
    spec = TrafficSpec(seed=args.seed + 7, n_ticks=args.ticks,
                       prompt_lens=(args.prompt_len,),
                       gen_tokens=(max(args.gen - 4, 2), args.gen),
                       budget_mix=ladder_bits + (max(ladder_bits),))
    art_dir = args.artifact_dir or tempfile.mkdtemp(prefix="fleet_serve_")
    fleet = Fleet(cfg, fc, art_dir, params=params, device=device)
    del params
    trace = make_trace(spec, cfg.vocab_size, fleet.ladder)

    t0 = time.monotonic()
    report = fleet.run(trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    fleet.assert_no_recompile()

    summary = {
        "arch": cfg.name,
        "mode": "fleet",
        "hosts": report["hosts"],
        "artifact_dir": art_dir,
        "cap_gbitflips_per_s": args.global_budget,
        "requests": report["requests"],
        "served": report["served"],
        "realized_gbitflips": report["realized_gbitflips"],
        "realized_gbitflips_per_s": report["realized_gbitflips_per_s"],
        "cap_violations": report["cap_violations"],
        "rung_token_histogram": report["rung_token_histogram"],
        "governor_replans": len(report["governor"]["replans"]),
        "wall_s": round(dt, 3),
    }
    print("[serve] " + json.dumps(summary))
    return summary


def serve_encode(args) -> dict:
    """Item serving through ``EncodeEngine``: the same ladder and one
    weight store, per-item power budgets cycled over the requests."""
    ladder_bits = [int(b) for b in (args.power_ladder or "2,4,6").split(",")]
    budgets = ([int(b) for b in args.budgets.split(",")] if args.budgets
               else ladder_bits)
    cfg = _config(args, quant=QuantConfig(mode="none"))
    device = MD.resolve_device(args.device)
    params = MD.init_params(cfg, seed=args.seed, device=device)
    engine = EncodeEngine(cfg, params, ladder_bits=ladder_bits,
                          max_batch=args.batch, allocation=args.allocation,
                          backend=("packed" if args.backend is None
                                   else args.backend or None),
                          device=device)
    del params
    engine.warmup()
    _print_rungs(engine)
    n = args.requests or args.batch
    raw = frontend_raw_stub(cfg, n, 0, args.seed)
    if raw is None:                 # no conv stem: stub embeddings
        raw = frontend_stub(cfg, n, 0, args.seed)
    reqs = [EncodeRequest(uid=i, item=raw[i],
                          power_budget_bits=budgets[i % len(budgets)])
            for i in range(n)]
    t0 = time.monotonic()
    responses = engine.encode(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    engine.assert_no_recompile()
    summary = {
        "arch": cfg.name,
        "mode": "encode",
        "engine": engine.describe(),
        "items": [{"uid": r.uid, "rung_bits": r.rung_bits,
                   "encoded_shape": list(r.encoded.shape), **r.metadata}
                  for r in responses],
        "encoded": len(responses),
        "wall_s": round(dt, 3),
        "items_per_s": round(len(responses) / max(dt, 1e-9), 1),
    }
    print("[serve] " + json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's own)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--quant", default=None,
                    choices=["none", "ruq", "ruq_unsigned", "pann"],
                    help="serve ONE operating point at this quant mode "
                         "(single-point mode, unless --power_ladder is "
                         "given too)")
    ap.add_argument("--power_bits", type=int, default=4,
                    help="single point: the power budget as an unsigned-"
                         "MAC bit width")
    ap.add_argument("--power_ladder", default="",
                    help="comma-separated bit budgets of the ladder rungs "
                         "(default 2,4,6 when --quant is not given)")
    ap.add_argument("--allocation", default="uniform",
                    choices=["uniform", "layerwise"],
                    help="ladder rung allocation: one global (b~x, R) per "
                         "rung, or a per-module PolicyTree spending the "
                         "same total power layer-wise "
                         "(planner.allocate_layerwise)")
    ap.add_argument("--backend", default=None,
                    choices=["", "ref", "fused", "packed"],
                    help="serving-matmul backend: ref (plain PyTorch "
                         "integer dataflow), fused (bit-plane kernel), "
                         "packed (packed-plane kernel). Default: packed in "
                         "ladder mode and with --quant pann; a single "
                         "point at another --quant runs without one (a "
                         "backend there is refused). '' with --quant pann "
                         "serves the fp params through the fake-quant "
                         "projections, the reference's legacy path; a "
                         "ladder engine refuses it")
    ap.add_argument("--cache_bits", default="",
                    help="quantize the decode-time KV cache: an int in "
                         "[2, 7] pins every rung's cache width; 'auto' lets "
                         "each rung pick (uniform rungs cache at their own "
                         "b~x, layerwise rungs let the allocator trade "
                         "cache bits against weight bits under one "
                         "budget); empty = fp cache")
    ap.add_argument("--artifact_format", default="views",
                    help="ladder materialization: 'views' (the only "
                         "format) quantizes once at the per-module max "
                         "budget and serves every rung as a zero-copy view "
                         "over one weight store. The per-rung 'legacy' "
                         "format was retired.")
    ap.add_argument("--encode", action="store_true",
                    help="serve the encode workload (a vision or speech "
                         "frontend and its encoder) instead of decode: "
                         "whole-sequence waves through EncodeEngine, per-"
                         "item power budgets on the same ladder; "
                         "encoder-decoder and vision configs only")
    ap.add_argument("--budgets", default="",
                    help="per-request power budgets (bits), cycled over the "
                         "request stream; defaults to the ladder itself")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default: --batch)")
    ap.add_argument("--autotune", action="store_true",
                    help="ladder mode: measure and cache the best K split "
                         "of every projection's kernel before warmup "
                         "(kernels/autotune; $REPRO_TORCH_AUTOTUNE_CACHE "
                         "names the cache file). The CPU records the "
                         "heuristic untimed")
    ap.add_argument("--fleet_hosts", type=int, default=0,
                    help="serve a simulated fleet with this many rung-"
                         "sharded decode hosts (+1 prefill host) under "
                         "--global_budget (serve_engine.fleet)")
    ap.add_argument("--global_budget", type=float, default=0.25,
                    help="fleet mode: global power cap in Gbit-flips/s, "
                         "enforced every tick by the fleet governor")
    ap.add_argument("--ticks", type=int, default=12,
                    help="fleet mode: length of the synthetic traffic "
                         "trace")
    ap.add_argument("--artifact_dir", default="",
                    help="fleet mode: write the serving artifact here "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.artifact_format == "legacy":
        raise SystemExit(
            "--artifact_format legacy was retired: the ladder is always "
            "materialized as one weight store with zero-copy rung views "
            "(DESIGN.md §11). Budget-snapping drift is bounded in closed "
            "form by benchmarks/artifact_parity.py; drop the flag.")
    if args.artifact_format != "views":
        raise SystemExit(
            f"unknown --artifact_format {args.artifact_format!r}; "
            "the only format is 'views'")
    if args.encode:
        return serve_encode(args)
    if args.fleet_hosts:
        return serve_fleet(args)
    if args.quant is not None and not args.power_ladder:
        return serve_single(args)
    return serve_ladder(args)


if __name__ == "__main__":
    main()
