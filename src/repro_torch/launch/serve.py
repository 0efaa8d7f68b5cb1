"""Serving driver, ladder mode (port of ``repro.launch.serve``'s
``serve_ladder``): plan a ladder of equal-power PANN operating points once,
quantize into one weight store, then serve requests whose rung is chosen
per request from a declared power budget.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --power_ladder 2,4,6 --backend packed --cache_bits 4

Runs on the card by default (``--device cuda``; raises without one). Prints
the same ``[serve]`` JSON summary as the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import QuantConfig
from repro_torch.models import model as MD
from repro_torch.serve_engine import Request, ServeEngine


def serve_ladder(args) -> dict:
    """One ServeEngine, per-request rung selection."""
    ladder_bits = [int(b) for b in args.power_ladder.split(",")]
    budgets = ([int(b) for b in args.budgets.split(",")] if args.budgets
               else ladder_bits)
    cfg = configs.get_config(args.arch, quant=QuantConfig(mode="none"))
    if args.reduced:
        cfg = configs.reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    device = MD.resolve_device(args.device)
    params = MD.init_params(cfg, seed=args.seed, device=device)
    cache_bits = None
    if args.cache_bits:
        cache_bits = "auto" if args.cache_bits == "auto" \
            else int(args.cache_bits)
    engine = ServeEngine(cfg, params, ladder_bits=ladder_bits,
                         max_batch=args.batch,
                         max_len=args.prompt_len + args.gen,
                         allocation=args.allocation,
                         backend=args.backend,
                         cache_bits=cache_bits,
                         device=device)
    del params
    engine.warmup()
    total_macs = sum(m.macs for m in engine.profile)
    for op in engine.ladder:
        if op.lw is not None:
            print(f"[serve] {op.describe()}")
        else:
            # same unit as the layerwise line: total network Gbit-flips
            print(f"[serve] rung[{op.bits}b] "
                  f"{op.plan.describe(total_macs=total_macs)}")

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
    ap.add_argument("--power_ladder", default="2,4,6",
                    help="comma-separated bit budgets of the ladder rungs")
    ap.add_argument("--allocation", default="uniform",
                    choices=["uniform", "layerwise"],
                    help="ladder rung allocation: one global (b~x, R) per "
                         "rung, or a per-module PolicyTree spending the "
                         "same total power layer-wise "
                         "(planner.allocate_layerwise)")
    ap.add_argument("--backend", default="packed",
                    choices=["ref", "fused", "packed"],
                    help="serving-matmul backend: ref (plain PyTorch "
                         "integer dataflow), fused (bit-plane kernel), "
                         "packed (packed-plane kernel)")
    ap.add_argument("--cache_bits", default="",
                    help="quantize the decode-time KV cache: an int in "
                         "[2, 7] pins every rung's cache width; 'auto' lets "
                         "each rung pick (uniform rungs cache at their own "
                         "b~x, layerwise rungs let the allocator trade "
                         "cache bits against weight bits under one "
                         "budget); empty = fp cache")
    ap.add_argument("--budgets", default="",
                    help="per-request power budgets (bits), cycled over the "
                         "request stream; defaults to the ladder itself")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default: --batch)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return serve_ladder(args)


if __name__ == "__main__":
    main()
