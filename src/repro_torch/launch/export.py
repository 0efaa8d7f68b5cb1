"""Train -> serve export: freeze a trained checkpoint into a serving
artifact and prove the hand-off (CLI; port of ``repro.launch.export``).

Loads a checkpoint written by ``launch/train.py`` (either package's),
rebuilds the run's final operating point (re-running the deterministic
budget annealer and layer-wise allocator when the run used
``--budget_schedule``), quantizes the params for serving with the
EMA-calibrated activation ranges frozen in
(``models.serving.quantize_params_for_serving(calib=...)``), and checks
that the exported rung reproduces the training-time held-out eval loss
within ``--tol``:

    python -m repro_torch.launch.train --arch llama3-8b --reduced \
        --steps 120 --quant pann --budget_schedule 0:fp,20:8,60:6 \
        --ckpt_dir /tmp/ck --device cpu
    python -m repro_torch.launch.export --ckpt_dir /tmp/ck \
        --out /tmp/artifact --device cpu

``--out`` writes the single-point artifact in checkpoint layout (the
reference's keys). ``--artifact_out`` writes the mmap-able ladder store
(``serve_engine.artifact``, the v1 format): one max-budget weight store
quantized from the same calibrated params, a rung view per
``--artifact_ladder`` bit budget. ``--cache_bits`` (the port's; the
reference's artifact has no KV-cache leaves) adds each view's
``kv_cache`` leaves at that width, with the calibrated cache roles'
frozen quantizer scalars, for a server that runs the quantized cache.

Memory: the params are restored once to the host; each consumer that
pops the fp32 weights (the single-point quantizer, ``build_weight_store``) gets
a device copy of its own, made after the previous one is gone, so the
fp32 params are never twice on the device. The optimizer moments stay on
disk. Runs on the card by default (``--device cuda``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.core import anneal
from repro_torch.dist.constrain import use_mesh
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as MD
from repro_torch.models import serving
from repro_torch.serve_engine import artifact
from repro_torch.serve_engine.ladder import build_ladder


def _final_operating_point(cfg, tcfg, targs, step: int):
    """(eval config, policy tree, uniform point, bits) at the end of
    training: the rung the artifact is exported at."""
    annealer = anneal.BudgetAnnealer.from_train_config(cfg, tcfg)
    if annealer is not None:
        bits = annealer.schedule.bits_at(max(step - 1, 0))
        if bits <= 0:
            raise SystemExit(
                "[export] the schedule ends in a full-precision segment — "
                "nothing to quantize; extend the schedule past its last "
                "fp knot or export an earlier checkpoint")
        tree = annealer.tree_for(bits)
        return dataclasses.replace(cfg, policy=tree), tree, None, bits
    # fixed operating point: the global (R, b~x) the run was configured with
    return cfg, None, (targs.r, targs.act_bits), 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--step", type=int, default=0,
                    help="checkpoint step to export (default: latest)")
    ap.add_argument("--out", default="",
                    help="write the serving artifact here (ckpt layout)")
    ap.add_argument("--artifact_out", default="",
                    help="write the mmap-able ladder weight store here "
                         "(manifest.json + weights.bin; "
                         "serve_engine.artifact)")
    ap.add_argument("--artifact_ladder", default="",
                    help="comma-separated bit budgets for the artifact's "
                         "rung views, e.g. 2,4,6 (default: the training "
                         "run's final operating point alone)")
    ap.add_argument("--cache_bits", type=int, default=0,
                    help="add KV-cache leaves at this width to the ladder "
                         "artifact's views (frozen k/v quantizers where "
                         "calibrated); 0: none, as the reference")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="max |exported - training| eval-loss gap "
                         "(relative to the training loss)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = MD.resolve_device(args.device)
    # under a one-column mesh, as the reference exports (a config with
    # moe_impl="capacity" evaluates through the capacity dispatch)
    started = not dist.is_initialized()
    mesh = make_local_mesh(1, args.device)
    try:
        with use_mesh(mesh):
            return _export(args, device)
    finally:
        if started:
            dist.destroy_process_group()


def _export(args, device) -> dict:
    step = args.step or ck.latest_step(args.ckpt_dir)
    if step is None:
        raise SystemExit(f"[export] no checkpoint in {args.ckpt_dir}")
    meta = ck.read_meta(args.ckpt_dir, step)
    if "train_args" not in meta:
        raise SystemExit("[export] checkpoint meta lacks train_args "
                         "(written by a pre-export trainer?)")
    targs = SimpleNamespace(**meta["train_args"])
    cfg, tcfg, par = TR.build(targs)
    train_quant = TR.resolve_train_quant(targs)
    if targs.quant != "pann":
        raise SystemExit(f"[export] serving artifacts are PANN "
                         f"(checkpoint trained with --quant {targs.quant})")
    if cfg.tie_embeddings:
        raise SystemExit("[export] tied-embedding unembed has no separate "
                         "lm_head weight to quantize; untie to export")
    qat = train_quant == "qat"
    times = {}

    t0 = time.monotonic()
    template = convert.train_state_to_reference(ST.make_train_state(
        cfg, tcfg, calibrate=qat, seed=targs.seed, device="meta"), cfg)
    template["opt"] = None       # the moments stay on disk
    host = ck.restore(args.ckpt_dir, step, template, strict=("calib/",))
    params = convert.params_from_reference(host["params"], cfg, device)
    calib = None if host["calib"] is None or not qat else {
        k: torch.as_tensor(np.array(v), device=device)
        for k, v in host["calib"].items()}
    TR._sync(device)
    times["load_s"] = time.monotonic() - t0

    t0 = time.monotonic()
    cfg_eval, tree, uniform_pt, bits = _final_operating_point(
        cfg, tcfg, targs, step)
    batch = TR.make_eval_batch(cfg, targs, device)
    # the training-time reference: the forward as training ran it — QAT
    # fake-quant at the final operating point with activations frozen to
    # the calibrated ranges, or plain fp for PTQ runs
    if qat:
        loss_train = ST.eval_loss(params, cfg_eval, batch, calib=calib)
    else:
        loss_train = ST.eval_loss(params, anneal.strip_quant(cfg), batch)
    if tree is not None:
        qspec = serving.ServingQuantSpec(policy=tree, calib=calib)
    else:
        qspec = serving.ServingQuantSpec(r=float(uniform_pt[0]),
                                         act_bits=int(uniform_pt[1]),
                                         calib=calib)
    variant = serving.quantize_params_for_serving(params, cfg, spec=qspec)
    del params
    # the exported rung through the SERVING forward (w_q dequant + frozen
    # activation ranges) on the same held-out batch
    loss_serve = ST.eval_loss(variant, cfg_eval, batch)
    times["eval_s"] = time.monotonic() - t0

    abs_diff = abs(loss_serve - loss_train)
    rel_diff = abs_diff / max(abs(loss_train), 1e-8)
    meta_eval = meta.get("eval_loss")
    summary = {
        "step": step, "bits": bits,
        "allocation": tcfg.budget_allocation if tcfg.budget_schedule
        else "uniform",
        "train_quant": train_quant,
        "loss_train_eval": loss_train, "loss_serve_eval": loss_serve,
        "abs_diff": abs_diff, "rel_diff": rel_diff,
        "meta_eval_loss": meta_eval,
    }
    if args.out:
        out_meta = {k: v for k, v in summary.items() if v is not None}
        out_meta["source_ckpt"] = args.ckpt_dir
        out_meta["train_args"] = meta["train_args"]
        summary["out"] = ck.save(args.out, step,
                                 convert.reference_layout(variant, cfg),
                                 meta=out_meta)
    del variant
    if args.artifact_out:
        # the ladder form: quantize ONCE at each module's max budget, one
        # zero-copy view per rung, from a fresh device copy of the params
        t0 = time.monotonic()
        if args.artifact_ladder:
            lad = build_ladder([int(b) for b in
                                args.artifact_ladder.split(",")],
                               d=float(cfg.d_model))
            specs = {op.bits: (op.tree if op.tree is not None
                               else (op.r, op.b_x_tilde)) for op in lad}
        elif tree is not None:
            specs = {bits: tree}
        else:
            specs = {0: (float(uniform_pt[0]),
                         None if uniform_pt[1] is None
                         else int(uniform_pt[1]))}
        params = convert.params_from_reference(host["params"], cfg, device)
        del host
        ws = serving.build_weight_store(
            params, cfg, specs,
            spec=serving.ServingQuantSpec(
                pack_planes=True, calib=calib,
                cache_bits=args.cache_bits or None))
        del params
        summary["artifact_out"] = artifact.write_artifact(
            args.artifact_out, ws, cfg,
            meta={"source_ckpt": args.ckpt_dir, "step": step,
                  "rungs": sorted(specs),
                  "train_args": meta["train_args"]})
        del ws
        times["artifact_s"] = time.monotonic() - t0
    summary["seconds"] = times
    print("[export] " + json.dumps(summary))

    if meta_eval is not None and qat and \
            abs(meta_eval - loss_train) > args.tol * max(abs(meta_eval), 1.0):
        raise SystemExit(
            f"[export] re-evaluated training loss {loss_train:.6f} drifted "
            f"from the checkpoint's recorded eval loss {meta_eval:.6f} — "
            f"the training forward is not reproducible")
    if qat and rel_diff > args.tol:
        raise SystemExit(
            f"[export] exported rung does NOT reproduce the training-time "
            f"eval loss: {loss_serve:.6f} vs {loss_train:.6f} "
            f"(rel {rel_diff:.2e} > tol {args.tol:.0e})")
    if qat:
        print(f"[export] round-trip OK: serving artifact reproduces the "
              f"training eval loss (rel diff {rel_diff:.2e})")
    else:
        print("[export] PTQ export (fp training reference; loss gap "
              f"{rel_diff:.2e} is the quantization cost, not gated)")
    return summary


if __name__ == "__main__":
    main()
