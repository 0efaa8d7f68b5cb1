"""End-to-end trainer (CLI; port of ``repro.launch.train``).

Deterministic synthetic data, AdamW, checkpoint / resume, straggler
telemetry and power-aware QAT with budget annealing, on the card by
default (``--device cuda``; raises without one), the CPU when asked
(``--device cpu``). Every run is under a ("data", "model") mesh of
``--model_axis`` columns (``launch.mesh.make_local_mesh``), as the
reference's: 1 x 1 in one process, so a config with
``moe_impl="capacity"`` trains through the capacity dispatch. With more
ranks (``torchrun``) the params and AdamW moments are DTensors placed
by ``dist.sharding.param_specs`` (tensor parallelism over "model"), the
batch is split over "data", every rank runs on
``cuda:{local_rank % device_count}`` (two ranks may share a card,
``dist.compat``) and rank 0 prints the summary:

    torchrun --standalone --nproc_per_node 4 -m repro_torch.launch.train \
        --arch llama3-8b --reduced --model_axis 2 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --reduced --steps 200 --quant pann --r 2.0 --device cpu

``--train_quant`` picks how quantization meets training: ``none`` (fp),
``ptq`` (train fp, quantize only at export / serve time) or ``qat`` (STE
fake-quant in the train step, activation ranges EMA-calibrated into the
train state). ``--budget_schedule`` anneals the bit-flip budget through
the run, re-running the layer-wise allocator at every knot:

    python -m repro_torch.launch.train --arch llama3-8b --reduced \
        --steps 200 --quant pann --train_quant qat \
        --budget_schedule 0:fp,40:8,120:6 --ckpt_dir /tmp/ck --device cpu
    python -m repro_torch.launch.export --ckpt_dir /tmp/ck \
        --artifact_out /tmp/art --artifact_ladder 2,4,6 --device cpu

Checkpoints are the JAX package's (``ckpt.checkpoint``): either trainer
resumes from the other's, and a checkpoint restores onto a mesh of
another shape. The flags, their defaults and the summary are the
reference's; the summary adds the measured step times by segment,
tokens/s, peak device memory, the checkpoint's size and write time and,
under a mesh, its shape and the collectives staged through the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import configs, convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs.base import ParallelConfig, QuantConfig, TrainConfig
from repro_torch.core import anneal
from repro_torch.core import calibrate as CAL
from repro_torch.data.pipeline import SyntheticLM, frontend_stub
from repro_torch.dist import compat
from repro_torch.dist import sharding as SH
from repro_torch.dist.constrain import use_mesh
from repro_torch.dist.fault import StepMonitor
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as MD

# held-out eval stream: same generator family as training, disjoint seed
EVAL_SEED_OFFSET = 1


def resolve_train_quant(args) -> str:
    """The tri-state none (fp training) | ptq (train fp, quantize at
    export) | qat (fake-quant in the train step). Unset derives it: qat
    whenever a quant mode is configured."""
    tq = args.train_quant or ("qat" if args.quant != "none" else "none")
    if tq != "none" and args.quant == "none":
        raise ValueError(
            f"--train_quant {tq} needs a quantization scheme; pass "
            f"--quant pann (or ruq/ruq_unsigned)")
    if tq == "none" and args.quant != "none":
        raise ValueError(
            f"--quant {args.quant} with --train_quant none is ambiguous: "
            f"use ptq (train fp, quantize at export) or qat")
    if args.budget_schedule:
        if tq != "qat":
            raise ValueError("--budget_schedule anneals QAT operating "
                             "points; requires --train_quant qat")
        if args.quant != "pann":
            raise ValueError("--budget_schedule plans PANN (b~x, R) "
                             "points; requires --quant pann")
    return tq


def build(args):
    """(model config, train config, parallel config) of a run's args."""
    tq = resolve_train_quant(args)
    qc = QuantConfig(mode=args.quant, r=args.r,
                     act_bits_tilde=args.act_bits, act_bits=args.act_bits,
                     weight_bits=args.weight_bits, qat=tq == "qat")
    cfg = configs.get_config(args.arch, quant=qc)
    if args.reduced:
        cfg = configs.reduced(cfg)
        cfg = dataclasses.replace(cfg, quant=qc)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  d_ff=args.d_ff or 4 * args.d_model,
                                  num_layers=args.layers or cfg.num_layers)
    horizon = args.total_steps or args.steps
    schedule = anneal.BudgetSchedule.parse(args.budget_schedule) \
        if args.budget_schedule else None
    tcfg = TrainConfig(lr=args.lr, total_steps=horizon,
                       warmup_steps=max(horizon // 20, 5), seed=args.seed,
                       budget_schedule=args.budget_schedule or None,
                       budget_allocation=args.allocation,
                       calib_decay=args.calib_decay,
                       anneal_warmup_steps=args.anneal_warmup,
                       lr_rewarmup_knots=schedule.knot_steps()
                       if schedule and args.anneal_warmup else ())
    par = ParallelConfig(fsdp=False, remat="block" if args.remat else "none",
                         microbatches=args.microbatches)
    return cfg, tcfg, par


TRAIN_ARG_KEYS = (
    "arch", "reduced", "d_model", "d_ff", "layers", "steps", "total_steps",
    "batch", "seq", "lr", "seed", "quant", "train_quant", "r", "act_bits",
    "weight_bits", "budget_schedule", "allocation", "calib_decay",
    "anneal_warmup", "remat", "microbatches",
)


def _batch(cfg, data: SyntheticLM, step: int, device, mesh=None) -> dict:
    """Step ``step`` of ``data`` on ``device``, with the config's frontend
    stub when it has one; under a mesh each input a DTensor placed by
    ``input_sharding`` (every rank makes the whole batch and keeps its
    rows)."""
    out = data.device_batch(step, device)
    fe = frontend_stub(cfg, data.global_batch, step, data.seed)
    if fe is not None:
        key = "enc_inputs" if cfg.family == "encdec" else "image_embeds"
        out[key] = torch.as_tensor(fe, device=device)
    return _placed(out, mesh)


def _placed(batch: dict, mesh) -> dict:
    """Each input a DTensor placed by ``input_sharding`` on ``mesh`` (each
    rank keeps its rows of the whole batch it made); as it is without a
    mesh."""
    if mesh is None:
        return batch
    return {k: SH.NamedSharding(mesh, SH.input_sharding(mesh, v.shape)).put(
        v, v.device) for k, v in batch.items()}


def _state_shardings(params, cfg, mesh, par) -> tuple:
    """(NamedSharding per param in the port's layout, the train state's
    shardings in the checkpoint's (the reference's) layout)."""
    specs = SH.param_specs(params, mesh, par)
    ref = SH.to_named(SH.restack(convert.reference_layout(specs, cfg)),
                      mesh)
    return (SH.to_named(specs, mesh),
            {"params": ref, "opt": {"mu": ref, "nu": ref, "count": None},
             "step": None, "calib": None})


def make_eval_batch(cfg, args, device="cuda") -> dict:
    """The deterministic held-out batch both the trainer and the exporter
    evaluate on (the seed offset keeps it off the training stream)."""
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch,
                       seed=args.seed + EVAL_SEED_OFFSET)
    return _batch(cfg, data, 0, device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save(args, cfg, step: int, state, meta: dict, device) -> dict:
    """Write a checkpoint; its size and write time."""
    _sync(device)
    t0 = time.monotonic()
    path = ck.save(args.ckpt_dir, step,
                   convert.train_state_to_reference(state, cfg), meta=meta)
    s = time.monotonic() - t0
    nbytes = os.path.getsize(os.path.join(path, ck.ARRAYS))
    return {"step": step, "path": path, "gb": nbytes / 1e9, "write_s": s,
            "gb_per_s": nbytes / 1e9 / s if s > 0 else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d_model", type=int, default=0)
    ap.add_argument("--d_ff", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100,
                    help="steps to run in THIS invocation")
    ap.add_argument("--total_steps", type=int, default=0,
                    help="LR-schedule horizon (defaults to --steps); set it "
                         "when resuming so the schedule stays consistent")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="none",
                    choices=["none", "ruq", "ruq_unsigned", "pann"])
    ap.add_argument("--train_quant", default="",
                    choices=["", "none", "ptq", "qat"],
                    help="none: fp training | ptq: train fp, quantize at "
                         "export | qat: STE fake-quant + EMA activation "
                         "calibration in the train step (default: qat "
                         "when --quant is set)")
    ap.add_argument("--r", type=float, default=2.0)
    ap.add_argument("--act_bits", type=int, default=8)
    ap.add_argument("--weight_bits", type=int, default=8)
    ap.add_argument("--budget_schedule", default="",
                    help="power-annealing knots 'step:bits,...' (bits = "
                         "unsigned-MAC budget, 'fp' = unquantized), e.g. "
                         "'0:fp,40:8,120:6'; replans the layer-wise "
                         "allocator at every knot (core/anneal.py)")
    ap.add_argument("--allocation", default="layerwise",
                    choices=["uniform", "layerwise"],
                    help="how annealed budgets are spent across modules")
    ap.add_argument("--calib_decay", type=float, default=0.99)
    ap.add_argument("--anneal_warmup", type=int, default=0,
                    help="LR re-warmup ramp (steps) after each budget knot")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model_axis", type=int, default=1)
    ap.add_argument("--ckpt_dir", default="")
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        cfg, tcfg, par = build(args)
    except ValueError as e:
        raise SystemExit(f"[train] {e}")
    MD.resolve_device(args.device)
    # always under a mesh, as the reference trains: 1 x 1 in one process
    # (a config with moe_impl="capacity" trains through the capacity
    # dispatch), (world // model_axis, model_axis) under torchrun
    started = not dist.is_initialized()
    try:
        mesh = make_local_mesh(args.model_axis, args.device)
    except ValueError as e:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        raise SystemExit(f"[train] {e}")
    device = compat.rank_device(args.device)
    try:
        with use_mesh(mesh):
            return _run(args, cfg, tcfg, par, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, cfg, tcfg, par, device, mesh) -> dict:
    """The run of ``main`` on this rank, under the ambient ``mesh``; rank 0
    prints the logs and the summary."""
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    # the state and the batch are DTensors on a mesh of several ranks; a
    # one-rank mesh keeps plain tensors (every placement would replicate)
    placed_on = mesh if mesh.size() > 1 else None

    train_quant = resolve_train_quant(args)
    qat = train_quant == "qat"
    annealer = anneal.BudgetAnnealer.from_train_config(cfg, tcfg)
    if annealer is not None:
        say(f"[train] budget schedule {annealer.schedule.describe()} "
            f"({tcfg.budget_allocation} allocation)")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)

    def cfg_for_step(step):
        """The (config, plan, bits) governing ``step``: annealed when a
        schedule is set; stripped of quantization for fp/ptq training."""
        if annealer is not None:
            return annealer.config_at(cfg, step)
        if not qat:
            return anneal.strip_quant(cfg), None, None
        return cfg, None, None

    meta_args = {k: getattr(args, k) for k in TRAIN_ARG_KEYS}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)

    start_step = 0
    last = ck.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is not None:
        # the template holds shapes only; the state is made from the
        # checkpoint, so the params never exist twice
        meta_state = ST.make_train_state(cfg, tcfg, calibrate=qat,
                                         seed=args.seed, device="meta")
        tmpl = convert.train_state_to_reference(meta_state, cfg)
        placed = None
        if placed_on is not None:
            placed = _state_shardings(meta_state.params, cfg, placed_on,
                                      par)[1]
        restored = ck.restore(args.ckpt_dir, last, tmpl, shardings=placed,
                              strict=("calib/",))
        state = convert.train_state_from_reference(restored, cfg, device)
        del restored
        start_step = last
        say(f"[train] resumed from step {last}")
        if start_step >= args.steps:
            raise SystemExit(
                f"[train] checkpoint is already at step {start_step} >= "
                f"--steps {args.steps}; raise --steps to continue or point "
                f"--ckpt_dir at a fresh directory")
    else:
        shardings = None
        if placed_on is not None:
            shardings = _state_shardings(
                MD.init_params(cfg, args.seed, "meta"), cfg, placed_on,
                par)[0]
        state = ST.make_train_state(cfg, tcfg, calibrate=qat,
                                    seed=args.seed, device=device,
                                    shardings=shardings)
    matrix = convert.reference_matrix_mask(state.params, cfg)

    segments = annealer.schedule.segments(start_step, args.steps) \
        if annealer is not None else ((start_step, args.steps, None),)

    monitor = StepMonitor()
    losses = []
    plans_meta = []
    seg_times = []
    checkpoints = []
    tokens_per_step = args.batch * args.seq
    for seg_start, seg_end, seg_bits in segments:
        cfg_seg, plan, bits = cfg_for_step(seg_start)
        if annealer is not None:
            gbf = annealer.gbitflips_per_token(bits)
            label = "fp" if not bits else f"{bits}b"
            say(f"[train] segment [{seg_start}, {seg_end}): "
                f"budget {label}, planned {gbf:.3f} Gbit-flips/token")
            if plan is not None:
                say("[train] " + plan.describe())
            plans_meta.append({"step": seg_start, "bits": bits or 0,
                               "gbitflips_per_token": gbf,
                               "allocation": tcfg.budget_allocation})
        step_s = []
        for step in range(seg_start, seg_end):
            batch = _batch(cfg, data, step, device, placed_on)
            t0 = time.monotonic()
            state, metrics = ST.train_step(state, batch, cfg=cfg_seg,
                                           tcfg=tcfg, par=par, matrix=matrix)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            monitor.record(step, dt)
            step_s.append(dt)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"[train] step {step:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.3f}")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                checkpoints.append(_save(
                    args, cfg, step + 1, state,
                    {"arch": cfg.name, "loss": loss,
                     "train_args": meta_args}, device))
        label = ("fp" if not bits else f"{bits}b") if annealer is not None \
            else train_quant
        seg_times.append({
            "start": seg_start, "end": seg_end, "budget": label,
            "step_ms": [round(1e3 * t, 3) for t in step_s],
            # the first step of a segment pays its one-time costs
            "ms_per_step_after_first": (
                1e3 * sum(step_s[1:]) / (len(step_s) - 1)
                if len(step_s) > 1 else None),
            "tok_per_s": (tokens_per_step * (len(step_s) - 1)
                          / sum(step_s[1:]) if len(step_s) > 1 else None)})

    # deterministic held-out eval at the final operating point: the number
    # launch/export.py must reproduce from the serving artifact
    cfg_final, _, final_bits = cfg_for_step(max(args.steps - 1, 0))
    eval_l = ST.eval_loss(state.params, cfg_final,
                          _placed(make_eval_batch(cfg, args, device),
                                  placed_on), calib=state.calib)
    say(f"[train] eval loss {eval_l:.6f} (held-out batch, final "
        f"operating point)")
    if qat:
        say("[train] " + CAL.describe(state.calib))
    if args.ckpt_dir:
        checkpoints.append(_save(
            args, cfg, args.steps, state,
            {"arch": cfg.name, "loss": losses[-1], "eval_loss": eval_l,
             "final_bits": final_bits or 0, "train_args": meta_args},
            device))
    summary = {"first_loss": losses[0], "last_loss": losses[-1],
               "steps": args.steps, "eval_loss": eval_l,
               "losses": [round(v, 6) for v in losses],
               "losses_exact": losses,
               "plans": plans_meta, **monitor.summary(),
               "device": str(device), "segments": seg_times,
               "calib_seen": CAL.n_seen(state.calib),
               "calib_roles": len(state.calib) if state.calib else 0,
               "checkpoints": [{k: v for k, v in c.items() if k != "path"}
                               for c in checkpoints]}
    if device.type == "cuda":
        summary["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    summary["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    summary["backend"] = dist.get_backend()
    summary["rank"] = rank
    summary["staged_collectives"] = compat.staged_collectives()
    # every rank's own times and memory, rank by rank
    mine = {k: summary.get(k) for k in ("rank", "peak_mem_gb",
                                      "staged_collectives")}
    mine["ms_per_step_after_first"] = [
        seg["ms_per_step_after_first"] for seg in seg_times]
    for r in range(dist.get_world_size()):
        if r == rank:
            print("[train] rank " + json.dumps(mine), flush=True)
        dist.barrier()
    say("[train] " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
