"""Multi-pod dry run of the port (port of ``repro.launch.dryrun``): build
every (architecture x input shape) cell's state on the production meshes,
run one train, prefill or decode step as rank 0 of a fake process group,
prove that the sharding rules are coherent, and record the roofline terms
of the step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out benchmarks/results

It runs on no card, by design, as the reference runs on 512 fake CPU
devices: ``torch.distributed``'s ``fake`` backend in this process, at
world 256 (the (16, 16) ("data", "model") mesh) or 512 (the (2, 16, 16)
("pod", "data", "model") mesh), whose collectives move nothing; the state
lives on the ``meta`` device, so no value exists, and the step runs
eagerly as rank 0. Train and prefill cells place the params, the AdamW
moments and the batch as DTensors by ``dist.sharding.param_specs`` /
``input_sharding`` and run ``launch.steps.train_step`` /
``prefill_step``. Decode cells run ``launch.steps.serve_step`` on rank
0's local shards, as a serve engine under a mesh does
(``dist.local_ops.ServeShards``; the slots' layout of
``dist.sharding.slot_specs``; the store over "model" alone, never FSDP;
a cross-attending config's frontend on the rank's rows, its cross K/V at
the rank's KV heads), on the fp params or, with ``--quant pann_serve``,
on the serving artifact through the 'packed' kernels. A
kernel wrapper handed meta tensors launches nothing: it counts the
kernel's integer operations (``kernels.build.meta_ops``) and returns an
empty output.

Per cell it records, where the reference reads XLA's compiled artifact:

* ``flops_per_device``: the floating-point operations of rank 0's local
  ops (``torch.utils.flop_counter``'s formulas), plus the kernels' integer
  operations. DTensor's own dispatch runs each op once at the global
  shape (on fake tensors, to derive its output's placement) and once on
  the local shards; only the local ops are counted.
* ``bytes_per_device``: each local op's input and output bytes, summed
  (no fusion: an upper bound of the traffic).
* ``collective_bytes_per_device``: the output bytes of each collective
  rank 0 issues (DTensor's functional collectives and the local decode's
  ``torch.distributed`` calls), by the reference's five kinds, and
  ``total``.
* ``argument_size_in_bytes``: each argument's local bytes summed over the
  devices, what the reference's CPU record holds; split in
  ``argument_size_by_part`` (params, moments, the rest).
* ``temp_size_in_bytes``: the peak bytes of the tensors the step's local
  ops made that were alive at once (a dispatch mode that follows each op's
  new output until its Python tensor is freed; PyTorch's ``MemTracker``
  does not follow DTensors' local tensors), and ``output_size_in_bytes``
  the step's returned tensors; both summed over the devices, as the
  reference's CPU totals are.
* ``generated_code_size_in_bytes`` and ``alias_size_in_bytes`` are XLA's
  alone: left out.

The port runs every layer eagerly, so nothing is counted once per loop,
as XLA counts a while body: the probe fields (``*_corrected``) equal the
direct counts, and ``--no-probe`` leaves them out. ``compile_s`` is the
seconds to build the cell's meta state and run its step.

Nothing on these paths reads a value: the step counters are host tensors
(AdamW reads its count to compute the learning rate on the host), and the
quantized store of ``--quant pann_serve`` packs a pinned plane count
(``serving.LADDER_PLANE_COUNT``) instead of reading its codes' peak.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.base import (ModelConfig, ParallelConfig,
                                      QuantConfig, ShapeConfig, TrainConfig)
from repro_torch.core import costs
from repro_torch.dist import compat
from repro_torch.dist import local_ops
from repro_torch.dist import sharding as SH
from repro_torch.dist.constrain import use_mesh
from repro_torch.kernels import build
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.models import model as MD
from repro_torch.models import serving

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# op-name fragments of each kind (c10d's and the functional collectives')
_KIND_OF = (("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("send", "collective-permute"), ("recv", "collective-permute"),
            ("broadcast", "collective-permute"))


def parallel_for(cfg: ModelConfig, kind: str = "train") -> ParallelConfig:
    """FSDP when parameters don't fit otherwise (the reference's rule).

    Training: fp32 params + Adam state (12 B/param) must fit per data
    shard -> FSDP above ~3B params. Prefill: weights are only TP-sharded
    (16-way); FSDP would re-gather them every step, so it is enabled only
    when the TP shard alone exceeds ~8 GB (dbrx, vision-90b). Decode:
    never FSDP, the store over "model" alone, as a serve engine places it
    (the local decode reads whole K rows; ``ServeEngine(mesh=)`` refuses
    FSDP; ROADMAP C19)."""
    if kind == "train":
        return ParallelConfig(fsdp=costs.param_count(cfg) > 3e9,
                              remat="block")
    if kind == "decode":
        return ParallelConfig(fsdp=False, remat="none")
    per_dev = costs.param_count(cfg) * 2 / 16
    return ParallelConfig(fsdp=per_dev > 8e9, remat="none")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The cell's model inputs as meta tensors of their global shapes
    (train / prefill: whole sequences; decode: one new token each)."""
    b = shape.global_batch
    t = 1 if shape.kind == "decode" else shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out = {"tokens": meta((b, t), torch.int64)}
    if shape.kind == "train":
        out["labels"] = meta((b, t), torch.int64)
    if cfg.family == "encdec":
        out["enc_inputs"] = meta((b, cfg.encoder_seq_len, cfg.d_model),
                                 torch.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = meta((b, cfg.num_image_tokens, cfg.d_model),
                                   torch.float32)
    return out


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    """Local bytes of every tensor of ``tree`` (a DTensor's shard)."""
    return sum(_nbytes(t.to_local() if compat.is_dtensor(t) else t)
               for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


def _collective_kind(func) -> Optional[str]:
    name = str(func)
    if not (name.startswith("c10d") or name.startswith("_c10d_functional")):
        return None
    for frag, kind in _KIND_OF:
        if frag in name:
            return kind
    return None


class StepCounter(TorchDispatchMode):
    """The local ops of a step: FLOPs, bytes, collective bytes and the
    live bytes of the tensors they make. An op on DTensors is handed on
    (``NotImplemented``) to DTensor's dispatch, whose local ops come back
    through this mode; ops on fake tensors (DTensor's shape propagation at
    the global shape) are run and not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.live = 0
        self.peak = 0

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        leaves = pytree.tree_leaves((args, kwargs))
        if any(compat.is_dtensor(t) for t in leaves):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in leaves):
            return out
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives[kind] += sum(_nbytes(t) for t in outs)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        inputs = {id(t) for t in ins}
        for t in outs:
            if id(t) in inputs or t._base is not None:
                continue                    # in place, or a view
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._freed, n)
        return out


def measure(fn, parts: dict, n_dev: int) -> dict:
    """Run ``fn()`` (one step) under a ``StepCounter``; its counts, with
    the arguments ``parts`` ({name: tree}) summed over ``n_dev`` devices."""
    build.meta_ops.clear()
    with StepCounter() as c:
        out = fn()
    kernel_ops = sum(build.meta_ops.values())
    coll = dict(c.collectives)
    coll["total"] = sum(coll[k] for k in COLLECTIVES)
    by_part = {k: tree_bytes(v) * n_dev for k, v in parts.items()}
    return {"flops_per_device": float(c.flops + kernel_ops),
            "kernel_int_ops_per_device": dict(build.meta_ops),
            "bytes_per_device": float(c.bytes),
            "collective_bytes_per_device": coll,
            "argument_size_in_bytes": sum(by_part.values()),
            "argument_size_by_part": by_part,
            "temp_size_in_bytes": c.peak * n_dev,
            "output_size_in_bytes": tree_bytes(out) * n_dev}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _host_counters(state: ST.TrainState) -> ST.TrainState:
    """The step counters as host tensors: AdamW reads its count on the
    host for the learning rate, which a meta tensor does not hold."""
    zero = torch.zeros((), dtype=torch.int32)
    return state._replace(step=zero, opt=state.opt._replace(count=zero))


def _placed(batch: dict, mesh) -> dict:
    if mesh is None:
        return batch
    return {k: SH.NamedSharding(mesh, SH.input_sharding(mesh, v.shape)).put(
        v, v.device) for k, v in batch.items()}


def train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, par
               ) -> tuple:
    """(step, argument parts) of one ``train_step`` on meta: params and
    AdamW moments placed by ``param_specs`` on ``mesh`` (plain meta
    tensors without one), the batch by ``input_sharding``."""
    tcfg = TrainConfig()
    shardings = None
    if mesh is not None:
        shardings = SH.to_named(SH.param_specs(
            MD.init_params(cfg, 0, "meta"), mesh, par), mesh)
    state = _host_counters(ST.make_train_state(cfg, tcfg, device="meta",
                                               shardings=shardings))
    batch = _placed(input_specs(cfg, shape), mesh)

    def step():
        return ST.train_step(state, batch, cfg=cfg, tcfg=tcfg, par=par)

    parts = {"params": state.params,
             "moments": (state.opt.mu, state.opt.nu),
             "other": (state.opt.count, state.step, batch)}
    return step, parts


def prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, par) -> tuple:
    params = MD.init_params(cfg, 0, "meta")
    if mesh is not None:
        params = SH.distribute(params, SH.to_named(
            SH.param_specs(params, mesh, par), mesh))
    batch = _placed(input_specs(cfg, shape), mesh)

    def step():
        return ST.prefill_step(params, cfg, batch["tokens"],
                               enc_inputs=batch.get("enc_inputs"),
                               image_embeds=batch.get("image_embeds"))

    return step, {"params": params, "other": batch}


def decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, par,
                serve_quant: bool = False) -> tuple:
    """(step, argument parts) of one ``serve_step`` on rank 0's local
    shards: the fp params or, with ``serve_quant``, the serving artifact
    through the 'packed' kernels, both placed by ``serving_shardings``
    (``param_specs`` but for a MoE block, ROADMAP C15), and the decode
    state in the slots' layout (heads on "model", batch on "data"), made
    at the rank's head counts and batch rows."""
    params = MD.init_params(cfg, 0, "meta")
    if serve_quant:
        params = serving.quantize_params_for_serving(
            params, cfg, serving.ServingQuantSpec(
                pack_planes=True, plane_count=serving.LADDER_PLANE_COUNT))
        cfg = dataclasses.replace(cfg, kernel_backend="packed")
    b = shape.global_batch
    shards, step_cfg = None, cfg
    if mesh is not None:
        named = serving.serving_shardings(params, mesh, par)
        params = serving.local_tree(SH.distribute(params, named))
        shards = local_ops.ServeShards.for_mesh(mesh, cfg, b)
        step_cfg = shards.local_cfg(cfg)
        b = b // shards.data
    kwargs = {k: v for k, v in input_specs(cfg, shape).items()
              if k in ("enc_inputs", "image_embeds")}
    # the cell's context: a windowed layer caches its ring of min(seq,
    # window) rows, as the reference sizes its caches, a global layer seq
    with local_ops.use_shards(shards):      # the rank's heads
        state = MD.init_decode_state(params, step_cfg, b, shape.seq_len,
                                     **kwargs)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int64,
                         device="meta")

    def step():
        return ST.serve_step(params, step_cfg, state, tokens, shards=shards)

    return step, {"params": params, "state": state, "other": tokens}


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh, par,
              serve_quant: bool = False) -> tuple:
    """The cell's (step, argument parts) for its kind; ``mesh`` None runs
    it unsharded on one process."""
    if shape.kind == "train":
        return train_cell(cfg, shape, mesh, par)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh, par)
    return decode_cell(cfg, shape, mesh, par, serve_quant)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None, par=None,
               serve_quant: bool = False) -> dict:
    """``measure`` of the cell's step: on ``mesh`` (under ``use_mesh``) as
    rank 0, or unsharded on this process without one."""
    par = par or ParallelConfig()
    n_dev = 1 if mesh is None else mesh.size()
    with use_mesh(mesh):
        fn, parts = cell_step(cfg, shape, mesh, par, serve_quant)
        return measure(fn, parts, n_dev)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quant_mode: str = "none", verbose: bool = True,
             probe: bool = True, reduced: bool = False) -> dict:
    """One cell on the production mesh of a fake group started here;
    returns the roofline record. ``reduced`` swaps in the tiny
    same-family config (the mesh and the sharding rules are the same)."""
    shape = configs.SHAPES_BY_NAME[shape_name]
    serve_quant = quant_mode == "pann_serve"
    qc = QuantConfig(mode="none" if serve_quant else quant_mode,
                     qat=(shape.kind == "train"))
    cfg = configs.get_config(arch, dtype="bfloat16", quant=qc)
    # the parallel strategy of the FULL config, so a reduced run takes the
    # same (FSDP or not) sharding path as the real cell
    par = parallel_for(cfg, shape.kind)
    if reduced:
        cfg = configs.reduced(cfg)
    mesh_name = "multi" if multi_pod else "single"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": "pure full attention (DESIGN.md §5)"}
    fake_process_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.time()
        counts = count_cell(cfg, shape, mesh, par, serve_quant)
        t1 = time.time()
    finally:
        dist.destroy_process_group()
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": mesh.size(), "quant": quant_mode, "fsdp": par.fsdp,
        "compile_s": round(t1 - t0, 1), **counts,
        "model_flops_global": costs.model_flops(cfg, shape),
        "params": costs.param_count(cfg),
        "params_active": costs.param_count(cfg, active_only=True),
    }
    if probe:   # eager: every layer counted, nothing to fold back in
        record["flops_per_device_corrected"] = record["flops_per_device"]
        record["bytes_per_device_corrected"] = record["bytes_per_device"]
        record["collective_bytes_corrected"] = \
            record["collective_bytes_per_device"]["total"]
    if verbose:
        coll = record["collective_bytes_per_device"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: ran in "
              f"{record['compile_s']}s")
        print(f"  memory: temp={record['temp_size_in_bytes']} "
              f"args={record['argument_size_in_bytes']} "
              f"out={record['output_size_in_bytes']}")
        print(f"  cost: flops/dev={record['flops_per_device']:.3e} "
              f"bytes/dev={record['bytes_per_device']:.3e}")
        print("  collectives/dev: " + ", ".join(
            f"{k}={v:.3e}" for k, v in coll.items() if v))
    return record


ALL_CELLS = [(a, s.name) for a in configs.ARCH_NAMES for s in configs.SHAPES]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--quant", default="none",
                    choices=["none", "ruq", "ruq_unsigned", "pann",
                             "pann_serve"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family configs (a quick run of the "
                         "same meshes and sharding rules)")
    ap.add_argument("--no-probe", action="store_true",
                    help="leave out the *_corrected fields (equal to the "
                         "direct counts in the port)")
    ap.add_argument("--retry-failed-probes", action="store_true",
                    help="re-run cells whose record carries probe_error")
    ap.add_argument("--out", default="benchmarks/results")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = ALL_CELLS
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    tag = args.mesh + ("" if args.quant == "none" else f"_{args.quant}") \
        + ("_reduced" if args.reduced else "")
    path = os.path.join(args.out, f"dryrun_{tag}.json")

    # resumable: cells already recorded are skipped, the file is written
    # after every cell. A cell counts as done if it has what THIS run would
    # add (a record without probe fields is re-run when probing is asked);
    # a stale record is replaced only once its re-run succeeds
    def cell_complete(r) -> bool:
        if "skipped" in r:
            return True
        if r.get("mesh", "single") == "single" and not args.no_probe:
            return ("flops_per_device_corrected" in r
                    or ("probe_error" in r
                        and not args.retry_failed_probes))
        return True

    def rec_key(r):
        return (r["arch"], r["shape"], r.get("mesh", "single"))

    records, failures = [], []
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        records = prev.get("records", [])
        print(f"[dryrun] resuming: {len(records)} records already present")
    done = {rec_key(r) for r in records if cell_complete(r)}

    def flush():
        # atomic: a crash mid-write never corrupts the resume file
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"records": records, "failures": failures}, f,
                      indent=1)
        os.replace(tmp, path)

    for arch, shape in cells:
        for mp in meshes:
            key = (arch, shape, "multi" if mp else "single")
            if key in done:
                continue
            try:
                rec = run_cell(arch, shape, mp, args.quant,
                               probe=not mp and not args.no_probe,
                               reduced=args.reduced)
                records[:] = [r for r in records if rec_key(r) != key]
                records.append(rec)
                done.add(key)
            except Exception as e:  # noqa: BLE001 — report, keep going
                failures.append((arch, shape, mp, repr(e)[:400]))
                print(f"[dryrun][FAIL] {arch} x {shape} x "
                      f"{'multi' if mp else 'single'}: {e!r}")
            flush()

    print(f"[dryrun] wrote {path}: {len(records)} records, "
          f"{len(failures)} failures")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
