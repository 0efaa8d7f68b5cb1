"""ServeEngine: one checkpoint, a ladder of PANN operating points, and a
rung chosen per request (port of ``repro.serve_engine.engine``).

The ladder is quantized once into one ``WeightStore``; every rung is a view
whose per-rung values (``plane_shift``, activation and cache level counts)
are device tensors read by the kernels. So one step function serves every
rung, switching rungs is picking another view, and the decode loop makes
no host round trip: sampled tokens stay on the device until a response is
finalized.

The compiled decode step. The JAX package traces ``decode_step`` once per
engine (``jax.jit``) and proves after traffic that nothing retraced. The
port's counterpart is a CUDA graph: ``warmup()`` captures, for every rung
and every decode-state *slot*, one graph of the whole step (the model, the
copy of the new cache lengths, position and recurrent states back into
the slot, and the greedy token written into the slot's token buffer), and
every decode step of ``generate``, ``prefill_wave`` and ``decode_stream``
on the card is a replay of one of them. A graph replays fixed pointers,
so a slot owns its decode state and token buffer for the engine's life
and starting a wave zeroes them in place. A cross-attending config
(encoder-decoder, vision) takes its frontend from ``frontend_kwargs_fn``
at every wave's start: the stem and the encoder run eagerly, between
replays, at the wave's rung, and each cross_attn layer's K/V are copied
into the slot's fixed buffers, which the graphs read. Nothing is
captured after warmup (``assert_no_recompile``); a step whose graph
warmup did not capture raises, it never runs eagerly on the card. The
CPU has no graphs: a CPU engine runs the same slot step eagerly.

Lanes (one per in-flight wave) advance round-robin one decode step each, so
different rungs interleave between steps of one process. The fleet
(``serve_engine.fleet``) moves lanes between engines: an engine steps only
lanes in its own slots, so it ``adopt``s a lane another engine built (the
state copied into one of its slots, the donor's slot freed), rebuilds one
from its token prefix (``prefill_wave(prefix_rows=...)``), and
``release``s the slot of a lane it detaches without finalizing it.

Under a device mesh (``ServeEngine(mesh=..., par=...)``, any family on a
("data", "model") ``DeviceMesh``, one engine a rank) the store is
quantized once on the whole weights and each rank keeps its shard
(``serving.device_put_weight_store``); the decode step runs on the rank's
local shards with its collectives spelled out (``dist.local_ops``): the
rank's heads, columns or K rows of each projection and its batch rows,
its slots holding its heads and rows (``dist.sharding.slot_specs``: the
KV caches', the cross K/V's and the recurrent states' heads). A wave's
frontend runs on the rank's rows of its input (the conv stem whole on
every rank, the encoder on the rank's heads). The tokens, the logits and
everything the engine does between steps are the whole batch's, and every
rank's equal a one-rank engine's bit for bit (a MoE model's experts
split by expert, its router whole: ``models.mlp.apply_moe``).
Such steps run eagerly: with more than one rank a step waits on its
collectives, which the host-staged group of two ranks on one card runs on
the host (graph capture under NCCL is ROADMAP A10.4).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core import policy as pol
from repro_torch.core import power as pw
from repro_torch.dist import local_ops
from repro_torch.kernels import dispatch
from repro_torch.models import model as MD
from repro_torch.models import rwkv as R
from repro_torch.models import serving
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serve_engine.ladder import build_ladder, select_rung
from repro_torch.serve_engine.scheduler import (Request, Response, Scheduler,
                                                Wave)

Tensor = torch.Tensor

# the refusal of backend=None (the reference's float dequant path, which
# ignores a rung's plane_shift: ROADMAP C6), by the engine and the fleet
NO_BACKEND = (
    "ServeEngine serves its weight store through a kernel backend ('ref' | "
    "'fused' | 'packed'), not backend=None; the legacy float dequant is "
    "reached through models.model.forward / decode_step on an artifact with "
    "cfg.kernel_backend None")


def serve_shards(cfg: ModelConfig, mesh, par,
                 max_batch: int) -> local_ops.ServeShards:
    """This rank's ``ServeShards`` of a serve or encode engine on
    ``mesh``; raises ``ValueError`` naming ROADMAP A10 on what the local
    decode does not split: FSDP, a "model" axis that does not divide the
    KV heads, the experts, the SSM heads or the RWKV heads, a batch the
    "data" axis does not divide."""
    if par is not None and par.fsdp:
        raise ValueError("a serving mesh shards the store over 'model' "
                         "only: par.fsdp would re-gather every weight every "
                         "step (ROADMAP A10)")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    m = sizes.get("model", 1)
    split = {"SSM heads": S.n_heads(cfg) if cfg.family == "hybrid"
             else 0,
             "RWKV heads": cfg.d_model // R.HEAD_DIM
             if cfg.family == "ssm" else 0,
             "experts": cfg.moe.num_experts if cfg.family == "moe"
             else 0}
    if cfg.family != "ssm":
        split["KV heads"] = cfg.num_kv_heads
    for what, n in split.items():
        if n % m:
            raise ValueError(
                f"a 'model' axis of {m} does not divide {cfg.name}'s "
                f"{n} {what}: each rank serves whole heads and an "
                "even share of every split (ROADMAP A10)")
    if max_batch % sizes.get("data", 1):
        raise ValueError(
            f"max_batch {max_batch} is no multiple of the 'data' axis "
            f"{sizes.get('data', 1)} (ROADMAP A10)")
    return local_ops.ServeShards.for_mesh(mesh, cfg, max_batch)


def check_shards(view, shards: local_ops.ServeShards) -> None:
    """Every projection of a placed rung view is split over "model" but
    the conv stem's (a width the axis does not divide would stay whole on
    every rank, which the local decode cannot read). The stem is whole on
    every rank by design: ``dist.sharding.param_specs`` names it neither
    column- nor row-parallel, and each rank runs it on its own rows."""
    def walk(node, trail):
        if isinstance(node, dict):
            w_q = node.get("w_q")
            if w_q is not None and trail[:1] != ("conv_stem",) and not any(
                    p.is_shard() for p in w_q.placements):
                raise ValueError(
                    f"{'.'.join(trail)}: {tuple(w_q.shape)} is not split "
                    f"over the {shards.model}-way 'model' axis (ROADMAP "
                    "A10)")
            for key, v in node.items():
                walk(v, trail + (key,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, trail + (str(i),))

    if shards.model > 1:
        walk(view, ())


@dataclasses.dataclass
class Slot:
    """A decode state with fixed buffers: the caches and position a graph
    reads and writes in place, and the (max_batch, 1) int64 token buffer
    it reads its input from and writes its greedy token into."""
    index: int
    state: MD.DecodeState
    tok: Tensor
    busy: bool = False


@dataclasses.dataclass
class Lane:
    """One in-flight wave: the slot holding its decode state and the
    tokens grown so far (device tensors).

    Public because the fleet (``serve_engine.fleet``) moves lanes between
    engines: a prefill host builds the lane, a decode host ``adopt``s it
    (the state copied into one of its own slots, whose graphs it
    replays), and a restarted or switched-to host rebuilds it from the
    token prefix (``prefill_wave(prefix_rows=...)``: the decode state is a
    function of the prefix, so the rebuilt lane continues bit for bit). A
    lane holds its slot until the engine finalizes or ``release``s it.
    ``done`` counts tokens generated before this lane's state was
    (re)built; ``generated`` holds only the tokens grown since."""
    wave: Wave
    slot: Slot
    generated: list          # [(max_batch, 1), ...] greedy tokens
    steps_left: int
    done: int = 0

    def generated_rows(self) -> np.ndarray:
        """(n_requests, n_generated_since_build) int32 token matrix: what
        the fleet appends to its per-request records when this lane
        finishes, switches rung, or dies with its host."""
        n = len(self.wave.requests)
        if not self.generated:
            return np.zeros((n, 0), np.int32)
        return torch.cat(self.generated, dim=1)[:n].cpu().numpy().astype(
            np.int32)


def _tensors(tree) -> list:
    """The tensors of a decode state (nested tuples, NamedTuples and
    lists; None holds none), in order."""
    if tree is None:
        return []
    if isinstance(tree, Tensor):
        return [tree]
    return [t for node in tree for t in _tensors(node)]


class ServeEngine:
    """Multi-operating-point PANN serving runtime (see module docstring).

    Pass ``params`` (fp32, quantized here; the engine takes them over and
    drops each fp weight once it is quantized) or a prebuilt
    ``weight_store``. ``allocation`` is 'uniform' (one (b~x, R) per rung)
    or 'layerwise' (a per-module PolicyTree per rung at the same total
    power). ``cache_bits`` is None (fp KV cache), an int in [2, 7] (every
    rung's cache width), or 'auto' (each rung picks: a uniform rung caches
    at its own b~x, a layerwise rung lets the allocator trade cache bits
    against weight bits under one budget). ``slots`` is the number of
    decode states, hence of lanes in flight, that ``warmup`` captures
    graphs for: the default covers ``generate``'s default ``max_lanes``,
    and ``decode_stream`` uses one. ``frontend_kwargs_fn(batch)`` returns
    the ``init_decode_state`` keyword (``enc_inputs`` or ``image_embeds``:
    a numpy array or tensor, 3-D stub embeddings or raw 4-D input) of a
    wave of ``batch`` rows; an encoder-decoder or vision config needs it.
    ``device`` defaults to 'cuda' and raises without a card; the CPU runs
    only when asked for (the plain kernel versions). ``autotune`` measures
    and caches the K split of every distinct projection shape of the
    views at ``max_batch`` rows before ``warmup`` captures
    (``kernels.autotune``; a backend other than 'ref'). ``mesh`` (a
    ("data", "model") ``DeviceMesh``) and ``par`` (a ``ParallelConfig``
    without FSDP) serve the model on the mesh's ranks (module docstring);
    every rank builds its engine from the same params or store and is
    handed the same whole frontend input."""

    def __init__(self, cfg: ModelConfig, params: Any = None,
                 ladder_bits: Sequence[int] = (2, 3, 4, 6),
                 max_batch: int = 4, max_len: int = 64,
                 mse_dim: Optional[float] = None,
                 allocation: str = "uniform",
                 backend: str = "packed",
                 cache_bits: Any = None,
                 weight_store: Optional[serving.WeightStore] = None,
                 slots: int = 2,
                 device="cuda",
                 frontend_kwargs_fn: Optional[Callable[[int], dict]] = None,
                 autotune: bool = False,
                 artifact_format: str = "views",
                 mesh=None, par=None):
        # the ladder is always one weight store with zero-copy rung views;
        # the reference's per-rung 'legacy' format is refused, as there
        if artifact_format != "views":
            raise ValueError(
                f"artifact_format {artifact_format!r} is gone: the per-rung "
                "'legacy' materialization was retired — 'views' (one weight "
                "store, zero-copy rung views) is the only format. Budget "
                "snapping drift is bounded by benchmarks/artifact_parity.py; "
                "drop the artifact_format argument.")
        self.artifact_format = artifact_format
        self.device = MD.resolve_device(device)
        if (params is None) == (weight_store is None):
            raise ValueError("pass exactly one of params (quantize here) or "
                             "weight_store (serve a prebuilt store)")
        if cfg.family in ("encdec", "vlm") and frontend_kwargs_fn is None:
            raise ValueError(
                f"{cfg.family} decode needs a frontend; pass "
                "frontend_kwargs_fn(batch) -> init_decode_state kwargs")
        self._frontend_kwargs_fn = frontend_kwargs_fn
        # the cache STRUCTURE is fixed on the config (7 planes for 'auto');
        # per-rung widths ride in the views as data (k_nlvl / v_nlvl), so
        # one step function, one graph per slot, serves the whole ladder
        if cache_bits is not None and cache_bits != "auto":
            cache_bits = int(cache_bits)
            if not 2 <= cache_bits <= 7:
                raise ValueError(f"cache_bits must be in [2, 7], got "
                                 f"{cache_bits}")
        self.cache_bits = cache_bits
        if cache_bits is not None:
            cfg = dataclasses.replace(
                cfg, cache_bits=7 if cache_bits == "auto" else cache_bits)
        if backend is None:
            raise ValueError(NO_BACKEND)
        self.backend = dispatch.parse_backend(backend)
        cfg = dataclasses.replace(cfg, kernel_backend=self.backend)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.allocation = allocation
        self.mesh = mesh
        self._shards = (None if mesh is None
                        else serve_shards(cfg, mesh, par, self.max_batch))
        # the per-module MAC profile: feeds the layerwise allocator and the
        # per-module energy breakdown on every response
        self.profile = costs.module_cost_profile(cfg)
        # "auto" + layerwise: the allocator sees the cache roles as
        # pseudo-modules and spends ONE budget across weights and cache
        alloc_profile = self.profile
        if cache_bits == "auto" and allocation == "layerwise":
            alloc_profile = self.profile + costs.cache_cost_modules(cfg)
        self.ladder = build_ladder(ladder_bits,
                                   d=float(mse_dim or cfg.d_model),
                                   allocation=allocation,
                                   profile=alloc_profile)
        self.rungs = {op.bits: op for op in self.ladder}
        # per-rung cache width: an int pins the rung's k_nlvl / v_nlvl;
        # None defers to the rung's PolicyTree cache-role overrides
        self._cache_bits_by_rung: dict[int, Optional[int]] = {}
        if cache_bits is not None:
            for op in self.ladder:
                if cache_bits != "auto":
                    self._cache_bits_by_rung[op.bits] = cache_bits
                elif op.tree is not None and pol.tree_cache_bits(op.tree):
                    self._cache_bits_by_rung[op.bits] = None
                else:
                    self._cache_bits_by_rung[op.bits] = min(
                        int(op.b_x_tilde), 7)
        rung_specs = {op.bits: (op.tree if op.tree is not None
                                else (op.r, op.b_x_tilde))
                      for op in self.ladder}
        if weight_store is not None:
            missing = [b for b in rung_specs if b not in weight_store.views]
            if missing:
                raise ValueError(
                    f"weight_store has no view for rung(s) {missing}; "
                    f"available: {sorted(weight_store.views)}")
            ws = serving.device_put_weight_store(
                serving.WeightStore(
                    store=weight_store.store,
                    views={b: weight_store.views[b] for b in rung_specs}),
                mesh=mesh, par=par)
        else:
            spec = serving.ServingQuantSpec(
                pack_planes=self.backend == "packed",
                cache_bits=self._cache_bits_by_rung or None)
            ws = serving.build_weight_store(params, cfg, rung_specs, spec,
                                            mesh=mesh, par=par)
        self.weight_store = ws.store
        self.variants = ws.views
        # what a step reads: the views themselves, or under a mesh each
        # rank's local shards of them (views of the rank's store shards)
        # under the config of its heads
        self._views = {b: serving.local_tree(v)
                       for b, v in self.variants.items()}
        self._step_cfg = cfg
        if self._shards is not None:
            self._step_cfg = self._shards.local_cfg(cfg)
            check_shards(self.variants[self.ladder[0].bits], self._shards)
        table = self._views[self.ladder[0].bits]["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"weight store lives on {table.device}, engine "
                             f"device is {self.device}")
        if autotune and self.backend != "ref":
            self._autotune_projections()
        self.scheduler = Scheduler(self.ladder, self.max_batch)
        self.steps_by_rung = {op.bits: 0 for op in self.ladder}
        self.rung_switches = 0
        self._last_step_bits: Optional[int] = None
        self._macs_by_ctx: dict[int, Any] = {}
        # decode steps replay CUDA graphs on the card; the CPU runs them,
        # as does a mesh of more than one rank (its steps wait on their
        # collectives: ROADMAP A10.4 has capturing them under NCCL)
        self.graphed = self.device.type == "cuda" and (
            mesh is None or mesh.size() == 1)
        self._slots = [self._new_slot(i) for i in range(int(slots))]
        self._steps: dict[tuple[int, int], Callable[[], Tensor]] = {}
        self._pool = None
        self._stream = None
        self.graphs_captured = 0
        self.compilations_after_warmup: Optional[int] = None

    # -- offline autotuning -------------------------------------------------

    def _autotune_projections(self) -> None:
        """Tune every distinct projection shape (K, N, plane count) of the
        views once, at the engine's decode row count, walking the port's
        per-layer layout of the top rung's view (every plane live, so the
        launches that move the most bytes decide). Every rung's launches
        share the shape and so the split. Idempotent: a cached shape
        short-circuits inside ``autotune.tune``."""
        seen: set = set()

        def walk(node):
            if isinstance(node, dict):
                if "w_q" in node:
                    planes = node.get("w_planes_pos")
                    key = (tuple(node["w_q"].shape),
                           None if planes is None else planes.shape[-3])
                    if key not in seen:
                        seen.add(key)
                        dispatch.tune_projection(self.max_batch, node,
                                                 self.backend)
                    return
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)

        walk(self._views[self.ladder[-1].bits])

    # -- the compiled decode step -------------------------------------------

    def _frontend(self) -> dict:
        """A wave's ``init_decode_state`` keyword from
        ``frontend_kwargs_fn``, as tensors on the engine's device."""
        if self._frontend_kwargs_fn is None:
            return {}
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self._frontend_kwargs_fn(self.max_batch).items()}

    def _new_slot(self, index: int) -> Slot:
        rows = self.max_batch
        if self._shards is not None:
            rows = self._shards.rows.stop - self._shards.rows.start
        with local_ops.use_shards(self._shards):   # the rank's heads
            state = MD.init_decode_state(self._views[self.ladder[0].bits],
                                         self._step_cfg, rows, self.max_len,
                                         **self._frontend())
        tok = torch.zeros((self.max_batch, 1), dtype=torch.int64,
                          device=self.device)
        return Slot(index=index, state=state, tok=tok)

    @staticmethod
    def _reset(slot: Slot) -> None:
        """Zero the slot's caches, position and token buffer in place: with
        the cross K/V of ``_load_frontend`` it then equals a fresh
        ``init_decode_state`` bit for bit."""
        for t in _tensors((slot.state.caches, slot.state.position)):
            t.zero_()
        slot.tok.zero_()

    def _load_frontend(self, bits: int, slot: Slot) -> None:
        """A new wave's cross-attention source: the frontend run eagerly
        through the stem and the encoder of rung ``bits``' view (the
        frontend side quantized at the decode rung, as the reference's
        ``_init_state``), each cross_attn layer's K/V written into the
        slot's own buffers with ``copy_``, so the captured graphs read
        them; a new tensor assigned to the state would leave the graphs
        reading the last wave's. Under a mesh each rank runs the frontend
        on its rows of the wave's input and writes its rows and KV heads
        (``models.model.frontend_cross_kv``)."""
        if slot.state.cross_kv is None:
            return
        with local_ops.use_shards(self._shards):   # the rank's rows, heads
            cross = MD.frontend_cross_kv(self._views[bits], self._step_cfg,
                                         **self._frontend())
        for buf, new in zip(slot.state.cross_kv, cross, strict=True):
            if buf is None:
                continue
            for b, n in zip(buf, new):
                if b.shape != n.shape:
                    raise ValueError(
                        f"frontend gives cross K/V of shape "
                        f"{tuple(n.shape)}; the engine's slots hold "
                        f"{tuple(b.shape)}")
                b.copy_(n)

    def _slot_step(self, bits: int, slot: Slot) -> Tensor:
        """One decode step of ``slot`` at rung ``bits``, in place: the
        model (``MD.decode_step``, which writes the new token's K/V into
        the slot's caches), every other leaf of the new state (cache
        lengths, the position, the recurrent layers' states) copied back
        into the slot's buffers, and the greedy token over the first
        ``vocab_size`` logits written into the slot's token buffer. Returns
        the logits. This is the work one graph replays."""
        with local_ops.use_shards(self._shards):
            logits, new = MD.decode_step(self._views[bits], self._step_cfg,
                                         slot.state, slot.tok)
        for old, out in zip(_tensors(slot.state), _tensors(new),
                            strict=True):
            if out is not old:
                old.copy_(out)
        slot.tok.copy_(self._greedy(logits))
        return logits

    def _prepare_capture(self) -> None:
        """Run one eager step per rung on the capture stream before any
        capture. It builds the kernels and resolves their entry points,
        fills the attention kernel's cluster-occupancy cache, and creates
        the capture stream's zeroed split-K scratch of the decode kernels
        (``kernels.pann_matmul.decode_scratch``, one pair per stream) at
        its largest size, so that no capture allocates it from the graph's
        pool, where a memset node would zero it on every replay. The
        kernels leave that scratch zero after each launch, which is what
        makes replays that share it safe."""
        self._stream = torch.cuda.Stream(self.device)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        slot = self._slots[0]
        with torch.cuda.stream(self._stream):
            for op in self.ladder:
                self._reset(slot)
                self._slot_step(op.bits, slot)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        torch.cuda.synchronize(self.device)

    def _capture(self, bits: int, slot: Slot) -> Callable[[], Tensor]:
        """The CUDA graph of ``slot``'s step at rung ``bits``, captured on
        the engine's capture stream into the pool all its graphs share
        (they replay one after another on one stream); returns its replay.
        A replay's logits are valid until the next replay of any of the
        engine's graphs."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            logits = self._slot_step(bits, slot)
        self.graphs_captured += 1

        def replay() -> Tensor:
            graph.replay()
            return logits

        return replay

    def warmup(self) -> None:
        """Capture the decode step of every (rung, slot) before traffic;
        the CPU has nothing to capture. A second call captures nothing."""
        if self.compilations_after_warmup is not None:
            return
        if self.graphed:
            self._prepare_capture()
            for slot in self._slots:
                for op in self.ladder:
                    self._steps[(op.bits, slot.index)] = self._capture(
                        op.bits, slot)
        self.compilations_after_warmup = self.graphs_captured

    def assert_no_recompile(self) -> None:
        """After serving: no graph was captured past warmup."""
        if self.compilations_after_warmup is None:
            raise RuntimeError("call warmup() first")
        if self.graphs_captured > self.compilations_after_warmup:
            raise AssertionError(
                f"decode step captured while serving: "
                f"{self.compilations_after_warmup} -> {self.graphs_captured}"
                " graphs")

    # -- decode plumbing ----------------------------------------------------

    def _acquire(self) -> Slot:
        """A free slot, zeroed for a new wave."""
        for slot in self._slots:
            if not slot.busy:
                slot.busy = True
                self._reset(slot)
                return slot
        raise ValueError(
            f"all {len(self._slots)} decode-state slots are in flight; "
            f"warmup() captures graphs for ServeEngine(slots=...) slots")

    def _owns(self, slot: Slot) -> bool:
        return any(s is slot for s in self._slots)

    def _check_own(self, lane: Lane) -> None:
        if not self._owns(lane.slot):
            raise ValueError(
                "the lane's decode state is in another engine's slot; this "
                "engine's graphs replay its own slots: adopt() it first")

    def adopt(self, lane: Lane) -> None:
        """Move a lane another engine built into one of this engine's free
        slots: its state is copied in place, in the order the graphs read
        it (caches, position, token buffer, the cross K/V where present;
        a recurrent layer's state is its cache), and the donor's slot is
        freed. A lane already in this engine's slot stays. The engines
        must share the config, ``max_batch`` and ``max_len``."""
        donor = lane.slot
        if self._owns(donor):
            return

        def read_order(s: Slot) -> list:
            return _tensors((s.state.caches, s.state.position)) + [s.tok] \
                + _tensors(s.state.cross_kv)

        slot = self._acquire()
        src, dst = read_order(donor), read_order(slot)
        if len(src) != len(dst) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(src, dst)):
            slot.busy = False
            raise ValueError("lane's decode state does not fit this "
                             "engine's slots (config, max_batch, max_len)")
        for a, b in zip(dst, src):
            a.copy_(b)
        donor.busy = False
        lane.slot = slot

    def release(self, lane: Lane) -> None:
        """Free the lane's slot without finalizing it: the lane finished
        elsewhere, switched rung, or died with its host."""
        self._check_own(lane)
        lane.slot.busy = False

    def _run_step(self, bits: int, slot: Slot) -> Tensor:
        """One decode step of ``slot`` at rung ``bits``: a replay on the
        card, the eager slot step on the CPU. Returns the logits."""
        if self.graphed:
            step = self._steps.get((bits, slot.index))
            if step is None:
                raise ValueError(
                    f"no decode graph for rung {bits}, slot {slot.index}: "
                    "call warmup() before serving on the card")
        else:
            step = functools.partial(self._slot_step, bits, slot)
        if self._last_step_bits is not None and bits != self._last_step_bits:
            self.rung_switches += 1
        self._last_step_bits = bits
        self.steps_by_rung[bits] += 1
        return step()

    def _greedy(self, logits):
        return torch.argmax(logits[:, :, :self.cfg.vocab_size], dim=-1)

    def _teacher_force(self, bits: int, slot: Slot, prompts) -> None:
        """Feed a (max_batch, L) prefix token by token through the slot;
        its token buffer then holds the greedy token after the prefix."""
        for i in range(prompts.shape[1]):
            slot.tok.copy_(prompts[:, i:i + 1])
            self._run_step(bits, slot)

    def _pad_rows(self, rows: np.ndarray) -> np.ndarray:
        """Pad the request dim to max_batch (repeating row 0)."""
        if rows.shape[0] == self.max_batch:
            return rows
        pad = np.broadcast_to(rows[:1], (self.max_batch - rows.shape[0],)
                              + rows.shape[1:])
        return np.concatenate([rows, pad], axis=0)

    def _rows_tensor(self, rows: np.ndarray):
        return torch.as_tensor(self._pad_rows(np.asarray(rows, np.int64)),
                               device=self.device)

    def prefill_wave(self, wave: Wave,
                     prefix_rows: Optional[np.ndarray] = None) -> Lane:
        """Teacher-force a wave's prompts in a free slot and return its
        lane (the first generated token included).

        ``prefix_rows`` (n_requests, prompt_len + done) replays a lane
        that already generated ``done`` tokens elsewhere: on a host
        restart or a governor-forced rung switch the fleet rebuilds the
        lane here from prompt + tokens so far, and since the decode state
        is a function of the token prefix, the rebuilt lane continues bit
        for bit. The replay runs at THIS wave's rung: switching is
        replaying into another rung's view."""
        reqs = wave.requests
        gen_max = max(r.max_new_tokens for r in reqs)
        if prefix_rows is None:
            rows, done = np.stack([r.prompt for r in reqs]), 0
        else:
            rows = np.asarray(prefix_rows, np.int32)
            done = rows.shape[1] - reqs[0].prompt_len
            if not 0 <= done < gen_max:
                raise ValueError(
                    f"replay prefix carries {done} generated tokens, "
                    f"wave needs 0 <= done < {gen_max}")
        if reqs[0].prompt_len + gen_max > self.max_len:
            raise ValueError(
                f"prompt_len {reqs[0].prompt_len} + gen {gen_max} exceeds "
                f"engine max_len {self.max_len}")
        rows = self._rows_tensor(rows)
        slot = self._acquire()
        try:
            self._load_frontend(wave.rung.bits, slot)
            self._teacher_force(wave.rung.bits, slot, rows)
        except BaseException:
            slot.busy = False
            raise
        return Lane(wave=wave, slot=slot, generated=[slot.tok.clone()],
                    steps_left=gen_max - done - 1, done=done)

    def step_lane(self, lane: Lane) -> bool:
        """Advance a lane one decode step; True when the lane is finished.
        The lane must be in one of this engine's slots (``adopt``)."""
        self._check_own(lane)
        if lane.steps_left > 0:
            self._run_step(lane.wave.rung.bits, lane.slot)
            lane.generated.append(lane.slot.tok.clone())
            lane.steps_left -= 1
        return lane.steps_left <= 0

    # -- energy accounting --------------------------------------------------

    def _rung_tree(self, rung) -> pol.PolicyTree:
        """The rung's PolicyTree: its layerwise tree, or the uniform lift
        of its (b~x, R) point; with a pinned cache width, plus explicit
        cache-role overrides at that width."""
        if rung.tree is not None:
            tree = rung.tree
        else:
            tree = pol.uniform_policy(pol.ModuleQuant(
                mode="pann", r=rung.r, b_x_tilde=rung.b_x_tilde))
        cb = self._cache_bits_by_rung.get(rung.bits)
        if cb is None:          # cache off, or policy-driven (tree has them)
            return tree
        ov = dict(tree.overrides)
        for role in pol.CACHE_PATHS:
            ov[role] = pol.cache_module_quant(cb)
        return pol.policy_tree(tree.default, ov)

    def ledger_for(self, rung, ctx: int) -> pw.EnergyLedger:
        macs = self._macs_by_ctx.get(ctx)
        if macs is None:
            macs = self._macs_by_ctx.setdefault(
                ctx, costs.macs_per_token(self.cfg, context_len=ctx))
        total, breakdown = pol.tree_power_per_token(
            self.profile, self._rung_tree(rung), act_macs=macs.act_macs)
        if rung.tree is None and self.cache_bits is None:
            # uniform rung, fp cache: the headline number of the JAX
            # package, bit for bit (same formula; the breakdown itemizes it)
            total = pw.pann_token_bitflips(macs, rung.r, rung.b_x_tilde)
        return pw.EnergyLedger(total, breakdown_per_token=breakdown)

    def token_flips(self, bits: int, ctx: int) -> float:
        """Estimated bit flips of ONE token at rung ``bits`` with context
        ``ctx``."""
        return self.ledger_for(self.rungs[bits], ctx).bitflips_per_token

    def _finalize(self, lane: Lane) -> list[Response]:
        gen = torch.cat(lane.generated, dim=1).cpu().numpy()
        lane.slot.busy = False
        rung = lane.wave.rung
        out = []
        for i, req in enumerate(lane.wave.requests):
            toks = [int(t) for t in gen[i, :req.max_new_tokens]]
            ledger = self.ledger_for(rung, req.prompt_len
                                     + req.max_new_tokens)
            ledger.charge(len(toks))
            meta = {
                "rung_bits": rung.bits,
                "b_x_tilde": rung.b_x_tilde,
                "r": rung.r,
                "allocation": rung.allocation,
                "power_per_weight_mac": rung.power,
                **ledger.report(),
            }
            if self.cache_bits is not None:
                meta["cache_bits"] = pol.tree_cache_bits(
                    self._rung_tree(rung))
            out.append(Response(uid=req.uid, tokens=toks,
                                rung_bits=rung.bits, metadata=meta))
        return out

    # -- serving loops ------------------------------------------------------

    def generate(self, requests: Sequence[Request], max_lanes: int = 2
                 ) -> list[Response]:
        """Serve a batch of mixed-budget requests to completion: lanes
        advance round-robin one decode step at a time, and a finished lane
        frees a slot for the scheduler's next wave."""
        if max_lanes > len(self._slots):
            raise ValueError(
                f"max_lanes={max_lanes} needs {max_lanes} decode-state "
                f"slots; warmup() captures graphs for {len(self._slots)} "
                "(ServeEngine(slots=...))")
        resolved = []
        for r in requests:
            if r.prompt_len + r.max_new_tokens > self.max_len:
                raise ValueError(
                    f"request {r.uid}: prompt_len {r.prompt_len} + gen "
                    f"{r.max_new_tokens} exceeds engine max_len "
                    f"{self.max_len}")
            resolved.append(
                select_rung(self.ladder, r.power_budget_bits, r.min_score))
        for r, rung in zip(requests, resolved):
            self.scheduler.submit(r, rung=rung)
        lanes: list[Lane] = []
        responses: list[Response] = []
        try:
            while lanes or self.scheduler.pending():
                while len(lanes) < max_lanes:
                    wave = self.scheduler.next_wave()
                    if wave is None:
                        break
                    lanes.append(self.prefill_wave(wave))
                for lane in list(lanes):
                    if self.step_lane(lane):
                        responses.extend(self._finalize(lane))
                        lanes.remove(lane)
        finally:
            for lane in lanes:
                lane.slot.busy = False
        return sorted(responses, key=lambda r: r.uid)

    def decode_stream(self, prompt: np.ndarray,
                      schedule: Sequence[tuple[int, int]]) -> dict:
        """Greedy-decode one stream whose rung changes mid-flight:
        ``schedule`` is [(bits, n_tokens), ...]; a switch replays the
        accumulated prefix through the target rung's view."""
        prefix = [int(t) for t in np.asarray(prompt).reshape(-1)]
        prompt_len = len(prefix)
        if prompt_len + sum(n for _, n in schedule) > self.max_len:
            raise ValueError("schedule exceeds engine max_len")
        for bits, _ in schedule:
            if bits not in self.rungs:
                raise KeyError(f"no rung for {bits}-bit budget; "
                               f"ladder has {sorted(self.rungs)}")
        segments = []
        for bits, n in schedule:
            if n <= 0:
                segments.append({"rung_bits": bits, "tokens": []})
                continue
            slot = self._acquire()
            try:
                self._load_frontend(bits, slot)
                self._teacher_force(
                    bits, slot,
                    self._rows_tensor(np.asarray(prefix)[None, :]))
                toks = [slot.tok.clone()]
                for _ in range(n - 1):
                    self._run_step(bits, slot)
                    toks.append(slot.tok.clone())
            finally:
                slot.busy = False
            seg = [int(t) for t in torch.cat(toks, dim=1)[0].cpu()]
            prefix.extend(seg)
            segments.append({"rung_bits": bits, "tokens": seg})
        return {"tokens": prefix[prompt_len:], "segments": segments}

    # -- reporting ----------------------------------------------------------

    def cache_rows(self) -> dict:
        """Rows of each attention layer kind's KV cache in a slot: a
        windowed layer's ring keeps min(max_len, window), the others
        max_len (zamba2's shared block at its mamba_attn layers)."""
        rows = {}
        for spec in MD.layer_specs(self.cfg):
            if spec.kind in ("mamba", "rwkv"):
                continue
            kind = spec.kind + (f" (window {spec.window})" if spec.window
                                else "")
            rows[kind] = T.cache_rows(spec, self.max_len)
        return rows

    def describe(self) -> dict:
        total_macs = sum(m.macs for m in self.profile)
        mesh = None
        if self.mesh is not None:
            mesh = {"shape": dict(zip(self.mesh.mesh_dim_names,
                                      self.mesh.shape)),
                    "rank": torch.distributed.get_rank(),
                    "backend": torch.distributed.get_backend()}
        return {
            "mesh": mesh,
            "graphed": self.graphed,
            "steps": ("CUDA graph replays" if self.graphed else
                      "eager: a step under a mesh of more than one rank "
                      "waits on its collectives (no graphs under a mesh: "
                      "ROADMAP A10.4)" if mesh is not None
                      else "eager (the CPU has no graphs)"),
            "allocation": self.allocation,
            "artifact_format": self.artifact_format,
            "backend": self.backend,
            "cache_bits": self.cache_bits,
            "cache_bits_by_rung": dict(self._cache_bits_by_rung) or None,
            "device": str(self.device),
            "ladder": [{"bits": op.bits, "b_x_tilde": op.b_x_tilde,
                        "r": round(op.r, 3),
                        "power_per_weight_mac": round(op.power, 2),
                        "total_gbitflips_per_token":
                            round(pw.giga(op.power * total_macs), 3)}
                       for op in self.ladder],
            "max_batch": self.max_batch,
            "max_len": self.max_len,
            "cache_rows": self.cache_rows(),
            "compilations_after_warmup": self.compilations_after_warmup,
            "steps_by_rung": dict(self.steps_by_rung),
            "rung_switches": self.rung_switches,
        }


__all__ = ["Lane", "ServeEngine", "Slot", "Request", "Response"]
