"""ServeEngine: one checkpoint, a ladder of PANN operating points, and a
rung chosen per request (port of ``repro.serve_engine.engine``).

The ladder is quantized once into one ``WeightStore``; every rung is a view
whose per-rung values (``plane_shift``, activation and cache level counts)
are device tensors read by the kernels. So one eager step function serves
every rung, switching rungs is picking another view, and the decode loop
makes no host round trip: sampled tokens stay on the device until a
response is finalized.

Lanes (one per in-flight wave) advance round-robin one decode step each, so
different rungs interleave between steps of one process.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core import policy as pol
from repro_torch.core import power as pw
from repro_torch.kernels import dispatch
from repro_torch.models import model as MD
from repro_torch.models import serving
from repro_torch.serve_engine.ladder import build_ladder, select_rung
from repro_torch.serve_engine.scheduler import (Request, Response, Scheduler,
                                                Wave)


@dataclasses.dataclass
class Lane:
    """One in-flight wave: its decode state and the tokens grown so far
    (device tensors)."""
    wave: Wave
    state: Any
    tok: Any                 # (max_batch, 1) int64 — last sampled token
    generated: list          # [(max_batch, 1), ...] greedy tokens
    steps_left: int


class ServeEngine:
    """Multi-operating-point PANN serving runtime (see module docstring),
    uniform allocation (one (b~x, R) per rung; the layerwise allocation is
    not ported yet).

    Pass ``params`` (fp32, quantized here; the engine takes them over and
    drops each fp weight once it is quantized) or a prebuilt
    ``weight_store``. ``device`` defaults to 'cuda' and raises without a
    card; the CPU runs only when asked for (the plain kernel versions)."""

    def __init__(self, cfg: ModelConfig, params: Any = None,
                 ladder_bits: Sequence[int] = (2, 3, 4, 6),
                 max_batch: int = 4, max_len: int = 64,
                 mse_dim: Optional[float] = None,
                 backend: str = "packed",
                 cache_bits: Optional[int] = None,
                 weight_store: Optional[serving.WeightStore] = None,
                 device="cuda"):
        self.device = MD.resolve_device(device)
        if (params is None) == (weight_store is None):
            raise ValueError("pass exactly one of params (quantize here) or "
                             "weight_store (serve a prebuilt store)")
        if cache_bits is not None:
            if cache_bits == "auto":
                raise ValueError("cache_bits='auto' is not ported yet")
            cache_bits = int(cache_bits)
            if not 2 <= cache_bits <= 7:
                raise ValueError(f"cache_bits must be in [2, 7], got "
                                 f"{cache_bits}")
            cfg = dataclasses.replace(cfg, cache_bits=cache_bits)
        self.cache_bits = cache_bits
        self.backend = dispatch.parse_backend(backend)
        cfg = dataclasses.replace(cfg, kernel_backend=self.backend)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        # the per-module MAC profile: the per-module energy breakdown on
        # every response
        self.profile = costs.module_cost_profile(cfg)
        self.ladder = build_ladder(ladder_bits,
                                   d=float(mse_dim or cfg.d_model))
        self.rungs = {op.bits: op for op in self.ladder}
        rung_specs = {op.bits: (op.r, op.b_x_tilde) for op in self.ladder}
        if weight_store is not None:
            missing = [b for b in rung_specs if b not in weight_store.views]
            if missing:
                raise ValueError(
                    f"weight_store has no view for rung(s) {missing}; "
                    f"available: {sorted(weight_store.views)}")
            self.weight_store = weight_store.store
            self.variants = {b: weight_store.views[b] for b in rung_specs}
        else:
            spec = serving.ServingQuantSpec(
                pack_planes=self.backend == "packed",
                cache_bits=cache_bits)
            ws = serving.build_weight_store(params, cfg, rung_specs, spec)
            self.weight_store = ws.store
            self.variants = ws.views
        table = self.weight_store["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"weight store lives on {table.device}, engine "
                             f"device is {self.device}")
        self.scheduler = Scheduler(self.ladder, self.max_batch)
        self.steps_by_rung = {op.bits: 0 for op in self.ladder}
        self.rung_switches = 0
        self._last_step_bits: Optional[int] = None
        self._macs_by_ctx: dict[int, Any] = {}

    # -- decode plumbing ----------------------------------------------------

    def warmup(self) -> None:
        """One decode step per rung before traffic: builds the kernels and
        touches every rung's view."""
        state = self._init_state(self.ladder[0].bits)
        tok = torch.zeros((self.max_batch, 1), dtype=torch.int64,
                          device=self.device)
        for op in self.ladder:
            MD.decode_step(self.variants[op.bits], self.cfg, state, tok)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _init_state(self, bits: int):
        return MD.init_decode_state(self.variants[bits], self.cfg,
                                    self.max_batch, self.max_len)

    def _run_step(self, bits: int, state, tok):
        if self._last_step_bits is not None and bits != self._last_step_bits:
            self.rung_switches += 1
        self._last_step_bits = bits
        self.steps_by_rung[bits] += 1
        return MD.decode_step(self.variants[bits], self.cfg, state, tok)

    def _greedy(self, logits):
        return torch.argmax(logits[:, :, :self.cfg.vocab_size], dim=-1)

    def _teacher_force(self, bits: int, state, prompts):
        """Feed a (max_batch, L) prefix token by token; return the logits of
        the final position and the threaded state."""
        logits = None
        for i in range(prompts.shape[1]):
            logits, state = self._run_step(bits, state, prompts[:, i:i + 1])
        return logits, state

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

    def prefill_wave(self, wave: Wave) -> Lane:
        """Teacher-force a wave's prompts and return its lane (the first
        generated token included)."""
        reqs = wave.requests
        gen_max = max(r.max_new_tokens for r in reqs)
        if reqs[0].prompt_len + gen_max > self.max_len:
            raise ValueError(
                f"prompt_len {reqs[0].prompt_len} + gen {gen_max} exceeds "
                f"engine max_len {self.max_len}")
        state = self._init_state(wave.rung.bits)
        logits, state = self._teacher_force(
            wave.rung.bits, state,
            self._rows_tensor(np.stack([r.prompt for r in reqs])))
        tok = self._greedy(logits)
        return Lane(wave=wave, state=state, tok=tok, generated=[tok],
                    steps_left=gen_max - 1)

    def step_lane(self, lane: Lane) -> bool:
        """Advance a lane one decode step; True when the lane is finished."""
        if lane.steps_left > 0:
            logits, lane.state = self._run_step(
                lane.wave.rung.bits, lane.state, lane.tok)
            lane.tok = self._greedy(logits)
            lane.generated.append(lane.tok)
            lane.steps_left -= 1
        return lane.steps_left <= 0

    # -- energy accounting --------------------------------------------------

    def _rung_tree(self, rung) -> pol.PolicyTree:
        """The rung's PolicyTree — the uniform lift of its (b~x, R) point,
        plus explicit cache-role overrides at the cache width when the KV
        cache is quantized."""
        tree = pol.uniform_policy(pol.ModuleQuant(
            mode="pann", r=rung.r, b_x_tilde=rung.b_x_tilde))
        if self.cache_bits is None:
            return tree
        ov = dict(tree.overrides)
        for role in pol.CACHE_PATHS:
            ov[role] = pol.cache_module_quant(self.cache_bits)
        return pol.policy_tree(tree.default, ov)

    def ledger_for(self, rung, ctx: int) -> pw.EnergyLedger:
        macs = self._macs_by_ctx.get(ctx)
        if macs is None:
            macs = self._macs_by_ctx.setdefault(
                ctx, costs.macs_per_token(self.cfg, context_len=ctx))
        total, breakdown = pol.tree_power_per_token(
            self.profile, self._rung_tree(rung), act_macs=macs.act_macs)
        if self.cache_bits is None:
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
            state = self._init_state(bits)
            logits, state = self._teacher_force(
                bits, state, self._rows_tensor(np.asarray(prefix)[None, :]))
            toks = [self._greedy(logits)]
            for _ in range(n - 1):
                logits, state = self._run_step(bits, state, toks[-1])
                toks.append(self._greedy(logits))
            seg = [int(t) for t in torch.cat(toks, dim=1)[0].cpu()]
            prefix.extend(seg)
            segments.append({"rung_bits": bits, "tokens": seg})
        return {"tokens": prefix[prompt_len:], "segments": segments}

    # -- reporting ----------------------------------------------------------

    def describe(self) -> dict:
        total_macs = sum(m.macs for m in self.profile)
        return {
            "allocation": "uniform",
            "backend": self.backend,
            "cache_bits": self.cache_bits,
            "cache_bits_by_rung": (None if self.cache_bits is None else
                                   {op.bits: self.cache_bits
                                    for op in self.ladder}),
            "device": str(self.device),
            "ladder": [{"bits": op.bits, "b_x_tilde": op.b_x_tilde,
                        "r": round(op.r, 3),
                        "power_per_weight_mac": round(op.power, 2),
                        "total_gbitflips_per_token":
                            round(pw.giga(op.power * total_macs), 3)}
                       for op in self.ladder],
            "max_batch": self.max_batch,
            "max_len": self.max_len,
            "steps_by_rung": dict(self.steps_by_rung),
            "rung_switches": self.rung_switches,
        }


__all__ = ["Lane", "ServeEngine", "Request", "Response"]
