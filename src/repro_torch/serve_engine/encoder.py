"""EncodeEngine: item-oriented encoder serving (port of
``repro.serve_engine.encoder``).

The decode engine is token-oriented (lanes, KV caches, one step a token).
An encode workload (a vision stem, a speech frontend and its encoder) is
item-oriented: one whole-sequence forward per image or utterance, no
cache, and a power budget per item. This engine serves it with the same
machinery: the ladder planned against the per-item
``costs.encoder_cost_profile`` (whose conv rows carry the exact
kh*kw*Cin*Cout*Ho*Wo MACs), one weight store with a view per rung, and
the request's ``power_budget_bits`` / ``min_score`` resolved through
``select_rung``; every response carries an ``EnergyLedger`` itemizing its
rung's per-module bit flips (the ``conv.s{i}`` roles included).

Requests resolve to rungs, group into waves of ``max_batch`` items per
rung (a short wave padded by repeating its first item), and each wave is
one eager ``models.model.encode`` call on the rung's view: thousands of
rows a launch, so a CUDA graph would gain nothing. Under a device mesh
(``EncodeEngine(mesh=...)``, one engine a rank) a wave's items split over
"data" and the encoder's heads over "model", each rank running the conv
stem whole on its items, and the rows are gathered so every rank returns
the whole wave, equal to one rank's bit for bit. The JAX package's
no-retrace proof becomes: ``warmup`` encodes once per rung and records
how many kernel libraries ``kernels.build`` has loaded, and
``assert_no_recompile`` raises if that count grew while serving.
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
from repro_torch.dist import local_ops
from repro_torch.kernels import build, dispatch
from repro_torch.models import model as MD
from repro_torch.models import serving
from repro_torch.serve_engine.engine import check_shards, serve_shards
from repro_torch.serve_engine.ladder import build_ladder, select_rung


@dataclasses.dataclass(frozen=True)
class EncodeRequest:
    """One item to encode: the raw frontend input, (H, W, C) pixels or
    (frames, 1, mels) features when the config has a conv stem, else
    (T, d_model) stub embeddings; the budget and floor mean what they mean
    on a decode ``Request``, per item."""
    uid: int
    item: np.ndarray
    power_budget_bits: Optional[int] = None
    min_score: Optional[float] = None


@dataclasses.dataclass
class EncodeResponse:
    uid: int
    encoded: np.ndarray          # (T, d_model) encoder states
    rung_bits: int
    metadata: dict


class EncodeEngine:
    """Multi-operating-point encoder serving runtime (module docstring).
    Pass ``params`` (fp32, quantized here; the engine takes them over) or
    a prebuilt ``weight_store``. ``backend`` defaults to 'packed';
    ``device`` to 'cuda', which raises without a card. ``mesh`` (a
    ("data", "model") ``DeviceMesh``) and ``par`` (a ``ParallelConfig``
    without FSDP) serve it on the mesh's ranks, one engine a rank, each
    handed the same requests: the store placed as
    ``serving.serving_shardings`` says (the conv stem whole on every
    rank), a wave's items split over "data" and the encoder's heads over
    "model", and each response whole on every rank, equal to one rank's
    bit for bit."""

    def __init__(self, cfg: ModelConfig, params: Any = None,
                 ladder_bits: Sequence[int] = (2, 3, 4, 6),
                 max_batch: int = 4, mse_dim: Optional[float] = None,
                 allocation: str = "uniform", backend: str = "packed",
                 weight_store: Optional[serving.WeightStore] = None,
                 device="cuda", mesh=None, par=None):
        self.device = MD.resolve_device(device)
        if (params is None) == (weight_store is None):
            raise ValueError("pass exactly one of params (quantize here) or "
                             "weight_store (serve a prebuilt store)")
        if backend is None:
            raise ValueError("EncodeEngine serves its weight store through "
                             "a kernel backend ('ref' | 'fused' | 'packed')")
        self.backend = dispatch.parse_backend(backend)
        cfg = dataclasses.replace(cfg, kernel_backend=self.backend)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.allocation = allocation
        self._shards = (None if mesh is None else
                        serve_shards(cfg, mesh, par, self.max_batch))
        # per-ITEM profile: conv rows exact, an encoder's rows at
        # encoder_layers x n_tokens instances
        self.profile = costs.encoder_cost_profile(cfg)
        if not self.profile:
            raise ValueError(
                f"{cfg.name} ({cfg.family}) has no encode path: needs a "
                "conv_stem, encoder layers, or image tokens")
        self._macs_item = costs.encoder_macs_per_item(cfg)
        self.ladder = build_ladder(ladder_bits,
                                   d=float(mse_dim or cfg.d_model),
                                   allocation=allocation,
                                   profile=self.profile)
        self.rungs = {op.bits: op for op in self.ladder}
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
            ws = serving.build_weight_store(
                params, cfg, rung_specs,
                serving.ServingQuantSpec(
                    pack_planes=self.backend == "packed"),
                mesh=mesh, par=par)
        self.weight_store = ws.store
        self.variants = ws.views
        # what an encode reads: the views, or under a mesh each rank's
        # local shards of them under the config of its heads
        self._views = {b: serving.local_tree(v)
                       for b, v in self.variants.items()}
        self._step_cfg = cfg
        if self._shards is not None:
            self._step_cfg = self._shards.local_cfg(cfg)
            check_shards(self.variants[self.ladder[0].bits], self._shards)
        self.compilations_after_warmup: Optional[int] = None
        self.items_by_rung = {op.bits: 0 for op in self.ladder}
        self.rung_switches = 0
        self._last_bits: Optional[int] = None

    # -- shapes -------------------------------------------------------------

    def item_shape(self) -> tuple:
        """The per-item input shape this engine encodes."""
        cfg = self.cfg
        if cfg.conv_stem:
            h, w = cfg.frontend_hw
            return (h, w, cfg.conv_stem[0].c_in)
        return (costs.encoder_tokens(cfg), cfg.d_model)

    def _batch(self, items: Sequence[np.ndarray]) -> torch.Tensor:
        want = self.item_shape()
        rows = []
        for it in items:
            a = np.asarray(it, np.float32)
            if a.shape != want:
                raise ValueError(
                    f"item shape {a.shape} != engine item shape {want}")
            rows.append(a)
        # a short wave repeats its first item up to max_batch
        while len(rows) < self.max_batch:
            rows.append(rows[0])
        return torch.as_tensor(np.stack(rows), device=self.device)

    def _encode(self, bits: int, x: torch.Tensor) -> torch.Tensor:
        """The wave ``x`` encoded at rung ``bits``: under a mesh each rank
        encodes its rows at its heads and the rows are gathered, so every
        rank returns the whole wave."""
        shards = self._shards
        if shards is None:
            return MD.encode(self._views[bits], self.cfg, x)
        with local_ops.use_shards(shards):
            out = MD.encode(self._views[bits], self._step_cfg,
                            shards.own_rows(x))
        return shards.gather_rows(out)

    # -- warmup bookkeeping (the decode engine's protocol) ------------------

    @staticmethod
    def _libraries_loaded() -> int:
        return len(build._libs)

    def warmup(self) -> None:
        """One encode per rung before traffic (it builds and loads the
        kernels on the card); records the loaded kernel libraries."""
        x = torch.zeros((self.max_batch,) + self.item_shape(),
                        dtype=torch.float32, device=self.device)
        for op in self.ladder:
            self._encode(op.bits, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compilations_after_warmup = self._libraries_loaded()

    def assert_no_recompile(self) -> None:
        """After serving: no kernel library was built or loaded past
        warmup."""
        if self.compilations_after_warmup is None:
            raise RuntimeError("call warmup() first")
        now = self._libraries_loaded()
        if now > self.compilations_after_warmup:
            raise AssertionError(
                f"encode step loaded kernels while serving: "
                f"{self.compilations_after_warmup} -> {now} libraries")

    # -- energy accounting --------------------------------------------------

    def _rung_tree(self, rung) -> pol.PolicyTree:
        if rung.tree is not None:
            return rung.tree
        return pol.uniform_policy(pol.ModuleQuant(
            mode="pann", r=rung.r, b_x_tilde=rung.b_x_tilde))

    def ledger_for(self, rung) -> pw.EnergyLedger:
        """Per-ITEM energy ledger: the rung's tree priced over the per-item
        profile (conv roles included), act MACs the encoder's
        bidirectional attention; the ledger's 'per_token' fields read 'per
        item' here."""
        total, breakdown = pol.tree_power_per_token(
            self.profile, self._rung_tree(rung),
            act_macs=self._macs_item.act_macs)
        if rung.tree is None:
            total = pw.pann_token_bitflips(self._macs_item, rung.r,
                                           rung.b_x_tilde)
        return pw.EnergyLedger(total, breakdown_per_token=breakdown)

    def item_flips(self, bits: int) -> float:
        """Estimated bit flips of encoding ONE item at rung ``bits``."""
        return self.ledger_for(self.rungs[bits]).bitflips_per_token

    # -- serving ------------------------------------------------------------

    def _encode_wave(self, rung, reqs: Sequence[EncodeRequest]
                     ) -> list[EncodeResponse]:
        if self._last_bits is not None and rung.bits != self._last_bits:
            self.rung_switches += 1
        self._last_bits = rung.bits
        self.items_by_rung[rung.bits] += len(reqs)
        out = self._encode(rung.bits, self._batch([r.item for r in reqs]))
        out = out.cpu().numpy()
        responses = []
        for i, req in enumerate(reqs):
            ledger = self.ledger_for(rung)
            ledger.charge(1)
            meta = {
                "rung_bits": rung.bits,
                "b_x_tilde": rung.b_x_tilde,
                "r": rung.r,
                "allocation": rung.allocation,
                "power_per_weight_mac": rung.power,
                **ledger.report(),
            }
            responses.append(EncodeResponse(uid=req.uid, encoded=out[i],
                                            rung_bits=rung.bits,
                                            metadata=meta))
        return responses

    def encode(self, requests: Sequence[EncodeRequest]
               ) -> list[EncodeResponse]:
        """Serve mixed-budget encode requests: every request resolves to a
        rung first (an infeasible budget or floor fails the call before
        any work), then per-rung waves of ``max_batch`` items."""
        resolved = [select_rung(self.ladder, r.power_budget_bits,
                                r.min_score) for r in requests]
        by_rung: dict[int, list[EncodeRequest]] = {}
        for req, rung in zip(requests, resolved):
            by_rung.setdefault(rung.bits, []).append(req)
        responses: list[EncodeResponse] = []
        for bits in sorted(by_rung):
            reqs = by_rung[bits]
            for i in range(0, len(reqs), self.max_batch):
                responses.extend(
                    self._encode_wave(self.rungs[bits],
                                      reqs[i:i + self.max_batch]))
        return sorted(responses, key=lambda r: r.uid)

    # -- reporting ----------------------------------------------------------

    def describe(self) -> dict:
        total_macs = sum(m.macs for m in self.profile)
        return {
            "workload": "encode",
            "allocation": self.allocation,
            "backend": self.backend,
            "item_shape": list(self.item_shape()),
            "encoder_tokens": costs.encoder_tokens(self.cfg),
            "ladder": [{"bits": op.bits, "b_x_tilde": op.b_x_tilde,
                        "r": round(op.r, 3),
                        "power_per_weight_mac": round(op.power, 2),
                        "total_gbitflips_per_item":
                            round(pw.giga(op.power * total_macs), 3)}
                       for op in self.ladder],
            "max_batch": self.max_batch,
            "compilations_after_warmup": self.compilations_after_warmup,
            "items_by_rung": dict(self.items_by_rung),
            "rung_switches": self.rung_switches,
        }


__all__ = ["EncodeEngine", "EncodeRequest", "EncodeResponse"]
