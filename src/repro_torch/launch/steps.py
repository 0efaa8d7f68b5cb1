"""The train, eval, prefill and decode steps shared by the trainer, the
exporter and the server (port of ``repro.launch.steps``). Every step runs
eagerly on the tensors' device.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.core import calibrate as CAL
from repro_torch.dist import compat, local_ops
from repro_torch.dist import sharding as SH
from repro_torch.models import model as MD
from repro_torch.optim import optimizers as OPT

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any
    opt: OPT.AdamWState
    step: Tensor            # () int32
    # EMA activation-range collection ({path: [lo, hi]}, core/calibrate.py)
    # of power-aware QAT; None when calibration is off. Checkpointed with
    # the rest of the state, so a mid-anneal resume is bit-exact.
    calib: Any = None


def make_train_state(cfg: ModelConfig, tcfg: TrainConfig, *,
                     calibrate: bool = False, seed: Optional[int] = None,
                     device="cuda", shardings: Optional[Any] = None
                     ) -> TrainState:
    """Fresh params from ``seed`` (``tcfg.seed`` by default), zero AdamW
    moments, step 0 and, with ``calibrate``, an all-unseen calibration
    collection. ``device="meta"`` gives the state's shapes only (a
    checkpoint template); its calibration collection then lives on the
    host, where a restore can keep it as the init of an absent subtree.
    ``shardings`` (``dist.sharding.NamedSharding`` per param, from
    ``param_specs``) makes the params DTensors, every rank keeping its
    shard of the same seeded values, and the moments DTensors alike."""
    dev = MD.resolve_device(device)
    params = MD.init_params(cfg, tcfg.seed if seed is None else seed, dev)
    if shardings is not None:
        params = SH.distribute(params, shardings)
    opt = OPT.AdamW(tcfg).init(params)
    calib = CAL.init_calib(cfg, "cpu" if dev.type == "meta" else dev) \
        if calibrate else None
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      calib=calib)


def _loss(params, cfg, batch, *, remat, calib):
    return MD.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                      enc_inputs=batch.get("enc_inputs"),
                      image_embeds=batch.get("image_embeds"),
                      remat=remat, calib=calib, return_calib=True)


def _grads(loss: Tensor, leaves: list) -> list:
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def train_step(state: TrainState, batch: dict, *, cfg: ModelConfig,
               tcfg: TrainConfig, par: ParallelConfig,
               matrix: Optional[Any] = None) -> tuple[TrainState, dict]:
    """One optimizer step, eagerly. The state is donated: its params and
    AdamW moments are updated in place and belong to the returned state.

    With a calibration collection on the state, the forward quantizes
    activations against its ranges and reports the batch's observed
    ranges, which fold into the collection (``calibrate.ema_update``).
    ``par.microbatches > 1`` accumulates the gradients of equal slices of
    the batch (their sum, then / n, as the reference's scan) and merges
    their observations. ``matrix`` is the weight-decay mask
    (``convert.reference_matrix_mask``).

    Under a mesh (``dist.constrain.use_mesh``) the params and moments are
    DTensors placed by ``dist.sharding.param_specs`` and the batch by
    ``input_sharding``; DTensor's sharding rules run the step, with every
    tensor the model makes on its own taken as replicated. Each gradient
    comes back with its parameter's placements (a batch-sharded loss
    leaves them partial over "data": the redistribute is the
    data-parallel all-reduce), the loss and the calibration's
    observations as plain tensors on every rank (``compat.full``: the
    min / max all-reduce of the observed ranges), so ``calib`` and the
    step counters stay replicated plain tensors."""
    leaves = OPT.tree_leaves(state.params)
    if not any(compat.is_dtensor(p) for p in leaves):
        return _train_step(state, batch, cfg=cfg, tcfg=tcfg, par=par,
                           matrix=matrix)
    with compat.implicit_replication():
        new_state, metrics = _train_step(state, batch, cfg=cfg, tcfg=tcfg,
                                         par=par, matrix=matrix)
    return new_state, {k: compat.full(v) for k, v in metrics.items()}


def _train_step(state: TrainState, batch: dict, *, cfg: ModelConfig,
                tcfg: TrainConfig, par: ParallelConfig,
                matrix: Optional[Any]) -> tuple[TrainState, dict]:
    remat = par.remat != "none"
    calib = state.calib
    collect = calib is not None
    leaves = OPT.tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        if par.microbatches > 1:
            b = batch["tokens"].shape[0]
            assert b % par.microbatches == 0
            mb = b // par.microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            observed = CAL.unseen_like(calib) if collect else None
            for i in range(par.microbatches):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()
                      if v is not None}
                l, obs = _loss(state.params, cfg, sl, remat=remat,
                               calib=calib)
                g = _grads(l, leaves)
                loss = loss + l.detach()
                torch._foreach_add_(grads, g)
                del g
                if collect:
                    observed = CAL.merge(observed, obs)
            n = torch.tensor(float(par.microbatches), dtype=torch.float32,
                             device=loss.device)
            loss = loss / n
            torch._foreach_div_(grads, n)
        else:
            loss, observed = _loss(state.params, cfg, batch, remat=remat,
                                   calib=calib)
            grads = _grads(loss, leaves)
            loss = loss.detach()
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if compat.is_dtensor(g) else g for p, g in zip(leaves, grads)]
    if collect:
        observed = {k: compat.full(v) for k, v in observed.items()}
    _, new_opt, metrics = OPT.AdamW(tcfg).update(
        grads, state.opt, leaves,
        matrix=None if matrix is None else OPT.tree_leaves(matrix))
    del grads
    new_calib = CAL.ema_update(calib, observed, tcfg.calib_decay) \
        if collect else None
    metrics = {"loss": loss, **metrics}
    return TrainState(state.params, new_opt, state.step + 1,
                      new_calib), metrics


@torch.no_grad()
def eval_loss(params: Any, cfg: ModelConfig, batch: dict,
              calib: Optional[dict] = None) -> float:
    """Deterministic eval loss of ``params`` on one batch: the number the
    train -> serve export round trip is held to (launch/export.py).
    ``calib`` freezes the activation quantizers to its ranges, as the
    export bakes them into the serving artifact. Takes training params
    (fake-quant forward) and serving artifacts alike."""
    with _replicated(params):
        loss = MD.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                          enc_inputs=batch.get("enc_inputs"),
                          image_embeds=batch.get("image_embeds"),
                          remat=False, calib=calib)
    return float(compat.full(loss))


def _replicated(params):
    """DTensor's implicit replication of the tensors a model makes on its
    own, for DTensor ``params``; nothing otherwise."""
    if any(compat.is_dtensor(p) for p in OPT.tree_leaves(params)):
        return compat.implicit_replication()
    return contextlib.nullcontext()


@torch.no_grad()
def prefill_step(params, cfg: ModelConfig, tokens, *, enc_inputs=None,
                 image_embeds=None):
    """Whole-sequence logits (``forward``); under a mesh (DTensor params
    and inputs, ``use_mesh``) DTensor's rules run it."""
    with _replicated(params):
        out = MD.forward(params, cfg, tokens, enc_inputs=enc_inputs,
                         image_embeds=image_embeds, remat=False)
    return out.logits


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, state: MD.DecodeState, tokens,
               shards=None):
    """One decode tick: (B, 1) tokens -> (B, 1, V) logits + new state.
    With ``shards`` (``dist.local_ops.ServeShards``) ``params`` and
    ``state`` are the rank's local shards and ``cfg`` its head counts, as
    in a serve engine under a mesh; the tokens and logits are the whole
    batch's."""
    with local_ops.use_shards(shards):
        return MD.decode_step(params, cfg, state, tokens)
