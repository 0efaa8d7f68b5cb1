#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100 and check
it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device   — requires CUDA; prints the card's name and power limit and the
              torch / CUDA / nvcc / driver versions.
2. build    — compiles the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels  — holds each kernel against its plain PyTorch version on the
              card at the main path's shapes, and times the kernel, the
              plain version, a PyTorch yardstick call and the bound. The
              matmuls are checked at M = 1, 3, 4 and 8 (B1 both modes and
              B2 at plane_shift 0-6 at the serve's batch of 4, 0 and 5 at
              the others; B4 both modes and B5 on int8 codes) and timed at
              M = 4, one ``[decode]`` line per kernel and shape (ms, bound,
              achieved TB/s, share of the bound, library ms, and a
              torch.sum over the same plane bytes as a streaming
              yardstick); B2 also above 8 rows (M = 9, 64, 512, the
              tensor-core tile kernel) at plane_shift 0 and 5. B3 is
              checked at S = 48, 1000 and 4096, 1-7
              live planes, the first, middle and last position and windows
              (at 4096 ones that leave whole cluster blocks masked), and at
              other group sizes and head dims; timed at 4 planes with the
              cluster size it launched. The same B3 checks and timings at
              the dense variants' (B, KH, G, hd): qwen1.5-4b (4, 20, 1,
              128), gemma2-9b (4, 8, 2, 256) with softcap 50, and
              stablelm-12b (4, 8, 4, 160), and dbrx-132b (4, 8, 6, 128):
              G = 6, one warp a head; and B2 at each variant's and each
              MoE config's decode shapes (M = 4 at plane_shift 0-6, M = 1
              at 0 and 5; dbrx's K = 6144 and 100352-wide head), timed
              at M = 4 beside its bound and the fp32 matmul on the
              dequantized weight; gemma2's tied head (an fp32 matmul over
              the embedding table) timed alone. B2 and B1 (fused) at every
              plane count a single-point artifact can have, P = 1-7, at
              llama3-8b's (4096, 14336) and (14336, 4096), M = 4 (the
              decode kernel), 64 and 4096 (the tile kernel), plane_shift 0
              and P - 1; both timed at P = 5, M = 4 beside their
              plane-byte bound and the fp32 matmul on the dequantized
              weight. B2 at zamba2-1.2b's and rwkv6-1.6b's decode shapes
              the same way (zamba2's ssm.in_proj (2048, 8384), the shared
              block's (2048, 2048), (2048, 8192), (8192, 2048); rwkv6's
              decay LoRA (2048, 64) and (64, 2048), (2048, 7168), (7168,
              2048); both heads), the narrow and partial-tile ones also
              above 8 rows (M = 9, 64, 512), B3 at zamba2's (4, 32, 1,
              64); and ``dispatch.serving_linear`` at a width N = 1030
              that is no multiple of 4 (ROADMAP C8): 'fused' and 'packed'
              (N padded to 1032 for the kernels, sliced back) bit for bit
              against 'ref' on every rung view, M = 1 and 4. The encode
              path (``[encode]`` lines): B2 and B1 ('fused') at the stems'
              (M, K, N) = (8192, 240, 1024), (4096, 3072, 1024), (6400,
              588 -> 592 packed, 8192), the encoder's (4096, 1024, 1024)
              and vision's cross K/V (6400, 8192, 1024), plane_shift 0
              and 5, timed beside their bound and the fp32 matmul; B3 at
              seamless's (4, 16, 1, 64) and vision's (4, 8, 8, 128)
              (G = 8, one warp a head) as the other served shapes; and
              ``dispatch.serving_conv`` on 'ref', 'fused', 'packed' bit
              for bit against ``serving_conv_oracle`` (a float64
              convolution of the codes) at both full-width stems on every
              rung view.
4. serve    — full-width llama3-8b (32 layers, d=4096, GQA 32/8, d_ff=14336,
              vocab 128256, random weights from a seed) through the PANN
              ladder 2,4,6 with backend 'packed' and a 4-bit KV cache:
              6 requests, prompt 32, gen 16. Every decode step replays a
              CUDA graph that ``warmup`` captured (``ServeEngine``): the
              wrappers' launch counts advance only while warmup captures,
              so they are held at (rungs + graphs) steps' worth and must
              not move while serving; the profiler counts the kernels of
              a graph replay (guard step, ``spin_kernel`` marker): 225 B2
              and 32 B3 a step, no epilogue kernel. The requests are
              served again with every step's input token and logits
              recorded, and every wave is replayed eagerly through
              ``MD.decode_step``: every graphed step's logits must be
              bit-identical. ``assert_no_recompile`` after serving.
4b. layerwise — the same model cut to 8 layers (LAYERWISE_LAYERS) at
              allocation 'layerwise' with
              cache_bits 'auto' (each rung's allocator trades cache bits
              against weight bits), served through graphs and held to
              eager the same way; reports each rung's cache bits and
              Gbit-flips per token.
4c. variants — qwen1.5-4b, gemma2-9b and stablelm-12b at full width,
              cut to 2 layers (VARIANT_LAYERS; gemma2 one local and one
              global) to keep the script inside its time limit (random
              weights, qwen's q/k/v biases
              overwritten with nonzero values), each as phase 4 with 3
              requests: every
              graphed step bit-identical to eager, B2 / B3 launches a
              graphed step 7 L (+ 1 with an untied head) / L, no
              recompile, peak memory under 70 GB.
4d. moe     — mixtral-8x7b cut to 2 layers and dbrx-132b to 1 (full
              width; MOE_LAYERS: the fp32 experts fit one card at 8 and
              2, cut further for the script's time limit),
              each as phase 4c: B2 / B3 launches a graphed step 4 L + 1 /
              L (the router and the E experts are fp32 matmuls, every
              expert on every token), every graphed step bit-identical to
              eager, no recompile, peak under 70 GB; the device ms a step
              split between the expert matmuls (against their byte
              bound), B2, B3 and the small kernels.
4e. recurrent — zamba2-1.2b (Mamba2 with a shared attention + MLP block
              at every 6th layer; cut to 14 of 38 layers: 2 groups and
              the 2-layer tail) and rwkv6-1.6b (cut to 4 of 24 layers)
              at full width (RECURRENT_LAYERS), each as phase 4c (zamba2 with the 4-bit KV cache, rwkv6 has no
              attention): every graphed step bit-identical to eager (the
              recurrent states live in the engine's fixed slots and are
              written back in place every replay; a stale slot would
              show here), B2 / B3 launches a graphed step 41 / 2 and 37
              / 0, no recompile, peak under 70 GB; the device ms of the
              graphed step by kernel kind, and of one eager step (top
              rung) split between B2, B3, the dispatch's small kernels,
              the recurrent blocks' fp ops (scan, conv, wkv recurrence)
              and the rest (profiler ranges around the blocks).
4f. encdec  — seamless-m4t-medium (d 1024, a two-conv speech stem over
              (4096, 1, 80) features -> 1024 encoder positions) at full
              width, its decoder cut to 4 of 12 layers and its encoder
              at its 12, and llama-3.2-vision-90b (d 8192, GQA 64/8) at
              full width cut to 5 layers (ENCDEC_LAYERS; one group, one
              cross-attention layer; a 14x14/s14 patchify over
              560x560x3 -> 1600 image tokens), random
              weights with xgate, conv and layernorm biases seeded
              nonzero, each as phase 4c; every wave starts with a new raw
              input (``data.pipeline.frontend_raw_stub``) run eagerly
              through the stem, the encoder and the cross K/V
              projections, written into the slot's buffers in place; its
              ms and B2 launches (82 and 3 a wave) are reported apart
              from the step's (B2 / B3 a graphed step 33 / 4 and 38 /
              5); every graphed step bit-identical to an eager replay
              from a state built by ``MD.init_decode_state`` off the
              wave's raw input.
5. backends — each served config cut to 2 layers (gemma2: one local and
              one global layer; mixtral to 1; zamba2 to 8: one group and
              the 2-layer tail, so the shared block and the tail both
              run; seamless to 2 + 2 layers, vision to 5: one cross
              layer) served by 'ref', 'fused' and
              'packed' engines over ONE weight store: logits (teacher-
              forcing the prompt's first 8 tokens, P5_TOKENS, through
              every rung; vision's 4)
              and tokens must
              be bit-identical; counts the fused matmul kernel's launches;
              the store is written as a v1 serving artifact
              (``write_artifact``), loaded back onto the card
              (``load_artifact``), and its logits must be bit-identical to
              the store's on every backend, every view leaf that the store
              holds aliasing the store's tensor.
6. unfused  — the kernel API (``repro_torch.kernels.ops``), one PANN linear
              deployed as "quantize, then multiply codes", over a layer's
              seven projections and the lm_head at llama3-8b's full widths,
              at M = 4 (the decode batch) and M = 512 (a prefill chunk):
              x -> quantize_act -> pann_matmul ('fused' and 'planes'),
              pann_matmul_packed and unsigned_matmul, and x -> pann_matmul
              through the prologue kernel in both modes; beside the pass,
              uncounted, B2 on the same operands with the planes packed
              (checked and timed). Every kernel is
              held bit for bit against its plain version, the four codes
              products against each other and ``ref.pann_matmul_ref``, and
              quantize_act against ``ref.quantize_act_ref`` at 2, 4, 6 and 8
              bits and on bf16; checks the launch counts of the pass, then
              repeats the checks (uncounted) at ragged M, K and N, on
              extreme operands (7 planes of +-127 weights, codes of 127,
              K = 14336) and, for B1 and B2 above 8 rows, at plane_shift
              0-7. Then B6's decode regime at every M = 1..8 (the pass's
              (K, N), ragged (K, N), the extremes; one wrapper launch a
              call; phase 3 counts the device kernels of such calls with
              the profiler: one a call, no epilogue), each
              M timed over the pass's launches beside its byte bound and
              torch._int_mm on the codes zero-padded to 32 rows; and B7 at
              M = 1, 4, 8, 131, 512, the pass's and ragged K, fp32 and
              bf16, bits 2..8, an all-negative and an all-zero row and an
              x not 16-byte aligned, each M timed over the pass's launches
              beside the time of a one-element torch op.
7. prefill and single point — (a) a llama3-8b weight store at full
              width cut to 8 layers (PREFILL_LAYERS; ladder 2,4,6, packed
              planes, seed 7): ``MD.forward`` on the
              top rung's view at (B, T) = (2, 2048) through 'ref', 'fused'
              and 'packed', logits bit-identical; launches counted from 0:
              57 B2 on 'packed', 57 B1 on 'fused', nothing else; forward
              ms, prefill tokens/s and the device time by kernel kind
              (profiler). (b) ``repro_torch.launch.serve.main`` in
              single-point mode at full width cut to 4 layers
              (SINGLE_POINT_LAYERS), --quant pann
              --power_bits
              2 and 4 through 'packed' (the artifact's value-exact P: 5
              and 6 on the square projections, asserted, the rest
              recorded), --power_bits 2 again through 'ref' and 'fused':
              the same sample tokens; batch 4, prompt 32, gen 16, every
              step an eager ``decode_step``. (c) the legacy paths cut to 2
              layers: --quant none, --quant ruq --power_bits 8, --quant
              pann --power_bits 4 --backend "" (fp params through the
              fake-quant projections). (d) 7a on mixtral-8x7b at 2
              layers (MOE_PREFILL_LAYERS): logits and
              the load-balance ``aux_loss`` bit-identical across the
              backends. (e) mixtral at 2 layers through the single-point
              CLI, --quant pann --power_bits 4 on
              'packed' and 'ref': every step's logits bit-identical. (f)
              7a's ``forward`` on zamba2-1.2b and rwkv6-1.6b at 4e's
              depths (41 and 37 B2 launches), logits
              bit-identical across the backends, forward ms (no
              profile: rwkv6's token-by-token wkv recurrence alone is
              ~400,000 small kernels a forward). (g) 7a's ``forward``
              on seamless-m4t-medium at 4f's depth, (B, T) = (2, 256),
              over raw (2, 4096, 1, 80) features (115 B2:
              stem, encoder, decoder, head), logits bit-identical across
              the backends. Every serve: the reference's summary keys,
              finite logits, peak memory under 70 GB.
8. encode   — ``EncodeEngine`` on seamless and vision at 4f's depths:
              8 raw items over budgets cycling the ladder, waves of 4 on
              'packed' (one B2 a stem layer and an encoder projection),
              items/s and each rung's Gbit-flips an item,
              ``assert_no_recompile``; engines on 'ref' and 'fused' over
              the same store give bit-identical encoded states.
9. train    — power-aware training to a served artifact, llama3-8b at
              full width cut to 2 layers: (a) ``launch.train.main`` in
              process, QAT at batch 4 x 256 over ``0:fp,4:8,8:6``
              (layerwise), 12 steps, one checkpoint in a temporary
              directory: losses, ms a step by segment, tok/s, peak
              memory under 70 GB, the checkpoint's GB and write s, every
              calibration role seen; (b) ``launch.export.main`` to the
              ladder artifact 2,4,6 with the 4-bit cache's frozen
              quantizers, the reference's two gates at tol 1e-3, the
              artifact's top rung on 'packed' equal to 'ref' (the float
              dequant and the trained rung reported beside); (c) the
              loaded artifact through ``ServeEngine`` (3 requests) as
              phase 4, every projection view with act_s/act_z and every
              cache view with k_s/k_z/v_s/v_z, 'ref' / 'fused' / 'packed'
              bit-identical, the small kernels a step against the same
              store with its frozen leaves stripped; (d) B1, B2 (M = 4,
              1024) and B3 (S = 48) with the artifact's frozen scalars
              bit for bit against their plain versions (the kernels
              line's "(frozen calibration scalars)" entries); (e) 8 steps
              against 4 + restore + 4 at configs.reduced size: whether
              losses and every checkpoint array are bit-identical.
10. fleet   — (a) ``serve_engine.fleet.Fleet``: 4 rung-sharded decode
              hosts and a prefill host (ladder 2,4,6, 'packed', 4-bit
              cache, batch 2) over ONE device copy of the artifact,
              llama3-8b at full width cut to 8 layers (FLEET_LAYERS),
              ``benchmarks/fleet_sim.py``'s trace (seed 7, 12 ticks, a
              host kill at tick 4, a cap step at tick 6), its caps scaled
              by rho (rung 6's flips a token, full width over reduced):
              every request served, 0 cap violations, 1 restart, >= 1
              migration, the ceiling moved after the step,
              ``verify_streams`` empty on a fresh full-ladder engine over
              the same store, no recompile on any host (reborn ones
              included), every host's views the store's tensors, peak
              under 70 GB; wall s, decode tok/s, each host's StepMonitor,
              the reborn host's rebuild s, the handoff copies' ms. (b)
              ``launch.serve.main`` in fleet mode at the same depth and
              cap: the reference's summary keys, every request served,
              no violation.
11. autotune — (a) ``dispatch.tune_projection`` at M = 4 over llama3-8b's
              5 distinct projection shapes (4 of a layer and the
              lm_head) on 'fused' (B1) and 'packed' (B2): every legal K
              split bit-identical to the heuristic's, each timed with a
              cold L2, one ``[autotune]`` line a shape with the
              heuristic's and the winner's ms and the bound; (b) a
              full-width 2-layer store served through graphs by an engine
              on the heuristic and by ``ServeEngine(autotune=True)``: one
              cache entry a shape, every step's logits bit-identical,
              device ms a step both ways. The cache files live in
              temporary directories.

12. dist    — ``dist/`` on torch.distributed: (a) mixtral-8x7b at full
              width cut to 1 layer, one rank on nccl under a 1 x 1 mesh
              (``launch.mesh.make_local_mesh``, ``dist.constrain.
              use_mesh``): the capacity dispatch's loss and gradients
              against the scan on the same params at capacity factor 4.0
              (no token dropped; rel 1e-5 and 1e-4), the share of routes
              dropped at mixtral's 1.25, 3 AdamW steps through the
              capacity path (finite losses, ms a step, peak memory); (b)
              ``launch.train`` under ``torchrun`` on two ranks that share
              the card (``--model_axis 2``, QAT, llama3-8b at full width
              cut to 2 layers, batch 2 x 128; the host-staged backend of
              ``dist.compat``): its 3 losses within rel 2e-3 of the same
              command on one rank, each rank's ms a step, peak memory and
              the collectives it staged through the host; then two ranks
              of this script (``--dist-worker``): ``compressed_psum_mean``'s
              int8 codes equal to the single-process restatement's, and
              ``pipeline_stack`` over a 2-stage "pod" axis within 1e-5 of
              the sequential fold (gradient 1e-4 relative); (c) llama3-8b
              at full width cut to 2 layers: ``build_variant_cache``'s top
              rung equal leaf for leaf to ``materialize_view`` of the
              weight store's top view, and the rung view with the most
              skipped planes and its materialized copy decoding 8 tokens
              at batch 4 bit for bit on 'packed' and 'fused' (B2, B1).
13. mesh    — serving under a device mesh: (a) in 12b's ``--dist-worker``
              launch, llama3-8b at full width cut to MESH_LAYERS = 8, the
              whole store quantized on both ranks from the same seeded params,
              served by ``ServeEngine(mesh=...)`` on a (1, 2) ("data",
              "model") mesh on 'packed' and 'fused' and a (2, 1) mesh on
              'packed' (ladder 2,4,6, 4-bit cache, batch 4, prompt 32, gen 16,
              a request a rung); then (MESH_CASES) mixtral-8x7b at 2 layers on
              (1, 2) and (2, 1) 'packed' (the experts split by expert),
              zamba2-1.2b at 6 layers on (1, 2) 'packed' (its shared block and
              B3), rwkv6-1.6b at 4 layers on (1, 2) 'fused' and (2, 1)
              'packed', seamless-m4t-medium at full depth (12 + 12) on (1, 2)
              and (2, 1) 'packed' and llama-3.2-vision-90b at 5 layers on (1,
              2) 'packed' (a raw frontend a wave; vision's stores built one
              rank after the other), a request each: rank 0's tokens and every
              step's logits bit for bit against a one-rank engine on the same
              store (graph replays), each rank's store at most 1/2 + 0.02 of
              the whole on (1, 2), both ranks' peaks under 70 GB, the B1 / B2,
              accumulator-mode, epilogue and B3 launches counted; host ms a
              step, tok/s, staged collectives a step and peak memory of each
              rank; (d) in the same launch, ``EncodeEngine(mesh=...)`` of
              seamless and vision on (1, 2) and (2, 1) over 4 raw items, every
              rank's items bit for bit a one-rank engine's on the same store,
              items/s; (e) the fp32 ops a cross-attending mesh rank runs on
              its heads or rows (``rank_shape_ops``), each at the rank's shape
              against one rank's: the encoder's attention, RoPE, layernorm and
              the gate must agree bit for bit (the port runs them so), the
              decode cross-attention's max |diff| is reported (the port runs
              it at one rank's shape); (b) B1 and B2 in the accumulator mode
              and the epilogue entry at the row-parallel shard shapes of every
              13a config (ACC_SHAPES) bit for bit against their plain
              versions, and the shards' sums through the epilogue against the
              whole projection; B1 / B2 at the column shards' shapes and the
              conv stems at a data rank's rows, B2 timed (COLUMN_SHARDS); B3
              at a (1, 2) rank's heads of seamless and vision; timed at M = 4;
              (c) the dry run (``repro_torch.launch.dryrun``) of llama3-8b
              ``decode_32k`` and ``train_4k --reduced`` and
              seamless-m4t-medium ``decode_32k`` on a fake 256-rank group,
              three subprocesses that see no card.

TF32 must stay off for the fp32 matmuls (PyTorch's defaults, asserted at
the start and the end). A ``[time]`` line marks the end of each phase.

The build phase also counts the tensor-core instructions (wgmma's GMMA,
mma.sync's IMMA) in the SASS of the pann_matmul, pann_matmul_packed and
unsigned_matmul libraries, whose tile kernels run on wgmma, and fails on a
library without a GMMA line.

The line before the last is the ``{"kernels": [...]}`` summary; the last line
is ``{"ok": true, "device": {...}}``. A longer report is written to
``chiprun_out/chip_smoke.json`` (git-ignored output directory).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
LADDER = (2, 4, 6)
BATCH, PROMPT, GEN, REQUESTS = 4, 32, 16, 6
CACHE_BITS = 4
L2_FLUSH_BYTES = 256 << 20         # > the 50 MB L2: every timed call is cold
# the GPU sleep ahead of a timed loop, ~0.2 s of GPU clock at most: the
# host enqueues every call while the card sleeps; SLEEP_MARGIN times the
# loop's host time, from SLEEP_MIN_CYCLES (~10 ms) up
SLEEP_CYCLES = 400_000_000
SLEEP_MIN_CYCLES = 20_000_000
SLEEP_MARGIN = 4
PROFILE_STEPS = 2
PROFILE_ATTEMPTS = 3               # profiles of a serve whose counts differ
# the MoE configs served at full width, each cut in depth: to fit one card
# with its fp32 experts (5.64 GB a mixtral layer, 12.68 GB a dbrx layer;
# the full depth needs sharding across cards), and further to keep the
# script inside its time limit: mixtral 8 layers took 20.6 s of phase 4d,
# dbrx 2 layers 9.8 s (NVIDIA H100 80GB HBM3, 700.00 W)
MOE_LAYERS = {"mixtral-8x7b": 2, "dbrx-132b": 1}
MOE_ARCHS = tuple(MOE_LAYERS)
# phase 7d/7e's depth of mixtral: its forward and single point
MOE_PREFILL_LAYERS = 2
# phase 4c's depth of the dense variants (of 40, 42 and 40 layers; gemma2's
# 2: one local and one global layer): cut so the script stays inside its
# time limit (at 8 layers phase 4c took 37 s)
VARIANT_LAYERS = {"qwen1.5-4b": 2, "gemma2-9b": 2, "stablelm-12b": 2}
# the recurrent families at full width (phases 4e and 7f), cut in depth to
# keep the script inside its time limit (at full depth, 38 and 24 layers,
# phase 4e took 33.5 and 36.4 s, 7f 1.7 and 22.2 s): zamba2 two groups
# and its 2-layer tail (the shared block runs at two depths), rwkv6 4
RECURRENT_LAYERS = {"zamba2-1.2b": 14, "rwkv6-1.6b": 4}
# the depth phase 5 cuts each to: zamba2 one group and its 2-layer tail
# (the shared block and the tail both run), rwkv6 2 layers
RECURRENT_CUT = {"zamba2-1.2b": 8, "rwkv6-1.6b": 2}
RECURRENT_ARCHS = tuple(RECURRENT_CUT)
# the cross-attending configs (phases 4f, 7g, 8) at full width:
# seamless-m4t-medium's decoder cut to 4 of 12 layers (its encoder keeps
# its 12; at 12 + 12 phase 4f took 21.0 s), llama-3.2-vision-90b cut to 5
# of 100 layers (one group: a cross-attention layer and 4 self-attention
# layers; at 10 layers phase 4f took 19.3 s; the 100 layers need sharding
# across cards); phase 5 cuts seamless to 2 + 2 layers and vision to its
# one group of 5 (a cross_attn layer past the last whole group gets no
# cross K/V in decode, as in the reference, so no shorter cut crosses)
ENCDEC_LAYERS = {"seamless-m4t-medium": 4, "llama-3.2-vision-90b": 5}
ENCDEC_ARCHS = tuple(ENCDEC_LAYERS)
ENCDEC_CUT = {"seamless-m4t-medium": 2, "llama-3.2-vision-90b": 5}
# phase 5's prompt tokens teacher-forced through every rung, backend and
# the artifact: 8 (at 32 llama3-8b's phase 5 took 60.9 s, the dense
# variants' 37.0, 33.1 and 69.4 s), vision's 4; and its requests:
# vision's 'fused' and 'ref' steps rebuild or widen its weights a step,
# so its phase 5 took 322 s at 32 tokens and 3 requests, 197 s at 8 and
# 3, 115 s at 8 and 1 (NVIDIA H100 80GB HBM3, 700.00 W)
P5_TOKENS = 8
ENCDEC_P5 = {"seamless-m4t-medium": (P5_TOKENS, 3),
             "llama-3.2-vision-90b": (4, 1)}


def served_config(arch: str, **kwargs):
    """``arch``'s config as the script serves it: full width, at its
    depth in MOE_LAYERS, VARIANT_LAYERS, RECURRENT_LAYERS or
    ENCDEC_LAYERS when it has one."""
    from repro_torch import configs
    cfg = configs.get_config(arch, **kwargs)
    layers = {**MOE_LAYERS, **VARIANT_LAYERS, **RECURRENT_LAYERS,
              **ENCDEC_LAYERS}.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

_flush = None


def _cold():
    global _flush
    if _flush is None:
        _flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    _flush.zero_()


def time_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` over ``iters`` calls, each after an L2
    flush, with CUDA events around the call only. A GPU sleep queued first
    lets the host enqueue every call before the card reaches them, so the
    events time the work of the call (its wrapper's small ops included) and
    not the host's Python between launches. The sleep is SLEEP_MARGIN
    times the host time of the calls, from a warm call's (flush
    included), within [SLEEP_MIN_CYCLES, SLEEP_CYCLES]."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _cold()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(min(SLEEP_CYCLES, max(
        SLEEP_MIN_CYCLES,
        SLEEP_MARGIN * iters * host_s * SLEEP_CYCLES / 0.2))))
    for start, end in events:
        _cold()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_core_sass(name: str = "pann_matmul") -> dict:
    """Tensor-core instructions in the SASS of the built ``csrc/<name>.cu``
    library (``cuobjdump`` from the toolkit beside nvcc): GMMA (wgmma) and
    IMMA (mma.sync) lines. Raises if there are none."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    lines = sh([str(tool), "-sass", str(build.library_path(name))]
               ).splitlines()
    counts = {op: sum(op in ln for ln in lines) for op in ("GMMA", "IMMA")}
    if not any(counts.values()):
        raise AssertionError(f"{name}: no tensor-core instruction in its SASS")
    return counts


def sh(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {out.stderr}")
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# (K, N) of every projection of one llama3-8b layer, with its count per
# layer, and the lm_head once per step
LAYER_SHAPES = [((4096, 4096), 2, "wq,wo"), ((4096, 1024), 2, "wk,wv"),
                ((4096, 14336), 2, "w_gate,w_up"), ((14336, 4096), 1,
                                                     "w_down")]
HEAD_SHAPE = ((4096, 128256), 1, "lm_head")


def _attention_layers(cfg) -> int:
    """The layers of ``cfg`` that run a decode attention (B3) a step:
    zamba2's shared block runs at each mamba_attn position, a cross_attn
    layer's self-attention runs it (its cross-attention is fp), rwkv6 has
    none."""
    from repro_torch.models import model as MD
    return sum(s.kind in ("attn", "attn_moe", "mamba_attn", "cross_attn")
               for s in MD.layer_specs(cfg))


def _matmul_operands(gen, m, k, n, planes: int = 7):
    """Operands of B1/B2 at ``planes`` planes: x (m, k) N(0, 1), codes
    uniform in +-(2^planes - 1) as int8 planes and packed planes, (s, z)
    of x at 127 levels, random gamma and zcol."""
    from repro_torch.core import quant
    from repro_torch.kernels.pann_matmul_packed import pack_planes
    x = torch.randn((m, k), generator=gen, device="cuda")
    top = 1 << planes
    codes = torch.randint(1 - top, top, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32)
    pos = torch.empty((planes, k, n), dtype=torch.int8, device="cuda")
    neg = torch.empty_like(pos)
    for p in range(planes):
        pos[p] = (codes.clamp(min=0) >> p) & 1
        neg[p] = ((-codes).clamp(min=0) >> p) & 1
    del codes
    ppk = torch.stack([pack_planes(pos[p]) for p in range(planes)])
    npk = torch.stack([pack_planes(neg[p]) for p in range(planes)])
    lo, hi = quant.act_range_bounds(x)
    n127 = torch.full((), 127.0, device="cuda")
    s, z = quant.affine_scale_zp(lo, hi, n127)
    gamma = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    zcol = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=gen,
                         device="cuda", dtype=torch.int32)
    return x, pos, neg, ppk, npk, s, z, n127, gamma, zcol


# the decode regime's rows: the serve's batch, and the row counts the
# streaming kernels' 4- and 8-row instantiations meet
DECODE_M = (1, 3, 4, 8)
EXTRA_SHIFTS = (0, 5)       # plane_shifts checked at M != BATCH


def _check_decode(x, pos, neg, ppk, npk, s, z, n127, gamma, zcol,
                  shifts, err: dict) -> None:
    """B1 (both modes) and B2 at each plane_shift, B4 (both modes) and B5
    on the int8 codes of x, each bit for bit against its plain version
    (these launches are not the path's)."""
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    from repro_torch.kernels import ref
    for shift in shifts:
        qp = torch.stack([s, z, n127, torch.full((), float(shift),
                                                 device="cuda")])
        p1 = pm.pann_matmul_act_plain(x, pos, neg, qp, gamma, zcol)
        for mode in pm.MODES:
            plain = p1 if mode == "fused" else pm.pann_matmul_act_plain(
                x, pos, neg, qp, gamma, zcol, mode)
            _agree("pann_matmul_act",
                   pm.pann_matmul_act(x, pos, neg, qp, gamma, zcol, mode),
                   plain, err)
        p2 = pk.pann_matmul_packed_act_plain(x, ppk, npk, qp, gamma, zcol)
        _agree("pann_matmul_packed_act",
               pk.pann_matmul_packed_act(x, ppk, npk, qp, gamma, zcol), p2,
               err)
        if not torch.equal(p1, p2):
            raise AssertionError(f"plain versions disagree shift={shift}")
        del p1, p2
    xq, sx = ref.quantize_act_ref(x, 8)
    for mode in pm.MODES:
        _agree("pann_matmul",
               pm.pann_matmul(xq, pos, neg, sx, gamma, zcol, mode=mode),
               pm.pann_matmul_plain(xq, pos, neg, sx, gamma, zcol,
                                    mode=mode), err)
    _agree("pann_matmul_packed",
           pk.pann_matmul_packed(xq, ppk, npk, sx, gamma, zcol),
           pk.pann_matmul_packed_plain(xq, ppk, npk, sx, gamma, zcol), err)


def check_matmuls(gen) -> tuple:
    """Phase 3's matmuls at the serve's projection and lm_head widths: the
    decode kernels against their plain versions at M in DECODE_M (every
    plane_shift at the serve's batch, EXTRA_SHIFTS at the others), then
    B1 and B2 timed at the serve's batch and plane_shift 0. Returns (timed
    rows by kernel, the max |err| by kernel)."""
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    rows = {"pann_matmul_act": [], "pann_matmul_packed_act": []}
    err: dict = {}
    # the rows other than the serve's batch draw from a generator of their
    # own, so every later phase sees the operands it saw before they were
    # added
    extra = torch.Generator(device="cuda")
    extra.manual_seed(1)
    for (k, n), count, names in LAYER_SHAPES + [HEAD_SHAPE]:
        for m in DECODE_M:
            x, pos, neg, ppk, npk, s, z, n127, gamma, zcol = \
                _matmul_operands(gen if m == BATCH else extra, m, k, n)
            _check_decode(x, pos, neg, ppk, npk, s, z, n127, gamma, zcol,
                          range(7) if m == BATCH else EXTRA_SHIFTS, err)
            if m != BATCH:
                del x, pos, neg, ppk, npk
                continue
            # timings at plane_shift 0: every plane live (the top rung)
            qp = torch.stack([s, z, n127, torch.zeros((), device="cuda")])
            w_deq = (pm.rebuild_weight(pos, neg, qp[3]).float()
                     * gamma[None, :])
            lib = time_ms(lambda: torch.matmul(x, w_deq), 20)
            del w_deq
            small = 4 * (m * k + 2 * n + 4 + m * n)
            # a read-only streaming yardstick: one torch.sum over the same
            # plane bytes, timed the same way
            streams = {}
            for name, planes in (("pann_matmul_act", (pos, neg)),
                                 ("pann_matmul_packed_act", (ppk, npk))):
                both = torch.cat([t.reshape(-1) for t in planes])
                words = both.view(torch.int64)
                streams[name] = time_ms(lambda: words.sum(), 20)
                del both, words
            for name, fn, plain, plane_bytes in (
                    ("pann_matmul_act",
                     lambda: pm.pann_matmul_act(x, pos, neg, qp, gamma,
                                                zcol),
                     lambda: pm.pann_matmul_act_plain(x, pos, neg, qp,
                                                      gamma, zcol),
                     2 * 7 * k * n),
                    ("pann_matmul_packed_act",
                     lambda: pk.pann_matmul_packed_act(x, ppk, npk, qp,
                                                       gamma, zcol),
                     lambda: pk.pann_matmul_packed_act_plain(
                         x, ppk, npk, qp, gamma, zcol),
                     2 * 7 * (k // 8) * n)):
                nbytes = small + plane_bytes
                b_ms, b_by = bound_ms(nbytes, 2 * m * k * n)
                ms = time_ms(fn, 20)
                row = {"K": k, "N": n, "M": m, "modules": names,
                       "per_step": count * (32 if names != "lm_head" else 1),
                       "ms": ms, "plain_ms": time_ms(plain, 3),
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                       "tb_per_s": nbytes / (ms * 1e-3) / 1e12,
                       "share_of_bound": b_ms / ms,
                       "stream_ms": streams[name],
                       "shifts_checked": 7, "m_checked": list(DECODE_M),
                       "max_abs_err": err[name]}
                rows[name].append(row)
                print(f"[decode] {name} K={k} N={n} M={m}: {ms:.4f} ms, "
                      f"bound {b_ms:.4f} ms ({b_by}), "
                      f"{row['tb_per_s']:.3f} TB/s, "
                      f"{100 * row['share_of_bound']:.1f} % of bound, "
                      f"library {lib:.4f} ms, torch.sum over the planes "
                      f"{streams[name]:.4f} ms", flush=True)
            del x, pos, neg, ppk, npk
        torch.cuda.empty_cache()
    return rows, err


# B2's tile regime at the serve's widths: a few rows above the decode
# kernels, a tile and a half, a prefill chunk
PACKED_TILE_M = (9, 64, 512)
# the recurrent families' products that llama3-8b's widths do not cover in
# phase 7's forward: rwkv6's decay LoRA (N = 64 below one 128-column tile,
# K = 64 one 64-row step) and zamba2's ssm.in_proj (a half tile at N's end)
RECURRENT_TILE_SHAPES = ((2048, 64), (64, 2048), (2048, 8384))


def check_packed_tile_rows() -> tuple:
    """B2 above 8 rows (the tensor-core tile kernel, mode kPacked) against
    its plain version at the serve's projection and lm_head widths, M in
    PACKED_TILE_M, plane_shift in EXTRA_SHIFTS (these launches are not the
    path's), then at RECURRENT_TILE_SHAPES. Operands from a generator of
    their own, so the later phases see the operands they saw before.
    Returns (max |err|, checked)."""
    from repro_torch.kernels import pann_matmul_packed as pk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    err: dict = {}
    checked = []
    shapes = [kn for kn, _, _ in LAYER_SHAPES + [HEAD_SHAPE]]
    for k, n in shapes + list(RECURRENT_TILE_SHAPES):
        x, _, _, ppk, npk, s, z, n127, gamma, zcol = _matmul_operands(
            gen, max(PACKED_TILE_M), k, n)
        for m in PACKED_TILE_M:
            for shift in EXTRA_SHIFTS:
                qp = torch.stack([s, z, n127, torch.full(
                    (), float(shift), device="cuda")])
                args = (x[:m], ppk, npk, qp, gamma, zcol)
                _agree("pann_matmul_packed_act",
                       pk.pann_matmul_packed_act(*args),
                       pk.pann_matmul_packed_act_plain(*args), err)
            checked.append([m, k, n])
        del x, ppk, npk
        torch.cuda.empty_cache()
    return err.get("pann_matmul_packed_act", 0.0), checked


# B1 and B2 at every plane count a single-point artifact can have (its
# value-exact P: 5 and 6 at the single-point serve's --power_bits 2 and 4)
# at llama3-8b's widest projections; rows: the decode kernel, the tile
# kernel, a (2, 2048) prefill
PLANE_COUNTS = tuple(range(1, 8))
PLANE_M = (4, 64, 4096)
PLANE_SHAPES = ((4096, 14336), (14336, 4096))
TIMED_PLANES, TIMED_M = 5, 4


def _time_planes(x, pos, neg, ppk, npk, s, z, n127, gamma, zcol) -> list:
    """B2 and B1 at TIMED_M rows, plane_shift 0, cold L2, beside their
    plane-byte bound and the fp32 matmul on the dequantized weight."""
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    planes, k, n = pos.shape
    m = TIMED_M
    xm = x[:m]
    qp = torch.stack([s, z, n127, torch.zeros((), device="cuda")])
    w_deq = pm.rebuild_weight(pos, neg, qp[3]).float() * gamma[None, :]
    lib = time_ms(lambda: torch.matmul(xm, w_deq), 20)
    del w_deq
    rows = []
    for name, fn, plain, plane_bytes in (
            ("pann_matmul_packed_act",
             lambda: pk.pann_matmul_packed_act(xm, ppk, npk, qp, gamma,
                                               zcol),
             lambda: pk.pann_matmul_packed_act_plain(xm, ppk, npk, qp,
                                                     gamma, zcol),
             2 * planes * (k // 8) * n),
            ("pann_matmul_act",
             lambda: pm.pann_matmul_act(xm, pos, neg, qp, gamma, zcol),
             lambda: pm.pann_matmul_act_plain(xm, pos, neg, qp, gamma,
                                              zcol),
             2 * planes * k * n)):
        nbytes = 4 * (m * k + 2 * n + 4 + m * n) + plane_bytes
        b_ms, b_by = bound_ms(nbytes, 2 * m * k * n)
        ms = time_ms(fn, 20)
        row = {"kernel": name, "K": k, "N": n, "M": m, "planes": planes,
               "ms": ms, "plain_ms": time_ms(plain, 3), "library_ms": lib,
               "bound_ms": b_ms, "bound_by": b_by,
               "share_of_bound": b_ms / ms}
        rows.append(row)
        print(f"[planes] {name} P={planes} K={k} N={n} M={m}: {ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * row['share_of_bound']:.1f} % of bound, library "
              f"{lib:.4f} ms, plain {row['plain_ms']:.3f} ms", flush=True)
    return rows


def check_plane_counts() -> tuple:
    """B2 and B1 (mode fused) at P = 1..7 planes, M in PLANE_M (B2: the
    decode kernel at 4, the tile kernel above 8 rows), plane_shift 0 and P
    - 1 (the top plane alone), each bit for bit against its plain version
    (these launches are not the path's); B2 and B1 timed at P =
    TIMED_PLANES, M = TIMED_M. Operands from a generator of their own, so
    the later phases see the operands they saw before. Returns (max |err|
    by kernel, the checked (P, shift, M, K, N), the timed rows)."""
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    err: dict = {}
    checked, timed = [], []
    for k, n in PLANE_SHAPES:
        for planes in PLANE_COUNTS:
            ops = _matmul_operands(gen, max(PLANE_M), k, n, planes)
            x, pos, neg, ppk, npk, s, z, n127, gamma, zcol = ops
            for shift in sorted({0, planes - 1}):
                qp = torch.stack([s, z, n127, torch.full(
                    (), float(shift), device="cuda")])
                for m in PLANE_M:
                    args1 = (x[:m], pos, neg, qp, gamma, zcol)
                    args2 = (x[:m], ppk, npk, qp, gamma, zcol)
                    p2 = pk.pann_matmul_packed_act_plain(*args2)
                    _agree("pann_matmul_packed_act",
                           pk.pann_matmul_packed_act(*args2), p2, err)
                    p1 = pm.pann_matmul_act_plain(*args1)
                    if not torch.equal(p1, p2):
                        raise AssertionError(
                            f"plain versions disagree at P={planes} "
                            f"shift={shift} M={m}")
                    _agree("pann_matmul_act", pm.pann_matmul_act(*args1),
                           p1, err)
                    del p1, p2
                    checked.append([planes, shift, m, k, n])
            if planes == TIMED_PLANES:
                timed += _time_planes(*ops)
            del ops, x, pos, neg, ppk, npk
            torch.cuda.empty_cache()
    return err, checked, timed


def _pack_lean(codes: torch.Tensor) -> torch.Tensor:
    """``ref.pack_cache_codes(codes).movedim(0, 1)`` of uint8 codes (B, S,
    KH, hd), a plane at a time in uint8: the reference's int32 (P, ...)
    transients would take 30 GB at S = 131,072."""
    b, s, kh, hd = codes.shape
    c = codes.reshape(b, s, kh, hd // 8, 8)
    planes = torch.empty((b, 7, s, kh, hd // 8), dtype=torch.uint8,
                         device=codes.device)
    for p in range(7):
        acc = torch.zeros((b, s, kh, hd // 8), dtype=torch.uint8,
                          device=codes.device)
        for i in range(8):
            acc |= ((c[..., i] >> p) & 1) << i
        planes[:, p] = acc
    return planes


def _attention_operands(gen, b, kh, g, hd, s, k_bits, v_bits):
    """B3's operands: uniform K / V codes (uint8) packed by ``_pack_lean``
    (held against ``ref.pack_cache_codes`` on the first 64 positions),
    random rows and query codes."""
    from repro_torch.kernels import ref
    kc = torch.randint(0, 1 << k_bits, (b, s, kh, hd), generator=gen,
                       device="cuda", dtype=torch.uint8)
    vc = torch.randint(0, 1 << v_bits, (b, s, kh, hd), generator=gen,
                       device="cuda", dtype=torch.uint8)
    k_planes = _pack_lean(kc)
    if not torch.equal(k_planes[:, :, :64],
                       ref.pack_cache_codes(kc[:, :64]).movedim(0, 1)):
        raise AssertionError("_pack_lean differs from pack_cache_codes")
    return dict(
        qq=torch.randint(0, 128, (b, kh, g, hd), generator=gen,
                         device="cuda", dtype=torch.int32),
        q_z=torch.full((), 41.0, device="cuda"),
        q_scale=torch.full((), 0.004, device="cuda"),
        k_planes=k_planes,
        k_s=torch.rand((b, s), generator=gen, device="cuda") * 0.1 + 0.01,
        k_z=torch.randint(0, 1 << k_bits, (b, s), generator=gen,
                          device="cuda").float(),
        v_planes=_pack_lean(vc),
        v_s=torch.rand((b, s), generator=gen, device="cuda") * 0.1 + 0.01,
        v_z=torch.randint(0, 1 << v_bits, (b, s), generator=gen,
                          device="cuda").float(),
        kc=kc, vc=vc)


ATT_KEYS = ("qq", "q_z", "q_scale", "k_planes", "k_s", "k_z", "v_planes",
            "v_s", "v_z")


def _attention_cases(s: int) -> list:
    """(pos, window) cases of one cache length: the last position, the
    middle, a window of a quarter, the first position; at S = 4096 also
    windows that leave whole cluster blocks masked."""
    cases = [(s - 1, None), (s // 2, None), (s - 1, max(s // 4, 8)),
             (0, None)]
    if s >= 4096:
        cases += [(s - 1, 64), (s // 2, 100)]
    return cases


def _check_attention(a, s, bits, softcap: float = 0.0) -> float:
    """Hold the kernel bit for bit against its plain version at every
    (pos, window) case; the largest difference (0)."""
    from repro_torch.kernels import pann_attention as pa
    args = [a[key] for key in ATT_KEYS]
    pact = torch.full((), float(bits), device="cuda")
    err = 0.0
    long = pa.plan_of(a["qq"], a["k_planes"])[0] == "long"
    before = (pa.launches, pa.long_launches)
    for pos, window in _attention_cases(s):
        p = torch.full((), pos, dtype=torch.int32, device="cuda")
        y = pa.decode_attention(*args, p, pact, pact, window=window,
                                softcap=softcap)
        ref_y = pa.decode_attention_plain(*args, p, window=window,
                                          softcap=softcap)
        diff = (y - ref_y).abs().max().item()
        err = max(err, diff)
        if not torch.equal(y, ref_y):
            shape = tuple(a["qq"].shape)
            raise AssertionError(
                f"decode_attention {shape} S={s} bits={bits} pos={pos} "
                f"window={window} softcap={softcap}: max |diff| {diff} "
                "(must be 0)")
    n = len(_attention_cases(s))
    got = (pa.launches - before[0], pa.long_launches - before[1])
    if got != ((0, n) if long else (n, 0)):
        raise AssertionError(f"decode_attention S={s}: (cluster, long) "
                             f"launches {got} for {n} calls")
    return err


# (config, B, KH, G, hd, softcap) of each served configuration's attention:
# llama3-8b's (the main path) first, then the dense variants', then dbrx's
# (G = 6: each head gets 8 // 6 = 1 of the block's 8 warps), then zamba2's
# shared block (G = 1 at hd 64), seamless's decoder (G = 1 at hd 64) and
# vision's (G = 8: one warp a head); mixtral's is llama3-8b's, rwkv6 has
# none
ATT_SERVE_SHAPES = (("llama3-8b", BATCH, 8, 4, 128, 0.0),
                    ("qwen1.5-4b", BATCH, 20, 1, 128, 0.0),
                    ("gemma2-9b", BATCH, 8, 2, 256, 50.0),
                    ("stablelm-12b", BATCH, 8, 4, 160, 0.0),
                    ("dbrx-132b", BATCH, 8, 6, 128, 0.0),
                    ("zamba2-1.2b", BATCH, 32, 1, 64, 0.0),
                    ("seamless-m4t-medium", BATCH, 16, 1, 64, 0.0),
                    ("llama-3.2-vision-90b", BATCH, 8, 8, 128, 0.0))
ATT_S = (48, 1000, 4096)   # the serve's cache, a ragged one, a long one

# (B, KH, G, hd, S, bits) checked beside the served shapes: G = 8 at
# hd = 64, and the other head dims the kernel takes
ATT_OTHER_SHAPES = ((4, 4, 8, 64, 1000, (1, 4, 7)),
                    (2, 2, 2, 256, 3000, (4, 7)),
                    (2, 2, 8, 16, 700, (3,)), (2, 2, 3, 32, 300, (5,)))


def _attention_rows(gen, arch, b, kh, g, hd, softcap, lengths=ATT_S,
                    bit_set=range(1, 8)) -> list:
    """One served configuration's attention shape at every S in
    ``lengths``: bit for bit at every live-plane count of ``bit_set`` and
    every (pos, window) case, each launch counted on the path its S takes
    (the cluster kernel, or the long path past ``max_seq_len``), timed at
    the serve's cache bits (full cache, no window) beside its bound and
    SDPA on the dequantized K/V; one row per S."""
    import torch.nn.functional as F
    from repro_torch.kernels import pann_attention as pa
    per_step = _attention_layers(served_config(arch))
    out = []
    for s in lengths:
        err, t0 = 0.0, time.perf_counter()
        for bits in bit_set:
            a = _attention_operands(gen, b, kh, g, hd, s, bits, bits)
            err = max(err, _check_attention(a, s, bits, softcap))
            if bits != CACHE_BITS:
                continue
            args = [a[key] for key in ATT_KEYS]
            pact = torch.full((), float(bits), device="cuda")
            p = torch.full((), s - 1, dtype=torch.int32, device="cuda")
            live = 2 * bits * s * kh * (hd // 8)
            nbytes = 4 * b * kh * g * hd * 2 + b * live + 4 * 4 * b * s
            b_ms, b_by = bound_ms(nbytes, 4 * b * kh * g * s * hd)
            path, cluster = pa.plan_of(a["qq"], a["k_planes"])
            row = {
                "config": arch, "B": b, "KH": kh, "G": g, "hd": hd, "S": s,
                "softcap": softcap, "planes_live": bits,
                "per_step": per_step, "path": path, "cluster": cluster,
                "ms": time_ms(lambda: pa.decode_attention(
                    *args, p, pact, pact, softcap=softcap), 20),
                "plain_ms": time_ms(lambda: pa.decode_attention_plain(
                    *args, p, softcap=softcap), 3 if path == "cluster"
                    else 2),
                "bound_ms": b_ms, "bound_by": b_by}
            # SDPA on the dequantized K / V (8.6 GB each at S = 131,072),
            # timed once B3's operands are freed
            kc, vc = a["kc"], a["vc"]
            del a, args
            torch.cuda.empty_cache()
            qf = torch.randn((b, kh * g, 1, hd), generator=gen,
                             device="cuda")
            kf = kc.float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
            vf = vc.float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
            del kc, vc
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qf, kf, vf), 20)
            del qf, kf, vf
            torch.cuda.empty_cache()
        # the largest difference over every live-plane count, position and
        # window checked at this S
        row["max_abs_err"] = err
        row["check_s"] = time.perf_counter() - t0
        out.append(row)
    return out


def check_attention(gen) -> tuple:
    """Timed rows of every served configuration's shape (S = 48, a ragged
    1000, 4096) and the checks at other shapes. llama3-8b's rows and the
    other shapes draw from ``gen``, the variants' from a generator of
    their own. Returns ({config: rows}, checks)."""
    first, *variants = ATT_SERVE_SHAPES
    rows = {first[0]: _attention_rows(gen, *first)}
    if next(r for r in rows[first[0]] if r["S"] == 4096)["cluster"] < 2:
        raise AssertionError("decode_attention: S = 4096 must launch in "
                             "clusters of more than one block")
    checks = _other_attention_checks(gen)
    vgen = torch.Generator(device="cuda")
    vgen.manual_seed(3)
    for shape in variants:
        rows[shape[0]] = _attention_rows(vgen, *shape)
    for arch, arch_rows in rows.items():
        for r in arch_rows:
            print(f"[kernels] decode_attention {arch} " + json.dumps(r),
                  flush=True)
    return rows, checks


def _other_attention_checks(gen) -> list:
    from repro_torch.kernels import pann_attention as pa
    checks = []
    for b2, kh2, g2, hd2, s, bit_set in ATT_OTHER_SHAPES:
        err = 0.0
        for bits in bit_set:
            a = _attention_operands(gen, b2, kh2, g2, hd2, s, bits, bits)
            err = max(err, _check_attention(a, s, bits))
        checks.append({"B": b2, "KH": kh2, "G": g2, "hd": hd2, "S": s,
                       "bits": list(bit_set), "cluster": pa.plan_of(
                           a["qq"], a["k_planes"])[1], "max_abs_err": err})
        print(f"[kernels] decode_attention check {json.dumps(checks[-1])}",
              flush=True)
    return checks


# phase 3, B3's long path (caches past max_seq_len): (config, B, KH, G,
# hd, softcap, cache lengths): llama3-8b's past its 12,032 cap, at
# decode_32k and at 131,072; gemma2-9b's (cap 7,168) at its 8,192 context
# and at decode_32k
ATT_LONG_SHAPES = (("llama3-8b", BATCH, 8, 4, 128, 0.0,
                    (12_288, 32_768, 131_072)),
                   ("gemma2-9b", BATCH, 8, 2, 256, 50.0, (8_192, 32_768)))
ATT_LONG_BITS = (1, 4, 7)


def check_long_attention(gen) -> list:
    """B3's long path: every ATT_LONG_SHAPES case past ``max_seq_len``,
    by ``_attention_rows`` at 1, 4 and 7 live planes. One row a (config,
    S)."""
    from repro_torch.kernels import pann_attention as pa
    rows = []
    for arch, b, kh, g, hd, softcap, lengths in ATT_LONG_SHAPES:
        if min(lengths) <= pa.max_seq_len(g, hd):
            raise AssertionError(f"{arch}: {lengths} not past the cap")
        for r in _attention_rows(gen, arch, b, kh, g, hd, softcap, lengths,
                                 ATT_LONG_BITS):
            r.update(chunk=pa.long_chunk(r["S"]), tile=pa.LONG_TILE)
            rows.append(r)
            print("[kernels] decode_attention long path " + json.dumps(r),
                  flush=True)
    return rows


def check_attention_past_caps() -> list:
    """B3's long path just past the cap of every served shape
    (ATT_SERVE_SHAPES and MESH_ATT_SHAPES at S = ``max_seq_len`` + 1, 4
    live planes, every (pos, window) case), bit for bit: each (G, hd) is
    an instantiation of its own. Operands from a generator of their own.
    One check a shape."""
    from repro_torch.kernels import pann_attention as pa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    checks = []
    for arch, b, kh, g, hd, softcap in ATT_SERVE_SHAPES + MESH_ATT_SHAPES:
        s = pa.max_seq_len(g, hd) + 1
        t0 = time.perf_counter()
        a = _attention_operands(gen, b, kh, g, hd, s, CACHE_BITS, CACHE_BITS)
        err = _check_attention(a, s, CACHE_BITS, softcap)
        del a
        torch.cuda.empty_cache()
        checks.append({"config": arch, "B": b, "KH": kh, "G": g, "hd": hd,
                       "S": s, "softcap": softcap, "bits": CACHE_BITS,
                       "cases": len(_attention_cases(s)), "max_abs_err": err,
                       "check_s": time.perf_counter() - t0})
        print("[kernels] decode_attention long path past the cap "
              + json.dumps(checks[-1]), flush=True)
    return checks


def time_long_below_cap() -> list:
    """Why B3 keeps two kernels: at every served shape's ATT_S rows (4
    planes, full cache) the long path, forced (``path="long"``) and held
    bit for bit to the plain version, timed beside the cluster kernel the
    wrapper launches there. One row a (shape, S)."""
    from repro_torch.kernels import pann_attention as pa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = []
    for arch, b, kh, g, hd, softcap in ATT_SERVE_SHAPES + MESH_ATT_SHAPES:
        for s in ATT_S:
            a = _attention_operands(gen, b, kh, g, hd, s, CACHE_BITS,
                                    CACHE_BITS)
            args = [a[key] for key in ATT_KEYS]
            pact = torch.full((), float(CACHE_BITS), device="cuda")
            p = torch.full((), s - 1, dtype=torch.int32, device="cuda")
            y = pa.decode_attention(*args, p, pact, pact, softcap=softcap,
                                    path="long")
            if not torch.equal(y, pa.decode_attention_plain(
                    *args, p, softcap=softcap)):
                raise AssertionError(f"decode_attention (long path) {arch} "
                                     f"S={s}: not bit for bit")
            row = {"config": arch, "B": b, "KH": kh, "G": g, "hd": hd,
                   "S": s, "cluster": pa.plan_of(a["qq"], a["k_planes"])[1],
                   "cluster_ms": time_ms(lambda: pa.decode_attention(
                       *args, p, pact, pact, softcap=softcap), 20),
                   "long_ms": time_ms(lambda: pa.decode_attention(
                       *args, p, pact, pact, softcap=softcap, path="long"),
                       20)}
            row["long_over_cluster"] = row["long_ms"] / row["cluster_ms"]
            rows.append(row)
            print("[kernels] decode_attention below the cap, long path "
                  "forced " + json.dumps(row), flush=True)
            del a, args
            torch.cuda.empty_cache()
    return rows


VARIANTS = ("qwen1.5-4b", "gemma2-9b", "stablelm-12b")


def _recurrent_shapes(cfg) -> list:
    """((K, N), launches a decode step, modules) of zamba2's Mamba2
    projections and shared block, or of rwkv6's time and channel mix."""
    d, ff, layers = cfg.d_model, cfg.d_ff, cfg.num_layers
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        width = (2 * d_inner + 2 * cfg.ssm_state
                 + d_inner // cfg.ssm_head_dim)
        shared = _attention_layers(cfg)
        hd = cfg.resolved_head_dim
        return [((d, width), layers, "ssm.in_proj"),
                ((d_inner, d), layers, "ssm.out_proj"),
                ((d, cfg.num_heads * hd), 4 * shared,
                 "shared attn.wq,wk,wv,wo"),
                ((d, ff), shared, "shared mlp.w_up"),
                ((ff, d), shared, "shared mlp.w_down")]
    return [((d, d), 5 * layers, "tm.wr,wk,wv,wg,wo"),
            ((d, 64), layers, "tm.decay_a"), ((64, d), layers, "tm.decay_b"),
            ((d, ff), layers, "cm.wk"), ((ff, d), layers, "cm.wv")]


def _cross_shapes(cfg) -> list:
    """((K, N), launches a decode step, modules) of a cross-attending
    config: every layer's self-attention and MLP, and each cross layer's
    xattn.wq and xattn.wo (its K and V are projected once a wave)."""
    from repro_torch.models import model as MD
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    n, cross = cfg.num_layers, sum(s.kind == "cross_attn"
                                   for s in MD.layer_specs(cfg))
    mods = [((d, q), n, "wq"), ((d, kv), 2 * n, "wk,wv"), ((q, d), n, "wo"),
            ((d, q), cross, "xattn.wq"), ((q, d), cross, "xattn.wo"),
            ((d, cfg.d_ff), 2 * n if cfg.activation in ("swiglu", "geglu")
             else n, "mlp up"), ((cfg.d_ff, d), n, "w_down")]
    by: dict = {}
    for kn, count, name in mods:
        c, names = by.get(kn, (0, []))
        by[kn] = (c + count, names + [name])
    return [(kn, c, ",".join(names)) for kn, (c, names) in by.items()]


def _serve_shapes(cfg) -> list:
    """((K, N), launches a decode step, modules) of every B2 shape of one
    decode step of ``cfg``; a tied head is a float matmul, not B2, and so
    are the MoE router and experts (fp32 in the store)."""
    if cfg.family in ("hybrid", "ssm"):
        rows = _recurrent_shapes(cfg)
    elif cfg.family in ("encdec", "vlm"):
        rows = _cross_shapes(cfg)
    else:
        by: dict = {}
        for name, k, n in _projections(cfg)[:4 if cfg.moe else -1]:
            by.setdefault((k, n), []).append(name)
        rows = [((k, n), len(names) * cfg.num_layers, ",".join(names))
                for (k, n), names in by.items()]
    if not cfg.tie_embeddings:
        rows.append(((cfg.d_model, cfg.padded_vocab), 1, "lm_head"))
    return rows


def check_variant_matmuls() -> dict:
    """B2 at each dense variant's, each MoE config's and each recurrent
    config's decode shapes (the attention projections and the head; K =
    6144 and the 100352-wide head at dbrx; zamba2's Mamba2 and shared-block
    projections, rwkv6's mixing matrices and N = 64 / K = 64 decay LoRA),
    bit for bit against its
    plain version at M = BATCH (plane_shift 0-6) and M = 1 (EXTRA_SHIFTS),
    timed at M = BATCH and plane_shift 0 (the top rung) beside its bound
    and the fp32 matmul on the dequantized weight; a tied head's fp32
    matmul over the embedding table (what the serve runs) timed alone.
    Operands from a generator of their own. Returns {config: report}."""
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    out = {}
    for arch in VARIANTS + MOE_ARCHS + RECURRENT_ARCHS + ENCDEC_ARCHS:
        cfg = served_config(arch)
        err: dict = {}
        rows = []
        for (k, n), per_step, names in _serve_shapes(cfg):
            x, pos, neg, ppk, npk, s, z, n127, gamma, zcol = \
                _matmul_operands(gen, BATCH, k, n)
            for m, shifts in ((BATCH, range(7)), (1, EXTRA_SHIFTS)):
                for shift in shifts:
                    qp = torch.stack([s, z, n127, torch.full(
                        (), float(shift), device="cuda")])
                    args = (x[:m], ppk, npk, qp, gamma, zcol)
                    _agree("pann_matmul_packed_act",
                           pk.pann_matmul_packed_act(*args),
                           pk.pann_matmul_packed_act_plain(*args), err)
            qp = torch.stack([s, z, n127, torch.zeros((), device="cuda")])
            w_deq = (pm.rebuild_weight(pos, neg, qp[3]).float()
                     * gamma[None, :])
            del pos, neg
            lib = time_ms(lambda: torch.matmul(x, w_deq), 20)
            del w_deq
            nbytes = (4 * (BATCH * k + 2 * n + 4 + BATCH * n)
                      + 2 * 7 * (k // 8) * n)
            b_ms, b_by = bound_ms(nbytes, 2 * BATCH * k * n)
            ms = time_ms(lambda: pk.pann_matmul_packed_act(
                x, ppk, npk, qp, gamma, zcol), 20)
            row = {"K": k, "N": n, "M": BATCH, "modules": names,
                   "per_step": per_step, "ms": ms,
                   "plain_ms": time_ms(
                       lambda: pk.pann_matmul_packed_act_plain(
                           x, ppk, npk, qp, gamma, zcol), 3),
                   "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                   "share_of_bound": b_ms / ms, "shifts_checked": 7,
                   "max_abs_err": err["pann_matmul_packed_act"]}
            rows.append(row)
            print(f"[decode] {arch} pann_matmul_packed_act K={k} N={n} "
                  f"M={BATCH}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{100 * row['share_of_bound']:.1f} % of bound, library "
                  f"{lib:.4f} ms", flush=True)
            del x, ppk, npk
            torch.cuda.empty_cache()
        tied = None
        if cfg.tie_embeddings:
            table = torch.randn((cfg.padded_vocab, cfg.d_model),
                                generator=gen, device="cuda") * 0.02
            xh = torch.randn((BATCH, 1, cfg.d_model), generator=gen,
                             device="cuda")
            nbytes = 4 * (table.numel() + xh.numel()
                          + BATCH * cfg.padded_vocab)
            b_ms, b_by = bound_ms(nbytes, 2 * BATCH * table.numel(),
                                  FP32_OPS_PER_S)
            tied = {"K": cfg.d_model, "N": cfg.padded_vocab, "M": BATCH,
                    "modules": "lm_head (tied: x @ table.T, fp32)",
                    "ms": time_ms(lambda: xh @ table.t(), 20),
                    "bound_ms": b_ms, "bound_by": b_by}
            print(f"[decode] {arch} tied head fp32 matmul " + json.dumps(
                tied), flush=True)
            del table, xh
            torch.cuda.empty_cache()

        def total(key):
            return float(sum(r[key] * r["per_step"] for r in rows))
        out[arch] = {"rows": rows, "tied_head": tied,
                     "ms_per_step": total("ms"),
                     "bound_ms_per_step": total("bound_ms"),
                     "plain_ms_per_step": total("plain_ms"),
                     "library_ms_per_step": total("library_ms"),
                     "launches_per_step": sum(r["per_step"] for r in rows),
                     "max_abs_err": err.get("pann_matmul_packed_act", 0.0)}
    return out


# a serving projection whose width is no multiple of the kernels' 4 columns
# (ROADMAP C8: seamless-m4t-medium's head is 256,206 wide)
RAGGED_KN = (2048, 1030)


def check_ragged_dispatch() -> dict:
    """C8: ``dispatch.serving_linear`` on a (2048, 1030) module of a weight
    store (ladder LADDER, packed planes) at every rung view and M = 1 and
    BATCH: 'fused' and 'packed' hand their kernels N padded to 1032 and
    slice the result back, bit for bit against 'ref' (these launches are
    not the path's). Returns the checked cases and the launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import serving
    from repro_torch.serve_engine import build_ladder
    k, n = RAGGED_KN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    ladder = build_ladder(LADDER, d=float(k))
    ws = serving.build_weight_store(
        {"lm_head": {"w": torch.randn((k, n), generator=gen, device="cuda")
                     * k ** -0.5}}, served_config("llama3-8b"),
        {op.bits: (op.r, op.b_x_tilde) for op in ladder},
        serving.ServingQuantSpec(pack_planes=True))
    before = _counts()
    cases = 0
    for bits, view in ws.views.items():
        p = view["lm_head"]
        for m in (1, BATCH):
            x = torch.randn((m, 1, k), generator=gen, device="cuda")
            want = dispatch.serving_linear(x, p, "ref")
            for backend in ("fused", "packed"):
                got = dispatch.serving_linear(x, p, backend)
                if got.shape != (m, 1, n) or not torch.equal(got, want):
                    raise AssertionError(
                        f"serving_linear N={n} {backend} rung {bits} M={m}:"
                        f" {tuple(got.shape)}, max |diff| "
                        f"{(got - want).abs().max().item()} (must be 0)")
                cases += 1
    launched = {key: v - before[key] for key, v in _counts().items()
                if v != before[key]}
    if launched != {"pann_matmul_act": cases // 2,
                    "pann_matmul_packed_act": cases // 2}:
        raise AssertionError(f"ragged N launches {launched}")
    return {"K": k, "N": n, "N_padded": n + (-n) % 4, "cases": cases,
            "launches": launched, "max_abs_err": 0.0}

# the encode path's products above 8 rows (M, K, N, modules): seamless's
# two stem layers (4 x 2048 and 4 x 1024 positions), vision's patchify
# (4 x 1600 patches, K = 588, which the packed planes pad to 592), the
# encoder's projections and the cross K/V at seamless's 4 x 1024 rows,
# and vision's cross K/V at its 4 x 1600 image tokens
ENCODE_SHAPES = ((8192, 240, 1024, "seamless conv.s0"),
                 (4096, 3072, 1024, "seamless conv.s1"),
                 (6400, 588, 8192, "vision conv.s0"),
                 (4096, 1024, 1024, "seamless encoder attn, cross wk,wv"),
                 (6400, 8192, 1024, "vision cross wk,wv"))
ENCODE_SHIFTS = (0, 5)


def check_encode_matmuls(gen) -> tuple:
    """B1 ('fused') and B2 at the encode path's shapes (ENCODE_SHAPES) bit
    for bit against their plain versions at plane_shift 0 and 5, B2 on
    x zero-padded to the packed planes' K as ``dispatch`` pads it; each
    timed at plane_shift 0 beside its bound and the fp32 matmul on the
    dequantized weight. Returns (rows, max |err| by kernel)."""
    import torch.nn.functional as F
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    err: dict = {}
    rows = []
    for m, k, n, names in ENCODE_SHAPES:
        x, pos, neg, ppk, npk, s, z, n127, gamma, zcol = \
            _matmul_operands(gen, m, k, n)
        xk = F.pad(x, (0, ppk.shape[1] * 8 - k))
        for shift in ENCODE_SHIFTS:
            qp = torch.stack([s, z, n127, torch.full((), float(shift),
                                                     device="cuda")])
            p1 = pm.pann_matmul_act_plain(x, pos, neg, qp, gamma, zcol)
            _agree("pann_matmul_act",
                   pm.pann_matmul_act(x, pos, neg, qp, gamma, zcol), p1, err)
            p2 = pk.pann_matmul_packed_act_plain(xk, ppk, npk, qp, gamma,
                                                 zcol)
            _agree("pann_matmul_packed_act",
                   pk.pann_matmul_packed_act(xk, ppk, npk, qp, gamma, zcol),
                   p2, err)
            if not torch.equal(p1, p2):
                raise AssertionError(f"plain versions disagree at M={m} "
                                     f"K={k} N={n} shift={shift}")
            del p1, p2
        qp = torch.stack([s, z, n127, torch.zeros((), device="cuda")])
        w_deq = pm.rebuild_weight(pos, neg, qp[3]).float() * gamma[None, :]
        lib = time_ms(lambda: torch.matmul(x, w_deq), 10)
        del w_deq
        small = 4 * (m * k + 2 * n + 4 + m * n)
        for name, fn, plain, plane_bytes in (
                ("pann_matmul_act",
                 lambda: pm.pann_matmul_act(x, pos, neg, qp, gamma, zcol),
                 lambda: pm.pann_matmul_act_plain(x, pos, neg, qp, gamma,
                                                  zcol),
                 2 * 7 * k * n),
                ("pann_matmul_packed_act",
                 lambda: pk.pann_matmul_packed_act(xk, ppk, npk, qp, gamma,
                                                   zcol),
                 lambda: pk.pann_matmul_packed_act_plain(xk, ppk, npk, qp,
                                                         gamma, zcol),
                 2 * 7 * ppk.shape[1] * n)):
            b_ms, b_by = bound_ms(small + plane_bytes, 2 * m * k * n)
            ms = time_ms(fn, 10)
            row = {"kernel": name, "M": m, "K": k, "N": n,
                   "K_packed": ppk.shape[1] * 8, "modules": names, "ms": ms,
                   "plain_ms": time_ms(plain, 2), "library_ms": lib,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "share_of_bound": b_ms / ms,
                   "shifts_checked": list(ENCODE_SHIFTS),
                   "max_abs_err": err[name]}
            rows.append(row)
            print(f"[encode] {name} M={m} K={k} N={n} ({names}): {ms:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{100 * row['share_of_bound']:.1f} % of bound, library "
                  f"{lib:.4f} ms, plain {row['plain_ms']:.3f} ms",
                  flush=True)
        del x, xk, pos, neg, ppk, npk
        torch.cuda.empty_cache()
    return rows, err


def check_serving_conv() -> dict:
    """``dispatch.serving_conv`` on 'ref', 'fused' and 'packed' bit for bit
    against ``serving_conv_oracle`` (an exact float64 convolution of the
    codes) at both cross-attending configs' full-width stems, on every
    rung view of a stem-only weight store (ladder LADDER, packed planes,
    seeded biases): seamless's s0 over raw (4, 4096, 1, 80) features and
    s1 over relu(s0), vision's patchify over (4, 560, 560, 3) pixels.
    These launches are not the path's."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import dispatch
    from repro_torch.models import serving
    from repro_torch.serve_engine import build_ladder
    out = {}
    for i, arch in enumerate(ENCDEC_ARCHS):
        cfg = served_config(arch, quant=QuantConfig(mode="none"))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(40 + i)
        params = {"conv_stem": {}}
        for j, spec in enumerate(cfg.conv_stem):
            params["conv_stem"][f"s{j}"] = {
                "w": torch.randn((spec.fan_in, spec.c_out), generator=gen,
                                 device="cuda") * spec.fan_in ** -0.5,
                "b": torch.randn((spec.c_out,), generator=gen,
                                 device="cuda") * 0.1}
        ladder = build_ladder(LADDER, d=float(cfg.d_model))
        ws = serving.build_weight_store(
            params, cfg, {op.bits: (op.r, op.b_x_tilde) for op in ladder},
            serving.ServingQuantSpec(pack_planes=True))
        x = Frontend(cfg, 40 + i).raw(BATCH, 0)
        cases, t0 = 0, time.perf_counter()
        for j, spec in enumerate(cfg.conv_stem):
            outs = {}
            for bits, view in ws.views.items():
                p = view["conv_stem"][f"s{j}"]
                want = dispatch.serving_conv_oracle(x, p, spec)
                if not torch.isfinite(want).all():
                    raise AssertionError(f"{arch} s{j}: oracle not finite")
                for backend in ("ref", "fused", "packed"):
                    got = dispatch.serving_conv(x, p, spec, backend)
                    if not torch.equal(got, want):
                        d = (got - want).abs().max().item()
                        raise AssertionError(
                            f"serving_conv {arch} s{j} rung {bits} "
                            f"{backend}: max |diff| {d} (must be 0)")
                    cases += 1
                outs[bits] = want
            if torch.equal(outs[min(outs)], outs[max(outs)]):
                raise AssertionError(f"{arch} s{j}: rungs agree")
            x = torch.relu(outs[max(outs)])
        out[arch] = {"stem": [dataclasses.asdict(sp) for sp in cfg.conv_stem],
                     "input": [BATCH, *cfg.frontend_hw,
                               cfg.conv_stem[0].c_in],
                     "cases": cases, "seconds": time.perf_counter() - t0,
                     "max_abs_err": 0.0}
        print(f"[kernels] serving_conv {arch}: {cases} cases bit-identical "
              f"to the float64 oracle ({out[arch]['seconds']:.1f} s)",
              flush=True)
        del ws, params, x, outs
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: serving through the port's entry points
# ---------------------------------------------------------------------------

def _requests(cfg, seed, n=REQUESTS):
    from repro_torch.serve_engine import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               PROMPT).astype(np.int32),
                    max_new_tokens=GEN,
                    power_budget_bits=LADDER[i % len(LADDER)])
            for i in range(n)]


# every wrapper's launch counter: (kernel, module, attribute)
COUNTERS = (("pann_matmul_act", "pann_matmul", "launches"),
            ("pann_matmul_packed_act", "pann_matmul_packed", "launches"),
            ("decode_attention", "pann_attention", "launches"),
            ("decode_attention_long", "pann_attention", "long_launches"),
            ("pann_matmul", "pann_matmul", "pann_matmul_launches"),
            ("pann_matmul_packed", "pann_matmul_packed",
             "pann_matmul_packed_launches"),
            ("unsigned_matmul", "unsigned_matmul", "launches"),
            ("quantize_act", "quantize_act", "launches"),
            ("pann_matmul_act_acc", "pann_matmul", "acc_launches"),
            ("pann_matmul_packed_act_acc", "pann_matmul_packed",
             "acc_launches"),
            ("pann_epilogue", "pann_matmul", "epilogue_launches"))


def _counter_module(name: str):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _reset_counts():
    for _, mod, attr in COUNTERS:
        setattr(_counter_module(mod), attr, 0)


def _counts() -> dict:
    return {kernel: getattr(_counter_module(mod), attr)
            for kernel, mod, attr in COUNTERS}


def _graph_launches(cfg) -> dict:
    """The wrappers' launches of one decode step of an engine serving
    ``cfg`` through the packed backend with a quantized cache: one matmul
    a projection of every layer (a MoE layer's router and experts are
    fp32 matmuls; a mamba layer has 2, a mamba_attn layer 2 and the shared
    block's, an rwkv layer 9, a cross_attn layer its self-attention's 4,
    xattn.wq and xattn.wo and the MLP's), and the lm_head unless the head
    is tied (a float matmul over the embedding table); one attention a
    layer that self-attends."""
    from repro_torch.models import model as MD
    mlp = 3 if cfg.activation in ("swiglu", "geglu") else 2
    per_kind = {"attn": 4 + mlp, "attn_moe": 4, "mamba": 2,
                "mamba_attn": 2 + 4 + mlp, "rwkv": 9,
                "cross_attn": 4 + 2 + mlp}
    return {"pann_matmul_packed_act": sum(
                per_kind[s.kind] for s in MD.layer_specs(cfg))
            + (0 if cfg.tie_embeddings else 1),
            "decode_attention": _attention_layers(cfg)}


def _frontend_launches(cfg) -> int:
    """B2 launches of one wave's frontend (``ServeEngine._load_frontend``;
    also the frontend part of a ``forward``): one a conv-stem layer, an
    encoder layer's 4 + MLP projections, and each cross_attn layer's K
    and V."""
    from repro_torch.models import model as MD
    mlp = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return (len(cfg.conv_stem) + cfg.encoder_layers * (4 + mlp)
            + 2 * sum(s.kind == "cross_attn" for s in MD.layer_specs(cfg)))


class Frontend:
    """``frontend_kwargs_fn`` of a cross-attending config: raw 4-D input
    from ``data.pipeline.frontend_raw_stub`` with the seed, the next step
    at every call, each kept (on the card) for the eager replay."""

    def __init__(self, cfg, seed: int):
        self.cfg, self.seed, self.made = cfg, seed, []
        self.key = "enc_inputs" if cfg.family == "encdec" else "image_embeds"

    def raw(self, batch: int, step: int) -> torch.Tensor:
        from repro_torch.data.pipeline import frontend_raw_stub
        return torch.as_tensor(frontend_raw_stub(self.cfg, batch, step,
                                                 self.seed), device="cuda")

    def __call__(self, batch: int) -> dict:
        self.made.append(self.raw(batch, len(self.made)))
        return {self.key: self.made[-1]}


def _check_capture_counts(engine, counts: dict, per_step: dict) -> None:
    """The wrappers count a launch while ``warmup`` captures a graph (a
    replay launches without them) and in its eager step per rung before
    the captures: (rungs + graphs) steps' worth, nothing else."""
    steps = len(engine.ladder) + engine.graphs_captured
    want = dict.fromkeys(counts, 0)
    want.update({k: v * steps for k, v in per_step.items()})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want} "
                             f"over warmup's {steps} steps")


def _record(engine):
    """Log every wave the engine starts and every decode step's input
    token and logits (device copies) by wrapping its slot acquisition and
    its step; returns (log, restore)."""
    log = []
    acquire, run = engine._acquire, engine._run_step

    def rec_acquire():
        slot = acquire()
        log.append(("wave", slot.index))
        return slot

    def rec_run(bits, slot):
        tok = slot.tok.clone()
        logits = run(bits, slot)
        log.append(("step", slot.index, bits, tok, logits.clone()))
        return logits

    engine._acquire, engine._run_step = rec_acquire, rec_run

    def restore():
        del engine._acquire, engine._run_step

    return log, restore


def eager_replay(engine, log, frontends=None) -> dict:
    """Replay every logged wave eagerly through ``MD.decode_step`` on the
    engine's views from a fresh decode state (for a cross-attending
    config built by ``MD.init_decode_state`` off the wave's frontend input,
    ``frontends`` in wave order, never from the slot's buffers): every
    graphed step's logits must be finite and bit-identical to the eager
    step's."""
    from repro_torch.models import model as MD
    current, waves = {}, []
    for entry in log:
        if entry[0] == "wave":
            current[entry[1]] = []
            waves.append(current[entry[1]])
        else:
            current[entry[1]].append(entry[2:])
    err: dict = {}
    steps = 0
    if frontends is not None and len(frontends) != len(waves):
        raise AssertionError(f"{len(frontends)} frontends for {len(waves)} "
                             "waves")
    for i, wave in enumerate(waves):
        if not wave:
            continue
        bits = wave[0][0]
        view = engine.variants[bits]
        state = MD.init_decode_state(view, engine.cfg, engine.max_batch,
                                     engine.max_len,
                                     **({} if frontends is None
                                        else frontends[i]))
        for b, tok, graphed in wave:
            if b != bits:
                raise AssertionError("a wave switched rung mid-flight")
            if not torch.isfinite(graphed).all():
                raise AssertionError(f"rung {bits}: graphed logits not "
                                     "finite")
            logits, state = MD.decode_step(view, engine.cfg, state, tok)
            d = (logits.double() - graphed.double()).abs().max().item()
            err[bits] = max(err.get(bits, 0.0), d)
            if not torch.equal(logits, graphed):
                raise AssertionError(f"rung {bits}, step {steps}: graphed "
                                     f"logits differ from eager by {d}")
            steps += 1
    return {"waves": len([w for w in waves if w]), "steps": steps,
            "max_abs_err_by_rung": err}


def _timed_frontend(engine, fe: dict) -> None:
    """Wrap the engine's wave-start frontend (stem, encoder, cross K/V
    projections, run eagerly between replays): each call's host ms (both
    ends synchronised) and wrapper launches go into ``fe``."""
    load = engine._load_frontend

    def timed(bits, slot):
        torch.cuda.synchronize()
        before = _counts()
        t0 = time.perf_counter()
        load(bits, slot)
        torch.cuda.synchronize()
        fe["ms"].append((time.perf_counter() - t0) * 1e3)
        fe["launches"].append({k: v - before[k] for k, v in _counts().items()
                               if v != before[k]})

    engine._load_frontend = timed


def serve_graphed(engine, reqs, vocab: int, frontend=None) -> dict:
    """Warm the engine up (every graph captured) with the launch counters
    from 0, serve ``reqs`` (timed), prove that nothing was captured or
    launched outside a replay while serving, then serve them again with
    every step recorded and replay every wave eagerly. With a
    ``Frontend``, each wave's frontend runs eagerly at its start: its
    launches and ms are reported apart (``frontend``) and taken out of
    the step's."""
    _reset_counts()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    counts = _counts()
    steps0 = dict(engine.steps_by_rung)
    fe = {"ms": [], "launches": []}
    if frontend is not None:
        _timed_frontend(engine, fe)
    t0 = time.perf_counter()
    responses = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.assert_no_recompile()
    outside = {k: v - sum(f.get(k, 0) for f in fe["launches"])
               for k, v in _counts().items()}
    if outside != counts:
        raise AssertionError(f"a wrapper launched while serving: {counts} "
                             f"-> {outside} besides the frontends: a step "
                             "ran outside a graph")
    steps_by_rung = {b: engine.steps_by_rung[b] - steps0[b]
                     for b in engine.rungs}
    for r in responses:
        if len(r.tokens) != GEN or not all(0 <= t < vocab
                                           for t in r.tokens):
            raise AssertionError(f"request {r.uid}: bad tokens {r.tokens}")
    n_made = 0 if frontend is None else len(frontend.made)
    log, restore = _record(engine)
    try:
        again = engine.generate(reqs)
    finally:
        restore()
    engine.assert_no_recompile()
    if frontend is not None:
        del engine._load_frontend
    same = [r.tokens for r in again] == [r.tokens for r in responses]
    if not same and frontend is None:
        raise AssertionError("a second serve of the same requests gave "
                             "other tokens")
    t0 = time.perf_counter()
    replay = eager_replay(engine, log, None if frontend is None else [
        {frontend.key: t} for t in frontend.made[n_made:]])
    replay["seconds"] = time.perf_counter() - t0
    del log
    steps = sum(steps_by_rung.values())
    n_tok = sum(len(r.tokens) for r in responses)
    fe_s = sum(fe["ms"]) / 1e3
    out = {"responses": responses, "launches": counts,
           "warmup_s": warmup_s, "generate_s": wall,
           "decode_steps": steps, "steps_by_rung": steps_by_rung,
           "ms_per_step": (wall - fe_s) / steps * 1e3,
           "tok_per_s": n_tok / wall, "generated": n_tok,
           "compilations_after_warmup": engine.compilations_after_warmup,
           "eager_replay": replay}
    if frontend is not None:
        # a new frontend every wave: the second serve's tokens may differ
        out["frontend"] = {
            "waves": len(fe["ms"]), "ms": fe["ms"],
            "launches_per_wave": fe["launches"],
            "seconds_in_generate": fe_s,
            "second_serve_same_tokens": same,
            "ms_per_step_is": "(generate_s - the frontends' s) / steps"}
    return out


def _seed_biases(params: dict, seed: int) -> None:
    """Nonzero q/k/v biases, N(0, 0.1^2) from ``seed``: init makes them
    zero, and a zero bias would check nothing."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1000 + seed)
    for lp in params["layers"]:
        for name in ("wq", "wk", "wv"):
            b = lp["attn"][name]["b"]
            b.copy_(torch.randn(b.shape, generator=gen, device="cuda") * 0.1)


def _seed_recurrent(params: dict, seed: int) -> None:
    """Nonzero rwkv bonus (u) and Mamba2 conv bias, N(0, 0.1^2) from
    ``seed``: init makes them zero, and a zero would check nothing."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2000 + seed)
    for lp in params["layers"]:
        for t in ([lp["tm"]["bonus"]] if "tm" in lp else []) + \
                ([lp["ssm"]["conv_b"]] if "ssm" in lp else []):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.1)


def _seed_cross(params: dict, seed: int) -> None:
    """Nonzero cross-attention gates (0.5 + N(0, 0.1^2)), conv-stem biases
    and layernorm biases (N(0, 0.1^2)) from ``seed``: init makes them
    zero, and tanh(0) = 0 would make every cross-attention check pass
    without cross-attending."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3000 + seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, name)
        elif name in ("xgate", "bias", "b"):
            noise = torch.randn(node.shape, generator=gen, device="cuda")
            node.copy_(noise * 0.1 + (0.5 if name == "xgate" else 0.0))

    walk({k: params[k] for k in ("layers", "conv_stem", "encoder",
                                 "enc_norm", "final_norm") if k in params})


def _init_params(cfg, seed: int) -> dict:
    from repro_torch.models import model as MD
    params = MD.init_params(cfg, seed=seed, device="cuda")
    if cfg.qkv_bias:
        _seed_biases(params, seed)
    if cfg.family in ("hybrid", "ssm"):
        _seed_recurrent(params, seed)
    if cfg.family in ("encdec", "vlm"):
        _seed_cross(params, seed)
    return params


def full_width_serve(arch: str = "llama3-8b", seed: int = 0,
                     n_requests: int = REQUESTS,
                     eager_profile: bool = True) -> dict:
    """Phase 4 (llama3-8b), 4c (each dense variant), 4d (each MoE config
    at its MOE_LAYERS depth), 4e (each recurrent config) and 4f (each
    cross-attending config at its ENCDEC_LAYERS depth, a raw frontend a
    wave): one config at full width served through graphs, held to eager
    and profiled. An attention-free config (rwkv6) is served without a KV
    cache."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.serve_engine import ServeEngine
    cfg = served_config(arch, quant=QuantConfig(mode="none"))
    cache_bits = None if cfg.is_attention_free else CACHE_BITS
    frontend = (Frontend(cfg, seed) if cfg.family in ("encdec", "vlm")
                else None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, _init_params(cfg, seed),
                         ladder_bits=LADDER, max_batch=BATCH,
                         max_len=PROMPT + GEN, backend="packed",
                         cache_bits=cache_bits, device="cuda",
                         frontend_kwargs_fn=frontend)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    served = serve_graphed(engine, _requests(cfg, seed=seed, n=n_requests),
                           cfg.vocab_size, frontend)
    if frontend is not None:
        want = _frontend_launches(cfg)
        got = served["frontend"]["launches_per_wave"]
        if any(f != {"pann_matmul_packed_act": want} for f in got):
            raise AssertionError(f"frontend launches {got}, want {want} B2 "
                                 "a wave")
    n_layers = cfg.num_layers
    per_step = _graph_launches(cfg)
    _check_capture_counts(engine, served["launches"], per_step)
    steps_by_rung = served["steps_by_rung"]
    # one launch per matmul (the split-K sum and epilogue run inside the
    # decode kernel) and one per attention, in every graphed step. A graph
    # replays the same kernels every time, but the profiler on the H100
    # host can lose a record inside a counted window too (once in a
    # stablelm-12b window: 280.8 B2 a step): a profile whose counts differ
    # is taken again, PROFILE_ATTEMPTS times at most
    want_ops = dict(per_step, epilogue=0)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        names: dict = {}
        profile = profile_steps(functools.partial(_graph_runner, engine),
                                steps_by_rung, names)
        if profile["device_ms_per_step"] is None:
            raise AssertionError("the profiler recorded no kernel of a graph "
                                 "replay: the step's kernels are not "
                                 "counted")
        ops = profile["device_ops_per_step_by_kind"]
        got_ops = {k: ops.get(k, 0.0) for k in want_ops}
        if got_ops == want_ops:
            break
        print(f"[profile] {arch} attempt {attempt}: device kernels per "
              f"graphed step {got_ops} != {want_ops}", flush=True)
    else:
        raise AssertionError(f"device kernels per graphed step {got_ops} != "
                             f"{want_ops} in {PROFILE_ATTEMPTS} profiles")
    profile["attempts"] = attempt
    # the heaviest kernels by name over every profiled step
    profile["top_kernels_ms"] = dict(sorted(
        names.items(), key=lambda kv: -kv[1])[:8])
    eager = (profile_steps(functools.partial(_eager_runner, engine),
                           steps_by_rung) if eager_profile else None)
    split = (recurrent_split(engine, profile)
             if cfg.family in ("hybrid", "ssm") else None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= 70.0:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB >= 70 GB")
    responses = served.pop("responses")
    ms = served["ms_per_step"]
    full = configs.get_config(arch).num_layers
    cut = (f" (of {full}: cut to fit one card and the script's time)"
           if n_layers != full else "")
    out = {
        "config": f"{arch} full width, {n_layers} layers{cut}, random "
                  f"weights seed {seed}" + ("; q/k/v biases N(0, 0.1^2)"
                                            if cfg.qkv_bias else "")
                  + ("; xgate 0.5 + N(0, 0.1^2), conv and layernorm biases"
                     " N(0, 0.1^2); a raw frontend_raw_stub input a wave"
                     if frontend is not None else ""),
        "ladder": list(LADDER), "backend": "packed",
        "cache_bits": cache_bits,
        "max_batch": BATCH, "prompt": PROMPT, "gen": GEN,
        "requests": n_requests, "store_build_s": build_s, **served,
        "graphs": engine.graphs_captured,
        "profile": profile,
        # the rung-weighted device time of a graphed step over its host
        # wall time
        "device_busy_share": profile["device_ms_per_step"] / ms,
        "eager_profile": eager,
        "peak_mem_gb": peak_gb,
        "launches_per_captured_step": per_step,
        "tokens": {r.uid: r.tokens for r in responses},
        "rung_bits": {r.uid: r.rung_bits for r in responses},
        "est_gbitflips_per_token": {
            r.uid: r.metadata["est_gbitflips_per_token"] for r in responses},
    }
    if cfg.moe:
        out["fp32_matmuls"] = _moe_matmul_report(cfg, profile)
    if split is not None:
        out["device_ms_split"] = split
    if frontend is not None:
        out["frontend"]["b2_launches_per_wave"] = _frontend_launches(cfg)
        out["frontend"]["encoder_layers"] = cfg.encoder_layers
        out["frontend"]["input_shape"] = list(frontend.made[0].shape)
    del engine, frontend
    torch.cuda.empty_cache()
    return out


# phase 4g: long-context decode. gemma2-9b at full width, one local and
# one global layer (VARIANT_LAYERS), serving its 8,192-token context
# (Gemma 2, arXiv:2408.00118): the global layer's 8,192-row cache is past
# B3's cap (7,168 at G = 2, hd = 256), so its attention takes the long
# path; the local layer's ring of 4,096 rows wraps once
LONG_ARCH = "gemma2-9b"
LONG_MAX_LEN = 8_192
LONG_GEN = 32
LONG_PROMPT = LONG_MAX_LEN - LONG_GEN
LONG_REQUESTS = 4
LONG_TIMED_STEPS = 64      # the last steps, timed on the host clock


def long_context_serve(seed: int = 4) -> dict:
    """Phase 4g: LONG_REQUESTS requests of LONG_PROMPT tokens and LONG_GEN
    generated ones, one wave at batch BATCH, through graphs on 'packed'
    with the 4-bit cache at max_len LONG_MAX_LEN. Checks: graphed steps,
    nothing captured after warmup, no launch outside a replay, the slot's
    cache rows (the local ring 4,096, the global layer 8,192), and the
    last step (at position 8,190) run once more on 'ref' from a copy of
    the state it started from: logits bit for bit. Reports the host ms a
    step over the last LONG_TIMED_STEPS steps and B3's device ms at the
    last step's operands (the long path on the global cache, the cluster
    kernel on the local ring)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import pann_attention as pa
    from repro_torch.models import model as MD
    from repro_torch.models import transformer as T
    from repro_torch.serve_engine import Request, ServeEngine
    cfg = served_config(LONG_ARCH, quant=QuantConfig(mode="none"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, _init_params(cfg, seed), ladder_bits=LADDER,
                         max_batch=BATCH, max_len=LONG_MAX_LEN,
                         backend="packed", cache_bits=CACHE_BITS,
                         device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not engine.graphed:
        raise AssertionError("phase 4g: the engine does not run graphs")
    specs = MD.layer_specs(engine.cfg)
    g = cfg.num_heads // cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    rows = [T.cache_rows(sp, LONG_MAX_LEN) for sp in specs]
    long_layers = sum(r > pa.max_seq_len(g, hd) for r in rows)
    per_step = _graph_launches(cfg)
    per_step["decode_attention"] -= long_layers
    per_step["decode_attention_long"] = long_layers
    if long_layers != 1:
        raise AssertionError(f"phase 4g: cache rows {rows}, want one layer "
                             f"past B3's cap {pa.max_seq_len(g, hd)}")
    _reset_counts()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    counts = _counts()
    _check_capture_counts(engine, counts, per_step)
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               LONG_PROMPT).astype(np.int32),
                    max_new_tokens=LONG_GEN, power_budget_bits=LADDER[1])
            for i in range(LONG_REQUESTS)]
    n_steps = LONG_PROMPT + LONG_GEN - 1
    run, seen, rec = engine._run_step, [0], {}

    def step(bits, slot):
        i = seen[0]
        seen[0] += 1
        if i == n_steps - LONG_TIMED_STEPS:
            torch.cuda.synchronize()
            rec["t0"] = time.perf_counter()
        if i != n_steps - 1:
            return run(bits, slot)
        torch.cuda.synchronize()
        rec["t1"] = time.perf_counter()
        rec.update(bits=bits, state=_clone(slot.state),
                   tok=slot.tok.clone())
        logits = run(bits, slot)
        rec["logits"] = logits.clone()
        rec["rows"] = [(c.k_s.shape[1], int(c.length)) for c in
                       slot.state.caches]
        return logits

    engine._run_step = step
    t0 = time.perf_counter()
    try:
        responses = engine.generate(reqs)
        torch.cuda.synchronize()
    finally:
        del engine._run_step
    wall = time.perf_counter() - t0
    engine.assert_no_recompile()
    if _counts() != counts:
        raise AssertionError(f"a wrapper launched while serving: {counts} "
                             f"-> {_counts()}: a step ran outside a graph")
    if seen[0] != n_steps:
        raise AssertionError(f"phase 4g: {seen[0]} steps, want {n_steps}")
    if rec["rows"] != [(r, n_steps) for r in rows] or rows != [
            4096 if sp.window else LONG_MAX_LEN for sp in specs]:
        raise AssertionError(f"phase 4g: cache (rows, length) "
                             f"{rec['rows']}, want rows {rows}")
    for r in responses:
        if len(r.tokens) != LONG_GEN or not all(0 <= t < cfg.vocab_size
                                                for t in r.tokens):
            raise AssertionError(f"request {r.uid}: bad tokens {r.tokens}")
    # the last step once more on 'ref' (the plain versions) from its state
    ref_cfg = dataclasses.replace(engine.cfg, kernel_backend="ref")
    ref_logits, _ = MD.decode_step(engine.variants[rec["bits"]], ref_cfg,
                                   rec["state"], rec["tok"])
    if not torch.isfinite(rec["logits"]).all():
        raise AssertionError("phase 4g: the last step's logits not finite")
    if not torch.equal(ref_logits, rec["logits"]):
        d = (ref_logits - rec["logits"]).abs().max().item()
        raise AssertionError(f"phase 4g: 'ref' logits differ from 'packed' "
                             f"by {d} at the last step")
    del ref_logits
    # B3 at the last step's operands: the long path on the global cache,
    # the cluster kernel on the local ring
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    qq = torch.randint(0, 128, (BATCH, cfg.num_kv_heads, g, hd),
                       generator=gen, device="cuda", dtype=torch.int32)
    q_z = torch.full((), 41.0, device="cuda")
    q_scale = torch.full((), 0.004, device="cuda")
    pact = torch.full((), float(CACHE_BITS), device="cuda")
    pos = torch.full((), n_steps - 1, dtype=torch.int32, device="cuda")
    b3 = {}
    for sp, cache in zip(specs, rec["state"].caches):
        args = (qq, q_z, q_scale, cache.k_planes, cache.k_s, cache.k_z,
                cache.v_planes, cache.v_s, cache.v_z, pos, pact, pact)
        key = "local ring" if sp.window else "global"
        path = pa.plan_of(qq, cache.k_planes)
        b3[key] = {"rows": cache.k_s.shape[1], "path": path[0],
                   "cluster": path[1], "device_ms": time_ms(
                       lambda: pa.decode_attention(
                           *args, softcap=cfg.attn_softcap), 10)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_ms = (rec["t1"] - rec["t0"]) / (LONG_TIMED_STEPS - 1) * 1e3
    out = {"config": f"{LONG_ARCH} full width, {cfg.num_layers} layers (one "
                     f"local, one global), random weights seed {seed}",
           "backend": "packed", "cache_bits": CACHE_BITS,
           "max_batch": BATCH, "max_len": LONG_MAX_LEN,
           "prompt": LONG_PROMPT, "gen": LONG_GEN,
           "requests": LONG_REQUESTS, "graphed": engine.graphed,
           "store_build_s": build_s, "warmup_s": warmup_s,
           "generate_s": wall, "decode_steps": n_steps,
           "compilations_after_warmup": engine.compilations_after_warmup,
           "cache_rows": engine.describe()["cache_rows"],
           "launches": counts, "launches_per_captured_step": per_step,
           "host_ms_per_step_last": host_ms,
           "host_ms_per_step_is": f"the last {LONG_TIMED_STEPS - 1} steps "
                                  f"(positions {n_steps - LONG_TIMED_STEPS}"
                                  f"..{n_steps - 2}), both ends synchronised",
           "mean_ms_per_step": wall / n_steps * 1e3,
           "b3_last_step": b3,
           "last_step_ref_logits_bit_identical": True,
           "peak_mem_gb": peak_gb,
           "tokens": {r.uid: r.tokens for r in responses}}
    del engine, rec
    torch.cuda.empty_cache()
    return out


def _moe_matmul_report(cfg, profile: dict) -> dict:
    """A MoE serve's fp32 matmuls (every expert on every token, and the
    router) against their byte bound: each weight read once a step (the
    batch's rows and outputs are a few KB); and the device ms a step by
    part."""
    e = cfg.moe.num_experts
    nbytes = 4 * cfg.num_layers * (3 * e * cfg.d_model * cfg.d_ff
                                   + cfg.d_model * e)
    ops = 2 * BATCH * cfg.num_layers * (3 * e * cfg.d_model * cfg.d_ff
                                        + cfg.d_model * e)
    b_ms, b_by = bound_ms(nbytes, ops, FP32_OPS_PER_S)
    by_kind = profile["ms_per_step_by_kind"]
    ms = by_kind.get("fp32 matmul", 0.0)
    return {"weight_bytes_per_step": nbytes, "ms_per_step": ms,
            "launches_per_step": profile["device_ops_per_step_by_kind"].get(
                "fp32 matmul", 0.0),
            "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms if ms else None,
            "device_ms_split": {
                "expert and router matmuls": ms,
                "B2": by_kind.get("pann_matmul_packed_act", 0.0),
                "B3": by_kind.get("decode_attention", 0.0),
                "small kernels": by_kind.get("other PyTorch kernels", 0.0)}}


# phase 4b's depth: llama3-8b at full width cut to 8 of its 32 layers, so
# the script stays inside its time limit with phases 10 and 11 (phase 4
# serves the full depth)
LAYERWISE_LAYERS = 8


def layerwise_serve() -> dict:
    """Phase 4b: a full-width engine at allocation 'layerwise' with
    cache_bits 'auto', LAYERWISE_LAYERS layers, served through graphs and
    held to eager."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import policy as pol
    from repro_torch.models import model as MD
    from repro_torch.serve_engine import ServeEngine
    cfg = dataclasses.replace(
        configs.get_config("llama3-8b", quant=QuantConfig(mode="none")),
        num_layers=LAYERWISE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, MD.init_params(cfg, seed=2, device="cuda"),
                         ladder_bits=LADDER, max_batch=BATCH,
                         max_len=PROMPT + GEN, backend="packed",
                         allocation="layerwise", cache_bits="auto",
                         device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    served = serve_graphed(engine, _requests(cfg, seed=2), cfg.vocab_size)
    _check_capture_counts(engine, served["launches"], _graph_launches(cfg))
    responses = served.pop("responses")
    ctx = PROMPT + GEN
    rungs = {op.bits: {
        "allocation": op.allocation, "b_x_tilde": op.b_x_tilde,
        "r": op.r, "power_per_weight_mac": op.power,
        "cache_bits": pol.tree_cache_bits(engine._rung_tree(op)),
        "gbitflips_per_token": engine.token_flips(op.bits, ctx) / 1e9}
        for op in engine.ladder}
    if any(r["allocation"] != "layerwise" for r in rungs.values()):
        raise AssertionError(f"rungs not layerwise: {rungs}")
    out = {
        "config": f"llama3-8b full width, {LAYERWISE_LAYERS} of 32 layers, "
                  "random weights seed 2",
        "allocation": "layerwise", "cache_bits": "auto",
        "ladder": list(LADDER), "backend": "packed", "store_build_s": build_s,
        **served, "graphs": engine.graphs_captured,
        "cache_bits_by_rung": engine.describe()["cache_bits_by_rung"],
        "rungs": rungs, "context": ctx,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens": {r.uid: r.tokens for r in responses},
        "rung_bits": {r.uid: r.rung_bits for r in responses},
    }
    del engine
    torch.cuda.empty_cache()
    return out


# the kernels of a decode step by the names the profiler gives them: the
# serve's matmuls run the streaming decode kernels (batch <= 8); cuBLAS's
# kernels are the fp32 matmuls (MoE experts and router, a tied head)
KERNEL_KINDS = (("packed_decode_kernel", "pann_matmul_packed_act"),
                ("planes_decode_kernel", "pann_matmul_act"),
                ("signed_decode_kernel", "unsigned_matmul"),
                ("quantize_act_kernel", "quantize_act"),
                ("decode_attention", "decode_attention"),
                ("tile_kernel", "tile_kernel"),
                ("epilogue", "epilogue"),
                ("gemm", "fp32 matmul"), ("gemv", "fp32 matmul"),
                ("splitKreduce", "fp32 matmul"))


def _kernel_kind(name: str) -> str:
    for key, kind in KERNEL_KINDS:
        if key in name:
            return kind
    return "other PyTorch kernels"


def _graph_runner(engine, bits: int):
    """A call replays rung ``bits``'s graph of a slot zeroed here (the
    profiled rung advances it by PROFILE_STEPS + 1 positions)."""
    slot = engine._acquire()
    slot.busy = False
    return engine._steps[(bits, slot.index)]


def _eager_runner(engine, bits: int):
    """A call runs one eager ``MD.decode_step`` of rung ``bits`` on a
    fresh decode state made here."""
    from repro_torch.models import model as MD
    view = engine.variants[bits]
    box = [MD.init_decode_state(view, engine.cfg, engine.max_batch,
                                engine.max_len)]
    tok = torch.zeros((engine.max_batch, 1), dtype=torch.int64,
                      device="cuda")

    def run():
        _, box[0] = MD.decode_step(view, engine.cfg, box[0], tok)
    return run


def _profile_rung(run, steps: int = PROFILE_STEPS,
                  names: dict | None = None, guard_run=None) -> tuple:
    """(device ms by kernel kind, device ops by kind, records lost) of
    ``steps`` calls of ``run`` (one decode step each), from torch.profiler;
    ``names``, when given, gathers the counted device ms by kernel name.

    The profiler can lose the records of the first kernels of a window
    (none in some windows, more in each later window of a process), so
    the window opens with one uncounted guard step; what it lacks against
    a counted step is reported as ``guard_step_records_lost``. A marker
    kernel (``torch.cuda._sleep``'s ``spin_kernel``) follows it on the
    same stream, and only the kernels that start after the marker are
    counted: device timestamps against device timestamps. ``guard_run``,
    when given, is run in place of the guard step. A window whose marker
    record the profiler lost, or that holds no device record at all, is
    taken again, PROFILE_ATTEMPTS times at most (each run advances its
    decode state a few positions); ({}, {}, 0) when no window held a
    device record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            (guard_run or run)()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        marks = [e.time_range.start for e in kernels
                 if "spin_kernel" in e.name]
        if len(marks) == 1:
            break
        print(f"[profile] attempt {attempt}: the profiler recorded "
              f"{len(kernels)} device kernels, {len(marks)} marker kernels "
              "(spin_kernel), expected 1", flush=True)
    else:
        if not kernels:
            return {}, {}, 0
        raise AssertionError(f"profiler recorded {len(marks)} marker "
                             f"kernels (spin_kernel), expected 1, in "
                             f"{PROFILE_ATTEMPTS} windows")
    ms: dict = {}
    count: dict = {}
    guard = 0
    for e in kernels:
        if e.time_range.start < marks[0]:
            guard += 1
        if e.time_range.start <= marks[0]:
            continue
        kind = _kernel_kind(e.name)
        ms[kind] = ms.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
        count[kind] = count.get(kind, 0) + 1
        if names is not None:
            names[e.name] = (names.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    # the guard step launches what a counted step does: what it lacks, the
    # profiler lost
    lost = sum(count.values()) / steps - guard
    return ms, count, lost


def profile_steps(runner, steps_by_rung: dict,
                  names: dict | None = None, guard_run=None) -> dict:
    """Device kernel time per decode step of each rung (PROFILE_STEPS
    steps each, torch.profiler), and the mean over rungs weighted by the
    serve's steps per rung: the device time of the serve's average step,
    by kernel kind. The profiler's own host overhead does not enter the
    device times. ``device_ms_per_step`` is None when the profiler
    records no device activity on this machine. ``names`` gathers the
    device ms by kernel name over every profiled step; ``guard_run``
    replaces each window's guard step (``_profile_rung``)."""
    by_rung = {}
    for bits in LADDER:
        ms, count, lost = _profile_rung(runner(bits), names=names,
                                        guard_run=guard_run)
        if not ms:
            print("[profile] the profiler recorded no device activity: "
                  "device time per step not measured", flush=True)
            return {"device_ms_per_step": None}
        by_rung[bits] = {
            "device_ms_per_step": sum(ms.values()) / PROFILE_STEPS,
            "ms_per_step_by_kind": {k: v / PROFILE_STEPS
                                    for k, v in sorted(ms.items())},
            "device_ops_per_step_by_kind": {k: v / PROFILE_STEPS
                                            for k, v in sorted(
                                                count.items())},
            "guard_step_records_lost": lost}
    total = sum(steps_by_rung.values())

    def weighted(key):
        kinds = sorted({k for r in by_rung.values() for k in r[key]})
        return {k: sum(steps_by_rung[b] * r[key].get(k, 0.0)
                       for b, r in by_rung.items()) / total for k in kinds}

    return {"steps_per_rung": PROFILE_STEPS, "weights": steps_by_rung,
            "device_ms_per_step": sum(
                steps_by_rung[b] * r["device_ms_per_step"]
                for b, r in by_rung.items()) / total,
            "ms_per_step_by_kind": weighted("ms_per_step_by_kind"),
            "device_ops_per_step_by_kind": weighted(
                "device_ops_per_step_by_kind"),
            "by_rung": by_rung}


# profiler ranges of ``recurrent_split``: (module, function, range) around
# the recurrent blocks, every serving projection and the decode attention
SPLIT_RANGES = (("models.ssm", "decode_ssm", "recurrent block"),
                ("models.rwkv", "apply_time_mix", "recurrent block"),
                ("models.rwkv", "apply_channel_mix", "recurrent block"),
                ("kernels.dispatch", "serving_linear", "projection"),
                ("kernels.dispatch", "decode_attention", "attention"))
NESTED_PROJECTION = "projection in a recurrent block"


def recurrent_split(engine, graph_profile: dict) -> dict:
    """Phase 4e: where a recurrent config's decode step spends its device
    time. Over graph replays the profiler sees kernels but no host op to
    attribute a small kernel to, so one eager step of the top rung (the
    kernels a graph captures) runs under ``record_function`` ranges
    around the recurrent blocks (``ssm.decode_ssm``,
    ``rwkv.apply_time_mix``, ``rwkv.apply_channel_mix``), every
    ``dispatch.serving_linear`` and ``dispatch.decode_attention``, after
    an uncounted guard step and a marker kernel (as ``_profile_rung``).
    B2 and B3 are the step's kernels by name (device timestamps after the
    marker); every other kernel is attributed to the range whose host op
    launched it: the projections' small kernels (the dispatch's quantizer
    and epilogue ops), the recurrent fp ops (scan, conv, gates, the wkv
    recurrence: the recurrent ranges less the projections inside them),
    the attention's (the query's quantizer), and the rest (norms,
    residuals, the cache write, the head's argmax, the state copies).
    Kernels the profiler links to no host op are reported apart. Returns
    the eager step's split (ms) and the graphed step's by kind."""
    import importlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    depth = [0]

    def ranged(fn, name):
        recurrent = name == "recurrent block"

        def run(*args, **kwargs):
            label = (NESTED_PROJECTION if name == "projection" and depth[0]
                     else name)
            with record_function(label):
                depth[0] += recurrent
                try:
                    return fn(*args, **kwargs)
                finally:
                    depth[0] -= recurrent
        return run

    saved = []
    for mod_name, attr, name in SPLIT_RANGES:
        mod = importlib.import_module(f"repro_torch.{mod_name}")
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, ranged(getattr(mod, attr), name))
    try:
        run = _eager_runner(engine, max(LADDER))
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            with record_function("counted step"):
                run()
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    events = prof.events()
    labels = {name for _, _, name in SPLIT_RANGES} | {NESTED_PROJECTION,
                                                     "counted step"}
    # the device timeline also carries a span for each host range
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in labels]
    mark = [e.time_range.start for e in kernels if "spin_kernel" in e.name]
    if len(mark) != 1:
        raise AssertionError(f"profiler recorded {len(mark)} marker "
                             "kernels (spin_kernel), expected 1")
    step = [e for e in kernels if e.time_range.start > mark[0]]
    total = sum(e.time_range.elapsed_us() for e in step) / 1e3
    b2, b3 = (sum(e.time_range.elapsed_us() for e in step
                  if _kernel_kind(e.name) == kind) / 1e3
              for kind in ("pann_matmul_packed_act", "decode_attention"))
    big = ("pann_matmul_packed_act", "decode_attention")

    def small_ms(ev) -> float:
        """Device ms of the non-B2/B3 kernels ``ev``'s host ops launched."""
        own = sum(k.duration for k in ev.kernels
                  if _kernel_kind(k.name) not in big) / 1e3
        return own + sum(small_ms(c) for c in ev.cpu_children)

    start = next(e for e in events
                 if e.name == "counted step").time_range.start
    ranges: dict = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in labels \
                and e.time_range.start >= start:
            ranges[e.name] = ranges.get(e.name, 0.0) + small_ms(e)
    nested = ranges.get(NESTED_PROJECTION, 0.0)
    split = {"B2": b2, "B3": b3,
             "projection small kernels": ranges.get("projection", 0.0)
             + nested,
             "recurrent fp ops": ranges.get("recurrent block", 0.0) - nested,
             "attention small kernels": ranges.get("attention", 0.0)}
    split["other small kernels"] = (ranges.get("counted step", 0.0)
                                    - sum(split.values()) + b2 + b3)
    split["not linked to a host op"] = total - sum(split.values())
    return {"eager_step_ms": total, "eager_step_kernels": len(step),
            "eager_step_ms_by_part": split,
            "recurrent_share_of_eager_step": split["recurrent fp ops"]
            / total if total else None,
            "graphed_step_ms_by_kind": graph_profile["ms_per_step_by_kind"],
            "graphed_step_ms": graph_profile["device_ms_per_step"]}


def _teacher_forced(views: dict, cfg, rows, frontend=None) -> torch.Tensor:
    """(rungs, B, T, V) eager logits of teacher-forcing ``rows`` (B, T)
    through every rung's view (from ``frontend``'s step 0 input, when
    given)."""
    from repro_torch.models import model as MD
    kw = ({} if frontend is None else
          {frontend.key: frontend.raw(rows.shape[0], 0)})
    per_rung = []
    for bits in LADDER:
        view = views[bits]
        state = MD.init_decode_state(view, cfg, rows.shape[0], rows.shape[1],
                                     **kw)
        steps = []
        for i in range(rows.shape[1]):
            lg, state = MD.decode_step(view, cfg, state, rows[:, i:i + 1])
            steps.append(lg)
        per_rung.append(torch.cat(steps, 1))
    return torch.stack(per_rung)


def _check_aliasing(ws) -> int:
    """Every view leaf at a path the store holds is the store's own
    device tensor; returns how many there are."""
    from repro_torch.serve_engine.artifact import _flatten
    store = dict(_flatten(ws.store))
    n = 0
    for key, view in ws.views.items():
        for path, t in _flatten(view):
            if path in store:
                if t is not store[path] or t.data_ptr() != \
                        store[path].data_ptr():
                    raise AssertionError(f"rung {key}: {path} does not "
                                         "alias the store")
                n += 1
    return n


def backends_agree(arch: str = "llama3-8b", seed: int = 1,
                   n_requests: int = REQUESTS, layers: int = 2,
                   tf_len: int = P5_TOKENS) -> dict:
    """Phase 5: ``arch`` at full width cut to ``layers`` layers (gemma2's
    2: one local and one global layer; mixtral's 1 carries 5.64 GB of
    fp32 experts into the artifact; zamba2's 8: one group and its 2-layer
    tail; seamless's 2 and 2 encoder layers; vision's 5: one group, one
    cross layer), one store served by 'ref', 'fused' and 'packed', and
    its v1 artifact; the logits compared are those of teacher-forcing the
    first ``tf_len`` prompt tokens through every rung. An attention-free
    config (rwkv6) has no KV cache; a cross-attending one takes a raw
    frontend a wave. ``seconds`` splits the phase's time."""
    import tempfile
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import serving
    from repro_torch.serve_engine import (ServeEngine, build_ladder,
                                          load_artifact, write_artifact)
    t_start = time.perf_counter()
    cfg = configs.get_config(arch, quant=QuantConfig(mode="none"))
    cfg = dataclasses.replace(cfg, num_layers=layers,
                              encoder_layers=min(cfg.encoder_layers, layers))
    cache_bits = None if cfg.is_attention_free else CACHE_BITS
    cross = cfg.family in ("encdec", "vlm")
    ladder = build_ladder(LADDER, d=float(cfg.d_model))
    ws = serving.build_weight_store(
        _init_params(cfg, seed), cfg,
        {op.bits: (op.r, op.b_x_tilde) for op in ladder},
        serving.ServingQuantSpec(pack_planes=True, cache_bits=cache_bits))
    # the v1 artifact: written off the card, mapped and copied back
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        write_artifact(d, ws, cfg, meta={"arch": cfg.name})
        blob_bytes = Path(d, "weights.bin").stat().st_size
        loaded = load_artifact(d, device="cuda")
        torch.cuda.synchronize()
    artifact_s = time.perf_counter() - t0
    aliased = _check_aliasing(loaded)
    reqs = _requests(cfg, seed=seed, n=n_requests)
    rows = torch.as_tensor(np.stack([reqs[0].prompt[:tf_len]] * BATCH)
                           .astype(np.int64), device="cuda")
    seconds = {"store_and_artifact": time.perf_counter() - t_start}

    def backend_cfg(backend):       # the config an engine serves with
        c = dataclasses.replace(cfg, kernel_backend=backend)
        return (c if cache_bits is None
                else dataclasses.replace(c, cache_bits=cache_bits))

    # teacher-forced logits of every rung over the first request's prompt
    # from the artifact's copy first, which then goes (at vision's widths
    # the copy and a graph pool would not fit beside the store)
    from_artifact = {b: _teacher_forced(loaded.views, backend_cfg(b), rows,
                                        Frontend(cfg, seed) if cross
                                        else None)
                     for b in ("ref", "fused", "packed")}
    del loaded
    torch.cuda.empty_cache()
    seconds["artifact_logits"] = time.perf_counter() - t_start - sum(
        seconds.values())
    tokens, logits, launches = {}, {}, {}
    for backend in ("ref", "fused", "packed"):
        t0 = time.perf_counter()
        # every engine sees the same frontends, in the same order
        frontend = Frontend(cfg, seed) if cross else None
        eng = ServeEngine(cfg, weight_store=ws, ladder_bits=LADDER,
                          max_batch=BATCH, max_len=PROMPT + GEN,
                          backend=backend, cache_bits=cache_bits,
                          device="cuda", frontend_kwargs_fn=frontend)
        fe = {"ms": [], "launches": []}
        if cross:
            _timed_frontend(eng, fe)
        _reset_counts()
        eng.warmup()
        res = eng.generate(reqs)
        torch.cuda.synchronize()
        eng.assert_no_recompile()
        seconds[f"{backend}_engine"] = time.perf_counter() - t0
        launches[backend] = {k: v - sum(f.get(k, 0) for f in fe["launches"])
                             for k, v in _counts().items()}
        launches[backend]["graphs"] = eng.graphs_captured
        launches[backend]["decode_steps"] = sum(eng.steps_by_rung.values())
        launches[backend]["frontend_waves"] = len(fe["launches"])
        if backend != "ref" and any(
                f != {("pann_matmul_act" if backend == "fused" else
                       "pann_matmul_packed_act"): _frontend_launches(cfg)}
                for f in fe["launches"]):
            raise AssertionError(f"{backend} frontend launches "
                                 f"{fe['launches']}")
        tokens[backend] = [r.tokens for r in res]
        # the engine's graph pool goes before the eager steps below ('ref'
        # at vision's widths captured 30 GB of int32 temporaries in it);
        # the timed frontend's closure would keep the engine alive
        if cross:
            del eng._load_frontend
        views, cfg_b = eng.variants, eng.cfg
        del eng
        torch.cuda.empty_cache()
        # the store's teacher-forced logits, held to the artifact's
        t0 = time.perf_counter()
        logits[backend] = _teacher_forced(views, cfg_b, rows, frontend)
        seconds[f"{backend}_logits"] = time.perf_counter() - t0
        if not torch.equal(from_artifact[backend], logits[backend]):
            d = (from_artifact[backend] - logits[backend]).abs().max().item()
            raise AssertionError(f"{backend}: the artifact's logits differ "
                                 f"from the store's by {d}")
        del views
        torch.cuda.empty_cache()
    for backend in ("fused", "packed"):
        if not torch.equal(logits[backend], logits["ref"]):
            d = (logits[backend] - logits["ref"]).abs().max().item()
            raise AssertionError(f"{backend} logits differ from ref by {d}")
        if tokens[backend] != tokens["ref"]:
            raise AssertionError(f"{backend} tokens differ from ref")
    fused = launches["fused"]
    steps = len(LADDER) + fused["graphs"]
    per_step = _graph_launches(cfg)
    if (fused["pann_matmul_act"] != per_step["pann_matmul_packed_act"] * steps
            or fused["decode_attention"]
            != per_step["decode_attention"] * steps):
        raise AssertionError(f"fused launch counts {fused} over warmup's "
                             f"{steps} steps")
    if any(v for k, v in launches["ref"].items()
           if k not in ("decode_steps", "graphs", "frontend_waves")):
        raise AssertionError(f"ref backend launched kernels: "
                             f"{launches['ref']}")
    cut = ("one local and one global layer" if cfg.local_global_period
           else "one group and the 2-layer tail" if cfg.family == "hybrid"
           else f"and {cfg.encoder_layers} encoder layers"
           if cfg.encoder_layers else "one group, one cross layer"
           if cfg.family == "vlm" else "the only cut")
    return {"config": f"{arch} full width cut to {layers} layer"
                      f"{'s' if layers > 1 else ''} ({cut}), random "
                      f"weights seed {seed}",
            "cache_bits": cache_bits, "logits_bit_identical": True,
            "teacher_forced_tokens": tf_len, "seconds": seconds,
            "tokens_identical": True, "logits_shape": list(
                logits["ref"].shape), "launches": launches,
            "artifact": {"blob_bytes": blob_bytes, "write_load_s": artifact_s,
                         "view_leaves_aliasing_the_store": aliased,
                         "logits_bit_identical_on": ["ref", "fused",
                                                     "packed"]}}


# ---------------------------------------------------------------------------
# phase 6: the unfused path through the kernel API
# ---------------------------------------------------------------------------

UNFUSED_M = (4, 512)        # the serve's decode batch; a prefill chunk
PATH_BITS = 8               # the path's activation bits
SWEEP_BITS = (2, 4, 6)      # quantize_act also checked at these widths
PLAIN_ITERS = 2


def _projections(cfg) -> list:
    """(name, K, N) of one llama3-8b layer's seven projections, then the
    lm_head."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("w_gate", d, cfg.d_ff), ("w_up", d, cfg.d_ff),
            ("w_down", cfg.d_ff, d), ("lm_head", d, cfg.vocab_size)]


def _agree(name: str, got, want, err: dict) -> None:
    """Bit-identity of a kernel's output with its plain version; records
    the measured max |difference| under ``name``."""
    diff = (got.double() - want.double()).abs().max().item()
    err[name] = max(err.get(name, 0.0), diff)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: max |diff| {diff} (must be 0)")


def _check_unfused(x, packed, w, out, err: dict) -> None:
    """Every output of one pass at one projection and M against its plain
    version, the codes products against each other and the oracle, and
    quantize_act at the sweep's other widths and on bf16 (launches made
    here are not the path's)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    from repro_torch.kernels import unsigned_matmul as um
    xq, sx = out["quantize_act"]
    qr, sr = ref.quantize_act_ref(x, PATH_BITS)
    _agree("quantize_act", xq, qr, err)
    _agree("quantize_act", sx, sr, err)
    for bits, xb in [(b, x) for b in SWEEP_BITS] + [
            (PATH_BITS, x.to(torch.bfloat16))]:
        q, s = ops.quantize_act(xb, bits=bits)
        qr, sr = ref.quantize_act_ref(xb, bits)
        _agree("quantize_act", q, qr, err)
        _agree("quantize_act", s, sr, err)
    pp, pn, gamma = packed["planes_pos"], packed["planes_neg"], \
        packed["gamma"]
    oracle = ref.pann_matmul_ref(xq, pp, pn, sx, gamma)
    for mode in pm.MODES:
        _agree("pann_matmul", out[f"pann_matmul/{mode}"],
               pm.pann_matmul_plain(xq, pp, pn, sx, gamma, mode=mode), err)
    if "pann_matmul_packed" in out:
        _agree("pann_matmul_packed", out["pann_matmul_packed"],
               pk.pann_matmul_packed_plain(xq, w["ppk"], w["pnk"], sx,
                                           gamma), err)
    _agree("unsigned_matmul", out["unsigned_matmul"],
           um.unsigned_matmul_plain(xq, w["w_q"], sx, gamma), err)
    for key in ("pann_matmul/fused", "pann_matmul/planes",
                "pann_matmul_packed", "unsigned_matmul"):
        if key in out and not torch.equal(out[key], oracle):
            raise AssertionError(f"{key} differs from ref.pann_matmul_ref")
    n = pp.shape[2]
    operands = ops.act_operands(x, packed, PATH_BITS)
    for mode in pm.MODES:
        _agree("pann_matmul_act", out[f"pann_matmul_act/{mode}"],
               pm.pann_matmul_act_plain(*operands, mode)[:, :n], err)
    if not torch.equal(out["pann_matmul_act/fused"],
                       out["pann_matmul_act/planes"]):
        raise AssertionError("pann_matmul_act modes disagree")


def _packed_act_operands(x, packed, w) -> tuple:
    """B2's operands beside B1's (``ops.act_operands``): the same x,
    qparams, gamma and zcol, the planes packed along K (N % 4 == 0 at every
    shape checked, so nothing is padded)."""
    from repro_torch.kernels import ops
    xf, _, _, qp, gamma, zcol = ops.act_operands(x, packed, PATH_BITS)
    return xf, w["ppk"], w["pnk"], qp, gamma, zcol


def _check_packed_act(x, packed, w, out, err: dict) -> None:
    """B2 on the pass's operands against its plain version and B1's
    output (the same function on unpacked planes); uncounted."""
    from repro_torch.kernels import pann_matmul_packed as pk
    args = _packed_act_operands(x, packed, w)
    y = pk.pann_matmul_packed_act(*args)
    _agree("pann_matmul_packed_act", y,
           pk.pann_matmul_packed_act_plain(*args), err)
    if not torch.equal(y[:, :out["pann_matmul_act/fused"].shape[1]],
                       out["pann_matmul_act/fused"]):
        raise AssertionError("pann_matmul_packed_act differs from "
                             "pann_matmul_act on the same operands")


def _time_unfused(x, packed, w, out, names, per_pass) -> list:
    """Kernel, plain and library times (cold L2) and the bound of every
    kernel of the pass at one (K, N) and M; one row per kernel and mode."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    from repro_torch.kernels import unsigned_matmul as um
    xq, sx = out["quantize_act"]
    pp, pn, gamma = packed["planes_pos"], packed["planes_neg"], \
        packed["gamma"]
    ppk, pnk, w_q = w["ppk"], w["pnk"], w["w_q"]
    p, k, n = pp.shape
    m = x.shape[0]
    operands = ops.act_operands(x, packed, PATH_BITS)
    act_packed = _packed_act_operands(x, packed, w)
    # the library yardstick of the products: cuBLAS's int8 product of the
    # same integers where torch._int_mm's shape rules allow it (M > 16),
    # else fp32 torch.matmul on the dequantized weight
    if m > 16:
        if not torch.equal(torch._int_mm(xq, w_q),
                           ref.int_matmul(xq, w_q)):
            raise AssertionError("torch._int_mm differs from the integers")
        lib_name = "torch._int_mm (int8 codes x int8 w_q)"
        lib = time_ms(lambda: torch._int_mm(xq, w_q), 10)
        b6_lib, b6_lib_name = lib, lib_name
    else:
        w_deq = w_q.float() * gamma[None, :]
        lib_name = "fp32 torch.matmul on the dequantized weight"
        lib = time_ms(lambda: torch.matmul(x, w_deq), 10)
        del w_deq
        b6_lib, b6_lib_name = int_mm_padded_ms(xq, w_q), INT_MM_PADDED
    out_b = 4 * (m * n + n + m)          # y, gamma, s_x
    products = 2 * m * k * n
    # 'planes' multiplies each live plane, pos and neg apart: 2 P_live
    # products (every plane is live for B4; B1 here at plane_shift 0)
    live_b1 = p - int(operands[3][3].item())
    planes_b4, planes_b1 = 2 * p * products, 2 * live_b1 * products
    cases = [
        ("quantize_act", None,
         lambda: ops.quantize_act(x, bits=PATH_BITS),
         lambda: ref.quantize_act_ref(x, PATH_BITS),
         (4 * m * k + m * k + 4 * m, 4 * m * k, FP32_OPS_PER_S), None, None),
        ("pann_matmul_act", "fused",
         lambda: pm.pann_matmul_act(*operands, mode="fused"),
         lambda: pm.pann_matmul_act_plain(*operands, "fused"),
         (4 * m * k + 2 * p * k * n + 4 * n + out_b + 16, products,
          INT8_OPS_PER_S), lib, lib_name),
        ("pann_matmul_act", "planes",
         lambda: pm.pann_matmul_act(*operands, mode="planes"),
         lambda: pm.pann_matmul_act_plain(*operands, "planes"),
         (4 * m * k + 2 * p * k * n + 4 * n + out_b + 16, planes_b1,
          INT8_OPS_PER_S), lib, lib_name)]
    for mode in pm.MODES:
        cases.append((
            "pann_matmul", mode,
            lambda mode=mode: pm.pann_matmul(xq, pp, pn, sx, gamma,
                                             mode=mode),
            lambda mode=mode: pm.pann_matmul_plain(xq, pp, pn, sx, gamma,
                                                   mode=mode),
            (m * k + 2 * p * k * n + out_b,
             planes_b4 if mode == "planes" else products, INT8_OPS_PER_S),
            lib, lib_name))
    cases += [
        ("pann_matmul_packed", None,
         lambda: pk.pann_matmul_packed(xq, ppk, pnk, sx, gamma),
         lambda: pk.pann_matmul_packed_plain(xq, ppk, pnk, sx, gamma),
         (m * k + 2 * p * (k // 8) * n + out_b, products, INT8_OPS_PER_S),
         lib, lib_name),
        ("unsigned_matmul", None,
         lambda: um.unsigned_matmul(xq, w_q, sx, gamma),
         lambda: um.unsigned_matmul_plain(xq, w_q, sx, gamma),
         (m * k + k * n + out_b, products, INT8_OPS_PER_S), b6_lib,
         b6_lib_name),
        # B2 beside the pass (not one of its launches): B1 on packed planes
        ("pann_matmul_packed_act", None,
         lambda: pk.pann_matmul_packed_act(*act_packed),
         lambda: pk.pann_matmul_packed_act_plain(*act_packed),
         (4 * m * k + 2 * p * (k // 8) * n + 4 * n + out_b + 16, products,
          INT8_OPS_PER_S), lib, lib_name)]
    rows = []
    for kernel, mode, fn, plain, (nbytes, ops_n, rate), lib_ms, lname \
            in cases:
        b_ms, b_by = bound_ms(nbytes, ops_n, rate)
        rows.append({"kernel": kernel, "mode": mode, "M": m, "K": k, "N": n,
                     "P": p, "modules": names, "per_pass": per_pass,
                     "ms": time_ms(fn, 10),
                     "plain_ms": time_ms(plain, PLAIN_ITERS),
                     "library_ms": lib_ms, "library": lname,
                     "bound_ms": b_ms, "bound_by": b_by})
        if kernel == "unsigned_matmul" and lname != lib_name:
            rows[-1].update(library_fp32_ms=lib, library_fp32=lib_name)
    return rows


# torch._int_mm takes more than 16 rows: B6's library yardstick at decode
# runs it on the codes zero-padded to INT_MM_ROWS rows
INT_MM_ROWS = 32
INT_MM_PADDED = (f"torch._int_mm (int8 codes zero-padded to {INT_MM_ROWS} "
                 "rows x int8 w_q)")


def int_mm_padded_ms(xq, w_q) -> float:
    """torch._int_mm on the codes xq (M <= 16 rows) zero-padded to
    INT_MM_ROWS rows (the pad made before the timing), held equal to the
    integers on the first M rows."""
    from repro_torch.kernels import ref
    m, k = xq.shape
    xp = torch.zeros((INT_MM_ROWS, k), dtype=torch.int8, device=xq.device)
    xp[:m] = xq
    if not torch.equal(torch._int_mm(xp, w_q)[:m], ref.int_matmul(xq, w_q)):
        raise AssertionError("torch._int_mm (padded) differs from the "
                             "integers")
    return time_ms(lambda: torch._int_mm(xp, w_q), 10)


def _pack(gen, k: int, n: int, r: float) -> tuple:
    """N(0, 0.02) weights packed by the kernel API, and the packed planes
    and int8 codes the codes kernels take."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    packed = ops.pann_pack_weights(w, r)
    del w
    pp, pn = packed["planes_pos"], packed["planes_neg"]
    wts = {"w_q": pm.rebuild_weight(pp, pn).to(torch.int8)}
    if k % 8 == 0:
        wts.update(ppk=pk.pack_planes(pp), pnk=pk.pack_planes(pn))
    return packed, wts


def _pass(x, packed, wts) -> dict:
    """The unfused path on rows x: quantize_act, then the four codes
    products (the packed one only where K % 8 == 0), and the prologue
    kernel through ops.pann_matmul."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    pp, pn, gamma = packed["planes_pos"], packed["planes_neg"], \
        packed["gamma"]
    xq, sx = ops.quantize_act(x, bits=PATH_BITS)
    out = {"quantize_act": (xq, sx)}
    for mode in pm.MODES:
        out[f"pann_matmul/{mode}"] = pm.pann_matmul(xq, pp, pn, sx, gamma,
                                                    mode=mode)
    if x.shape[1] % 8 == 0:
        out["pann_matmul_packed"] = pk.pann_matmul_packed(
            xq, wts["ppk"], wts["pnk"], sx, gamma)
    out["unsigned_matmul"] = ops.unsigned_matmul(xq, wts["w_q"], sx, gamma)
    for mode in pm.MODES:
        out[f"pann_matmul_act/{mode}"] = ops.pann_matmul(x, packed,
                                                         PATH_BITS, mode=mode)
    return out


# ragged shapes the pass does not reach: the decode kernels' 4- and 8-row
# instantiations with a partial row tile, a partial 128-column tile (N =
# 72, 136; N = 1028 leaves one lane of the last tile), a K that is no
# multiple of 4 or of the 32-row chunk alignment (B1/B4: 130, 4100) and a
# K of whole 8-row steps that is no multiple of the 64-row chunk alignment
# (B2/B5: 520); the edges of the tile kernels' 64-row (B5, B6) and 128-row
# (B1, B4) tiles; a K that is no multiple of 32 or 16 and an N that is no
# multiple of 16 or 128 (B1/B4 load those without TMA); 130 and 4100 are
# not multiples of 8, so the packed kernel is left out there
RAGGED = ((1, 4096, 1024), (8, 4096, 1024), (9, 4096, 1024),
          (13, 4096, 1024), (64, 4096, 1024), (100, 4096, 1024),
          (127, 4096, 1024), (129, 4096, 1024), (200, 4096, 1024),
          (3, 130, 72), (8, 130, 72), (13, 130, 72), (100, 130, 72),
          (129, 130, 72), (1, 4100, 136), (5, 4100, 136), (13, 4100, 136),
          (129, 4100, 136), (4, 520, 1028), (7, 520, 1028))


def ragged_parity(gen, r: float, err: dict) -> None:
    """Every kernel of the pass against its plain version at RAGGED shapes
    (these launches are not the path's and are not counted)."""
    weights: dict = {}
    for m, k, n in RAGGED:
        if (k, n) not in weights:
            weights[(k, n)] = _pack(gen, k, n, r)
        packed, wts = weights[(k, n)]
        x = torch.randn((m, k), generator=gen, device="cuda")
        out = _pass(x, packed, wts)
        torch.cuda.synchronize()
        _check_unfused(x, packed, wts, out, err)
        if k % 8 == 0:
            _check_packed_act(x, packed, wts, out, err)


EXTREME = (512, 14336, 1024)   # M, K, N: the deepest K of the path
TILE_SHIFT_SHAPES = ((512, 4096, 1024), (129, 4096, 1024))


def extremes_parity(gen, err: dict) -> None:
    """P = 7 planes of weights +-127 (random signs) and codes of 127 at
    K = 14336: the largest products the int32 sums and the s8 operands
    meet. B4 (both modes), B5 and B6 against their plain versions and
    ref.pann_matmul_ref; B1 (both modes) and B2 with x = 127, s = 1, z =
    0, so every code is 127 (uncounted launches)."""
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    from repro_torch.kernels import ref
    from repro_torch.kernels import unsigned_matmul as um
    m, k, n = EXTREME
    sign = torch.randint(0, 2, (k, n), generator=gen, device="cuda",
                         dtype=torch.int32) * 2 - 1
    w = 127 * sign
    pos = torch.stack([((w.clamp(min=0) >> p) & 1).to(torch.int8)
                       for p in range(7)])
    neg = torch.stack([(((-w).clamp(min=0) >> p) & 1).to(torch.int8)
                       for p in range(7)])
    xq = torch.full((m, k), 127, dtype=torch.int8, device="cuda")
    sx = torch.rand((m, 1), generator=gen, device="cuda") + 0.5
    gamma = torch.rand((n,), generator=gen, device="cuda") * 1e-6
    oracle = ref.pann_matmul_ref(xq, pos, neg, sx, gamma)
    for mode in pm.MODES:
        y = pm.pann_matmul(xq, pos, neg, sx, gamma, mode=mode)
        _agree("pann_matmul", y, pm.pann_matmul_plain(
            xq, pos, neg, sx, gamma, mode=mode), err)
        if not torch.equal(y, oracle):
            raise AssertionError(f"extremes: pann_matmul/{mode} differs "
                                 f"from ref.pann_matmul_ref")
    ppk, pnk = pk.pack_planes(pos), pk.pack_planes(neg)
    y = pk.pann_matmul_packed(xq, ppk, pnk, sx, gamma)
    _agree("pann_matmul_packed", y, pk.pann_matmul_packed_plain(
        xq, ppk, pnk, sx, gamma), err)
    w_q = w.to(torch.int8)
    y6 = um.unsigned_matmul(xq, w_q, sx, gamma)
    _agree("unsigned_matmul", y6, um.unsigned_matmul_plain(xq, w_q, sx,
                                                           gamma), err)
    if not (torch.equal(y, oracle) and torch.equal(y6, oracle)):
        raise AssertionError("extremes: B5/B6 differ from the oracle")
    x = torch.full((m, k), 127.0, device="cuda")
    qp = torch.tensor([1.0, 0.0, 127.0, 0.0], device="cuda")
    zcol = torch.zeros((n,), dtype=torch.int32, device="cuda")
    for mode in pm.MODES:
        _agree("pann_matmul_act",
               pm.pann_matmul_act(x, pos, neg, qp, gamma, zcol, mode),
               pm.pann_matmul_act_plain(x, pos, neg, qp, gamma, zcol, mode),
               err)
    _agree("pann_matmul_packed_act",
           pk.pann_matmul_packed_act(x, ppk, pnk, qp, gamma, zcol),
           pk.pann_matmul_packed_act_plain(x, ppk, pnk, qp, gamma, zcol), err)
    torch.cuda.synchronize()


def tile_shift_parity(gen, err: dict) -> list:
    """B1's (both modes) and B2's tile regime (M > 8) at plane_shift 0-7,
    7 planes of weights in [-127, 127] (shift 7 leaves no plane live)."""
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    checked = []
    for m, k, n in TILE_SHIFT_SHAPES:
        x, pos, neg, ppk, npk, s, z, n127, gamma, zcol = _matmul_operands(
            gen, m, k, n)
        for shift in range(8):
            qp = torch.stack([s, z, n127, torch.full((), float(shift),
                                                     device="cuda")])
            for mode in pm.MODES:
                _agree("pann_matmul_act",
                       pm.pann_matmul_act(x, pos, neg, qp, gamma, zcol,
                                          mode),
                       pm.pann_matmul_act_plain(x, pos, neg, qp, gamma, zcol,
                                                mode), err)
            _agree("pann_matmul_packed_act",
                   pk.pann_matmul_packed_act(x, ppk, npk, qp, gamma, zcol),
                   pk.pann_matmul_packed_act_plain(x, ppk, npk, qp, gamma,
                                                   zcol), err)
        checked.append([m, k, n])
        del x, pos, neg, ppk, npk
    torch.cuda.synchronize()
    return checked


# B6's decode regime (M <= 8) beyond the pass's M = 4: every M at the
# pass's (K, N), ragged (K, N) (a K that is no multiple of 4 or 32, a
# partial 128-column tile, K % 16 != 0: the code panel's byte loads) and
# the extremes at the path's deepest K
DECODE_M_MAX = 8
B6_RAGGED = ((130, 72), (4100, 136), (520, 1028))
B6_EXTREME = (14336, 1024)


def b6_decode_sweep(gen, projections, err: dict) -> dict:
    """B6 at M = 1..8: bit for bit against its plain version at the pass's
    (K, N) (random int8 weights in [-127, 127], codes in [0, 127]), at
    B6_RAGGED and with |w| = 127 against codes of 127 at B6_EXTREME; one
    wrapper launch a call (``b6_kernels_per_call`` checks the device
    kernels); one timed row a M, the pass's launches summed, beside the
    bound and torch._int_mm on the codes padded to INT_MM_ROWS rows (timed
    once a shape: it does not depend on M). These launches are not the
    path's."""
    from repro_torch.kernels import unsigned_matmul as um
    t0 = time.perf_counter()
    per_pass: dict = {}
    for _, k, n in projections:
        per_pass[(k, n)] = per_pass.get((k, n), 0) + 1
    shapes = list(per_pass) + list(B6_RAGGED)
    weights = {kn: torch.randint(-127, 128, kn, generator=gen, device="cuda",
                                 dtype=torch.int8) for kn in shapes}
    k, n = B6_EXTREME
    weights["extreme"] = (127 * (torch.randint(
        0, 2, (k, n), generator=gen, device="cuda") * 2 - 1)).to(torch.int8)
    scales = {kn: torch.rand((w.shape[1],), generator=gen, device="cuda")
              * 1e-3 for kn, w in weights.items()}
    checked, rows, lib = 0, [], {}
    for m in range(1, DECODE_M_MAX + 1):
        row = {"M": m, "ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "shapes": {}}
        for key, w in weights.items():
            kk = w.shape[0]
            if key == "extreme":
                xq = torch.full((m, kk), 127, dtype=torch.int8,
                                device="cuda")
            else:
                xq = torch.randint(0, 128, (m, kk), generator=gen,
                                   device="cuda", dtype=torch.int8)
            sx = torch.rand((m, 1), generator=gen, device="cuda") + 0.5
            before = um.launches
            y = um.unsigned_matmul(xq, w, sx, scales[key])
            if um.launches != before + 1:
                raise AssertionError("unsigned_matmul: not one launch a call")
            _agree("unsigned_matmul", y, um.unsigned_matmul_plain(
                xq, w, sx, scales[key]), err)
            checked += 1
            if key not in per_pass:
                continue
            nn = w.shape[1]
            ms = time_ms(lambda: um.unsigned_matmul(xq, w, sx, scales[key]),
                         10)
            b_ms, _ = bound_ms(m * kk + kk * nn + 4 * (m * nn + nn + m),
                               2 * m * kk * nn)
            if key not in lib:
                lib[key] = int_mm_padded_ms(xq, w)
            cnt = per_pass[key]
            row["shapes"][f"{kk}x{nn}"] = {"ms": ms, "bound_ms": b_ms,
                                           "library_ms": lib[key],
                                           "per_pass": cnt}
            row["ms"] += cnt * ms
            row["bound_ms"] += cnt * b_ms
            row["library_ms"] += cnt * lib[key]
        rows.append(row)
    del weights
    return {"rows": rows, "cases_checked": checked,
            "shapes": [list(kn) for kn in shapes] + [list(B6_EXTREME)],
            "library": INT_MM_PADDED, "seconds": time.perf_counter() - t0}


GUARD_KERNELS = 2000


def guard_ops() -> None:
    """GUARD_KERNELS one-element ops: the guard of a profiler window late
    in the process, whose first records the profiler loses."""
    one = torch.zeros(1, device="cuda")
    for _ in range(GUARD_KERNELS):
        one.add_(1.0)


def b6_kernels_per_call(seed: int = 21) -> dict:
    """The device kernels of B6 calls at M = 1..DECODE_M_MAX at (4096,
    4096), from the profiler: one decode kernel a call, no epilogue and
    nothing else. The profiler loses the records of a window's first
    kernels, more in each later window of a process, so the window opens
    with GUARD_KERNELS one-element ops, the marker and the calls; phase 3
    runs this, before the serves' windows. Operands from a generator of
    its own."""
    from repro_torch.kernels import unsigned_matmul as um
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    k = n = 4096
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    sw = torch.rand((n,), generator=gen, device="cuda")
    calls = [(torch.randint(0, 128, (m, k), generator=gen, device="cuda",
                            dtype=torch.int8),
              torch.rand((m, 1), generator=gen, device="cuda") + 0.5)
             for m in range(1, DECODE_M_MAX + 1)]
    def run():
        for xq, sx in calls:
            um.unsigned_matmul(xq, w, sx, sw)
    run()                   # the decode scratch at its largest
    for _ in range(PROFILE_ATTEMPTS):
        _, kinds, _ = _profile_rung(run, steps=1, guard_run=guard_ops)
        if kinds:
            break
    if kinds != {"unsigned_matmul": DECODE_M_MAX}:
        raise AssertionError(f"B6 at M = 1..{DECODE_M_MAX}: device kernels "
                             f"{kinds}, expected one decode kernel a call")
    return {"K": k, "N": n, "calls": DECODE_M_MAX, "device_kernels": kinds}


B7_M = (1, 4, 8, 131, 512)
B7_RAGGED_K = (4100, 130)     # K * 4 % 16 == 0 and != 0; bf16 both ragged


def b7_sweep(gen, projections, err: dict) -> dict:
    """B7 bit for bit against its plain version at M in B7_M, K of the pass
    and ragged, fp32 and bf16, bits 2..8, row 0 all negative and row 2 all
    zero (scale 1e-12 / qmax, codes 0), and x whose base is 1-3 fp32
    elements past a 16-byte boundary; one launch a call. One timed row a
    M: the pass's launches at PATH_BITS, fp32, beside the bound, the plain
    version and the time of a one-element torch op (the launch floor of
    this timing). These launches are not the path's."""
    from repro_torch.kernels import quantize_act as qa
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    per_pass: dict = {}
    for _, k, _ in projections:
        per_pass[k] = per_pass.get(k, 0) + 1
    checked = 0

    def agree(x, bits):
        nonlocal checked
        before = qa.launches
        q, s = qa.quantize_act(x, bits=bits)
        if qa.launches != before + 1:
            raise AssertionError("quantize_act: not one launch a call")
        qr, sr = ref.quantize_act_ref(x, bits)
        _agree("quantize_act", q, qr, err)
        _agree("quantize_act", s, sr, err)
        checked += 1
    for m in B7_M:
        for k in list(per_pass) + list(B7_RAGGED_K):
            x = torch.randn((m, k), generator=gen, device="cuda")
            x[0] = -x[0].abs() - 1.0
            if m > 2:
                x[2] = 0.0
            for dtype in (torch.float32, torch.bfloat16):
                for bits in range(2, 9):
                    agree(x.to(dtype), bits)
    buf = torch.randn(4 * 4096 + 3, generator=gen, device="cuda")
    for off in (1, 2, 3):
        agree(buf[off:off + 4 * 4096].view(4, 4096), PATH_BITS)
    one = torch.zeros(1, device="cuda")
    floor = time_ms(lambda: one.add_(1.0), 10)
    rows = []
    for m in B7_M:
        row = {"M": m, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "floor_ms": floor, "shapes": {}}
        for k, cnt in per_pass.items():
            x = torch.randn((m, k), generator=gen, device="cuda")
            ms = time_ms(lambda: qa.quantize_act(x, bits=PATH_BITS), 10)
            plain = time_ms(lambda: ref.quantize_act_ref(x, PATH_BITS),
                            PLAIN_ITERS)
            b_ms, _ = bound_ms(4 * m * k + m * k + 4 * m, 4 * m * k,
                               FP32_OPS_PER_S)
            row["shapes"][str(k)] = {
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                "per_pass": cnt,
                "plan": list(qa.cluster_plan(m, k, 4, qa.sm_count(0)))}
            row["ms"] += cnt * ms
            row["plain_ms"] += cnt * plain
            row["bound_ms"] += cnt * b_ms
        rows.append(row)
    return {"rows": rows, "cases_checked": checked, "M": list(B7_M),
            "K": list(per_pass) + list(B7_RAGGED_K),
            "bits": list(range(2, 9)),
            "floor_ms": floor, "seconds": time.perf_counter() - t0}


def unfused_path(gen) -> dict:
    """Phase 6: one pass of the unfused path over a layer's projections and
    the lm_head at each M, weights N(0, 0.02) packed at the serve ladder's
    top-rung R, activations N(0, 1). The launch counters are set to 0 just
    before each projection's pass and read just after it."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.serve_engine import build_ladder
    cfg = configs.get_config("llama3-8b", quant=QuantConfig(mode="none"))
    r_top = max(op.r for op in build_ladder(LADDER, d=float(cfg.d_model)))
    projections = _projections(cfg)
    launches = dict.fromkeys(_counts(), 0)
    err: dict = {}
    rows, planes, timed = [], {}, set()
    t0 = time.perf_counter()
    for name, k, n in projections:
        packed, wts = _pack(gen, k, n, r_top)
        planes[name] = packed["n_planes"]
        print(f"[unfused] {name} K={k} N={n}: P={packed['n_planes']} planes "
              f"at R={r_top:.4f}", flush=True)
        first = (k, n) not in timed
        timed.add((k, n))
        for m in UNFUSED_M:
            x = torch.randn((m, k), generator=gen, device="cuda")
            _reset_counts()
            out = _pass(x, packed, wts)
            torch.cuda.synchronize()
            for kernel, count in _counts().items():
                launches[kernel] += count
            _check_unfused(x, packed, wts, out, err)
            _check_packed_act(x, packed, wts, out, err)
            if first:
                same = [p for p, kk, nn in projections if (kk, nn) == (k, n)]
                rows += _time_unfused(x, packed, wts, out, ",".join(same),
                                      len(same))
            del x, out
        del packed, wts
        torch.cuda.empty_cache()
    want = dict.fromkeys(launches, 0)
    per_m = len(projections) * len(UNFUSED_M)
    want.update({"quantize_act": per_m, "pann_matmul": 2 * per_m,
                 "pann_matmul_packed": per_m, "unsigned_matmul": per_m,
                 "pann_matmul_act": 2 * per_m})
    if launches != want:
        raise AssertionError(f"unfused launch counts {launches} != {want}")
    ragged_parity(gen, r_top, err)
    extremes_parity(gen, err)
    shifts = tile_shift_parity(gen, err)
    b6_decode = b6_decode_sweep(gen, projections, err)
    b7 = b7_sweep(gen, projections, err)
    return {"config": "llama3-8b full-width projections (7 of a layer and "
                      "the lm_head), random N(0, 0.02) weights packed at "
                      "the top rung R, N(0, 1) activations, seed 0",
            "r_top": r_top, "M": list(UNFUSED_M), "act_bits": PATH_BITS,
            "planes": planes, "launches": launches,
            "ragged_shapes_checked": [list(s) for s in RAGGED],
            "extremes_checked": list(EXTREME),
            "tile_shift_shapes_checked": shifts,
            "max_abs_err": err, "b6_decode": b6_decode, "b7": b7,
            "seconds": time.perf_counter() - t0, "rows": rows}


# ---------------------------------------------------------------------------
# phase 7: prefill (forward) and the single-point serve
# ---------------------------------------------------------------------------

PREFILL_B, PREFILL_T = 2, 2048
# phase 7a's depth of llama3-8b: cut to 8 of its 32 layers to keep the
# script inside its time limit (phase 4 serves the full depth)
PREFILL_LAYERS = 8
ENCDEC_T = 256                  # phase 7g's tokens over seamless's frontend
# the reference's single-point summary keys (repro/launch/serve.py)
SINGLE_POINT_KEYS = ("arch", "quant", "backend", "batch", "generated",
                     "prefill_s", "decode_s", "tok_per_s", "sample")


def prefill_forward(seed: int = 7, arch: str = "llama3-8b",
                    profiled: bool = True, t_len: int = PREFILL_T,
                    layers: int | None = None) -> dict:
    """Phase 7a (llama3-8b), 7d (mixtral-8x7b at ``layers``), 7f
    (zamba2-1.2b and rwkv6-1.6b, ``profiled`` False) and 7g
    (seamless-m4t-medium at ``t_len`` 256 with a raw frontend,
    ``profiled`` False):
    ``MD.forward`` at (PREFILL_B, PREFILL_T) on the top rung's view of a
    full-width weight store, through 'ref', 'fused' and 'packed': the
    logits must be bit-identical, and so must the MoE load-balance loss
    ``aux_loss`` (finite; 0 without MoE); each run's wrapper
    launches counted from 0 (one B1 or B2 a projection and the lm_head,
    no B3); forward ms on the host clock of the first (cold) call and of
    the counted call after it, and the device time by kernel kind from
    the profiler (one guard forward, one counted); unless ``profiled`` is
    False: then the one (cold) call is counted and timed. B1's and B2's bounds are summed over the (M, K, N, P) products
    the warm-up call of 'packed' hands B2."""
    from repro_torch.kernels import pann_matmul_packed as pk
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import model as MD
    from repro_torch.models import serving
    from repro_torch.serve_engine import build_ladder
    cfg = served_config(arch, quant=QuantConfig(mode="none"))
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ladder = build_ladder(LADDER, d=float(cfg.d_model))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws = serving.build_weight_store(
        _init_params(cfg, seed), cfg,
        {op.bits: (op.r, op.b_x_tilde) for op in ladder},
        serving.ServingQuantSpec(pack_planes=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    top = max(LADDER)
    view = ws.views[top]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, t_len),
                           generator=gen, device="cuda")
    fe = {}
    per_fwd = _graph_launches(cfg)["pann_matmul_packed_act"]
    if cfg.family in ("encdec", "vlm"):
        frontend = Frontend(cfg, seed)
        fe = {frontend.key: frontend.raw(PREFILL_B, 0)}
        # a forward projects each cross layer's K and V too, and runs the
        # stem and the encoder: the frontend's launches
        per_fwd += _frontend_launches(cfg)
    want_counts = {"ref": {}, "fused": {"pann_matmul_act": per_fwd},
                   "packed": {"pann_matmul_packed_act": per_fwd}}
    ref_logits = ref_aux = None
    runs = {}
    products = []           # (M, K, N, P) of every B2 launch of a forward
    launch = pk.pann_matmul_packed_act

    def launch_seen(xf, pp, *rest):
        products.append((xf.shape[0], pp.shape[1] * 8, pp.shape[2],
                         pp.shape[0]))
        return launch(xf, pp, *rest)

    def forward_ms(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = MD.forward(view, c, tokens, **fe)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for backend in ("ref", "fused", "packed"):
        c = dataclasses.replace(cfg, kernel_backend=backend)
        _reset_counts()
        if backend == "packed":
            pk.pann_matmul_packed_act = launch_seen
        try:
            out, cold_ms = forward_ms(c)
        finally:
            pk.pann_matmul_packed_act = launch
        ms = cold_ms
        if profiled:        # a warm call, counted and timed on its own
            del out
            _reset_counts()
            out, ms = forward_ms(c)
        logits, aux = out.logits, out.aux_loss
        del out
        counts = _counts()
        want = dict.fromkeys(counts, 0)
        want.update(want_counts[backend])
        if counts != want:
            raise AssertionError(f"forward on {backend}: launches {counts} "
                                 f"!= {want}")
        if ref_logits is None:
            if logits.shape != (PREFILL_B, t_len, cfg.padded_vocab) \
                    or not torch.isfinite(logits).all():
                raise AssertionError(f"forward logits {tuple(logits.shape)}"
                                     " not finite or of the wrong shape")
            if not torch.isfinite(aux) or (float(aux) > 0) != bool(cfg.moe):
                raise AssertionError(f"forward aux_loss {float(aux)}")
            ref_logits, ref_aux = logits, aux
        elif not torch.equal(logits, ref_logits):
            d = (logits - ref_logits).abs().max().item()
            raise AssertionError(f"forward on {backend}: logits differ "
                                 f"from ref by {d}")
        elif not torch.equal(aux, ref_aux):
            raise AssertionError(f"forward on {backend}: aux_loss "
                                 f"{float(aux)} != ref's {float(ref_aux)}")
        del logits
        run = {"forward_ms": ms, "cold_forward_ms": cold_ms,
               "launches": counts, "aux_loss": float(aux),
               "prefill_tok_per_s": PREFILL_B * t_len / (ms * 1e-3)}
        if backend != "ref" and profiled:
            dev_ms, ops, lost = _profile_rung(
                lambda: MD.forward(view, c, tokens, **fe), steps=1)
            total = sum(dev_ms.values())
            kernel = dev_ms.get("tile_kernel", 0.0) + dev_ms.get(
                "epilogue", 0.0)
            run.update(device_ms=total, device_ms_by_kind=dev_ms,
                       device_ops_by_kind=ops, guard_records_lost=lost,
                       kernel_share=kernel / total if total else None)
        runs[backend] = run
        print(f"[prefill] {arch} {backend}: forward {ms:.1f} ms (cold "
              f"{cold_ms:.1f}), "
              f"{run['prefill_tok_per_s']:.0f} tok/s, launches "
              + json.dumps({k: v for k, v in counts.items() if v})
              + ("" if "device_ms" not in run else
                 f", device {run['device_ms']:.1f} ms, tile + epilogue "
                 f"share {run['kernel_share']:.3f}, by kind "
                 + json.dumps(run["device_ms_by_kind"])), flush=True)
    if len(products) != per_fwd:
        raise AssertionError(f"forward handed B2 {len(products)} products, "
                             f"not {per_fwd}")
    # each launch reads its fp32 rows, gamma, zcol, qparams and its planes
    # once and writes its fp32 output: B2 packed planes, B1 int8 planes
    small = sum(4 * (m * k + 2 * n + 4 + m * n) for m, k, n, _ in products)
    ops = sum(2 * m * k * n for m, k, n, _ in products)
    for backend, name, plane_bytes in (
            ("packed", "pann_matmul_packed_act",
             sum(2 * p * (k // 8) * n for _, k, n, p in products)),
            ("fused", "pann_matmul_act",
             sum(2 * p * k * n for _, k, n, p in products))):
        b_ms, b_by = bound_ms(small + plane_bytes, ops)
        run = runs[backend]
        by_kind = run.get("device_ms_by_kind")
        kernel_ms = (None if by_kind is None else by_kind.get(
            "tile_kernel", 0.0) + by_kind.get("epilogue", 0.0))
        run.update(kernel=name, kernel_ms=kernel_ms, bound_ms=b_ms,
                   bound_by=b_by)
        print(f"[prefill] {arch} {name}: {kernel_ms} ms over "
              f"{len(products)} "
              f"products, bound {b_ms:.1f} ms ({b_by})", flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= 70.0:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB >= 70 GB")
    del ws, view, ref_logits, fe
    torch.cuda.empty_cache()
    return {"config": f"{arch} full width, {cfg.num_layers} layers, random "
                      f"weights seed {seed}; weight store ladder "
                      f"{list(LADDER)}, packed planes; the top rung's view "
                      f"({top} bits)" + (
                          f"; raw frontend {list(cfg.frontend_hw)} through "
                          f"the stem" + (f" and {cfg.encoder_layers} "
                                         "encoder layers"
                                         if cfg.encoder_layers else "")
                          if cfg.family in ("encdec", "vlm") else ""),
            "B_T": [PREFILL_B, t_len], "store_build_s": build_s,
            "logits_bit_identical": ["ref", "fused", "packed"],
            "products_MKNP": sorted(set(products)),
            "runs": runs, "peak_mem_gb": peak_gb}


def _plane_counts(artifact: dict) -> dict:
    """{module path: sorted plane counts over the layers} of an artifact's
    packed leaves."""
    out: dict = {}
    for lp in artifact["layers"]:
        for block in ("attn", "mlp"):
            for name, node in lp.get(block, {}).items():
                if isinstance(node, dict) and "w_planes_pos" in node:
                    out.setdefault(f"{block}.{name}", set()).add(
                        node["w_planes_pos"].shape[0])
    if "w_planes_pos" in artifact.get("lm_head", {}):
        out["lm_head"] = {artifact["lm_head"]["w_planes_pos"].shape[0]}
    return {k: sorted(v) for k, v in out.items()}


def serve_single(argv: list) -> dict:
    """One ``repro_torch.launch.serve.main`` run in single-point mode with
    the launch counters from 0: its summary (the reference's keys), the
    wrappers' launches, peak memory and the artifact's plane counts (read
    off ``serving.quantize_params_for_serving``'s result); and every
    decode step's logits (read off ``MD.decode_step``'s), finite, stacked
    on the card for the comparison across backends."""
    from repro_torch.launch import serve
    from repro_torch.models import model as MD
    from repro_torch.models import serving
    seen, planes = [], {}
    quantize, step = serving.quantize_params_for_serving, MD.decode_step

    def quantize_seen(*args, **kwargs):
        artifact = quantize(*args, **kwargs)
        planes.update(_plane_counts(artifact))
        return artifact

    def step_seen(*args, **kwargs):
        logits, state = step(*args, **kwargs)
        seen.append(logits.detach().clone())
        return logits, state

    serving.quantize_params_for_serving = quantize_seen
    MD.decode_step = step_seen
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out = serve.main(argv)
    finally:
        serving.quantize_params_for_serving = quantize
        MD.decode_step = step
    wall = time.perf_counter() - t0
    counts = _counts()
    if sorted(out) != sorted(SINGLE_POINT_KEYS):
        raise AssertionError(f"summary keys {sorted(out)} != the "
                             f"reference's {sorted(SINGLE_POINT_KEYS)}")
    logits = torch.stack(seen) if seen else None
    if logits is None or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{argv}: logits not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= 70.0:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB >= 70 GB")
    torch.cuda.empty_cache()
    return dict(out, argv=argv, launches=counts, steps=len(seen),
                peak_mem_gb=peak_gb, wall_s=wall, planes=planes), logits


# phase 7b's depth: llama3-8b's single point at full width, cut to 8 of its
# 32 layers to keep the script inside its time limit (each layer's
# value-exact plane count is the same at any depth: the codes' peak is
# 19-21 at --power_bits 2 and 36-40 at 4 in every layer)
SINGLE_POINT_LAYERS = 4


def single_point() -> dict:
    """Phase 7b: the single-point serve at full-width llama3-8b cut to
    SINGLE_POINT_LAYERS layers, --quant
    pann at --power_bits 2 through 'ref', 'packed' and 'fused' and at
    --power_bits 4 through 'ref' and 'packed' (the artifact's value-exact
    P = 5 and 6 on the square projections): every step's logits of
    'packed' and 'fused' bit-identical to those of 'ref' at the same
    bits; 7c: the legacy paths cut to 2 layers (fp params through the
    fake-quant projections, no kernel)."""
    from repro_torch import configs
    base = ["--arch", "llama3-8b", "--batch", str(BATCH), "--prompt_len",
            str(PROMPT), "--gen", str(GEN)]
    steps = PROMPT + GEN - 1
    per_step = _graph_launches(dataclasses.replace(
        configs.get_config("llama3-8b"), num_layers=SINGLE_POINT_LAYERS))[
        "pann_matmul_packed_act"]
    runs, ref_logits = {}, {}
    for bits, backend, want_p in ((2, "ref", None), (2, "packed", 5),
                                  (2, "fused", None), (4, "ref", None),
                                  (4, "packed", 6)):
        out, logits = serve_single(base + [
            "--layers", str(SINGLE_POINT_LAYERS), "--quant", "pann",
            "--power_bits", str(bits), "--backend", backend])
        kernel = {"packed": "pann_matmul_packed_act",
                  "fused": "pann_matmul_act"}.get(backend)
        want = dict.fromkeys(out["launches"], 0)
        if kernel:
            want[kernel] = per_step * steps
        if out["launches"] != want or out["steps"] != steps:
            raise AssertionError(f"{backend} P{bits}: launches "
                                 f"{out['launches']} over {out['steps']} "
                                 f"steps != {want}")
        if want_p is not None:
            for name in ("attn.wq", "attn.wo"):
                if out["planes"][name] != [want_p]:
                    raise AssertionError(f"--power_bits {bits}: {name} "
                                         f"packs {out['planes'][name]} "
                                         f"planes, not {want_p}")
        if backend == "ref":
            ref_logits[bits] = logits
        elif not torch.equal(logits, ref_logits[bits]):
            d = (logits - ref_logits[bits]).abs().amax(dim=tuple(
                range(1, logits.ndim)))
            raise AssertionError(
                f"--power_bits {bits} --backend {backend}: logits differ "
                f"from ref at steps {torch.nonzero(d).flatten().tolist()}, "
                f"by up to {d.max().item()}")
        else:
            out["logits_bit_identical_to_ref"] = True
        del logits
        runs[f"pann{bits}_{backend}"] = out
        print(f"[single] --power_bits {bits} --backend {backend}: "
              + json.dumps({k: out[k] for k in (
                  "prefill_s", "decode_s", "tok_per_s", "peak_mem_gb",
                  "wall_s", "sample", "planes")}), flush=True)
    del ref_logits
    for bits in (2, 4):
        samples = {k: r["sample"] for k, r in runs.items()
                   if k.startswith(f"pann{bits}_")}
        if len({tuple(v) for v in samples.values()}) != 1:
            raise AssertionError(f"--power_bits {bits} sample tokens differ "
                                 f"across backends: {samples}")
    legacy = {}
    for argv in (["--quant", "none"], ["--quant", "ruq", "--power_bits", "8"],
                 ["--quant", "pann", "--power_bits", "4", "--backend", ""]):
        out, _ = serve_single(base + ["--layers", "2"] + argv)
        if out["backend"] != "legacy" or any(out["launches"].values()):
            raise AssertionError(f"{argv}: backend {out['backend']}, "
                                 f"launches {out['launches']}")
        legacy[" ".join(argv)] = out
        print(f"[single] legacy {argv} (2 layers): " + json.dumps(
            {k: out[k] for k in ("quant", "prefill_s", "decode_s",
                                 "tok_per_s", "sample")}), flush=True)
    return {"config": "llama3-8b full width cut to "
                      f"{SINGLE_POINT_LAYERS} layers, random weights seed 0 "
                      "(the CLI's --seed); batch, prompt, gen "
                      f"{BATCH}, {PROMPT}, {GEN}; legacy paths cut to 2 "
                      "layers", "steps_per_serve": steps,
            "runs": runs, "legacy": legacy}


def moe_single_point(arch: str = "mixtral-8x7b") -> dict:
    """Phase 7e: the single-point serve of ``arch`` at full width and
    MOE_PREFILL_LAYERS depth, ``launch/serve.py --quant pann --power_bits 4``
    through 'packed' and 'ref': the attention projections and the head
    through the artifact's backend, the router and the experts (fp32 in
    the artifact) through the fake-quant projections; every step's logits
    of 'packed' bit-identical to those of 'ref', the same sample tokens."""
    layers = MOE_PREFILL_LAYERS
    base = ["--arch", arch, "--layers", str(layers), "--batch", str(BATCH),
            "--prompt_len", str(PROMPT), "--gen", str(GEN), "--quant",
            "pann", "--power_bits", "4"]
    steps = PROMPT + GEN - 1
    per_step = _graph_launches(dataclasses.replace(
        served_config(arch), num_layers=layers))["pann_matmul_packed_act"]
    runs, logits = {}, {}
    for backend in ("packed", "ref"):
        out, logits[backend] = serve_single(base + ["--backend", backend])
        want = dict.fromkeys(out["launches"], 0)
        if backend == "packed":
            want["pann_matmul_packed_act"] = per_step * steps
        if out["launches"] != want or out["steps"] != steps:
            raise AssertionError(f"{arch} single point on {backend}: "
                                 f"launches {out['launches']} over "
                                 f"{out['steps']} steps != {want}")
        runs[backend] = out
        print(f"[single] {arch} --layers {layers} --power_bits 4 --backend "
              f"{backend}: " + json.dumps({k: out[k] for k in (
                  "prefill_s", "decode_s", "tok_per_s", "peak_mem_gb",
                  "wall_s", "sample", "planes")}), flush=True)
    if not torch.equal(logits["packed"], logits["ref"]):
        d = (logits["packed"] - logits["ref"]).abs().max().item()
        raise AssertionError(f"{arch} single point: packed logits differ "
                             f"from ref by {d}")
    if runs["packed"]["sample"] != runs["ref"]["sample"]:
        raise AssertionError(f"{arch} single point: samples differ")
    del logits
    return {"config": f"{arch} full width, {layers} layers, random weights "
                      f"seed 0 (the CLI's --seed); batch, prompt, gen "
                      f"{BATCH}, {PROMPT}, {GEN}", "steps_per_serve": steps,
            "logits_bit_identical": ["ref", "packed"], "runs": runs}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 8: whole-sequence encode under per-item budgets
# ---------------------------------------------------------------------------

ENCODE_ITEMS = 8


def encode_serve(arch: str, seed: int) -> dict:
    """Phase 8: ``EncodeEngine`` on ``arch`` at its ENCDEC_LAYERS depth
    (full width; its store quantizes the whole model, as the reference's),
    ENCODE_ITEMS raw items over budgets cycling the ladder, on 'packed':
    warmup, the timed encode (items/s), ``assert_no_recompile``, one B2 a
    stem layer and an encoder projection a wave; then engines on 'ref'
    and 'fused' over the same store: every encoded state bit-identical.
    Reports each rung's Gbit-flips an item."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import frontend_raw_stub
    from repro_torch.models.serving import WeightStore
    from repro_torch.serve_engine import EncodeEngine, EncodeRequest
    cfg = served_config(arch, quant=QuantConfig(mode="none"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = EncodeEngine(cfg, _init_params(cfg, seed), ladder_bits=LADDER,
                          max_batch=BATCH, backend="packed", device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    raw = frontend_raw_stub(cfg, ENCODE_ITEMS, 0, seed)
    reqs = [EncodeRequest(uid=i, item=raw[i],
                          power_budget_bits=LADDER[i % len(LADDER)])
            for i in range(ENCODE_ITEMS)]
    _reset_counts()
    t0 = time.perf_counter()
    out = engine.encode(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.assert_no_recompile()
    launches = {k: v for k, v in _counts().items() if v}
    waves = sum(-(-n // BATCH) for n in engine.items_by_rung.values())
    mlp = 3 if cfg.activation in ("swiglu", "geglu") else 2
    per_wave = len(cfg.conv_stem) + cfg.encoder_layers * (4 + mlp)
    if launches != {"pann_matmul_packed_act": per_wave * waves}:
        raise AssertionError(f"encode launches {launches}, want "
                             f"{per_wave} B2 a wave over {waves} waves")
    shape = (cfg.stem_tokens, cfg.d_model)
    for r in out:
        if r.encoded.shape != shape or not np.isfinite(r.encoded).all():
            raise AssertionError(f"item {r.uid}: {r.encoded.shape} not "
                                 f"{shape} or not finite")
    ws = WeightStore(store=engine.weight_store, views=engine.variants)
    for backend in ("ref", "fused"):
        other = EncodeEngine(cfg, weight_store=ws, ladder_bits=LADDER,
                             max_batch=BATCH, backend=backend,
                             device="cuda")
        for a, b in zip(other.encode(reqs), out):
            if not np.array_equal(a.encoded, b.encoded):
                d = float(np.abs(a.encoded - b.encoded).max())
                raise AssertionError(f"encode {backend} item {a.uid}: "
                                     f"max |diff| {d} from packed")
        del other
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= 70.0:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB >= 70 GB")
    report = {
        "config": f"{arch} full width, {cfg.num_layers} decoder layers, "
                  f"{cfg.encoder_layers} encoder layers, random weights "
                  f"seed {seed}; the stem over {list(raw.shape[1:])} items",
        "items": ENCODE_ITEMS, "budgets": [r.power_budget_bits
                                           for r in reqs],
        "backend": "packed", "store_build_s": build_s,
        "warmup_s": warmup_s, "encode_s": wall,
        "items_per_s": ENCODE_ITEMS / wall, "waves": waves,
        "launches": launches, "b2_launches_per_wave": per_wave,
        "compilations_after_warmup": engine.compilations_after_warmup,
        "items_by_rung": dict(engine.items_by_rung),
        "gbitflips_per_item": {op.bits: engine.item_flips(op.bits) / 1e9
                               for op in engine.ladder},
        "encoded_shape": list(shape),
        "bit_identical_on": ["packed", "ref", "fused"],
        "peak_mem_gb": peak_gb}
    del engine, ws, out
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 9: power-aware training, export, the calibrated artifact served
# ---------------------------------------------------------------------------

# 9a: llama3-8b at full width (d 4096, GQA 32/8, d_ff 14336, vocab 128256,
# untied head) cut to 2 layers by the trainer's own flags: QAT through the
# budget schedule fp -> 8 -> 6 bits, layerwise allocation, one checkpoint
TRAIN_LAYERS = 2
TRAIN_STEPS = 12
TRAIN_BATCH, TRAIN_SEQ = 4, 256
TRAIN_SCHEDULE = "0:fp,4:8,8:6"
EXPORT_TOL = 1e-3
TRAIN_ARGV = ["--arch", "llama3-8b", "--d_model", "4096", "--d_ff", "14336",
              "--layers", str(TRAIN_LAYERS), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
              "--quant", "pann", "--train_quant", "qat",
              "--budget_schedule", TRAIN_SCHEDULE, "--allocation",
              "layerwise", "--ckpt_every", "1000", "--log_every", "1",
              "--device", "cuda"]
# 9e: the resume at configs.reduced size, resumed at the 8-bit knot
RESUME_ARGV = ["--arch", "llama3-8b", "--reduced", "--batch", "4", "--seq",
               "64", "--quant", "pann", "--train_quant", "qat",
               "--budget_schedule", "0:fp,2:8,5:6", "--allocation",
               "layerwise", "--lr", "1e-2", "--total_steps", "8",
               "--ckpt_every", "4", "--log_every", "100", "--device", "cuda"]
# 9c's prompt tokens teacher-forced through every rung on each backend
TF_TOKENS = 8
# the frozen leaves a calibrated view carries
FROZEN_ACT = ("act_lo", "act_hi", "act_s", "act_z")
FROZEN_CACHE = ("k_s", "k_z", "v_s", "v_z")
# 9d's rows: the decode batch and a prefill-sized block
FROZEN_M = (BATCH, 1024)
FROZEN_MODULES = (("attn", "wq"), ("mlp", "w_down"))


def _free() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def power_aware_train(ckpt_dir: str) -> dict:
    """9a: ``repro_torch.launch.train.main`` in-process on the card with
    TRAIN_ARGV: losses, step times by segment, tokens/s, peak memory, the
    checkpoint's size and write time, the seen calibration roles."""
    from repro_torch.launch import train as TR
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = TR.main(TRAIN_ARGV + ["--ckpt_dir", ckpt_dir])
    wall = time.perf_counter() - t0
    _free()
    if not all(np.isfinite(summary["losses"])) or \
            not np.isfinite(summary["eval_loss"]):
        raise AssertionError(f"QAT losses not finite: {summary['losses']}")
    if summary["peak_mem_gb"] >= 70.0:
        raise AssertionError(f"training peak {summary['peak_mem_gb']:.1f} GB "
                             ">= 70 GB")
    if summary["calib_seen"] != summary["calib_roles"]:
        raise AssertionError(f"{summary['calib_seen']} of "
                             f"{summary['calib_roles']} calibration roles "
                             "seen: a projection never observed")
    return {"argv": TRAIN_ARGV, "wall_s": wall, **summary}


def _eval_view(view, cfg, batch, backend) -> float:
    from repro_torch.launch import steps as ST
    return ST.eval_loss(view, dataclasses.replace(cfg, kernel_backend=backend),
                        batch)


def _view_points(view) -> list:
    """The distinct (act_n, act_nlvl, plane_shift) of a view's
    projections: where act_n exceeds the kernels' 127 levels or the shift
    is above 0, the float-dequant forward quantizes otherwise than the
    kernels (its act_n levels; every stored plane)."""
    from repro_torch.serve_engine.artifact import _flatten
    flat = dict(_flatten(view))
    mods = sorted({p.rsplit("/", 1)[0] for p in flat if p.endswith("/w_q")})
    return sorted({tuple(float(flat[f"{m}/{k}"]) for k in (
        "act_n", "act_nlvl", "plane_shift")) for m in mods})


def export_calibrated(ckpt_dir: str, art_dir: str) -> dict:
    """9b: ``repro_torch.launch.export.main`` on 9a's checkpoint with the
    ladder artifact (2,4,6, the 4-bit cache's frozen quantizers) and the
    reference's two gates at tol 1e-3. Then the loaded artifact's top rung
    over the held-out batch: 'packed' and 'ref' give the same loss, bit
    for bit (the kernels against the integer oracle); reported beside it,
    not held to it, the same view's float-dequant forward (the forward the
    export's gate evaluates: act_n levels, not the kernels' 127, and no
    plane_shift) and the trained rung's loss (the 6-bit LAYERWISE point;
    the ladder's rung 6 is the uniform one)."""
    import types
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.launch import export as EX
    from repro_torch.launch import train as TR
    from repro_torch.serve_engine import load_artifact
    argv = ["--ckpt_dir", ckpt_dir, "--artifact_out", art_dir,
            "--artifact_ladder", ",".join(map(str, LADDER)),
            "--cache_bits", str(CACHE_BITS), "--tol", str(EXPORT_TOL),
            "--device", "cuda"]
    t0 = time.perf_counter()
    try:
        summary = EX.main(argv)
    except SystemExit as e:
        raise AssertionError(f"export gate failed: {e}") from None
    wall = time.perf_counter() - t0
    _free()
    blob = Path(art_dir, "weights.bin").stat().st_size
    meta = ck.read_meta(ckpt_dir, ck.latest_step(ckpt_dir))
    targs = types.SimpleNamespace(**meta["train_args"])
    cfg, _, _ = TR.build(targs)
    batch = TR.make_eval_batch(cfg, targs, "cuda")
    t0 = time.perf_counter()
    ws = load_artifact(art_dir, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    top = max(LADDER)
    loss = {b: _eval_view(ws.views[top], cfg, batch, b)
            for b in ("packed", "ref", None)}
    if loss["packed"] != loss["ref"]:
        raise AssertionError(f"the artifact's rung {top}: 'packed' loss "
                             f"{loss['packed']} != 'ref' {loss['ref']}")
    points = _view_points(ws.views[top])
    del ws
    _free()
    trained = summary["loss_serve_eval"]
    return {"argv": argv, "wall_s": wall, "artifact_gb": blob / 1e9,
            "artifact_load_s": load_s, **summary,
            "artifact_rung": top, "artifact_rung_packed_loss": loss["packed"],
            "artifact_rung_ref_loss": loss["ref"],
            "artifact_rung_dequant_loss": loss[None],
            "artifact_rung_act_n_nlvl_shift": points,
            "dequant_gap": abs(loss["packed"] - loss[None])
            / max(abs(loss[None]), 1e-8),
            "trained_rung_gap": abs(loss["packed"] - trained)
            / max(abs(trained), 1e-8)}


def _calibrated_leaves(ws) -> dict:
    """Every projection view leaf carries act_s/act_z, every attention's
    kv_cache k_s/k_z/v_s/v_z: raise otherwise; the counts."""
    from repro_torch.serve_engine.artifact import _flatten
    proj = cache = 0
    for key, view in ws.views.items():
        flat = dict(_flatten(view))
        mods = {p.rsplit("/", 1)[0] for p in flat if p.endswith("/w_q")}
        for m in mods:
            missing = [k for k in FROZEN_ACT if f"{m}/{k}" not in flat]
            if missing:
                raise AssertionError(f"rung {key}: {m} lacks {missing}")
            proj += 1
        caches = {p.rsplit("/", 1)[0] for p in flat if "/kv_cache/" in p}
        if not caches:
            raise AssertionError(f"rung {key}: no kv_cache leaves")
        for c in caches:
            missing = [k for k in FROZEN_CACHE if f"{c}/{k}" not in flat]
            if missing:
                raise AssertionError(f"rung {key}: {c} lacks {missing}")
            cache += 1
    return {"projection_views": proj, "cache_views": cache}


def _strip_frozen(tree):
    """A view without its frozen calibration leaves: the dynamic-range
    path, for the same-depth comparison of the dispatch's small kernels."""
    if isinstance(tree, dict):
        return {k: _strip_frozen(v) for k, v in tree.items()
                if k not in FROZEN_ACT + FROZEN_CACHE}
    if isinstance(tree, list):
        return [_strip_frozen(v) for v in tree]
    return tree


def serve_calibrated(art_dir: str, seed: int = 30) -> dict:
    """9c: ``load_artifact`` -> ``ServeEngine(weight_store=..., ladder 2,4,6,
    'packed', cache_bits 4)`` -> warmup -> 3 requests (prompt 32, gen 16)
    through graphs, every graphed step held bit for bit to an eager
    replay, no recompile; 'ref' and 'fused' engines over the same store:
    the same tokens, and every rung's teacher-forced logits (the first
    TF_TOKENS prompt tokens) bit-identical across the three; the device ms
    a step by kernel kind beside the same store with its frozen leaves
    stripped (the dynamic-range path at the same depth). Returns the
    report and the loaded store (9d reads it).
    """
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models.serving import WeightStore
    from repro_torch.serve_engine import ServeEngine, load_artifact
    cfg = dataclasses.replace(
        configs.get_config("llama3-8b", quant=QuantConfig(mode="none")),
        num_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws = load_artifact(art_dir, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    leaves = _calibrated_leaves(ws)
    reqs = _requests(cfg, seed=seed, n=3)
    kw = dict(ladder_bits=LADDER, max_batch=BATCH, max_len=PROMPT + GEN,
              cache_bits=CACHE_BITS, device="cuda")
    engine = ServeEngine(cfg, weight_store=ws, backend="packed", **kw)
    served = serve_graphed(engine, reqs, cfg.vocab_size)
    per_step = _graph_launches(cfg)
    _check_capture_counts(engine, served["launches"], per_step)
    profile = profile_steps(functools.partial(_graph_runner, engine),
                            served["steps_by_rung"])
    tokens = {"packed": [r.tokens for r in served.pop("responses")]}
    views, cfg_b = engine.variants, engine.cfg
    del engine
    _free()
    rows = torch.as_tensor(np.stack([reqs[0].prompt[:TF_TOKENS]] * BATCH)
                           .astype(np.int64), device="cuda")
    logits = {"packed": _teacher_forced(views, cfg_b, rows)}
    launches = {"packed": served["launches"]}
    for backend in ("ref", "fused"):
        eng = ServeEngine(cfg, weight_store=ws, backend=backend, **kw)
        _reset_counts()
        eng.warmup()
        launches[backend] = _counts()
        res = eng.generate(reqs)
        torch.cuda.synchronize()
        eng.assert_no_recompile()
        tokens[backend] = [r.tokens for r in res]
        views, cfg_b = eng.variants, eng.cfg
        del eng
        _free()
        logits[backend] = _teacher_forced(views, cfg_b, rows)
    for backend in ("ref", "fused"):
        if tokens[backend] != tokens["packed"]:
            raise AssertionError(f"{backend} tokens differ from packed")
        if not torch.equal(logits[backend], logits["packed"]):
            d = (logits[backend] - logits["packed"]).abs().max().item()
            raise AssertionError(f"{backend} logits differ from packed by "
                                 f"{d}")
    del logits
    # the same store without its frozen leaves: the dynamic-range path
    plain_ws = WeightStore(store=ws.store, views={
        k: _strip_frozen(v) for k, v in ws.views.items()})
    eng = ServeEngine(cfg, weight_store=plain_ws, backend="packed", **kw)
    eng.warmup()
    eng.generate(reqs)
    plain_profile = profile_steps(functools.partial(_graph_runner, eng),
                                  served["steps_by_rung"])
    del eng, plain_ws
    _free()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= 70.0:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB >= 70 GB")
    small = "other PyTorch kernels"
    report = {
        "config": f"llama3-8b full width, {TRAIN_LAYERS} layers (of 32), "
                  "the calibrated ladder artifact of 9b",
        "artifact_load_s": load_s, "calibrated_leaves": leaves,
        **served, "launches_per_captured_step": per_step,
        "tokens_by_backend_identical": True,
        "logits_bit_identical_on": ["ref", "fused", "packed"],
        "launches_by_backend": launches,
        "tokens": tokens["packed"],
        "profile": profile, "uncalibrated_profile": plain_profile,
        "peak_mem_gb": peak_gb}
    for name, prof in (("calibrated", profile),
                       ("uncalibrated", plain_profile)):
        if prof["device_ms_per_step"] is not None:
            report[f"small_kernels_{name}"] = {
                "ms_per_step": prof["ms_per_step_by_kind"].get(small, 0.0),
                "ops_per_step": prof["device_ops_per_step_by_kind"].get(
                    small, 0.0),
                "device_ms_per_step": prof["device_ms_per_step"]}
    return report, ws


def _frozen_operands(p: dict, m: int, gen):
    """B1/B2 operands of one calibrated projection view ``p`` at ``m``
    rows: x drawn around the frozen range (a tenth of it outside, so the
    clip runs), the view's (s, z, n, shift) and gamma, zcol as the
    dispatch derives them."""
    from repro_torch.core.pann import bitplane_decompose
    from repro_torch.kernels import dispatch
    k = p["w_q"].shape[0]
    lo, hi = p["act_lo"].float(), p["act_hi"].float()
    x = (torch.randn((m, k), generator=gen, device="cuda") * (hi - lo) / 4
         + (hi + lo) / 2).contiguous()
    s, z = p["act_s"].float().reshape(()), p["act_z"].float().reshape(())
    n_lvl = p["act_nlvl"].float().reshape(())
    shift = p["plane_shift"].float().reshape(())
    qp = torch.stack([s, z, n_lvl, shift])
    gamma, zcol = dispatch._gamma_zcol(p, s, z)
    w_q = p["w_q"]
    pos = bitplane_decompose(torch.clamp(w_q, min=0), 7)
    neg = bitplane_decompose(torch.clamp(-w_q.to(torch.int32), min=0), 7)
    return x, pos, neg, qp, gamma, zcol


def frozen_kernels(ws, seed: int = 31) -> dict:
    """9d: B1 ('fused' and 'planes') and B2 on two calibrated projection
    views of the loaded artifact (every rung), at M = 4 and 1024, with the
    view's frozen (s, z): bit for bit against their plain versions, and
    ``serving_linear`` 'fused' and 'packed' against 'ref'; B3 at S = 48,
    4 bits, its cache rows the artifact's frozen k/v (s, z) (codes of K/V
    drawn around the calibrated range, encoded with them): bit for bit
    against its plain version. Rows timed at the top rung."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import pann_attention as pa
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    from repro_torch.kernels import ref as KREF
    from repro_torch.core import quant
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err: dict = {}
    rows = {"pann_matmul_act": [], "pann_matmul_packed_act": [],
            "decode_attention": []}
    top = max(LADDER)
    for parent, name in FROZEN_MODULES:
        for bits in LADDER:
            p = ws.views[bits]["layers"][0][parent][name]
            k, n = p["w_q"].shape
            for m in FROZEN_M:
                x, pos, neg, qp, gamma, zcol = _frozen_operands(p, m, gen)
                ppk, npk = p["w_planes_pos"], p["w_planes_neg"]
                for mode in pm.MODES:
                    _agree("pann_matmul_act",
                           pm.pann_matmul_act(x, pos, neg, qp, gamma, zcol,
                                              mode),
                           pm.pann_matmul_act_plain(x, pos, neg, qp, gamma,
                                                    zcol, mode), err)
                _agree("pann_matmul_packed_act",
                       pk.pann_matmul_packed_act(x, ppk, npk, qp, gamma,
                                                 zcol),
                       pk.pann_matmul_packed_act_plain(x, ppk, npk, qp,
                                                       gamma, zcol), err)
                y_ref = dispatch.serving_linear(x, p, "ref")
                for backend, kern in (("fused", "pann_matmul_act"),
                                      ("packed", "pann_matmul_packed_act")):
                    _agree(kern, dispatch.serving_linear(x, p, backend),
                           y_ref, err)
                if bits != top:
                    continue
                w_deq = (p["w_q"].float() * gamma[None, :]).contiguous()
                lib = time_ms(lambda: torch.matmul(x, w_deq), 10)
                del w_deq
                small = 4 * (m * k + 2 * n + 4 + m * n)
                for kern, fn, plain, plane_bytes in (
                        ("pann_matmul_act",
                         lambda: pm.pann_matmul_act(x, pos, neg, qp, gamma,
                                                    zcol),
                         lambda: pm.pann_matmul_act_plain(
                             x, pos, neg, qp, gamma, zcol),
                         2 * 7 * k * n),
                        ("pann_matmul_packed_act",
                         lambda: pk.pann_matmul_packed_act(
                             x, ppk, npk, qp, gamma, zcol),
                         lambda: pk.pann_matmul_packed_act_plain(
                             x, ppk, npk, qp, gamma, zcol),
                         2 * 7 * (k // 8) * n)):
                    b_ms, b_by = bound_ms(small + plane_bytes, 2 * m * k * n)
                    rows[kern].append({
                        "module": f"{parent}.{name}", "K": k, "N": n, "M": m,
                        "rung": bits, "act_s": float(qp[0]),
                        "act_z": float(qp[1]), "per_step": 1,
                        "ms": time_ms(fn, 10), "plain_ms": time_ms(plain, 2),
                        "library_ms": lib, "bound_ms": b_ms,
                        "bound_by": b_by, "max_abs_err": err[kern]})
                del x, pos, neg
    # B3 with the artifact's frozen cache scalars
    kc = ws.views[top]["layers"][0]["attn"]["kv_cache"]
    b, kh, g, hd, s = BATCH, 8, 4, 128, PROMPT + GEN
    n_lvl = kc["k_nlvl"].float().reshape(())
    cache = {}
    for role in ("k", "v"):
        sc = kc[f"{role}_s"].float().reshape(())
        zc = kc[f"{role}_z"].float().reshape(())
        center = (zc * -1.0 + n_lvl / 2) * sc
        vals = (torch.randn((b, s, kh, hd), generator=gen, device="cuda")
                * sc * n_lvl / 3 + center)
        codes = quant.affine_encode(vals, sc, zc, n_lvl).to(torch.int32)
        cache[role] = (KREF.pack_cache_codes(codes).movedim(0, 1)
                       .contiguous(),
                       torch.full((b, s), float(sc), device="cuda"),
                       torch.full((b, s), float(zc), device="cuda"), codes)
    qf = torch.randn((b, kh, g, hd), generator=gen, device="cuda")
    n127 = torch.full((), 127.0, device="cuda")
    lo, hi = quant.act_range_bounds(qf, include_zero=True)
    s_q, z_q = quant.affine_scale_zp(lo, hi, n127)
    q_scale = (s_q * float(hd) ** -0.5).reshape(())
    qq = quant.affine_encode(qf, s_q, z_q, n127).to(torch.int32).contiguous()
    args = (qq, z_q.reshape(()).contiguous(), q_scale.contiguous(),
            cache["k"][0], cache["k"][1], cache["k"][2],
            cache["v"][0], cache["v"][1], cache["v"][2])
    pact = dispatch.cache_planes_active(n_lvl).reshape(()).contiguous()
    for pos_i, window in _attention_cases(s):
        p_t = torch.full((), pos_i, dtype=torch.int32, device="cuda")
        _agree("decode_attention",
               pa.decode_attention(*args, p_t, pact, pact, window=window),
               pa.decode_attention_plain(*args, p_t, window=window), err)
    p_t = torch.full((), s - 1, dtype=torch.int32, device="cuda")
    kf = cache["k"][3].float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
    vf = cache["v"][3].float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
    qs = qf.reshape(b, kh * g, 1, hd)
    bits = int(pact.item())
    live = 2 * bits * s * kh * (hd // 8)
    b_ms, b_by = bound_ms(4 * b * kh * g * hd * 2 + b * live + 4 * 4 * b * s,
                          4 * b * kh * g * s * hd)
    rows["decode_attention"].append({
        "B": b, "KH": kh, "G": g, "hd": hd, "S": s, "planes_live": bits,
        "k_s": float(kc["k_s"]), "k_z": float(kc["k_z"]),
        "v_s": float(kc["v_s"]), "v_z": float(kc["v_z"]),
        "per_step": TRAIN_LAYERS,
        "ms": time_ms(lambda: pa.decode_attention(*args, p_t, pact, pact),
                      10),
        "plain_ms": time_ms(lambda: pa.decode_attention_plain(*args, p_t), 2),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qs, kf, vf), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err["decode_attention"]})
    _free()
    return {"rows": rows, "max_abs_err": err,
            "cases": {"matmul": [list(x) for x in FROZEN_MODULES],
                      "M": list(FROZEN_M), "rungs": list(LADDER),
                      "attention_cases": len(_attention_cases(s))}}


def _npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def resume_on_card(root: str) -> dict:
    """9e: the trainer at configs.reduced llama3-8b size on the card, 8
    steps straight against 4, a checkpoint, a restore and 4 more (resumed
    at the 8-bit knot's segment): whether the losses, the eval loss and
    every checkpoint array (params, AdamW moments, calib) are
    bit-identical, and the largest gap where they are not. Reported, not
    asserted: CUDA's atomics may order a sum differently (ROADMAP C)."""
    from repro_torch.launch import train as TR
    t0 = time.perf_counter()
    full = TR.main(RESUME_ARGV + ["--steps", "8", "--ckpt_dir",
                                  f"{root}/full"])
    first = TR.main(RESUME_ARGV + ["--steps", "4", "--ckpt_dir",
                                   f"{root}/resume"])
    resumed = TR.main(RESUME_ARGV + ["--steps", "8", "--ckpt_dir",
                                     f"{root}/resume"])
    wall = time.perf_counter() - t0
    a = _npz(f"{root}/full/step_00000008/arrays.npz")
    b = _npz(f"{root}/resume/step_00000008/arrays.npz")
    if sorted(a) != sorted(b):
        raise AssertionError("resumed checkpoint has other keys")
    gaps = {k: float(np.max(np.abs(a[k].astype(np.float64)
                                   - b[k].astype(np.float64))))
            if a[k].size else 0.0 for k in a}
    by_group = {}
    for k, v in gaps.items():
        group = k.split("/")[0] if not k.startswith("opt/") else \
            "/".join(k.split("/")[:2])
        by_group[group] = max(by_group.get(group, 0.0), v)
    losses = full["losses_exact"] == (first["losses_exact"]
                                      + resumed["losses_exact"])
    return {"argv": RESUME_ARGV, "wall_s": wall,
            "losses_bit_identical": losses,
            "first_4_bit_identical": first["losses_exact"]
            == full["losses_exact"][:4],
            "eval_loss_bit_identical": full["eval_loss"] ==
            resumed["eval_loss"],
            "arrays_bit_identical": all(v == 0.0 for v in gaps.values()),
            "largest_gap_by_group": by_group,
            "losses_full": full["losses_exact"],
            "losses_resumed": first["losses_exact"] + resumed["losses_exact"],
            "calib_seen": resumed["calib_seen"]}


# ---------------------------------------------------------------------------
# phase 10: a fleet of hosts under one global power cap
# ---------------------------------------------------------------------------

# llama3-8b at full width cut to 8 of its 32 layers (an 8.4 GB store that
# five hosts and the verify engine share), so the phase fits the script's
# time; benchmarks/fleet_sim.py's settings otherwise
FLEET_LAYERS = 8
FLEET_HOSTS = 4
FLEET_BATCH = 2
FLEET_PROMPT, FLEET_GEN = 6, (6, 10)
FLEET_TICKS = 12
FLEET_KILL = (4, 1)                 # (tick, decode host)
FLEET_STEP_TICK = 6
# fleet_sim.py's caps (Gbit-flips/s) for the reduced model, scaled by rho
REDUCED_CAPS = (0.25, 0.035)


def _fleet_config():
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    cfg = configs.get_config("llama3-8b", quant=QuantConfig(mode="none"))
    return dataclasses.replace(cfg, num_layers=FLEET_LAYERS)


def _reduced_flips(bits: int, ctx: int) -> float:
    """The reduced llama3-8b pricer's bit flips of one token at rung
    ``bits`` (the config fleet_sim.py's caps were set for), from an
    engine over a reduced store on the card."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import model as MD
    from repro_torch.serve_engine import ServeEngine
    cfg = configs.reduced(configs.get_config(
        "llama3-8b", quant=QuantConfig(mode="none")))
    eng = ServeEngine(cfg, MD.init_params(cfg, seed=0, device="cuda"),
                      ladder_bits=LADDER, max_batch=FLEET_BATCH,
                      max_len=FLEET_PROMPT + max(FLEET_GEN) + 2,
                      backend="packed", cache_bits=CACHE_BITS, slots=1,
                      device="cuda")
    return eng.token_flips(bits, ctx)


def _store_bytes(store) -> int:
    from repro_torch.serve_engine.artifact import _flatten
    seen = {}
    for _, t in _flatten(store):
        if isinstance(t, torch.Tensor):
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def _check_host_views(fleet) -> int:
    """Every host's engine serves the fleet's one store: its views are the
    fleet's, and each view leaf at a store path is the store's own device
    tensor (``_check_aliasing``). Returns the aliased leaves checked."""
    ws = fleet.weight_store
    n = _check_aliasing(ws)
    for host in (list(fleet.decode_hosts.values())
                 + list(fleet.prefill_hosts.values())):
        if host.engine.weight_store is not ws.store or any(
                v is not ws.views[b]
                for b, v in host.engine.variants.items()):
            raise AssertionError(f"host {host.role} {host.host_id} holds a "
                                 "store or view of its own")
    return n


def fleet_serve(tmp: str) -> dict:
    """10a: a ``Fleet`` of FLEET_HOSTS decode hosts and a prefill host over
    one device store (llama3-8b full width, FLEET_LAYERS layers), the
    fleet_sim trace with its host kill and cap step, the caps scaled by
    rho; every stream verified on a fresh full-ladder engine over the
    same store."""
    from repro_torch.serve_engine import ServeEngine
    from repro_torch.serve_engine.fleet import (Fleet, FleetConfig,
                                                TrafficSpec, make_trace,
                                                verify_streams)
    cfg = _fleet_config()
    max_len = FLEET_PROMPT + max(FLEET_GEN) + 2
    ctx = FLEET_PROMPT + max(FLEET_GEN)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    fc = FleetConfig(n_decode_hosts=FLEET_HOSTS, n_prefill_hosts=1,
                     ladder_bits=LADDER, cap_gbitflips_per_s=REDUCED_CAPS[0],
                     control_interval=3, max_batch=FLEET_BATCH,
                     max_len=max_len, drain_tick_factor=16,
                     backend="packed", cache_bits=CACHE_BITS)
    params = _init_params(cfg, seed=40)
    fleet = Fleet(cfg, fc, f"{tmp}/fleet_artifact", params=params,
                  device="cuda")
    del params
    _free()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the reference's caps were set for the reduced model: scale both by
    # rho so the governor feels the same pressure at full width
    rho = fleet._pricer.token_flips(LADDER[-1], ctx) / _reduced_flips(
        LADDER[-1], ctx)
    caps = tuple(c * rho for c in REDUCED_CAPS)
    fleet.governor.set_cap(caps[0], tick=0, replan=False)
    print(f"[fleet] rho {rho:.6g} (rung {LADDER[-1]} flips a token at "
          f"context {ctx}, full width {FLEET_LAYERS} layers over reduced); "
          f"caps {caps[0]:.6g} -> {caps[1]:.6g} Gbit-flips/s at tick "
          f"{FLEET_STEP_TICK}", flush=True)
    spec = TrafficSpec(seed=7, n_ticks=FLEET_TICKS, burst_prob=0.7,
                       mean_burst=2.0, prompt_lens=(FLEET_PROMPT,),
                       gen_tokens=FLEET_GEN, budget_mix=(2, 4, 6, 6),
                       slo_prob=0.3, slo_bits=(4,),
                       budget_steps=((FLEET_STEP_TICK, caps[1]),),
                       host_kills=(FLEET_KILL,))
    trace = make_trace(spec, cfg.vocab_size, fleet.ladder)
    t0 = time.perf_counter()
    report = fleet.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fleet.assert_no_recompile()
    aliased = _check_host_views(fleet)
    t0 = time.perf_counter()
    ref = ServeEngine(cfg, weight_store=fleet.weight_store,
                      ladder_bits=LADDER, max_batch=FLEET_BATCH,
                      max_len=max_len, backend="packed",
                      cache_bits=CACHE_BITS, slots=1, device="cuda")
    ref.warmup()
    mismatches = verify_streams(report, ref)
    ref.assert_no_recompile()
    verify_s = time.perf_counter() - t0
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    store_gb = _store_bytes(fleet.weight_store.store) / 1e9
    moved = [r for r in report["governor"]["replans"]
             if r["moved"] and r["tick"] >= FLEET_STEP_TICK]
    ticks = report["per_tick"]
    worst = max(ticks, key=lambda t: t["flips"] / t["cap"])
    hosts = {f"{h.role} {h.host_id} {list(h.rung_bits)}": h.monitor.summary()
             for h in (list(fleet.prefill_hosts.values())
                       + list(fleet.decode_hosts.values()))}
    checks = {
        "served == requests": report["served"] == report["requests"] > 0,
        "cap_violations 0": report["cap_violations"] == 0,
        "host_restarts 1": report["host_restarts"] == 1,
        "migrations >= 1": report["migrations"] >= 1,
        f"a replan moved the ceiling at tick >= {FLEET_STEP_TICK}":
            bool(moved),
        "verify_streams empty": mismatches == [],
        "peak < 70 GB": peak_gb < 70.0,
        "B2 and B3 launched": launches["pann_matmul_packed_act"] > 0
        and launches["decode_attention"] > 0}
    out = {
        "config": f"llama3-8b full width, {FLEET_LAYERS} of 32 layers, "
                  "random weights seed 40",
        "hosts": report["hosts"], "ladder": list(LADDER),
        "backend": "packed", "cache_bits": CACHE_BITS,
        "max_batch": FLEET_BATCH, "rho": rho, "caps_gbitflips_per_s": caps,
        "requests": report["requests"], "served": report["served"],
        "ticks": report["ticks"], "decode_tokens": report["decode_tokens"],
        "realized_gbitflips": report["realized_gbitflips"],
        "decode_gbitflips": report["decode_gbitflips"],
        "prefill_gbitflips": report["prefill_gbitflips"],
        "cap_violations": report["cap_violations"],
        "host_restarts": report["host_restarts"],
        "migrations": report["migrations"],
        "slo_violations": report["slo_violations"],
        "rung_token_histogram": report["rung_token_histogram"],
        "replans": report["governor"]["replans"],
        "largest_tick": {"tick": worst["tick"], "flips": worst["flips"],
                         "grant": worst["cap"],
                         "share": worst["flips"] / worst["cap"]},
        "build_s": build_s, "wall_s": wall,
        "decode_tok_per_s": report["decode_tokens"] / wall,
        "host_monitors": hosts, "restart_s": report["restart_s"],
        "handoff_ms": report["handoff_ms"],
        "verify_s": verify_s, "verify_mismatches": mismatches,
        "aliased_leaves": aliased, "store_gb": store_gb,
        "peak_mem_gb": peak_gb, "launches": launches,
        "graphs": {f"{h.role} {h.host_id}": h.engine.graphs_captured
                   for h in (list(fleet.prefill_hosts.values())
                             + list(fleet.decode_hosts.values()))},
        "checks": checks}
    del fleet, ref
    _free()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print("[fleet] " + json.dumps(out), flush=True)
        raise AssertionError(f"fleet checks failed: {failed}")
    return out


FLEET_CLI_KEYS = ("arch", "mode", "hosts", "artifact_dir",
                  "cap_gbitflips_per_s", "requests", "served",
                  "realized_gbitflips", "realized_gbitflips_per_s",
                  "cap_violations", "rung_token_histogram",
                  "governor_replans", "wall_s")


def fleet_cli(tmp: str, cap: float) -> dict:
    """10b: ``launch.serve.main`` in fleet mode, in process: the
    reference's summary keys, every request served, no violation; the
    fleet's ``assert_no_recompile`` runs inside."""
    from repro_torch.launch import serve
    _reset_counts()
    t0 = time.perf_counter()
    out = serve.main(["--arch", "llama3-8b", "--layers", str(FLEET_LAYERS),
                      "--fleet_hosts", str(FLEET_HOSTS),
                      "--global_budget", repr(cap), "--ticks",
                      str(FLEET_TICKS), "--backend", "packed",
                      "--artifact_dir", f"{tmp}/fleet_cli"])
    seconds = time.perf_counter() - t0
    _free()
    if tuple(out) != FLEET_CLI_KEYS or out["served"] != out["requests"] \
            or out["cap_violations"] != 0:
        raise AssertionError(f"fleet CLI summary {out}")
    return {**out, "phase_s": seconds, "launches": _counts()}


# ---------------------------------------------------------------------------
# phase 11: the projection autotuner
# ---------------------------------------------------------------------------

TUNE_LAYERS = 2            # 11b's store: full width, 2 layers
TUNE_REQUESTS = 3


def _distinct_projections(view) -> list:
    """(name, leaf) of each distinct (K, N, planes) projection of a view,
    in the engine's walk order."""
    seen, out = set(), []

    def walk(node, name):
        if isinstance(node, dict):
            if "w_q" in node:
                key = (tuple(node["w_q"].shape),
                       node["w_planes_pos"].shape[-3])
                if key not in seen:
                    seen.add(key)
                    out.append((name, node))
                return
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, name)

    walk(view, "")
    return out


def tune_shapes(view) -> list:
    """11a: ``dispatch.tune_projection`` at M = BATCH over every distinct
    projection of a full-width view, on 'fused' (B1) and 'packed' (B2):
    each candidate split bit-identical to the heuristic's (checked inside
    ``autotune.tune``), timed with a cold L2; the heuristic's and the
    winner's ms beside the bound, which counts the view's live planes
    (the kernels read no plane below its plane_shift)."""
    from repro_torch.kernels import autotune, dispatch
    rows = []
    for backend in ("fused", "packed"):
        for name, leaf in _distinct_projections(view):
            k, n = leaf["w_q"].shape
            planes = leaf["w_planes_pos"].shape[-3]
            live = planes - int(round(float(leaf["plane_shift"])))
            k_eff = leaf["w_planes_pos"].shape[-2] * 8 \
                if backend == "packed" else k
            dispatch.tune_projection(BATCH, leaf, backend)
            t = autotune.timings[autotune.cache_key(
                BATCH, k_eff, n, planes, backend,
                autotune.device_kind("cuda"))]
            plane_bytes = 2 * live * (k // 8 if backend == "packed"
                                      else k) * n
            nbytes = 4 * (BATCH * k + 2 * n + 4 + BATCH * n) + plane_bytes
            b_ms, b_by = bound_ms(nbytes, 2 * BATCH * k * n)
            (heur, heur_ms), (best, best_ms) = t["heuristic"], t["best"]
            row = {"kernel": ("pann_matmul_act" if backend == "fused"
                              else "pann_matmul_packed_act"),
                   "backend": backend, "module": name, "M": BATCH, "K": k,
                   "N": n, "planes": planes, "live_planes": live,
                   "heuristic": list(heur), "heuristic_ms": heur_ms,
                   "best": list(best), "best_ms": best_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "candidates": len(t["candidates"]),
                   "candidate_ms": {f"{c.ksplit}x{c.kchunk}": ms
                                    for c, ms in t["candidates"]}}
            rows.append(row)
            print(f"[autotune] {row['kernel']} {name} (M, K, N) = "
                  f"({BATCH}, {k}, {n}): heuristic {tuple(heur)} "
                  f"{heur_ms:.4f} ms, best {tuple(best)} {best_ms:.4f} ms "
                  f"of {row['candidates']} candidates, all bit-identical; "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return rows


def _served_log(engine, reqs) -> list:
    log, restore = _record(engine)
    try:
        responses = engine.generate(reqs)
    finally:
        restore()
    engine.assert_no_recompile()
    return [r.tokens for r in responses], log


def autotune_phase(tmp: str) -> dict:
    """Phase 11: (a) ``tune_shapes`` on the top rung's view (every plane
    live) of a full-width TUNE_LAYERS-layer store, in a cache file of its
    own; (b) the same
    store served through graphs by an engine warmed up on the heuristic
    and by a ``ServeEngine(autotune=True)`` in a fresh cache file: one
    entry per distinct shape, every step's logits bit-identical, device
    ms a step both ways (the profiler over replays)."""
    import os
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import autotune
    from repro_torch.models import serving
    from repro_torch.serve_engine import ServeEngine
    cfg = dataclasses.replace(
        configs.get_config("llama3-8b", quant=QuantConfig(mode="none")),
        num_layers=TUNE_LAYERS)
    _reset_counts()
    t0 = time.perf_counter()
    plain = ServeEngine(cfg, _init_params(cfg, seed=50), ladder_bits=LADDER,
                        max_batch=BATCH, max_len=PROMPT + GEN,
                        backend="packed", cache_bits=CACHE_BITS,
                        device="cuda")
    _free()
    cache_was = os.environ[autotune._ENV_VAR]
    os.environ[autotune._ENV_VAR] = f"{tmp}/autotune_a.json"
    autotune.clear_memory_cache()
    rows = tune_shapes(plain.variants[LADDER[-1]])
    tune_a_s = time.perf_counter() - t0
    # (b): a fresh cache; the untuned engine captures first
    os.environ[autotune._ENV_VAR] = f"{tmp}/autotune_b.json"
    autotune.clear_memory_cache()
    plain.warmup()
    t0 = time.perf_counter()
    tuned = ServeEngine(cfg, weight_store=serving.WeightStore(
                            store=plain.weight_store, views=plain.variants),
                        ladder_bits=LADDER, max_batch=BATCH,
                        max_len=PROMPT + GEN, backend="packed",
                        cache_bits=CACHE_BITS, device="cuda", autotune=True)
    engine_tune_s = time.perf_counter() - t0
    tuned.warmup()
    with open(autotune.cache_path()) as f:
        entries = json.load(f)["params"]
    reqs = _requests(cfg, seed=50, n=TUNE_REQUESTS)
    tok_plain, log_plain = _served_log(plain, reqs)
    tok_tuned, log_tuned = _served_log(tuned, reqs)
    steps = [e for e in log_plain if e[0] == "step"]
    steps_t = [e for e in log_tuned if e[0] == "step"]
    same = len(steps) == len(steps_t) and all(
        a[2] == b[2] and torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
        for a, b in zip(steps, steps_t))
    del log_plain, log_tuned, steps, steps_t
    # late in the process: each window opens with GUARD_KERNELS ops
    steps_by_rung = {b: plain.steps_by_rung[b] for b in LADDER}
    prof = {name: profile_steps(functools.partial(_graph_runner, eng),
                                steps_by_rung, guard_run=guard_ops)
            for name, eng in (("heuristic", plain), ("tuned", tuned))}
    launches = _counts()
    sms = autotune._pm.sm_count(torch.cuda.current_device())
    changed = 0
    for key, entry in entries.items():
        m, k, n = map(int, key.split("|")[2].split("x"))
        heur = autotune.heuristic_params(m, k, n, "packed", sms)
        changed += (entry["ksplit"], entry["kchunk"]) != tuple(heur)
    out = {"config": f"llama3-8b full width, {TUNE_LAYERS} layers, random "
                     "weights seed 50",
           "rows": rows, "tune_a_s": tune_a_s,
           "engine_entries": entries, "engine_tune_s": engine_tune_s,
           "entries_changed_from_heuristic": changed,
           "graphs": {"heuristic": plain.graphs_captured,
                      "tuned": tuned.graphs_captured},
           "steps_bit_identical": same,
           "tokens_equal": tok_plain == tok_tuned,
           "device_ms_per_step": {k: v["device_ms_per_step"]
                                  for k, v in prof.items()},
           "ms_per_step_by_kind": {k: v.get("ms_per_step_by_kind")
                                   for k, v in prof.items()},
           "launches": launches}
    del plain, tuned
    os.environ[autotune._ENV_VAR] = cache_was
    autotune.clear_memory_cache()
    _free()
    if not same or len(entries) != 5 or \
            out["graphs"]["heuristic"] != out["graphs"]["tuned"] or \
            not launches["pann_matmul_act"] or \
            not launches["pann_matmul_packed_act"]:
        raise AssertionError(f"autotune checks failed: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 12: dist/ on torch.distributed
# ---------------------------------------------------------------------------

# 12a: mixtral-8x7b's capacity dispatch in a training step at full width,
# cut to one layer (6.9 GB of fp32 params, as much again in gradients and
# twice in AdamW moments), batch (2, 256); no token dropped at capacity
# factor 4.0 (every expert can take all 512 tokens' top-2 routes)
CAPACITY_LAYERS = 1
CAPACITY_BATCH, CAPACITY_SEQ = 2, 256
CAPACITY_NO_DROP = 4.0
CAPACITY_STEPS = 3
# the bounds tests/test_torch_dist.py states for the capacity path against
# the scan where no token is dropped: the loss, and each gradient's
# largest difference over its largest value
CAPACITY_LOSS_RTOL = 1e-5
CAPACITY_GRAD_RTOL = 1e-4
# 12b: llama3-8b at full width cut to 2 layers, tensor-parallel over two
# ranks that share the card (launch.train under torchrun), against the
# same command on one rank; the reference's own tolerance
# (tests/test_dist_multidev.py:185)
TP_ARGV = ["--arch", "llama3-8b", "--d_model", "4096", "--d_ff", "14336",
           "--layers", "2", "--batch", "2", "--seq", "128", "--steps", "3",
           "--quant", "pann", "--train_quant", "qat", "--log_every", "1",
           "--device", "cuda"]
TP_RTOL = 2e-3
# 12b's collective checks on the two ranks: compressed_psum_mean's codes
# exact, its mean and residual within 1e-6 relative; pipeline_stack over
# a 2-stage "pod" axis within 1e-5 of the sequential fold, its gradient
# within 1e-4 relative
PSUM_RTOL = 1e-6
PIPE_ATOL, PIPE_GRAD_RTOL = 1e-5, 1e-4
# 12c: A11 on the kernels, llama3-8b at full width cut to 2 layers: 8
# tokens decoded at batch 4 through a rung view and its materialized copy
A11_LAYERS, A11_TOKENS = 2, 8


def _lm_batch(vocab: int, b: int, t: int, seed: int) -> tuple:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, vocab, (b, t), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    return tokens, labels


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got - want).abs().max()
                 / torch.clamp(want.abs().max(), min=1e-30))


def moe_capacity_train(seed: int = 40) -> dict:
    """12a: mixtral-8x7b (moe_impl "capacity") at full width cut to
    CAPACITY_LAYERS, one rank on nccl, a 1 x 1 mesh: at capacity factor
    4.0 the loss and every gradient of the capacity dispatch against the
    scan on the same params; at mixtral's own 1.25 the share of routed
    (token, expert) pairs dropped; CAPACITY_STEPS AdamW steps through the
    capacity path, finite losses, ms a step and peak memory."""
    import contextlib
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.dist import moe_ep
    from repro_torch.dist.constrain import use_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as MD
    from repro_torch.optim.optimizers import tree_leaves
    t_start = time.perf_counter()
    started = not dist.is_initialized()
    mesh = make_local_mesh(1, "cuda")
    backend = dist.get_backend()
    routed = []
    plan = moe_ep.dispatch_plan

    def recorded(mask, capacity):     # the dispatch's keep mask, counted
        keep, pos = plan(mask, capacity)
        routed.append((int(mask.sum()), int(keep.sum())))
        return keep, pos

    moe_ep.dispatch_plan = recorded
    try:
        cfg = dataclasses.replace(configs.get_config("mixtral-8x7b"),
                                  num_layers=CAPACITY_LAYERS)
        if cfg.moe_impl != "capacity":
            raise AssertionError(f"mixtral's moe_impl is {cfg.moe_impl}")
        no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY_NO_DROP))
        tcfg = TrainConfig(total_steps=CAPACITY_STEPS, warmup_steps=1,
                           seed=seed)
        torch.cuda.reset_peak_memory_stats()
        state = ST.make_train_state(cfg, tcfg, device="cuda")
        tokens, labels = _lm_batch(cfg.vocab_size, CAPACITY_BATCH,
                                   CAPACITY_SEQ, seed)
        leaves = tree_leaves(state.params)

        def loss_grads(meshed: bool):
            for p in leaves:
                p.requires_grad_(True)
            try:
                ctx = use_mesh(mesh) if meshed else contextlib.nullcontext()
                with ctx:
                    loss = MD.lm_loss(state.params, no_drop, tokens, labels,
                                      remat=False)
                grads = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            return loss.detach(), grads

        t0 = time.perf_counter()
        scan_loss, scan_grads = loss_grads(False)
        if routed:
            raise AssertionError("the scan ran the capacity dispatch")
        cap_loss, cap_grads = loss_grads(True)
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t0
        if len(routed) != CAPACITY_LAYERS or routed[0][0] != routed[0][1]:
            raise AssertionError(f"capacity factor {CAPACITY_NO_DROP} "
                                 f"dropped tokens: {routed}")
        loss_rel = abs(float(cap_loss) - float(scan_loss)) / abs(
            float(scan_loss))
        grad_rel = max(_rel(c, g) for c, g in zip(cap_grads, scan_grads))
        del scan_grads, cap_grads
        _free()
        if loss_rel > CAPACITY_LOSS_RTOL or grad_rel > CAPACITY_GRAD_RTOL:
            raise AssertionError(
                f"capacity vs scan: loss rel {loss_rel:.3g} (bound "
                f"{CAPACITY_LOSS_RTOL}), gradient rel {grad_rel:.3g} (bound "
                f"{CAPACITY_GRAD_RTOL})")
        routed.clear()
        with torch.no_grad(), use_mesh(mesh):
            MD.lm_loss(state.params, cfg, tokens, labels, remat=False)
        dropped = 1.0 - routed[0][1] / routed[0][0]
        routed.clear()
        losses, step_ms = [], []
        par = ParallelConfig(remat="none")
        with use_mesh(mesh):
            for _ in range(CAPACITY_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = ST.train_step(
                    state, {"tokens": tokens, "labels": labels}, cfg=cfg,
                    tcfg=tcfg, par=par)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
        if len(routed) != CAPACITY_STEPS * CAPACITY_LAYERS:
            raise AssertionError(f"the train steps ran {len(routed)} "
                                 "capacity dispatches")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"capacity training losses {losses}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
        _free()
    finally:
        moe_ep.dispatch_plan = plan
        if started:
            dist.destroy_process_group()
    return {"arch": "mixtral-8x7b", "layers": CAPACITY_LAYERS,
            "batch": [CAPACITY_BATCH, CAPACITY_SEQ], "backend": backend,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "no_drop_capacity_factor": CAPACITY_NO_DROP,
            "scan_loss": float(scan_loss), "capacity_loss": float(cap_loss),
            "loss_rel": loss_rel, "grad_rel": grad_rel,
            "parity_s": parity_s,
            "capacity_factor": cfg.moe.capacity_factor,
            "dropped_share": dropped, "losses": losses, "step_ms": step_ms,
            "ms_per_step_after_first": float(np.mean(step_ms[1:])),
            "peak_mem_gb": peak, "wall_s": time.perf_counter() - t_start}


def _torchrun(nproc: int, args: list, timeout: int = 600) -> str:
    """``torch.distributed.run --standalone`` with ``nproc`` ranks on this
    machine; its stdout. A rank's failure raises with the end of its
    output."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc)] + args, env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"torchrun {args[:3]} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    return proc.stdout


def tp_train() -> dict:
    """12b: ``launch.train`` under torchrun on two ranks that share the
    card (``--model_axis 2``: the params and moments DTensors split over
    "model", the host-staged backend) against the same command on one
    rank in process; then ``dist_worker``'s collective checks on two
    ranks."""
    import os
    import tempfile
    from repro_torch.launch import train as TR
    t0 = time.perf_counter()
    out = _torchrun(2, ["-m", "repro_torch.launch.train"] + TP_ARGV
                    + ["--model_axis", "2"])
    tp_s = time.perf_counter() - t0
    summary = ranks = None
    ranks = []
    for line in out.splitlines():
        if line.startswith("[train] {"):
            summary = json.loads(line[len("[train] "):])
        elif line.startswith("[train] rank {"):
            ranks.append(json.loads(line[len("[train] rank "):]))
    if summary is None or len(ranks) != 2:
        raise AssertionError(f"no summary of both ranks:\n{out[-3000:]}")
    t0 = time.perf_counter()
    one = TR.main(TP_ARGV + ["--model_axis", "1"])
    one_s = time.perf_counter() - t0
    _free()
    rel = [abs(a - b) / abs(b) for a, b in zip(summary["losses_exact"],
                                               one["losses_exact"])]
    if len(rel) != 3 or max(rel) > TP_RTOL or \
            not all(np.isfinite(summary["losses_exact"])):
        raise AssertionError(f"2-rank losses {summary['losses_exact']} vs "
                             f"1-rank {one['losses_exact']}: rel {rel}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dist_checks.json")
        t0 = time.perf_counter()
        _torchrun(2, [str(ROOT / "chip_smoke.py"), "--dist-worker", path])
        checks = json.loads(Path(path).read_text())
        checks["wall_s"] = time.perf_counter() - t0
        mesh = [json.loads(Path(f"{path}.mesh.rank{r}").read_text())
                for r in range(2)]
    for name in mesh[0]["cases"]:
        peak = sum(r["cases"][name]["peak_gb"] for r in mesh)
        if peak >= MESH_PEAK_GB:
            raise AssertionError(f"13a {name}: both ranks' peaks {peak:.2f}"
                                 f" GB >= {MESH_PEAK_GB} GB")
    return {"argv": TP_ARGV, "mesh": summary["mesh"],
            "backend": summary["backend"],
            "losses_2_ranks": summary["losses_exact"],
            "losses_1_rank": one["losses_exact"], "loss_rel": rel,
            "ranks": ranks, "segments": summary["segments"],
            "one_rank_ms_per_step_after_first": one["segments"][0][
                "ms_per_step_after_first"],
            "one_rank_peak_mem_gb": one["peak_mem_gb"],
            "tp_wall_s": tp_s, "one_rank_wall_s": one_s, "checks": checks,
            "mesh_serve": mesh}


def dist_worker(out_path: str) -> int:
    """One rank of 12b's collective checks (run by ``tp_train`` under
    torchrun, two ranks on the card): ``compressed_psum_mean``'s wire
    codes against the single-process restatement over both ranks' shards,
    and ``pipeline_stack`` over a 2-stage "pod" axis against the
    sequential fold, forward and gradient. Rank 0 writes the result."""
    import torch.distributed as dist
    from repro_torch.dist import compat
    from repro_torch.dist.collectives import _compress_one
    from repro_torch.dist.pipeline import pipeline_stack
    backend = compat.init_process_group("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = compat.rank_device("cuda")

    def randn(shape, seed, scale=1.0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev) * scale

    def gathered(t):                  # every rank's t, stacked
        flat = t.contiguous().reshape(-1)
        out = torch.empty(world * flat.numel(), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, flat)
        return out.reshape((world,) + tuple(t.shape))

    res = {"backend": backend, "world": world}
    psum = []
    for i, shape in enumerate(((4096,), (256, 1024))):
        g = randn(shape, 50 + 10 * i + rank, 1e-2)
        e = randn(shape, 80 + 10 * i + rank, 1e-5)
        mean, new_err, codes = _compress_one(g, e)
        gs, es = gathered(g), gathered(e)
        vals = gs + es
        wire = torch.tensor(127.0, device=dev)
        scale = torch.clamp(vals.abs().max(), min=1e-30) / wire
        want_codes = torch.clamp(torch.round(vals / scale), -127, 127).to(
            torch.int8)
        deq = want_codes.to(torch.float32) * scale
        want_mean = deq.sum(0) / torch.tensor(float(world), device=dev)
        if not torch.equal(gathered(codes), want_codes):
            raise AssertionError(f"wire codes differ at {shape}")
        psum.append({"shape": list(shape),
                     "mean_rel": _rel(mean, want_mean),
                     "err_rel": _rel(gathered(new_err), vals - deq)})
    if max(max(r["mean_rel"], r["err_rel"]) for r in psum) > PSUM_RTOL:
        raise AssertionError(f"compressed_psum_mean: {psum}")
    res["compressed_psum_mean"] = psum
    mesh = compat.DeviceMesh("cuda", torch.arange(world),
                             mesh_dim_names=("pod",))
    d, n_groups, batch, n_micro = 256, 4, 8, 4
    ws = randn((n_groups, d, d), 60, d ** -0.5).requires_grad_(True)
    x = randn((batch, d), 61).requires_grad_(True)

    def block(stage_ws, h):
        for w in stage_ws:
            h = torch.tanh(h @ w)
        return h

    out = pipeline_stack(block, ws, x, mesh=mesh, axis="pod",
                         n_micro=n_micro)
    gw, gx = torch.autograd.grad((out ** 2).sum(), (ws, x))
    dist.all_reduce(gw)
    dist.all_reduce(gx)
    want = block(ws, x)
    rw, rx = torch.autograd.grad((want ** 2).sum(), (ws, x))
    pipe = {"fwd_abs": float((out - want).abs().max()),
            "grad_ws_rel": _rel(gw, rw), "grad_x_rel": _rel(gx, rx)}
    if pipe["fwd_abs"] > PIPE_ATOL or max(pipe["grad_ws_rel"],
                                          pipe["grad_x_rel"]) > \
            PIPE_GRAD_RTOL:
        raise AssertionError(f"pipeline_stack: {pipe}")
    res["pipeline_stack"] = pipe
    res["staged_collectives"] = compat.staged_collectives()
    if rank == 0:
        Path(out_path).write_text(json.dumps(res))
    dist.barrier()
    # 13a in the same launch: no second torchrun start
    mesh_serve_worker(out_path + ".mesh")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def a11_on_kernels(seed: int = 45) -> dict:
    """12c: llama3-8b at full width cut to A11_LAYERS: a ladder store and,
    from the same params, ``build_variant_cache``'s variant of its top
    rung (plane_shift 0): equal leaf for leaf to ``materialize_view`` of
    the store's top view; the rung view with the most skipped planes and
    its ``materialize_view`` copy decode A11_TOKENS tokens at batch 4 on
    'packed' (B2) and 'fused' (B1), logits bit-identical, launches
    counted."""
    from repro_torch import configs
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import model as MD
    from repro_torch.models import serving
    from repro_torch.serve_engine import build_ladder
    t_start = time.perf_counter()
    cfg = dataclasses.replace(
        configs.get_config("llama3-8b", quant=QuantConfig(mode="none")),
        num_layers=A11_LAYERS)
    ladder = build_ladder(LADDER, d=float(cfg.d_model))
    points = {op.bits: (op.r, op.b_x_tilde) for op in ladder}
    top = max(points, key=lambda b: points[b][0])
    params = _init_params(cfg, seed)
    variant = serving.build_variant_cache(
        params, cfg, {top: points[top]}, pack_planes=True,
        plane_count=serving.LADDER_PLANE_COUNT, cache_bits=CACHE_BITS)[top]
    ws = serving.build_weight_store(
        params, cfg, points,
        serving.ServingQuantSpec(pack_planes=True, cache_bits=CACHE_BITS))
    del params
    mat_top = dict(flatten(serving.materialize_view(ws.views[top])))
    var = dict(flatten(variant))
    if set(mat_top) != set(var):
        raise AssertionError(f"variant / view keys differ: "
                             f"{sorted(set(mat_top) ^ set(var))[:8]}")
    unequal = [k for k in var if var[k].dtype != mat_top[k].dtype
               or not torch.equal(var[k], mat_top[k])]
    if unequal:
        raise AssertionError(f"variant != materialized view at {unequal}")
    del variant, var, mat_top
    shifts = {b: int(v["layers"][0]["attn"]["wq"]["plane_shift"])
              for b, v in ws.views.items()}
    rung = max(shifts, key=shifts.get)
    mat = serving.materialize_view(ws.views[rung])
    rows = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, A11_TOKENS)), device="cuda")
    runs = {}
    for backend in ("packed", "fused"):
        c = dataclasses.replace(cfg, kernel_backend=backend,
                                cache_bits=CACHE_BITS)
        logits = []
        _reset_counts()
        for tree in (ws.views[rung], mat):
            state = MD.init_decode_state(tree, c, BATCH, A11_TOKENS)
            steps = []
            for i in range(A11_TOKENS):
                lg, state = MD.decode_step(tree, c, state, rows[:, i:i + 1])
                steps.append(lg)
            logits.append(torch.cat(steps, 1))
        torch.cuda.synchronize()
        launches = _counts()
        if not torch.equal(logits[0], logits[1]) or \
                not torch.isfinite(logits[0]).all():
            raise AssertionError(f"{backend}: the view and its "
                                 "materialized copy decode differently")
        name = ("pann_matmul_packed_act" if backend == "packed"
                else "pann_matmul_act")
        if not launches[name]:
            raise AssertionError(f"{backend}: no {name} launch")
        runs[backend] = {"launches": launches}
    del mat, ws
    _free()
    return {"layers": A11_LAYERS, "ladder": list(LADDER), "top_rung": top,
            "rung": rung, "plane_shift": shifts[rung], "tokens": A11_TOKENS,
            "batch": BATCH, "variant_leaves_equal": True, "runs": runs,
            "wall_s": time.perf_counter() - t_start}


# ---------------------------------------------------------------------------
# phase 13: serving under a device mesh
# ---------------------------------------------------------------------------

# 13a: llama3-8b at full width cut to MESH_LAYERS on two ranks sharing the
# card (host-staged collectives): each rank quantizes the whole 8-layer
# store (~8.3 GB) from the same seeded params and keeps its shard, beside a
# one-rank engine on the same store in the same run; 8 layers keep both
# ranks' stores and transients well inside 80 GB and the three cases inside
# ~2 minutes of the script's 1,200 s. Then the MoE and recurrent configs,
# shallow to fit the script's time: mixtral-8x7b at its MOE_LAYERS depth
# (each rank builds the whole 2-layer store with its 11.3 GB of fp32
# experts), zamba2-1.2b at one group of 6 layers (five mamba and one
# mamba_attn: its shared block and B3 run), rwkv6-1.6b at its
# RECURRENT_LAYERS depth; then the cross-attending configs, a raw frontend
# a wave: seamless-m4t-medium at full depth (12 encoder and 12 decoder
# layers, 1.6 GB of fp32 params), llama-3.2-vision-90b at one group of 5
# layers (its cross_attn layer and 4 self-attention layers: C12 forbids a
# shorter cut; 26 GB of fp32 params and an 18 GB store a rank, so the
# ranks build their stores one after the other, MESH_SERIAL_BUILD)
MESH_LAYERS = 8
MESH_SEED = 50
# arch -> (layers, seed)
MESH_ARCHS = {"llama3-8b": (MESH_LAYERS, MESH_SEED),
              "mixtral-8x7b": (MOE_LAYERS["mixtral-8x7b"], 52),
              "zamba2-1.2b": (6, 53),
              "rwkv6-1.6b": (RECURRENT_LAYERS["rwkv6-1.6b"], 54),
              "seamless-m4t-medium": (12, 55),
              "llama-3.2-vision-90b": (5, 56)}
MESH_SERIAL_BUILD = ("llama-3.2-vision-90b",)
# (arch, name, (data, model), backend, requests): a request a rung (waves
# of prompt + gen steps). Cut for the script's time: the MoE, recurrent
# and cross-attending configs serve one request a case (the whole script
# took 1,105 s with them at two; NVIDIA H100 80GB HBM3, 700.00 W)
MESH_CASES = (("llama3-8b", "model2_packed", (1, 2), "packed", 3),
              ("llama3-8b", "model2_fused", (1, 2), "fused", 2),
              ("llama3-8b", "data2_packed", (2, 1), "packed", 3),
              ("mixtral-8x7b", "model2_packed", (1, 2), "packed", 1),
              ("mixtral-8x7b", "data2_packed", (2, 1), "packed", 1),
              ("zamba2-1.2b", "model2_packed", (1, 2), "packed", 1),
              ("rwkv6-1.6b", "model2_fused", (1, 2), "fused", 1),
              ("rwkv6-1.6b", "data2_packed", (2, 1), "packed", 1),
              ("seamless-m4t-medium", "model2_packed", (1, 2), "packed", 1),
              ("seamless-m4t-medium", "data2_packed", (2, 1), "packed", 1),
              ("llama-3.2-vision-90b", "model2_packed", (1, 2), "packed",
               1))
# both ranks' peaks together, a case
MESH_PEAK_GB = 70.0
# 13d: EncodeEngine on each cross-attending config of MESH_ARCHS (the
# frontend's params of its 13a params: the conv stem, and seamless's
# encoder), ENCODE_MESH_ITEMS raw items on each of these meshes against a
# one-rank engine on the same store
ENCODE_MESHES = ((1, 2), (2, 1))
ENCODE_MESH_ITEMS = 4
# 13e: where the port runs each fp32 op of ``rank_shape_ops`` on a mesh
# rank: "the rank's" own shape (its heads or rows alone: ``main`` fails if
# the op differs there from one rank's), "one rank's" (its heads and rows
# among zeros, ``ServeShards.place`` / ``take``), or "the batch's rows"
# (``ServeShards.at_batch_shape``, a data rank's rows and zeros)
RANK_SHAPE = {"encoder attention": "the rank's", "rope": "the rank's",
              "cross attention": "one rank's",
              "layernorm": "the batch's rows",
              "tanh(xgate) * h": "the rank's"}
# 13b: the accumulator mode's local shapes on the (1, 2) mesh, (K, N, the
# modules, launches of the shape a llama3-8b decode step on each rank), and
# the column shards' (K, N) the ordinary B1/B2 launch there. The shapes
# only the other 13a configs launch (mixtral's wo is llama3-8b's) are held
# and timed too, outside the llama3-8b step's sum
ACC_M = (BATCH, 512)
# (K, N, modules, launches a llama3-8b (1, 2) step, row counts checked; the
# first timed)
ACC_SHAPES = ((2048, 4096, "wo (llama3-8b, mixtral)", MESH_LAYERS, ACC_M),
              (7168, 4096, "w_down (llama3-8b)", MESH_LAYERS, ACC_M),
              (1024, 2048, "wo (zamba2 shared block, rwkv6)", 0, ACC_M),
              (2048, 2048, "out_proj (zamba2)", 0, ACC_M),
              (4096, 2048, "w_down (zamba2 shared block)", 0, ACC_M),
              # seamless in decode and in its encoder (4 items x 1,024
              # positions), vision
              (512, 1024, "wo, cross wo (seamless)", 0, (BATCH, 4096)),
              (2048, 1024, "w_down (seamless)", 0, (BATCH, 4096)),
              (4096, 8192, "wo, cross wo (vision)", 0, (BATCH,)),
              (14336, 8192, "w_down (vision)", 0, (BATCH,)))
# (K, N, modules, row counts) of the ordinary B1/B2 launches on a rank:
# the column shards on (1, 2) (a head's padded vocab over 2 ranks:
# seamless's 256,256 columns, vision's 128,256), and the conv stems, whole
# on every rank, at a (2, 1) data rank's rows (2 of 4 items; on (1, 2) a
# rank runs phase 3's ENCODE_SHAPES); each timed at its first row count
COLUMN_SHARDS = ((4096, 2048, "wq", ACC_M), (4096, 512, "wk,wv", ACC_M),
                 (4096, 7168, "w_gate,w_up", ACC_M),
                 (4096, 64128, "lm_head", ACC_M),
                 (1024, 512, "wq,wk,wv (seamless)", ACC_M),
                 (1024, 2048, "w_up (seamless)", ACC_M),
                 (1024, 128128, "lm_head (seamless)", (BATCH,)),
                 (8192, 4096, "wq (vision)", (BATCH,)),
                 (8192, 512, "wk,wv (vision)", (BATCH,)),
                 (8192, 14336, "w_gate,w_up (vision)", (BATCH,)),
                 (8192, 64128, "lm_head (vision)", (BATCH,)),
                 (240, 1024, "conv.s0 (seamless)", (4096,)),
                 (3072, 1024, "conv.s1 (seamless)", (2048,)),
                 (588, 8192, "conv (vision)", (3200,)))
# B3 at a (1, 2) rank's heads: (config, B, KH, G, hd, softcap)
MESH_ATT_SHAPES = (("seamless-m4t-medium", BATCH, 8, 1, 64, 0.0),
                   ("llama-3.2-vision-90b", BATCH, 4, 8, 128, 0.0))
# 13c: the dry run's cells, each a subprocess that sees no card: decode at
# full size (seconds on meta tensors), train_4k cut to --reduced (the full
# 32-layer DTensor step takes about a minute of CPU, past the phase's
# share of the script's time); (arch, cell, flags)
DRYRUN_CELLS = (("llama3-8b", "decode_32k", ()),
                ("llama3-8b", "train_4k", ("--reduced",)),
                ("seamless-m4t-medium", "decode_32k", ()))


def _mesh_cfg(arch: str):
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig
    return dataclasses.replace(
        configs.get_config(arch, quant=QuantConfig(mode="none")),
        num_layers=MESH_ARCHS[arch][0])


def _mesh_engine(cfg, ws, backend: str, mesh=None):
    """13a's engine; a cross-attending config's takes a new raw input a
    wave (``Frontend`` from the config's seed: every engine of a case,
    one-rank or a mesh rank, draws the same inputs in the same order)."""
    from repro_torch.serve_engine import ServeEngine
    frontend = (Frontend(cfg, MESH_ARCHS[_arch_of(cfg)][1])
                if cfg.family in ("encdec", "vlm") else None)
    return ServeEngine(cfg, weight_store=ws, ladder_bits=LADDER,
                       max_batch=BATCH, max_len=PROMPT + GEN,
                       backend=backend,
                       cache_bits=None if cfg.is_attention_free
                       else CACHE_BITS, mesh=mesh,
                       frontend_kwargs_fn=frontend)


def _arch_of(cfg) -> str:
    return next(a for a in MESH_ARCHS if cfg.name.startswith(a))


def _mesh_serve(engine, n_requests: int, seed: int) -> dict:
    """Serve ``n_requests`` of 13a's requests on ``engine`` (every step's
    logits recorded, copied to the host), timed; the launch counters from
    0 across the serve."""
    from repro_torch.dist import compat
    steps = []
    run = engine._run_step

    def recorded(bits, slot):
        logits = run(bits, slot)
        steps.append(logits.detach().cpu())
        return logits

    engine._run_step = recorded
    engine.warmup()
    torch.cuda.synchronize()
    staged0 = compat.staged_collectives()
    _reset_counts()
    t0 = time.perf_counter()
    out = engine.generate(_requests(engine.cfg, seed, n_requests))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    staged = {k: v - staged0.get(k, 0)
              for k, v in compat.staged_collectives().items()}
    n = len(steps)
    gen = sum(len(r.tokens) for r in out)
    return {"tokens": [r.tokens for r in out], "logits": torch.stack(steps),
            "steps": n, "ms_per_step": 1e3 * wall / n,
            "tok_per_s": gen / wall, "launches": counts,
            "staged_per_step": {k: v / n for k, v in staged.items()},
            "describe": {k: engine.describe()[k]
                         for k in ("mesh", "graphed", "steps")}}


def _mesh_arch(arch: str, rank: int) -> dict:
    """13a's cases of ``arch`` on this rank: the whole store built from
    the same seeded params; rank 0 serves it on a one-rank engine per
    backend (graph replays), then each case on its mesh (eager steps),
    its tokens and every step's logits held bit for bit to the one-rank
    engine's."""
    import torch.distributed as dist
    from repro_torch.dist.compat import DeviceMesh
    from repro_torch.models import serving
    from repro_torch.serve_engine import build_ladder
    cfg = _mesh_cfg(arch)
    seed = MESH_ARCHS[arch][1]
    cases = [c[1:] for c in MESH_CASES if c[0] == arch]
    ladder = build_ladder(LADDER, d=float(cfg.d_model))
    points = {op.bits: (op.r, op.b_x_tilde) for op in ladder}
    serial = arch in MESH_SERIAL_BUILD
    frontend_params = None
    build_s = 0.0
    for turn in range(2 if serial else 1):
        if serial and turn != rank:     # the other rank builds: wait
            dist.barrier()
            continue
        t0 = time.perf_counter()
        params = _init_params(cfg, seed)
        if cfg.family in ("encdec", "vlm"):     # 13d's, before the pops
            frontend_params = {k: _clone(params[k]) for k in (
                "conv_stem", "encoder", "enc_norm") if k in params}
        ws = serving.build_weight_store(
            params, cfg, points,
            serving.ServingQuantSpec(
                pack_planes=True,
                cache_bits=None if cfg.is_attention_free else CACHE_BITS))
        del params
        _free()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if serial:      # the fp32 params freed before the other's turn
            dist.barrier()
    whole = serving.store_bytes(ws.store, *ws.views.values())
    one = {}
    if rank == 0:
        for backend, n in sorted({(c[2], c[3]) for c in cases}):
            engine = _mesh_engine(cfg, ws, backend)
            one[backend, n] = _mesh_serve(engine, n, seed)
            del engine
            _free()
    dist.barrier()
    res = {"build_s": build_s, "store_gb_one_rank": whole / 1e9,
           "layers": cfg.num_layers, "cases": {}}
    for name, (d, m), backend, n in cases:
        mesh = DeviceMesh("cuda", torch.arange(2).reshape(d, m),
                          mesh_dim_names=("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = _mesh_engine(cfg, ws, backend, mesh)
        place_s = time.perf_counter() - t0
        nbytes = serving.store_bytes(engine.weight_store,
                                     *engine.variants.values())
        got = _mesh_serve(engine, n, seed)
        del engine
        _free()
        case = {"arch": arch, "mesh": {"data": d, "model": m},
                "backend": backend, "requests": n, "place_s": place_s,
                "store_gb": nbytes / 1e9, "store_share": nbytes / whole,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                **{k: got[k] for k in ("steps", "ms_per_step", "tok_per_s",
                                       "launches", "staged_per_step",
                                       "describe")}}
        if rank == 0:
            ref = one[backend, n]
            if not torch.isfinite(got["logits"]).all():
                raise AssertionError(f"13a {arch} {name}: non-finite "
                                     "logits")
            if got["tokens"] != ref["tokens"] or \
                    not torch.equal(got["logits"], ref["logits"]):
                diff = (got["logits"] - ref["logits"]).abs().max().item() \
                    if got["logits"].shape == ref["logits"].shape else None
                raise AssertionError(f"13a {arch} {name}: the mesh's tokens"
                                     f" or logits differ from one rank's "
                                     f"(max |diff| {diff})")
            else:
                case["bit_identical_steps"] = got["steps"]
            case["one_rank"] = {k: ref[k] for k in (
                "steps", "ms_per_step", "tok_per_s", "describe")}
        if m > 1 and case["store_share"] > 1 / m + 0.02:
            raise AssertionError(f"13a {arch} {name}: a rank holds "
                                 f"{case['store_share']:.4f} of the store")
        launched = got["launches"]
        want = ["pann_matmul_packed_act" if backend == "packed"
                else "pann_matmul_act"]
        if m > 1:
            want += [want[0] + "_acc", "pann_epilogue"]
        if not cfg.is_attention_free:
            want.append("decode_attention")
        missing = [k for k in want if not launched[k]]
        if missing:
            raise AssertionError(f"13a {arch} {name}: no launch of "
                                 f"{missing}: {launched}")
        res["cases"][f"{arch} {name}"] = case
    del ws
    _free()
    if frontend_params is not None:
        t0 = time.perf_counter()
        res["encode"] = _mesh_encode(cfg, frontend_params, rank)
        res["encode"]["wall_s"] = time.perf_counter() - t0
    return res


def _clone(tree):
    """A device copy of a params subtree (the store build pops each weight
    out of the tree it is handed) or of a decode state (NamedTuples)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree if tree is None else tree.clone()


def _mesh_encode(cfg, frontend_params: dict, rank: int) -> dict:
    """13d: ``EncodeEngine`` of a cross-attending config on each of
    ENCODE_MESHES against a one-rank engine on the same store (built from
    the frontend's params, its encode ladder's rungs): ENCODE_MESH_ITEMS
    raw items, their budgets cycling over the ladder, every rank's
    encoded items (the whole waves) bit for bit the one-rank engine's;
    items/s, each rank's store bytes and peak, the launches."""
    from repro_torch.data.pipeline import frontend_raw_stub
    from repro_torch.dist.compat import DeviceMesh
    from repro_torch.models import serving
    from repro_torch.serve_engine import EncodeEngine, EncodeRequest
    items = frontend_raw_stub(cfg, ENCODE_MESH_ITEMS, 0,
                              MESH_ARCHS[_arch_of(cfg)][1])
    reqs = [EncodeRequest(uid=i, item=items[i],
                          power_budget_bits=LADDER[i % len(LADDER)])
            for i in range(ENCODE_MESH_ITEMS)]
    kw = dict(ladder_bits=LADDER, max_batch=BATCH, backend="packed",
              device="cuda")

    def run(engine) -> dict:
        engine.warmup()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = engine.encode(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engine.assert_no_recompile()
        return {"encoded": [torch.as_tensor(r.encoded) for r in out],
                "rungs": [r.rung_bits for r in out],
                "items_per_s": len(out) / wall, "launches": _counts()}

    one = EncodeEngine(cfg, params=frontend_params, **kw)
    whole = serving.store_bytes(one.weight_store, *one.variants.values())
    want = run(one)
    ws = serving.WeightStore(store=one.weight_store, views=one.variants)
    res = {"items": ENCODE_MESH_ITEMS, "store_gb_one_rank": whole / 1e9,
           "one_rank": {k: want[k] for k in ("items_per_s", "launches")},
           "meshes": {}}
    for d, m in ENCODE_MESHES:
        mesh = DeviceMesh("cuda", torch.arange(2).reshape(d, m),
                          mesh_dim_names=("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        engine = EncodeEngine(cfg, weight_store=ws, mesh=mesh, **kw)
        nbytes = serving.store_bytes(engine.weight_store,
                                     *engine.variants.values())
        got = run(engine)
        del engine
        name = f"{_arch_of(cfg)} encode {d}x{m}"
        if got["rungs"] != want["rungs"] or any(
                not torch.equal(a, b) for a, b in zip(got["encoded"],
                                                      want["encoded"])):
            diff = max((a - b).abs().max().item() for a, b in zip(
                got["encoded"], want["encoded"]))
            raise AssertionError(f"13d {name} rank {rank}: the encoded "
                                 f"items differ from one rank's (max "
                                 f"|diff| {diff})")
        if not got["launches"]["pann_matmul_packed_act"]:
            raise AssertionError(f"13d {name}: no launch of "
                                 f"pann_matmul_packed_act: "
                                 f"{got['launches']}")
        res["meshes"][f"{d}x{m}"] = {
            "bit_identical_items": len(got["encoded"]),
            "items_per_s": got["items_per_s"], "launches": got["launches"],
            "store_gb": nbytes / 1e9, "store_share": nbytes / whole,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del one, ws
    _free()
    return res


def mesh_serve_worker(out_path: str) -> None:
    """13a and 13d, one rank of two sharing the card (run by
    ``dist_worker``): for each config of MESH_ARCHS, its cases of
    MESH_CASES (``_mesh_arch``) and a cross-attending config's encode
    meshes (``_mesh_encode``), the store bytes, host ms a step, tok/s,
    items/s, staged collectives a step and the peak of each rank written
    to ``out_path`` (a file a rank)."""
    import torch.distributed as dist
    rank = dist.get_rank()
    res = {"rank": rank, "archs": {}, "cases": {}}
    for arch in MESH_ARCHS:
        t0 = time.perf_counter()
        got = _mesh_arch(arch, rank)
        res["cases"].update(got.pop("cases"))
        res["archs"][arch] = {**got, "wall_s": time.perf_counter() - t0}
        print(f"[mesh] rank {rank} {arch}: {res['archs'][arch]['wall_s']:.1f}"
              " s", flush=True)
    Path(f"{out_path}.rank{rank}").write_text(json.dumps(res))


def acc_mode_kernels(seed: int = 51) -> dict:
    """13b: B1 and B2 in the accumulator mode and the epilogue entry at
    13a's row-parallel local shapes (M = BATCH and 512), each bit for bit
    against its plain version, the shards' sums (the all-reduce) and the
    epilogue against the whole projection's B1/B2; the ordinary B1/B2 at
    the column shards' shapes. Timed at M = BATCH beside their bound, the
    plain version and a library call (``torch._int_mm`` on the codes for
    the sums; none computes the epilogue in one call)."""
    import torch.nn.functional as F
    from repro_torch.kernels import pann_matmul as pm
    from repro_torch.kernels import pann_matmul_packed as pk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    err: dict = {}
    rows = {"pann_matmul_act_acc": [], "pann_matmul_packed_act_acc": [],
            "pann_epilogue": []}
    cases = 0
    seconds: dict = {}      # of each shape's checks and timings
    for k, n, module, per_step, acc_m in ACC_SHAPES:
        t0 = time.perf_counter()
        for m in acc_m:
            # the whole K of two shards: each shard's sums, added, then the
            # epilogue, against the whole projection
            x, pos, neg, ppk, npk, s, z, n127, gamma, zcol = \
                _matmul_operands(gen, m, 2 * k, n)
            for shift in (0, 5):
                qp = torch.stack([s, z, n127, torch.full(
                    (), float(shift), device="cuda")])
                for name, acc_fn, plain_fn, whole_fn, planes in (
                        ("pann_matmul_act_acc", pm.pann_matmul_act_acc,
                         pm.pann_matmul_act_acc_plain,
                         lambda: pm.pann_matmul_act(x, pos, neg, qp, gamma,
                                                    zcol),
                         lambda r: (pos[:, r * k:(r + 1) * k].contiguous(),
                                    neg[:, r * k:(r + 1) * k].contiguous())),
                        ("pann_matmul_packed_act_acc",
                         pk.pann_matmul_packed_act_acc,
                         pk.pann_matmul_packed_act_acc_plain,
                         lambda: pk.pann_matmul_packed_act(x, ppk, npk, qp,
                                                           gamma, zcol),
                         lambda r: (ppk[:, r * k // 8:(r + 1) * k // 8]
                                    .contiguous(),
                                    npk[:, r * k // 8:(r + 1) * k // 8]
                                    .contiguous()))):
                    total = None
                    for r in range(2):
                        xs = x[:, r * k:(r + 1) * k].contiguous()
                        ps, ns = planes(r)
                        sums = acc_fn(xs, ps, ns, qp)
                        _agree(name, sums, plain_fn(xs, ps, ns, qp), err)
                        total = sums if total is None else total + sums
                    y = pm.pann_epilogue(total, qp, gamma, zcol)
                    _agree("pann_epilogue", y, pm.pann_epilogue_plain(
                        total, qp, gamma, zcol), err)
                    _agree(name + " (shards + epilogue)", y, whole_fn(), err)
                    cases += 1
            if m != BATCH:
                del x, pos, neg, ppk, npk
                continue
            # timed on one shard, every plane live
            qp = torch.stack([s, z, n127, torch.zeros((), device="cuda")])
            xs = x[:, :k].contiguous()
            shard = {"pann_matmul_act_acc": (pos[:, :k].contiguous(),
                                             neg[:, :k].contiguous()),
                     "pann_matmul_packed_act_acc": (
                         ppk[:, :k // 8].contiguous(),
                         npk[:, :k // 8].contiguous())}
            xq = quant_codes(xs, qp)
            w_q = pm.rebuild_weight(*shard["pann_matmul_act_acc"]).to(
                torch.int8)
            lib = int_mm_padded_ms(xq, w_q)
            del w_q
            for name, fn, plain, plane_bytes in (
                    ("pann_matmul_act_acc",
                     lambda: pm.pann_matmul_act_acc(
                         xs, *shard["pann_matmul_act_acc"], qp),
                     lambda: pm.pann_matmul_act_acc_plain(
                         xs, *shard["pann_matmul_act_acc"], qp),
                     2 * 7 * k * n),
                    ("pann_matmul_packed_act_acc",
                     lambda: pk.pann_matmul_packed_act_acc(
                         xs, *shard["pann_matmul_packed_act_acc"], qp),
                     lambda: pk.pann_matmul_packed_act_acc_plain(
                         xs, *shard["pann_matmul_packed_act_acc"], qp),
                     2 * 7 * (k // 8) * n)):
                nbytes = 4 * (m * k + 4 + m * n) + plane_bytes
                b_ms, b_by = bound_ms(nbytes, 2 * m * k * n)
                ms = time_ms(fn, 20)
                rows[name].append({
                    "K": k, "N": n, "M": m, "modules": module,
                    "per_step": per_step, "ms": ms,
                    "plain_ms": time_ms(plain, 3), "library_ms": lib,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "share_of_bound": b_ms / ms})
            sums = pk.pann_matmul_packed_act_acc(
                xs, *shard["pann_matmul_packed_act_acc"], qp)
            ep_bytes = 4 * (2 * m * n + 2 * n + 4)
            b_ms, b_by = bound_ms(ep_bytes, 2 * m * n)
            ms = time_ms(lambda: pm.pann_epilogue(sums, qp, gamma, zcol), 20)
            rows["pann_epilogue"].append({
                "K": k, "N": n, "M": m, "modules": module,
                "per_step": per_step, "ms": ms,
                "plain_ms": time_ms(lambda: pm.pann_epilogue_plain(
                    sums, qp, gamma, zcol), 3),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "share_of_bound": b_ms / ms})
            for name in rows:
                r = rows[name][-1]
                print(f"[acc] {name} K={k} N={n} M={m} ({module}): "
                      f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
                      f"library {r['library_ms']}", flush=True)
            del x, pos, neg, ppk, npk, xs, shard, sums
        torch.cuda.empty_cache()
        seconds[f"acc {k}x{n}"] = time.perf_counter() - t0
    rows["pann_matmul_packed_act"] = []
    for k, n, module, col_m in COLUMN_SHARDS:
        t0 = time.perf_counter()
        for m in col_m:
            x, pos, neg, ppk, npk, s, z, n127, gamma, zcol = \
                _matmul_operands(gen, m, k, n)
            xk = F.pad(x, (0, ppk.shape[1] * 8 - k))
            for shift in (0, 5):
                qp = torch.stack([s, z, n127, torch.full(
                    (), float(shift), device="cuda")])
                _agree("pann_matmul_act (column shard)",
                       pm.pann_matmul_act(x, pos, neg, qp, gamma, zcol),
                       pm.pann_matmul_act_plain(x, pos, neg, qp, gamma,
                                                zcol), err)
                _agree("pann_matmul_packed_act (column shard)",
                       pk.pann_matmul_packed_act(xk, ppk, npk, qp, gamma,
                                                 zcol),
                       pk.pann_matmul_packed_act_plain(xk, ppk, npk, qp,
                                                       gamma, zcol), err)
                cases += 1
            if m == col_m[0]:      # timed, every plane live
                qp[3] = 0.0
                w_q = pm.rebuild_weight(pos, neg, qp[3]).to(torch.int8)
                lib = _int_mm_ms(quant_codes(x, qp), w_q)
                del w_q
                nbytes = 4 * (m * k + 2 * n + 4 + m * n) \
                    + 2 * 7 * ppk.shape[1] * n
                b_ms, b_by = bound_ms(nbytes, 2 * m * k * n)
                ms = time_ms(lambda: pk.pann_matmul_packed_act(
                    xk, ppk, npk, qp, gamma, zcol), 20)
                r = {"K": k, "N": n, "M": m,
                     "modules": module, "per_step": 0, "ms": ms,
                     "plain_ms": time_ms(
                         lambda: pk.pann_matmul_packed_act_plain(
                             xk, ppk, npk, qp, gamma, zcol), 3),
                     "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                     "share_of_bound": b_ms / ms}
                rows["pann_matmul_packed_act"].append(r)
                print(f"[acc] pann_matmul_packed_act K={k} N={n} M={m} "
                      f"({module}): {ms:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}), plain {r['plain_ms']:.4f} ms, library "
                      f"{lib:.4f} ms", flush=True)
            del x, xk, pos, neg, ppk, npk
        torch.cuda.empty_cache()
        seconds[f"column {k}x{n}"] = time.perf_counter() - t0
    # B3 at a (1, 2) rank's heads of the cross-attending configs
    att = []
    for arch, *shape in MESH_ATT_SHAPES:
        t0 = time.perf_counter()
        for r in _attention_rows(gen, arch, *shape):
            r["config"] = f"{arch}, a (1, 2) rank's heads"
            att.append(r)
            err["decode_attention"] = max(err.get("decode_attention", 0.0),
                                          r["max_abs_err"])
            print("[acc] decode_attention " + json.dumps(r), flush=True)
        seconds[f"attention {arch}"] = time.perf_counter() - t0
    return {"rows": rows, "attention": att, "max_abs_err": err,
            "cases": cases, "seconds": seconds,
            "shapes": [list(a[:3]) + [list(a[4])] for a in ACC_SHAPES],
            "column_shards": [list(a[:3]) + [list(a[3])]
                              for a in COLUMN_SHARDS]}


def _int_mm_ms(xq, w_q) -> float:
    """``torch._int_mm`` on the codes: ``int_mm_padded_ms`` at 16 rows or
    fewer; above, K zero-padded to its multiple of 8 (the pad made before
    the timing), held equal to the integers."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    if xq.shape[0] <= 16:
        return int_mm_padded_ms(xq, w_q)
    pad = -xq.shape[1] % 8
    xp, wp = F.pad(xq, (0, pad)), F.pad(w_q, (0, 0, 0, pad))
    if not torch.equal(torch._int_mm(xp, wp), ref.int_matmul(xq, w_q)):
        raise AssertionError("torch._int_mm differs from the integers")
    return time_ms(lambda: torch._int_mm(xp, wp), 10)


def quant_codes(x, qp):
    """The int8 activation codes the prologue kernels encode from x."""
    from repro_torch.core import quant
    return quant.affine_encode(x, qp[0], qp[1], qp[2]).to(torch.int8)


def dryrun_cells(tmp: str) -> dict:
    """13c: ``python -m repro_torch.launch.dryrun --arch <arch> --shape
    <cell> --mesh single [--reduced]`` for each of DRYRUN_CELLS, a
    subprocess that sees no card (``CUDA_VISIBLE_DEVICES`` empty), all at
    once: the fake 256-rank group on the card machine's torch. Each
    cell's record and seconds, by "<arch> <cell>"."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out = {}
    t0 = time.perf_counter()
    procs = {(arch, cell): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--shape", cell, "--mesh", "single", "--out",
         os.path.join(tmp, arch, cell), *extra], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, cell, extra in DRYRUN_CELLS}
    try:
        for arch, cell, extra in DRYRUN_CELLS:
            proc = procs[arch, cell]
            stdout, stderr = proc.communicate(timeout=300)
            wall = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(
                    f"dry run {arch} {cell} exited {proc.returncode}:\n"
                    f"{stdout[-3000:]}\n{stderr[-3000:]}")
            tag = "single" + ("_reduced" if extra else "")
            rec = json.loads(Path(tmp, arch, cell, f"dryrun_{tag}.json")
                             .read_text())
            (record,) = rec["records"]
            out[f"{arch} {cell}"] = {"wall_s": wall, "argv": list(extra),
                                     "record": record}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def rank_shape_ops(seed: int = 57) -> dict:
    """13e: the fp32 ops a rank of a serving mesh runs on its own heads or
    rows in the cross-attending configs, each at the rank's shape against
    the same heads and rows of one rank's shape on the card (bit for bit
    or not, and the max |diff|): the encoder's ``_chunked_attention`` at 8
    of seamless's 16 heads and 2 of 4 rows, ``_cross_core`` (the decode
    cross-attention's einsums and softmax) at 4 of vision's 8 KV groups and
    8 of seamless's 16 heads, ``layernorm`` at 2 x 1,024 of 4 x 1,024 rows,
    RoPE at 8 of 16 heads, and the gate ``tanh(xgate) * h`` at 2 of 4
    rows. The port runs an op at the rank's own shape only where this
    holds bit for bit (``RANK_SHAPE``); ``main`` fails otherwise."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {}

    def held(op, what, whole, part, idx):
        want = whole[idx]
        out[f"{op}, {what}"] = {
                     "op": op, "port_runs_it_at": RANK_SHAPE[op],
                     "bit_identical": bool(torch.equal(want, part)),
                     "max_abs_diff": float((want - part).abs().max()),
                     "shape": list(whole.shape), "part": list(part.shape)}

    def cut(t, rows=None, dim=None, n=None):
        idx = [slice(None)] * t.ndim
        if rows is not None:
            idx[0] = slice(0, rows)
        if dim is not None:
            idx[dim] = slice(0, n)
        return tuple(idx), t[tuple(idx)].contiguous()

    # seamless's encoder: (B, T, H, hd) = (4, 1024, 16, 64), bidirectional
    q, k, v = randn(4, 1024, 16, 64), randn(4, 1024, 16, 64), \
        randn(4, 1024, 16, 64)
    kw = dict(causal=False, window=None, softcap_val=0.0)
    whole = A._attention_core(q, k, v, **kw)
    for what, rows, heads in (("8 of 16 heads", None, 8),
                              ("2 of 4 rows", 2, None)):
        idx, qs = cut(q, rows, 2 if heads else None, heads)
        part = A._attention_core(qs, k[idx].contiguous(),
                                 v[idx].contiguous(), **kw)
        held("encoder attention", what, whole, part, idx + (slice(None),))
    pos = torch.arange(1024, device="cuda")
    whole = A.apply_rope(q, pos, 10000.0)
    idx, qs = cut(q, None, 2, 8)
    held("rope", "8 of 16 heads", whole, A.apply_rope(qs, pos, 10000.0),
         idx)
    del q, k, v, whole
    # decode cross-attention: vision (4, 1, 64, 128) over (4, 1600, 8, 128),
    # seamless (4, 1, 16, 64) over (4, 1024, 16, 64)
    for arch, (h, kh, hd, s) in (("vision", (64, 8, 128, 1600)),
                                 ("seamless", (16, 16, 64, 1024))):
        q, k, v = randn(4, 1, h, hd), randn(4, s, kh, hd), randn(4, s, kh, hd)
        whole = A._cross_core(q, k, v)
        for what, rows, qh, kvh in ((f"{kh // 2} of {kh} KV heads", None,
                                     h // 2, kh // 2),
                                    ("2 of 4 rows", 2, None, None)):
            idx, qs = cut(q, rows, 2 if qh else None, qh)
            kidx, ks = cut(k, rows, 2 if kvh else None, kvh)
            held("cross attention", f"{arch}, {what}", whole,
                 A._cross_core(qs, ks, v[kidx].contiguous()), idx)
    x = randn(4, 1024, 1024)
    scale, bias = randn(1024), randn(1024)
    idx, xs = cut(x, 2)
    held("layernorm", "2 x 1024 of 4 x 1024 rows",
         L.layernorm(x, scale, bias), L.layernorm(xs, scale, bias), idx)
    gate, h = randn(), randn(4, 1, 8192)
    idx, hs = cut(h, 2)
    held("tanh(xgate) * h", "2 of 4 rows", torch.tanh(gate) * h,
         torch.tanh(gate) * hs, idx)
    return out


def _kernel_entry(name, source, replaces, rows, launches, count_key,
                  max_abs_err, times_are):
    """One kernel of the ``kernels`` line: its times summed over the
    launches of one step (phases 3-5) or one pass (phase 6) at the rows'
    shapes, each row weighted by its launch count ``count_key``."""
    def total(key):
        return float(sum(r[key] * r[count_key] for r in rows))
    by = {r["bound_by"] for r in rows}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": float(max_abs_err),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": (None if any(r["library_ms"] is None for r in rows)
                           else total("library_ms")),
            "parity": "bit-identical to the plain version",
            "tolerance": "bit-identical (0)",
            "times_are": times_are, "shapes": rows}


def _assert_fp32_matmuls() -> None:
    """fp32 matmuls (the MoE experts and router, the reference's fp32) stay
    IEEE fp32: TF32 off and the matmul precision "highest", PyTorch's
    defaults, which nothing in the port may change."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError(
            "TF32 enabled: allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}, precision "
            f"{torch.get_float32_matmul_precision()!r}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 1
    import os
    import tempfile
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels import pann_attention as pa
    start = time.perf_counter()
    phase_s: dict = {}
    # the autotuner's cache file lives in a temporary directory: no launch
    # reads a tuned split before phase 11, and nothing is written outside
    cache_dir = tempfile.TemporaryDirectory()
    os.environ[autotune._ENV_VAR] = f"{cache_dir.name}/autotune_torch.json"

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def mark(phase: str) -> None:
        """Seconds since the start at the end of ``phase``, printed and
        written to chiprun_out/chip_smoke_times.json (kept when a later
        phase fails)."""
        phase_s[phase] = time.perf_counter() - start
        print(f"[time] {phase} done at {phase_s[phase]:.1f} s", flush=True)
        (out_dir / "chip_smoke_times.json").write_text(json.dumps(phase_s))

    # phase 1: device
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"])
    driver = sh(["nvidia-smi", "--query-gpu=driver_version",
                 "--format=csv,noheader"])
    nvcc = sh([build.nvcc_path(), "--version"]).splitlines()[-1]
    print(smi, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc '{nvcc}' driver {driver} "
          f"python {sys.version.split()[0]}", flush=True)
    _assert_fp32_matmuls()

    # phase 2: build
    build.build_all()
    print(f"[build] {len(build.SOURCES)} kernels built in "
          f"{build.build_seconds:.2f} s", flush=True)
    for name, log in build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {regs}", flush=True)
    sass = {}
    for name in ("pann_matmul", "pann_matmul_packed", "unsigned_matmul"):
        sass[name] = tensor_core_sass(name)
        print(f"[sass] {name}: {sass[name]['GMMA']} GMMA (wgmma) and "
              f"{sass[name]['IMMA']} IMMA (mma.sync) tensor-core "
              "instructions", flush=True)
        if not sass[name]["GMMA"]:   # its tile kernel runs on wgmma
            raise AssertionError(f"{name}: no GMMA line in its SASS")
    mark("2")

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    check_s: dict = {}      # seconds of each of phase 3's checks

    def timed(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        check_s[name] = time.perf_counter() - t
        return out

    mm_rows, mm_err = timed("matmuls", check_matmuls, gen)
    packed_tile_err, packed_tile_checked = timed("packed_tile_rows",
                                                 check_packed_tile_rows)
    print(f"[kernels] pann_matmul_packed_act above 8 rows at "
          f"{packed_tile_checked}: max |err| {packed_tile_err}", flush=True)
    plane_err, plane_checked, plane_rows = timed("plane_counts",
                                                 check_plane_counts)
    print(f"[planes] B2 and B1 at P = {list(PLANE_COUNTS)}, M = "
          f"{list(PLANE_M)}, plane_shift 0 and P - 1, shapes "
          f"{list(PLANE_SHAPES)}: {len(plane_checked)} cases, max |err| "
          f"{plane_err}", flush=True)
    att_by_config, att_checks = timed("attention", check_attention, gen)
    att_rows = att_by_config["llama3-8b"]
    att_long = timed("attention_long", check_long_attention, gen)
    att_caps = timed("attention_past_caps", check_attention_past_caps)
    att_fork = timed("attention_long_below_cap", time_long_below_cap)
    variant_mm = timed("variant_matmuls", check_variant_matmuls)
    ragged = timed("ragged_dispatch", check_ragged_dispatch)
    print("[kernels] serving_linear at a ragged N (C8): " + json.dumps(
        ragged), flush=True)
    b6_calls = timed("b6_kernels_per_call", b6_kernels_per_call)
    print("[kernels] unsigned_matmul at M = 1..8, device kernels (profiler): "
          + json.dumps(b6_calls), flush=True)
    encode_rows, encode_err = timed("encode_matmuls", check_encode_matmuls,
                                    gen)
    conv = timed("serving_conv", check_serving_conv)
    print(f"[kernels] all bit-identical to their plain versions "
          f"({time.perf_counter() - t0:.1f} s; by check "
          + json.dumps({k: round(v, 1) for k, v in check_s.items()}) + ")",
          flush=True)
    for name, rows in mm_rows.items():
        for r in rows:
            print(f"[kernels] {name} " + json.dumps(
                {k: v for k, v in r.items()}), flush=True)
    mark("3")

    # phase 4: full-width serve through the ladder, every step a graph
    serve = full_width_serve()
    print("[serve] " + json.dumps({k: v for k, v in serve.items()
                                   if k not in ("tokens", "profile",
                                                "eager_profile")}),
          flush=True)
    print(f"[serve] graphed step: {serve['ms_per_step']:.3f} ms on the host, "
          f"{serve['profile']['device_ms_per_step']:.3f} ms of device "
          f"kernels (busy share {serve['device_busy_share']:.3f}), "
          f"{serve['tok_per_s']:.2f} tok/s; the eager step's kernels "
          f"{serve['eager_profile']['device_ms_per_step']} ms; "
          f"{serve['graphs']} graphs captured", flush=True)
    print("[serve] kernels per graphed step " + json.dumps(
        serve["profile"]["device_ops_per_step_by_kind"]) + ", ms "
        + json.dumps(serve["profile"]["ms_per_step_by_kind"]), flush=True)
    for uid, toks in serve["tokens"].items():
        print(f"[serve] request {uid} (rung {serve['rung_bits'][uid]}) "
              f"tokens {toks}", flush=True)
    mark("4")

    # phase 4b: full width, layerwise allocation, cache_bits 'auto'
    layerwise = layerwise_serve()
    print("[layerwise] " + json.dumps({k: v for k, v in layerwise.items()
                                       if k != "tokens"}), flush=True)
    mark("4b")

    # phase 4c: the dense variants at full width, every step a graph
    variants = {}
    for i, arch in enumerate(VARIANTS):
        v = full_width_serve(arch, seed=3 + i, n_requests=3,
                             eager_profile=False)
        variants[arch] = v
        print(f"[variant] {arch}: " + json.dumps(
            {k: val for k, val in v.items()
             if k not in ("tokens", "profile", "eager_profile")}),
            flush=True)
        print(f"[variant] {arch} graphed step: {v['ms_per_step']:.3f} ms on "
              f"the host, {v['profile']['device_ms_per_step']:.3f} ms of "
              f"device kernels (busy share {v['device_busy_share']:.3f}), "
              f"{v['tok_per_s']:.2f} tok/s, peak {v['peak_mem_gb']:.2f} GB; "
              "kernels per graphed step " + json.dumps(
                  v["profile"]["device_ops_per_step_by_kind"]) + ", ms "
              + json.dumps(v["profile"]["ms_per_step_by_kind"]), flush=True)
    mark("4c")

    # phase 4d: the MoE configs at full width, cut in depth to one card
    moe = {}
    for i, arch in enumerate(MOE_ARCHS):
        t0 = time.perf_counter()
        m = full_width_serve(arch, seed=10 + i, n_requests=3,
                             eager_profile=False)
        m["phase_s"] = time.perf_counter() - t0
        moe[arch] = m
        print(f"[moe] {arch}: " + json.dumps(
            {k: val for k, val in m.items()
             if k not in ("tokens", "profile", "eager_profile")}),
            flush=True)
        print(f"[moe] {arch} graphed step: {m['ms_per_step']:.3f} ms on the "
              f"host, {m['profile']['device_ms_per_step']:.3f} ms of device "
              f"kernels (busy share {m['device_busy_share']:.3f}), "
              f"{m['tok_per_s']:.2f} tok/s, peak {m['peak_mem_gb']:.2f} GB; "
              "device ms a step by part " + json.dumps(
                  m["fp32_matmuls"]["device_ms_split"]) + "; kernels per "
              "graphed step " + json.dumps(
                  m["profile"]["device_ops_per_step_by_kind"]) + "; top "
              "kernels " + json.dumps(m["profile"]["top_kernels_ms"]),
              flush=True)
    mark("4d")

    # phase 4e: the recurrent families at full width, RECURRENT_LAYERS deep
    recurrent = {}
    for i, arch in enumerate(RECURRENT_ARCHS):
        t0 = time.perf_counter()
        r = full_width_serve(arch, seed=12 + i, n_requests=3,
                             eager_profile=False)
        r["phase_s"] = time.perf_counter() - t0
        recurrent[arch] = r
        print(f"[recurrent] {arch}: " + json.dumps(
            {k: val for k, val in r.items()
             if k not in ("tokens", "profile", "eager_profile")}),
            flush=True)
        print(f"[recurrent] {arch} graphed step: {r['ms_per_step']:.3f} ms "
              f"on the host, {r['profile']['device_ms_per_step']:.3f} ms of "
              f"device kernels (busy share {r['device_busy_share']:.3f}), "
              f"{r['tok_per_s']:.2f} tok/s, peak {r['peak_mem_gb']:.2f} GB; "
              "kernels per graphed step " + json.dumps(
                  r["profile"]["device_ops_per_step_by_kind"]) + ", ms "
              + json.dumps(r["profile"]["ms_per_step_by_kind"])
              + "; an eager step's device ms by part " + json.dumps(
                  r["device_ms_split"].get("eager_step_ms_by_part")),
              flush=True)
    mark("4e")

    # phase 4f: the cross-attending configs at full width, a raw frontend
    # a wave
    encdec = {}
    for i, arch in enumerate(ENCDEC_ARCHS):
        t0 = time.perf_counter()
        e = full_width_serve(arch, seed=20 + i, n_requests=3,
                             eager_profile=False)
        e["phase_s"] = time.perf_counter() - t0
        encdec[arch] = e
        print(f"[encdec] {arch}: " + json.dumps(
            {k: val for k, val in e.items()
             if k not in ("tokens", "profile", "eager_profile")}),
            flush=True)
        fe = e["frontend"]
        print(f"[encdec] {arch} graphed step: {e['ms_per_step']:.3f} ms on "
              f"the host, {e['profile']['device_ms_per_step']:.3f} ms of "
              f"device kernels (busy share {e['device_busy_share']:.3f}), "
              f"{e['tok_per_s']:.2f} tok/s, peak {e['peak_mem_gb']:.2f} GB; "
              "kernels per graphed step " + json.dumps(
                  e["profile"]["device_ops_per_step_by_kind"]) + ", ms "
              + json.dumps(e["profile"]["ms_per_step_by_kind"])
              + f"; wave-start frontend {fe['b2_launches_per_wave']} B2, ms "
              + json.dumps([round(x, 3) for x in fe["ms"]]), flush=True)
    mark("4f")

    # phase 4g: long-context decode, gemma2-9b's 8,192-token context
    long_ctx = long_context_serve()
    print("[long] " + json.dumps({k: v for k, v in long_ctx.items()
                                  if k != "tokens"}), flush=True)
    print(f"[long] {LONG_ARCH} at S = {LONG_MAX_LEN}: "
          f"{long_ctx['host_ms_per_step_last']:.3f} host ms a step over the "
          f"last steps; B3 long path "
          f"{long_ctx['b3_last_step']['global']['device_ms']:.4f} device ms "
          f"a step (the local ring's cluster kernel "
          f"{long_ctx['b3_last_step']['local ring']['device_ms']:.4f})",
          flush=True)
    mark("4g")

    # phase 5: backends agree, and the v1 artifact round trip, on each
    # served config cut to 2 layers, mixtral to 1, zamba2 to 8, seamless
    # to 2 + 2, vision to 5
    agree = backends_agree()
    print("[backends] " + json.dumps(agree), flush=True)
    agree_variants = {}
    for i, arch in enumerate(VARIANTS):
        agree_variants[arch] = backends_agree(arch, seed=6 + i, n_requests=3)
        print(f"[backends] {arch} " + json.dumps(agree_variants[arch]),
              flush=True)
    t0 = time.perf_counter()
    agree_variants["mixtral-8x7b"] = backends_agree(
        "mixtral-8x7b", seed=9, n_requests=3, layers=1)
    agree_variants["mixtral-8x7b"]["phase_s"] = time.perf_counter() - t0
    print("[backends] mixtral-8x7b " + json.dumps(
        agree_variants["mixtral-8x7b"]), flush=True)
    for i, arch in enumerate(RECURRENT_ARCHS):
        t0 = time.perf_counter()
        agree_variants[arch] = backends_agree(
            arch, seed=14 + i, n_requests=3, layers=RECURRENT_CUT[arch])
        agree_variants[arch]["phase_s"] = time.perf_counter() - t0
        print(f"[backends] {arch} " + json.dumps(agree_variants[arch]),
              flush=True)
    for i, arch in enumerate(ENCDEC_ARCHS):
        t0 = time.perf_counter()
        tf_len, n_requests = ENCDEC_P5[arch]
        agree_variants[arch] = backends_agree(
            arch, seed=22 + i, n_requests=n_requests,
            layers=ENCDEC_CUT[arch], tf_len=tf_len)
        agree_variants[arch]["phase_s"] = time.perf_counter() - t0
        print(f"[backends] {arch} " + json.dumps(agree_variants[arch]),
              flush=True)
    mark("5")

    # phase 6: the unfused path through the kernel API
    unfused = unfused_path(gen)
    print(f"[unfused] all bit-identical to their plain versions "
          f"({unfused['seconds']:.1f} s); launches {unfused['launches']}; "
          f"max |err| {unfused['max_abs_err']}", flush=True)
    for r in unfused["rows"]:
        print("[unfused] " + json.dumps(r), flush=True)
    for key in ("b6_decode", "b7"):
        sweep = unfused[key]
        print(f"[unfused] {key}: {sweep['cases_checked']} cases bit-identical "
              f"({sweep['seconds']:.1f} s)", flush=True)
        for r in sweep["rows"]:
            print(f"[unfused] {key} " + json.dumps(r), flush=True)
    mark("6")

    # phase 7: prefill (forward) and the single-point serve
    t0 = time.perf_counter()
    prefill = prefill_forward(layers=PREFILL_LAYERS)
    single = single_point()
    phase7_s = time.perf_counter() - t0
    print(f"[phase7] {phase7_s:.1f} s", flush=True)
    mark("7abc")

    # 7d and 7e: the same on mixtral-8x7b at MOE_PREFILL_LAYERS
    t0 = time.perf_counter()
    moe_prefill = prefill_forward(arch="mixtral-8x7b",
                                  layers=MOE_PREFILL_LAYERS)
    moe_single = moe_single_point()
    phase7_moe_s = time.perf_counter() - t0
    print(f"[phase7] mixtral-8x7b {phase7_moe_s:.1f} s", flush=True)
    mark("7de")

    # 7f: forward of the recurrent families at 4e's depths
    recurrent_prefill = {}
    for i, arch in enumerate(RECURRENT_ARCHS):
        t0 = time.perf_counter()
        recurrent_prefill[arch] = prefill_forward(seed=16 + i, arch=arch,
                                                  profiled=False)
        recurrent_prefill[arch]["phase_s"] = time.perf_counter() - t0
        print(f"[phase7] {arch} {recurrent_prefill[arch]['phase_s']:.1f} s",
              flush=True)
    mark("7f")

    # 7g: forward of seamless at 4f's depth over raw features
    t0 = time.perf_counter()
    encdec_prefill = prefill_forward(seed=24, arch=ENCDEC_ARCHS[0],
                                     profiled=False, t_len=ENCDEC_T)
    encdec_prefill["phase_s"] = time.perf_counter() - t0
    print(f"[phase7] {ENCDEC_ARCHS[0]} {encdec_prefill['phase_s']:.1f} s",
          flush=True)
    mark("7g")

    # phase 8: whole-sequence encode waves under per-item budgets
    encode = {}
    for i, arch in enumerate(ENCDEC_ARCHS):
        t0 = time.perf_counter()
        encode[arch] = encode_serve(arch, seed=26 + i)
        encode[arch]["phase_s"] = time.perf_counter() - t0
        print(f"[encode] {arch} " + json.dumps(encode[arch]), flush=True)
    mark("8")

    # phase 9: power-aware training -> export -> the calibrated artifact
    # served; its checkpoint and artifact live in a temporary directory
    import shutil
    t9 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        print(f"[train] temporary directory {tmp}: "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free", flush=True)
        ckpt_dir, art_dir = f"{tmp}/ckpt", f"{tmp}/artifact"
        train = power_aware_train(ckpt_dir)
        for seg in train["segments"]:
            print(f"[train] segment {seg['budget']} steps "
                  f"[{seg['start']}, {seg['end']}): ms a step "
                  f"{seg['step_ms']}, after the first "
                  f"{seg['ms_per_step_after_first']} ms, "
                  f"{seg['tok_per_s']} tok/s", flush=True)
        ck = train["checkpoints"][-1]
        print(f"[train] losses {train['losses']}; eval "
              f"{train['eval_loss']}; peak {train['peak_mem_gb']:.2f} GB; "
              f"checkpoint {ck['gb']:.2f} GB written in {ck['write_s']:.2f} "
              f"s ({ck['gb_per_s']:.2f} GB/s); calibration roles seen "
              f"{train['calib_seen']} of {train['calib_roles']}; "
              f"{train['wall_s']:.1f} s", flush=True)
        mark("9a")
        exported = export_calibrated(ckpt_dir, art_dir)
        shutil.rmtree(ckpt_dir)
        print("[export] " + json.dumps(exported), flush=True)
        mark("9b")
        calibrated, ws = serve_calibrated(art_dir)
        print("[calibrated] " + json.dumps(
            {k: v for k, v in calibrated.items()
             if k not in ("profile", "uncalibrated_profile")}), flush=True)
        print(f"[calibrated] graphed step {calibrated['ms_per_step']:.3f} "
              f"ms on the host, {calibrated['tok_per_s']:.2f} tok/s; "
              "dispatch's small kernels a step, calibrated "
              + json.dumps(calibrated.get("small_kernels_calibrated"))
              + " against the same store's dynamic ranges "
              + json.dumps(calibrated.get("small_kernels_uncalibrated")),
              flush=True)
        mark("9c")
        frozen = frozen_kernels(ws)
        del ws
        _free()
        for name, rows in frozen["rows"].items():
            for r in rows:
                print(f"[frozen] {name} " + json.dumps(r), flush=True)
        mark("9d")
        resume = resume_on_card(f"{tmp}/resume")
        print("[resume] " + json.dumps(resume), flush=True)
        mark("9e")
    phase9_s = time.perf_counter() - t9
    print(f"[phase9] {phase9_s:.1f} s", flush=True)

    # phase 10: a fleet under one global power cap; its artifacts live in
    # a temporary directory
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fleet = fleet_serve(tmp)
        print("[fleet] " + json.dumps(
            {k: v for k, v in fleet.items()
             if k not in ("replans", "host_monitors")}), flush=True)
        print(f"[fleet] {fleet['served']} of {fleet['requests']} requests "
              f"in {fleet['ticks']} ticks, {fleet['wall_s']:.2f} s wall "
              f"({fleet['decode_tok_per_s']:.1f} decode tok/s), "
              f"{fleet['realized_gbitflips']:.6g} Gbit-flips, largest tick "
              f"{fleet['largest_tick']['share']:.4f} of its grant; reborn "
              f"host {fleet['restart_s']} s; handoffs "
              f"{fleet['handoff_ms']} ms; peak {fleet['peak_mem_gb']:.2f} "
              f"GB against the {fleet['store_gb']:.2f} GB store", flush=True)
        for name, mon in fleet["host_monitors"].items():
            print(f"[fleet] {name}: " + json.dumps(mon), flush=True)
        for r in fleet["replans"]:
            print("[fleet] replan " + json.dumps(r), flush=True)
        mark("10a")
        fleet_cli_out = fleet_cli(tmp, fleet["caps_gbitflips_per_s"][0])
        print("[fleet] cli " + json.dumps(fleet_cli_out), flush=True)
        mark("10b")
    phase10_s = time.perf_counter() - t10
    print(f"[phase10] {phase10_s:.1f} s", flush=True)

    # phase 11: the projection autotuner
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tuned = autotune_phase(tmp)
    print("[autotune] " + json.dumps({k: v for k, v in tuned.items()
                                      if k != "rows"}), flush=True)
    mark("11")
    phase11_s = time.perf_counter() - t11
    print(f"[phase11] {phase11_s:.1f} s", flush=True)

    # phase 12: dist/ on torch.distributed
    t12 = time.perf_counter()
    capacity = moe_capacity_train()
    print(f"[capacity] {smi} " + json.dumps(capacity), flush=True)
    print(f"[capacity] {smi}: mixtral-8x7b 1 layer, batch (2, 256): loss "
          f"rel {capacity['loss_rel']:.3g}, gradient rel "
          f"{capacity['grad_rel']:.3g} against the scan at capacity factor "
          f"{CAPACITY_NO_DROP}; {100 * capacity['dropped_share']:.2f} % of "
          f"routes dropped at {capacity['capacity_factor']}; "
          f"{capacity['ms_per_step_after_first']:.1f} ms a step after the "
          f"first; peak {capacity['peak_mem_gb']:.2f} GB", flush=True)
    mark("12a")
    tp = tp_train()
    print(f"[tp] {smi} " + json.dumps(tp), flush=True)
    for r in tp["ranks"]:
        print(f"[tp] {smi}: rank {r['rank']} of 2 on the card: "
              f"{r['ms_per_step_after_first']} ms a step after the first, "
              f"peak {r['peak_mem_gb']:.2f} GB; staged through the host "
              f"{r['staged_collectives']}", flush=True)
    print(f"[tp] {smi}: one rank {tp['one_rank_ms_per_step_after_first']:.1f}"
          f" ms a step, peak {tp['one_rank_peak_mem_gb']:.2f} GB; loss rel "
          f"{max(tp['loss_rel']):.3g}; collective checks "
          + json.dumps(tp["checks"]), flush=True)
    mark("12b")
    a11 = a11_on_kernels()
    print(f"[a11] {smi} " + json.dumps(a11), flush=True)
    mark("12c")
    phase12_s = time.perf_counter() - t12
    print(f"[phase12] {phase12_s:.1f} s", flush=True)

    # phase 13: serving under a device mesh (13a ran in 12b's launch)
    t13 = time.perf_counter()
    mesh = tp["mesh_serve"]
    for r in mesh:
        for name, c in r["cases"].items():
            whole = r["archs"][c["arch"]]["store_gb_one_rank"]
            print(f"[mesh] {smi}: {name} rank {r['rank']} of 2 on the card "
                  f"({c['mesh']}, {c['backend']}, {c['requests']} requests):"
                  f" {c['ms_per_step']:.2f} host ms a step, "
                  f"{c['tok_per_s']:.2f} tok/s; staged a step "
                  f"{c['staged_per_step']}; store {c['store_gb']:.3f} GB "
                  f"of the one-rank {whole:.3f} GB "
                  f"({c['store_share']:.4f}); peak {c['peak_gb']:.2f} GB; "
                  f"launches {c['launches']}", flush=True)
            if "one_rank" in c:
                print(f"[mesh] {smi}: {name} bit-identical to one rank over "
                      f"{c['bit_identical_steps']} steps; one rank "
                      f"{c['one_rank']['ms_per_step']:.2f} host ms a step "
                      f"({c['one_rank']['describe']['steps']})", flush=True)
    for arch, a in mesh[0]["archs"].items():
        print(f"[mesh] {arch}: {a['layers']} layers, store build "
              f"{a['build_s']:.1f} s, 13a's cases {a['wall_s']:.1f} s on "
              "rank 0" + (f" (13d {a['encode']['wall_s']:.1f} s of it)"
                          if "encode" in a else ""), flush=True)
    # 13d: EncodeEngine under a mesh (in 12b's launch, after each config's
    # 13a cases)
    for r in mesh:
        for arch, a in r["archs"].items():
            if "encode" not in a:
                continue
            e = a["encode"]
            for name, c in e["meshes"].items():
                print(f"[encode-mesh] {smi}: {arch} {name} rank "
                      f"{r['rank']}: {c['bit_identical_items']} items bit-"
                      f"identical to one rank's, {c['items_per_s']:.2f} "
                      f"items/s (one rank {e['one_rank']['items_per_s']:.2f}"
                      f"); store {c['store_gb']:.3f} GB of "
                      f"{e['store_gb_one_rank']:.3f} ({c['store_share']:.4f})"
                      f"; peak {c['peak_gb']:.2f} GB; launches "
                      f"{c['launches']}", flush=True)
    t13e = time.perf_counter()
    rank_ops = rank_shape_ops()
    for name, r in rank_ops.items():
        print(f"[rank-shape] {smi}: {name}: "
              + ("bit-identical" if r["bit_identical"] else
                 f"max |diff| {r['max_abs_diff']!r}")
              + f" (the port runs it at {r['port_runs_it_at']} shape)",
              flush=True)
        if r["port_runs_it_at"] == "the rank's" and not r["bit_identical"]:
            raise AssertionError(f"13e {name}: the port runs it at a rank's "
                                 "shape, where it differs from one rank's "
                                 f"(max |diff| {r['max_abs_diff']!r})")
    print(f"[phase13e] {time.perf_counter() - t13e:.1f} s", flush=True)
    mark("13e")
    acc = acc_mode_kernels()
    for name, rows in acc["rows"].items():
        for r in rows:
            print(f"[acc] {smi} {name} " + json.dumps(r), flush=True)
    print(f"[acc] {acc['cases']} cases bit for bit: "
          + json.dumps(acc["max_abs_err"]), flush=True)
    print("[acc] seconds " + json.dumps(acc["seconds"]), flush=True)
    mark("13b")
    with tempfile.TemporaryDirectory() as tmp:
        dry = dryrun_cells(tmp)
    for cell, d in dry.items():
        r = d["record"]
        print(f"[dryrun] {cell} {d['argv']}: {r['n_devices']} ranks, "
              f"{r['flops_per_device']:.4e} FLOPs a device, collectives "
              f"{r['collective_bytes_per_device']['total']:.4e} B a device, "
              f"arguments {r['argument_size_in_bytes']:.4e} B, "
              f"{r['compile_s']} s in the step, {d['wall_s']:.1f} s wall",
              flush=True)
    mark("13c")
    phase13_s = time.perf_counter() - t13
    print(f"[phase13] {phase13_s:.1f} s after 12b (13a ran inside 12b's "
          "launch)", flush=True)
    cache_dir.cleanup()
    _assert_fp32_matmuls()

    step = "one full-width decode step's launches, cold L2"
    kernels = [
        _kernel_entry("pann_matmul_act", "src/repro_torch/csrc/pann_matmul.cu",
                      "src/repro/kernels/pann_matmul.py:329",
                      mm_rows["pann_matmul_act"],
                      agree["launches"]["fused"]["pann_matmul_act"],
                      "per_step",
                      max(mm_err["pann_matmul_act"],
                          unfused["max_abs_err"]["pann_matmul_act"]), step),
        _kernel_entry("pann_matmul_packed_act",
                      "src/repro_torch/csrc/pann_matmul_packed.cu",
                      "src/repro/kernels/pann_matmul_packed.py:255",
                      mm_rows["pann_matmul_packed_act"],
                      serve["launches"]["pann_matmul_packed_act"],
                      "per_step",
                      max([mm_err["pann_matmul_packed_act"], packed_tile_err,
                           unfused["max_abs_err"]["pann_matmul_packed_act"]]
                          + [v["max_abs_err"] for v in variant_mm.values()]),
                      step),
        _kernel_entry("decode_attention",
                      "src/repro_torch/csrc/pann_attention.cu",
                      "src/repro/kernels/pann_attention.py:188",
                      [r for r in att_rows if r["S"] == PROMPT + GEN],
                      serve["launches"]["decode_attention"],
                      "per_step", max(r["max_abs_err"] for r in sum(
                          att_by_config.values(), att_checks)),
                      step),
    ]
    for k in kernels:       # B1-B3: the serve's and phase 5's engines
        k["launches_are"] = ("the wrapper's count while warmup captured the "
                             "decode graphs (one eager step per rung, then "
                             "one step per graph); a replay launches "
                             "without the wrapper")
    kernels[0]["launches_unfused"] = unfused["launches"]["pann_matmul_act"]
    kernels[0]["unfused_shapes"] = [r for r in unfused["rows"]
                                    if r["kernel"] == "pann_matmul_act"]
    kernels[1]["unfused_shapes"] = [r for r in unfused["rows"]
                                    if r["kernel"] == "pann_matmul_packed_act"]
    kernels[1]["tile_rows_checked"] = packed_tile_checked
    # phase 3's plane counts, phase 7's prefill and single-point serves
    for k, name, backend in ((kernels[0], "pann_matmul_act", "fused"),
                             (kernels[1], "pann_matmul_packed_act",
                              "packed")):
        k["max_abs_err"] = max(k["max_abs_err"], plane_err[name])
        k["planes_checked"] = {"P": list(PLANE_COUNTS), "M": list(PLANE_M),
                               "shapes": [list(x) for x in PLANE_SHAPES],
                               "cases": len(plane_checked)}
        k[f"p{TIMED_PLANES}_m{TIMED_M}"] = [r for r in plane_rows
                                            if r["kernel"] == name]
        k["launches_prefill"] = prefill["runs"][backend]["launches"][name]
        k["prefill"] = {key: prefill["runs"][backend][key] for key in (
            "kernel_ms", "bound_ms", "bound_by", "forward_ms",
            "cold_forward_ms")}
        k["launches_single_point"] = single["runs"][f"pann2_{backend}"][
            "launches"][name]
    kernels[2]["shapes"] = att_rows
    kernels[2]["checks"] = att_checks
    kernels[2]["head_dims"] = list(pa.HEAD_DIMS)
    # the dense variants' and the MoE configs' serves (phases 4c, 4d) and
    # phase 3's rows at their shapes, a decode step's worth (B3 at S = 48,
    # the serve's cache; mixtral's attention is llama3-8b's shape)
    served = {**{a: ("variants", variants[a]) for a in VARIANTS},
              **{a: ("moe", moe[a]) for a in MOE_ARCHS},
              **{a: ("recurrent", recurrent[a]) for a in RECURRENT_ARCHS},
              **{a: ("encdec", encdec[a]) for a in ENCDEC_ARCHS}}
    for arch, (group, srv) in served.items():
        att_of = arch if arch in att_by_config else "llama3-8b"
        att = [r for r in att_by_config[att_of] if r["S"] == PROMPT + GEN]
        per_step = srv["launches_per_captured_step"]["decode_attention"]
        kernels[1].setdefault(group, {})[arch] = {
            "launches": srv["launches"]["pann_matmul_packed_act"],
            "per_graphed_step": srv["launches_per_captured_step"][
                "pann_matmul_packed_act"],
            **{k: variant_mm[arch][k] for k in (
                "ms_per_step", "bound_ms_per_step", "plain_ms_per_step",
                "library_ms_per_step", "launches_per_step", "max_abs_err",
                "tied_head")}}
        if not per_step:        # rwkv6: no attention
            kernels[2].setdefault(group, {})[arch] = {
                "launches": srv["launches"]["decode_attention"],
                "per_graphed_step": 0}
            continue
        kernels[2].setdefault(group, {})[arch] = {
            "launches": srv["launches"]["decode_attention"],
            "per_graphed_step": per_step, "rows_of": att_of,
            "B_KH_G_hd": [att[0][k] for k in ("B", "KH", "G", "hd")],
            "softcap": att[0]["softcap"],
            **{f"{k}_per_step": sum(r[k] * per_step for r in att)
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")},
            "max_abs_err": max(r["max_abs_err"]
                               for r in att_by_config[att_of])}
    # mixtral's prefill and single point (phases 7d, 7e)
    kernels[1]["launches_prefill_mixtral"] = moe_prefill["runs"]["packed"][
        "launches"]["pann_matmul_packed_act"]
    kernels[0]["launches_prefill_mixtral"] = moe_prefill["runs"]["fused"][
        "launches"]["pann_matmul_act"]
    kernels[1]["launches_single_point_mixtral"] = moe_single["runs"][
        "packed"]["launches"]["pann_matmul_packed_act"]
    # the recurrent families' forward (phase 7f) and the ragged N (phase 3)
    for k, name, backend in ((kernels[0], "pann_matmul_act", "fused"),
                             (kernels[1], "pann_matmul_packed_act",
                              "packed")):
        k["launches_prefill_recurrent"] = {
            arch: recurrent_prefill[arch]["runs"][backend]["launches"][name]
            for arch in RECURRENT_ARCHS}
        k["ragged_n"] = {key: ragged[key] for key in ("K", "N", "N_padded",
                                                      "cases")}
        k["launches_ragged_n"] = ragged["launches"][name]
        # the encode path (phases 3, 4f, 7g, 8): its shapes, the wave-start
        # frontends, seamless's forward, the encode waves
        k["encode_shapes"] = [r for r in encode_rows if r["kernel"] == name]
        k["max_abs_err"] = max(k["max_abs_err"], encode_err[name])
        k["serving_conv_cases"] = {a: conv[a]["cases"] for a in conv}
        k["launches_prefill_encdec"] = encdec_prefill["runs"][backend][
            "launches"][name]
    kernels[1]["launches_wave_frontend"] = {
        a: encdec[a]["frontend"]["launches_per_wave"] for a in ENCDEC_ARCHS}
    kernels[1]["launches_encode"] = {a: encode[a]["launches"]
                                     for a in ENCDEC_ARCHS}
    one_pass = ("one pass of the unfused path (7 projections and the "
                "lm_head at M = 4 and 512), cold L2")
    for name, source, replaces in (
            ("pann_matmul", "src/repro_torch/csrc/pann_matmul.cu",
             "src/repro/kernels/pann_matmul.py:113"),
            ("pann_matmul_packed",
             "src/repro_torch/csrc/pann_matmul_packed.cu",
             "src/repro/kernels/pann_matmul_packed.py:99"),
            ("unsigned_matmul", "src/repro_torch/csrc/unsigned_matmul.cu",
             "src/repro/kernels/unsigned_matmul.py:61"),
            ("quantize_act", "src/repro_torch/csrc/quantize_act.cu",
             "src/repro/kernels/quantize_act.py:63")):
        kernels.append(_kernel_entry(
            name, source, replaces,
            [r for r in unfused["rows"] if r["kernel"] == name],
            unfused["launches"][name], "per_pass",
            max(unfused["max_abs_err"][name], mm_err.get(name, 0.0)),
            one_pass))
    # B6 at every decode M and B7 at every M of the sweeps (phase 6)
    b6, b7 = unfused["b6_decode"], unfused["b7"]
    kernels[-2]["decode_rows"] = [
        {key: r[key] for key in ("M", "ms", "bound_ms", "library_ms")}
        for r in b6["rows"]]
    kernels[-2]["decode_library"] = b6["library"]
    kernels[-2]["decode_kernels_per_call"] = b6_calls
    kernels[-2]["decode_cases_checked"] = b6["cases_checked"]
    kernels[-1]["m_rows"] = [
        {key: r[key] for key in ("M", "ms", "plain_ms", "bound_ms")}
        for r in b7["rows"]]
    kernels[-1]["floor_ms"] = b7["floor_ms"]
    kernels[-1]["cases_checked"] = b7["cases_checked"]
    # B1-B3 with frozen calibration scalars (phases 9c, 9d)
    frozen_times = ("one call at each row's shape (two calibrated "
                    "projections of the artifact's top rung at M = 4 and "
                    "1024; B3 at S = 48, 4 bits), cold L2, summed")
    for name, source, replaces, launches in (
            ("pann_matmul_act", "src/repro_torch/csrc/pann_matmul.cu",
             "src/repro/kernels/pann_matmul.py:329",
             calibrated["launches_by_backend"]["fused"]["pann_matmul_act"]),
            ("pann_matmul_packed_act",
             "src/repro_torch/csrc/pann_matmul_packed.cu",
             "src/repro/kernels/pann_matmul_packed.py:255",
             calibrated["launches"]["pann_matmul_packed_act"]),
            ("decode_attention", "src/repro_torch/csrc/pann_attention.cu",
             "src/repro/kernels/pann_attention.py:188",
             calibrated["launches"]["decode_attention"])):
        e = _kernel_entry(f"{name} (frozen calibration scalars)", source,
                          replaces, frozen["rows"][name], launches,
                          "per_step", frozen["max_abs_err"][name],
                          frozen_times)
        e["launches_are"] = ("the wrapper's count while warmup captured the "
                             "calibrated artifact's decode graphs (phase 9c"
                             + (", the 'fused' engine" if name ==
                                "pann_matmul_act" else "") + ")")
        e["cases"] = frozen["cases"]
        kernels.append(e)
    # the fleet (phase 10a: every host's captures and the verify engine's)
    # and the autotuner (phase 11: the tuning launches and both engines'
    # captures)
    for k in kernels[1:3]:
        k["launches_fleet"] = fleet["launches"][k["name"]]
    kernels[1]["launches_fleet_cli"] = fleet_cli_out["launches"][
        "pann_matmul_packed_act"]
    for k in kernels[:2]:
        k["launches_autotune"] = tuned["launches"][k["name"]]
        k["autotune_m4"] = [
            {key: r[key] for key in ("module", "K", "N", "heuristic",
                                     "heuristic_ms", "best", "best_ms",
                                     "bound_ms", "candidates")}
            for r in tuned["rows"] if r["kernel"] == k["name"]]
        if not k["launches_autotune"]:
            raise AssertionError(f"{k['name']}: no launch in phase 11")
    for k in kernels[1:3]:
        if not k["launches_fleet"]:
            raise AssertionError(f"{k['name']}: no launch in phase 10")
    # phase 12c: a rung view and its materialized copy decoded on 'fused'
    # and 'packed' (counted from 0 before each backend)
    kernels[0]["launches_a11"] = a11["runs"]["fused"]["launches"][
        "pann_matmul_act"]
    kernels[1]["launches_a11"] = a11["runs"]["packed"]["launches"][
        "pann_matmul_packed_act"]
    kernels[2]["launches_a11"] = sum(a11["runs"][b]["launches"][
        "decode_attention"] for b in ("fused", "packed"))
    # phase 13: the accumulator mode and the epilogue entry, launched on
    # 13a's (1, 2) meshes (counted from 0 before each serve, rank 0; their
    # sum over the cases), timed at 13b's local shapes
    cases0 = mesh[0]["cases"]
    mesh_times = ("13b's call at each row-parallel shard shape (M = 4), cold "
                  "L2, weighted by its launches a llama3-8b (1, 2) mesh "
                  "decode step (the other 13a configs' shapes in 'shapes', "
                  "weight 0)")
    for name, source, replaces, err in (
            ("pann_matmul_act_acc", "src/repro_torch/csrc/pann_matmul.cu",
             "src/repro/kernels/pann_matmul.py:329", None),
            ("pann_matmul_packed_act_acc",
             "src/repro_torch/csrc/pann_matmul_packed.cu",
             "src/repro/kernels/pann_matmul_packed.py:255", None),
            ("pann_epilogue", "src/repro_torch/csrc/pann_matmul.cu",
             "src/repro/kernels/pann_matmul.py:329",
             acc["max_abs_err"]["pann_epilogue"])):
        if err is None:
            err = max(acc["max_abs_err"][name],
                      acc["max_abs_err"][name + " (shards + epilogue)"])
        e = _kernel_entry(name, source, replaces, acc["rows"][name],
                          sum(c["launches"][name] for c in cases0.values()),
                          "per_step", err, mesh_times)
        e["launches_are"] = "rank 0's serves of 13a's cases"
        kernels.append(e)
    # 13b's B2 column shards and stems on a rank, B3 at a (1, 2) rank's
    # heads of the cross-attending configs; B2's launches in 13d's encodes
    kernels[1]["mesh_shapes"] = acc["rows"]["pann_matmul_packed_act"]
    kernels[1]["max_abs_err"] = max(
        kernels[1]["max_abs_err"],
        acc["max_abs_err"]["pann_matmul_packed_act (column shard)"])
    kernels[2]["mesh_shapes"] = acc["attention"]
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"],
                                    acc["max_abs_err"]["decode_attention"])
    kernels[1]["launches_13d"] = {
        f"{arch} {name}": c["launches"]["pann_matmul_packed_act"]
        for arch, a in mesh[0]["archs"].items() if "encode" in a
        for name, c in a["encode"]["meshes"].items()}
    # every kernel's launches in 13a's mesh serves on rank 0, a case each
    for e in kernels:
        by_case = {c: n["launches"][e["name"]] for c, n in cases0.items()
                   if n["launches"].get(e["name"])}
        if by_case:
            e["launches_13a_by_case"] = by_case
    # B3's long path: its launches in phase 4g's serve (the global layer a
    # step), timed at phase 3's gemma2-9b operands at S = 8,192, the 4g
    # step's shape, with every long row beside it
    long_rows = [dict(r, per_step=int(r["config"] == LONG_ARCH
                                      and r["S"] == LONG_MAX_LEN))
                 for r in att_long]
    e = _kernel_entry(
        "decode_attention_long", "src/repro_torch/csrc/pann_attention.cu",
        "src/repro/kernels/pann_attention.py:188", long_rows,
        long_ctx["launches"]["decode_attention_long"], "per_step",
        max(r["max_abs_err"] for r in att_long + att_caps),
        "one call at phase 4g's step shape (gemma2-9b, S = 8,192, 4 planes, "
        "full cache), cold L2")
    e["row"] = "B3·long"
    e["launches_are"] = ("the wrapper's count while phase 4g's warmup "
                         "captured the decode graphs")
    e["step_ms_4g"] = long_ctx["b3_last_step"]["global"]["device_ms"]
    e["past_caps_checked"] = [[c["config"], c["G"], c["hd"], c["S"]]
                              for c in att_caps]
    e["below_cap_long_over_cluster"] = [
        [r["config"], r["S"], r["long_over_cluster"]] for r in att_fork]
    kernels.append(e)
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was never launched on its path")
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "nvcc": nvcc, "driver": driver,
              "build_s": build.build_seconds, "sass": sass,
              "kernels": kernels,
              "serve": serve, "layerwise": layerwise, "variants": variants,
              "attention_long": att_long, "long_context": long_ctx,
              "attention_past_caps": att_caps,
              "attention_long_below_cap": att_fork,
              "variant_matmuls": variant_mm, "attention": att_by_config,
              "backends": agree, "backends_variants": agree_variants,
              "unfused": unfused,
              "plane_counts": {"max_abs_err": plane_err,
                               "checked": plane_checked,
                               "timed": plane_rows},
              "prefill": prefill, "single_point": single,
              "phase7_s": phase7_s, "moe": moe, "moe_prefill": moe_prefill,
              "moe_single_point": moe_single,
              "phase7_moe_s": phase7_moe_s, "recurrent": recurrent,
              "recurrent_prefill": recurrent_prefill, "ragged_n": ragged,
              "encode_matmuls": encode_rows, "serving_conv": conv,
              "encdec": encdec, "encdec_prefill": encdec_prefill,
              "encode": encode, "train": train, "export": exported,
              "calibrated": calibrated, "frozen": frozen, "resume": resume,
              "phase9_s": phase9_s, "fleet": fleet, "fleet_cli": fleet_cli_out,
              "phase10_s": phase10_s, "autotune": tuned,
              "phase11_s": phase11_s, "capacity": capacity, "tp": tp,
              "a11": a11, "phase12_s": phase12_s, "mesh_serve": mesh,
              "acc_mode": acc, "dryrun": dry, "phase13_s": phase13_s,
              "rank_shape_ops": rank_ops,
              "phase_done_at_s": phase_s,
              "wall_s": time.perf_counter() - start}
    print(f"[time] {report['wall_s']:.1f} s from the device check to the "
          "report", flush=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k not in ("shapes", "unfused_shapes",
                                                "checks", "planes_checked",
                                                "encode_shapes",
                                                "mesh_shapes")}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":
        sys.exit(dist_worker(sys.argv[2]))
    sys.exit(main())
