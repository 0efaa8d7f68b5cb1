"""The port's launch-parameter autotuner (``repro_torch.kernels.autotune``,
``dispatch.tune_projection``, ``ServeEngine(autotune=True)``, the serve
CLI's ``--autotune``), on the CPU: the cases of the JAX package's
``tests/test_kernel_fused_prologue.py`` autotune section, for the port's
knob, the K split (ksplit, kchunk) of B1's and B2's launches.

The candidate splits are legal and hold the heuristic; the cache persists,
survives a dropped process snapshot, ignores a corrupt or foreign-version
file and is the port's own file; the CPU records the heuristic untimed;
a tuned engine captures as many graphs as an untuned one and serves the
same tokens as it (bit for bit) and as the JAX package's (up to the
reference's near-ties, ``test_torch_slice``'s rule). Every split giving
bit-identical sums is shown by ``test_torch_decode_math``'s emulation at
every candidate; on the card ``chip_smoke.py`` phase 11.
"""
import json

import numpy as np
import pytest
import torch

from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch.kernels import autotune
from repro_torch.kernels import dispatch
from repro_torch.kernels import pann_matmul as tpm
from repro_torch.launch import serve as tserve
from repro_torch.serve_engine import Request as TRequest
from repro_torch.serve_engine import ServeEngine as TServeEngine
from test_torch_common import LADDER, port_cfg, ref_cfg, reference_store
from test_torch_engine_graphs import _fake_graphs
from test_torch_slice import REL_BOUND, _margin, ref_logits

# llama3-8b's projections and lm_head, the reduced config's, ragged ones
SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
          (4096, 128256), (64, 64), (128, 64), (64, 512), (4104, 136),
          (8, 4)]



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced configs run thousands of tiny torch ops; one intra-op
    thread keeps them from contending with the other test workers'
    threads for the cores (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune_torch.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


@pytest.mark.parametrize("backend", ["fused", "packed"])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 512])
def test_candidates_are_legal_and_hold_the_heuristic(m, backend):
    for k, n in SHAPES:
        if backend == "packed" and k % 8:
            continue
        heur = autotune.heuristic_params(m, k, n, backend)
        cands = autotune.candidate_params(m, k, n, backend)
        assert heur in cands and len(set(cands)) == len(cands)
        align = (tpm.DECODE_WARPS * (tpm.STEP_PACKED if backend == "packed"
                                     else tpm.STEP_PLANES)
                 if m <= tpm.DECODE_ROWS else tpm.TC_TILE[2])
        for ksplit, kchunk in cands:
            assert kchunk % align == 0 and kchunk > 0
            assert ksplit * kchunk >= k > (ksplit - 1) * kchunk
            if m <= tpm.DECODE_ROWS:
                assert kchunk <= tpm._MAX_KCHUNK
                # the code panel and the block's sums in 48 KB of smem
                mt = 4 if m <= 4 else 8
                assert mt * (4 * tpm.DECODE_COLS + kchunk) <= 48 * 1024
        # the heuristic is the wrapper's own split
        if m <= tpm.DECODE_ROWS:
            step = tpm.STEP_PACKED if backend == "packed" else \
                tpm.STEP_PLANES
            blocks = tpm.BLOCKS_PACKED if backend == "packed" else \
                tpm.BLOCKS_PLANES
            assert heur == tpm.decode_split(
                k, n, step, autotune.H100_SMS * blocks[4 if m <= 4 else 8])
        else:
            assert heur == tpm.split_k(m, k, n)


@pytest.mark.parametrize("bad", [(2, 100), (1, 2048), (3, 2048), (8, 0),
                                 (1, 8192)])
def test_illegal_split_raises(bad):
    """A split whose kchunk is off the K step, leaves a split empty,
    misses rows, or overflows the decode panel raises: nothing falls
    back to the heuristic."""
    with pytest.raises(ValueError, match="illegal split"):
        autotune.check_params(4, 4096, "packed", bad)


def test_record_persists_and_survives_process_cache_drop(tmp_cache):
    heur = autotune.heuristic_params(4, 4096, 1024, "packed")
    assert autotune.params_for(4, 4096, 1024, 7, "packed") == heur
    autotune.record(4, 4096, 1024, 7, "packed", (4, 1024), kind="cpu")
    autotune.clear_memory_cache()               # force a disk re-read
    assert autotune.params_for(4, 4096, 1024, 7, "packed") == (4, 1024)
    on_disk = json.loads(tmp_cache.read_text())
    assert on_disk["version"] == autotune.CACHE_VERSION
    key = autotune.cache_key(4, 4096, 1024, 7, "packed", "cpu")
    assert key == "cpu|packed|4x4096x1024|p7a7"
    assert on_disk["params"][key] == {"ksplit": 4, "kchunk": 1024}
    # other backends, plane counts, active counts and devices: own keys
    assert autotune.params_for(4, 4096, 1024, 7, "fused") == \
        autotune.heuristic_params(4, 4096, 1024, "fused")
    assert autotune.params_for(4, 4096, 1024, 5, "packed") == heur
    assert autotune.params_for(4, 4096, 1024, 7, "packed", active=3) == heur
    assert autotune.cache_key(4, 4096, 1024, 7, "packed", "NVIDIA H100 "
                              "80GB HBM3") != key
    with pytest.raises(ValueError, match="illegal split"):
        autotune.record(4, 4096, 1024, 7, "packed", (3, 1000), kind="cpu")


def test_corrupt_or_foreign_cache_is_ignored(tmp_cache):
    heur = autotune.heuristic_params(4, 4096, 1024, "packed")
    tmp_cache.write_text("{ not json")
    assert autotune.params_for(4, 4096, 1024, 7, "packed") == heur
    for payload in ({"version": 999, "params": {autotune.cache_key(
            4, 4096, 1024, 7, "packed", "cpu"): {"ksplit": 4,
                                                 "kchunk": 1024}}},
                    [1, 2, 3], {"version": autotune.CACHE_VERSION,
                                "params": [1]}):
        autotune.clear_memory_cache()
        tmp_cache.write_text(json.dumps(payload))
        assert autotune.params_for(4, 4096, 1024, 7, "packed") == heur
    # a corrupt file is replaced on the next record, not crashed on
    autotune.record(4, 4096, 1024, 7, "packed", (4, 1024), kind="cpu")
    assert json.loads(tmp_cache.read_text())["version"] == \
        autotune.CACHE_VERSION


def test_port_reads_neither_the_reference_variable_nor_its_file(
        tmp_path, monkeypatch):
    """The reference's $REPRO_AUTOTUNE_CACHE and its
    ``~/.cache/repro_pann/autotune.json`` hold block shapes under keys the
    port's CPU keys would equal; the port has its own variable and file."""
    ref_file = tmp_path / "autotune.json"
    key = autotune.cache_key(4, 4096, 1024, 7, "packed", "cpu")
    ref_file.write_text(json.dumps({"version": 2, "blocks": {
        key: {"blocks": [4, 128, 512], "depth": 2, "order": "mnk"}}}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(ref_file))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    (tmp_path / ".cache" / "repro_pann").mkdir(parents=True)
    (tmp_path / ".cache" / "repro_pann" / "autotune.json").write_text(
        ref_file.read_text())
    autotune.clear_memory_cache()
    try:
        assert autotune.cache_path() == str(
            tmp_path / ".cache" / "repro_pann" / "autotune_torch.json")
        assert autotune.params_for(4, 4096, 1024, 7, "packed") == \
            autotune.heuristic_params(4, 4096, 1024, "packed")
        autotune.record(4, 4096, 1024, 7, "packed", (4, 1024), kind="cpu")
        assert json.loads(ref_file.read_text())["blocks"][key]["blocks"] \
            == [4, 128, 512]
    finally:
        autotune.clear_memory_cache()


def test_cpu_tune_records_heuristic_and_short_circuits(tmp_cache):
    calls = []
    best = autotune.tune(4, 4096, 1024, 7, "packed",
                         runner=lambda p: calls.append(p) or 1.0)
    assert best == autotune.heuristic_params(4, 4096, 1024, "packed")
    assert calls == []          # the CPU never times: it has no kernel
    assert autotune.tune(4, 4096, 1024, 7, "packed",
                         runner=lambda p: 1 / 0) == best
    assert json.loads(tmp_cache.read_text())["params"] == {
        autotune.cache_key(4, 4096, 1024, 7, "packed", "cpu"):
            {"ksplit": best.ksplit, "kchunk": best.kchunk}}


def test_tune_projection_fills_the_cache_for_store_leaves(tmp_cache):
    view = reference_store()[3].views[4]
    leaf = view["layers"][0]["mlp"]["w_down"]
    k, n = leaf["w_q"].shape
    planes = leaf["w_planes_pos"].shape[-3]
    dispatch.tune_projection(4, leaf, "packed")
    dispatch.tune_projection(4, leaf, "fused")
    dispatch.tune_projection(4, leaf, "ref")    # ref: nothing to tune
    got = json.loads(tmp_cache.read_text())["params"]
    assert set(got) == {
        autotune.cache_key(4, leaf["w_planes_pos"].shape[-2] * 8, n,
                           planes, "packed", "cpu"),
        autotune.cache_key(4, k, n, planes, "fused", "cpu")}
    dispatch.tune_projection(4, leaf, "packed", planes_active=3)
    assert len(json.loads(tmp_cache.read_text())["params"]) == 3
    with pytest.raises(ValueError, match="no meaning in the port"):
        dispatch.tune_projection(4, leaf, "packed:force")


def _requests(mod):
    rng = np.random.default_rng(7)
    return [mod(uid=i, prompt=rng.integers(0, 512, 6).astype(np.int32),
                max_new_tokens=5, power_budget_bits=b)
            for i, b in enumerate((2, 4, 6, 4))]


@pytest.mark.parametrize("backend", ["packed", "fused"])
def test_engine_autotune_serves_the_same_tokens(tmp_cache, backend,
                                                monkeypatch):
    """ServeEngine(autotune=True) tunes before warmup, one cache entry per
    distinct projection shape (wq/wo, wk/wv, gate/up, down, lm_head);
    through the graphed path it captures as many graphs as an untuned
    engine, nothing after warmup, and serves the same tokens as it and as
    the JAX package's engine on the same store."""
    _, _, ws, pws = reference_store()
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=12, cache_bits=4,
              backend=backend, device="cpu")
    engines = []
    for tuned in (True, False):
        eng = TServeEngine(port_cfg(), weight_store=pws, autotune=tuned,
                           **kw)
        _fake_graphs(eng, monkeypatch)
        eng.warmup()
        engines.append(eng)
    entries = json.loads(tmp_cache.read_text())["params"]
    assert len(entries) == 5
    assert all(f"|{backend}|2x" in key for key in entries)
    tuned, plain = engines
    got = tuned.generate([TRequest(**r.__dict__)
                          for r in _requests(TRequest)])
    want = plain.generate(_requests(TRequest))
    tuned.assert_no_recompile()
    assert tuned.graphs_captured == plain.graphs_captured == 6
    assert [r.tokens for r in got] == [r.tokens for r in want]
    reng = RServeEngine(ref_cfg(), weight_store=ws, ladder_bits=LADDER,
                        max_batch=2, max_len=12, cache_bits=4,
                        backend="ref")
    ref = reng.generate(_requests(RRequest))
    for r, t, q in zip(ref, got, _requests(RRequest)):
        assert (r.uid, r.rung_bits) == (t.uid, t.rung_bits)
        rows = np.concatenate([q.prompt, np.asarray(r.tokens[:-1],
                                                    np.int32)])
        logits = ref_logits(r.rung_bits, 4, np.stack([rows, rows]))[
            len(q.prompt) - 1:, 0]
        bound = REL_BOUND * np.max(np.abs(logits), axis=-1)
        for i, (a, b) in enumerate(zip(r.tokens, t.tokens)):
            if _margin(logits[i]) <= 2 * bound[i]:
                break
            assert a == b, (r.uid, i)


def test_ref_engine_tunes_nothing(tmp_cache):
    eng = TServeEngine(port_cfg(), weight_store=reference_store()[3],
                       ladder_bits=LADDER, max_batch=2, max_len=12,
                       cache_bits=4, backend="ref", device="cpu",
                       autotune=True)
    eng.warmup()
    assert not tmp_cache.exists()


def test_serve_cli_autotune(tmp_cache):
    out = tserve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt_len", "4", "--gen", "4", "--requests", "3",
                       "--cache_bits", "4", "--autotune"])
    assert out["engine"]["compilations_after_warmup"] == 0
    assert len(out["requests"]) == 3
    assert len(json.loads(tmp_cache.read_text())["params"]) == 5
