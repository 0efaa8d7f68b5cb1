"""The port's dry run (``repro_torch.launch.dryrun``) on a fake 256-rank
group, reduced llama3-8b ``train_4k``, against the JAX package's sharding
rules.

One subprocess run writes the record; a second (the CLI's ``main`` in
this process: a cell already recorded starts no group) must resume from
it, as ``tests/test_dryrun_smoke.py`` asks of the reference's. The record's
parameter and AdamW-moment bytes (summed over the 256 devices) equal, to
the byte, those of the reference's ``param_specs`` on an abstract
{"data": 16, "model": 16} stand-in over ``jax.eval_shape`` of the
reference's train state (the reference's sharding functions read only the
mesh's ``axis_names`` and ``shape``). Sharding never loses work: the
per-device FLOPs times 256 are at least the same step's FLOPs counted on
one unsharded meta process here.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest

from repro import configs as rconfigs
from repro.configs.base import ParallelConfig as RParallelConfig
from repro.configs.base import QuantConfig as RQuantConfig
from repro.configs.base import TrainConfig as RTrainConfig
from repro.dist import sharding as RSH
from repro.launch import steps as RST
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig
from repro_torch.launch import dryrun as TDR

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--arch", "llama3-8b", "--shape", "train_4k", "--mesh", "single",
        "--reduced"]


def _run(out: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *ARGV, "--out",
         out], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _cfg(configs_mod, quant_cls):
    return configs_mod.reduced(configs_mod.get_config(
        "llama3-8b", dtype="bfloat16",
        quant=quant_cls(mode="none", qat=True)))


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """(the record, the second run's stdout, the unsharded step's counts
    on this process, made while the first run works)."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    proc = _run(out)
    try:
        full = tconfigs.get_config("llama3-8b", dtype="bfloat16")
        unsharded = TDR.count_cell(
            _cfg(tconfigs, QuantConfig), tconfigs.SHAPES_BY_NAME["train_4k"],
            par=TDR.parallel_for(full, "train"))
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stdout[-2000:] + stderr[-3000:]
    # the second run in this process: a resumed cell starts no group
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TDR.main(ARGV + ["--out", out])
    stdout2 = buf.getvalue()
    with open(os.path.join(out, "dryrun_single_reduced.json")) as f:
        data = json.load(f)
    assert data["failures"] == []
    (record,) = data["records"]
    return record, stdout2, unsharded


def test_record_and_resume(dryrun):
    record, stdout2, _ = dryrun
    assert "resuming: 1 records already present" in stdout2
    assert record["n_devices"] == 256
    assert record["mesh"] == "single" and record["shape"] == "train_4k"
    assert record["fsdp"] is True     # the full config's strategy
    assert record["flops_per_device"] > 0
    assert record["collective_bytes_per_device"]["total"] > 0
    assert record["flops_per_device_corrected"] == \
        record["flops_per_device"]
    for key in ("temp_size_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "bytes_per_device"):
        assert record[key] > 0


def test_param_and_moment_bytes_match_reference_specs(dryrun):
    record, _, _ = dryrun
    cfg = _cfg(rconfigs, RQuantConfig)
    state = jax.eval_shape(
        lambda k: RST.make_train_state(k, cfg, RTrainConfig()),
        jax.random.PRNGKey(0))
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 16, "model": 16})
    full = tconfigs.get_config("llama3-8b", dtype="bfloat16")
    par = RParallelConfig(fsdp=TDR.parallel_for(full, "train").fsdp)
    specs = RSH.param_specs(state.params, mesh, par)

    def total(tree) -> int:
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        out = 0
        for leaf, spec in zip(leaves, spec_leaves, strict=True):
            split = 1
            for entry in spec:
                for ax in (entry if isinstance(entry, tuple) else (entry,)):
                    if ax is not None:
                        split *= mesh.shape[ax]
            out += math.prod(leaf.shape) * leaf.dtype.itemsize // split
        return out * 256

    want = total(state.params) + total(state.opt.mu) + total(state.opt.nu)
    parts = record["argument_size_by_part"]
    assert parts["params"] + parts["moments"] == want


def test_sharding_conserves_flops(dryrun):
    record, _, unsharded = dryrun
    ratio = record["flops_per_device"] * 256 / unsharded["flops_per_device"]
    print(f"256 x per-device FLOPs / unsharded FLOPs = {ratio:.4f}")
    assert ratio >= 1.0


# the decode cells of the MoE and recurrent families at --reduced on the
# (16, 16) mesh: (arch, the local-decode entry each must reach, as
# "module:attribute" under repro_torch)
DECODE_CELLS = (("mixtral-8x7b", "models.mlp:_apply_moe_shards"),
                ("zamba2-1.2b", "dist.local_ops:ServeShards.place"),
                ("rwkv6-1.6b", "dist.local_ops:ServeShards.place"))


@pytest.mark.parametrize("arch, entry", DECODE_CELLS)
def test_reduced_decode_cell(arch, entry, monkeypatch):
    """``decode_32k`` at --reduced on the fake 256-rank group (as rank 0,
    in this process): the record's per-device FLOPs, bytes and collective
    bytes by kind, its step run through the local decode of a serving
    mesh (the MoE block on the rank's shards of the experts, the
    recurrent states' heads placed at one rank's shape), and no FLOP lost
    against the same step counted unsharded here. The reduced configs' 4
    query heads on 16 "model" ranks run whole on every rank."""
    import importlib
    module, attr = entry.split(":")
    owner = importlib.import_module(f"repro_torch.{module}")
    *outer, name = attr.split(".")
    for part in outer:
        owner = getattr(owner, part)
    calls = []
    real = getattr(owner, name)

    def counted(*args, **kwargs):
        calls.append(entry)
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, counted)
    record = TDR.run_cell(arch, "decode_32k", False, verbose=False,
                          reduced=True)
    assert record["n_devices"] == 256 and record["shape"] == "decode_32k"
    assert calls, f"the step never reached {entry}"
    coll = record["collective_bytes_per_device"]
    assert set(coll) == set(TDR.COLLECTIVES) | {"total"}
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert coll["total"] == sum(coll[k] for k in TDR.COLLECTIVES)
    for key in ("flops_per_device", "bytes_per_device",
                "argument_size_in_bytes", "output_size_in_bytes"):
        assert record[key] > 0
    cfg = tconfigs.reduced(tconfigs.get_config(arch, dtype="bfloat16"))
    unsharded = TDR.count_cell(cfg, tconfigs.SHAPES_BY_NAME["decode_32k"])
    assert record["flops_per_device"] * 256 >= \
        unsharded["flops_per_device"]


@pytest.mark.parametrize("quant", ["none", "pann_serve"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_reduced_cross_decode_cell(arch, quant, monkeypatch):
    """``decode_32k`` of the cross-attending configs at --reduced on the
    fake 256-rank group (as rank 0, in this process), on the fp params and
    on the serving artifact: a record with no failure, its store placed
    over "model" alone (the serving mesh's layout, never FSDP), the
    frontend run on the rank's rows and every decode step's
    cross-attention through ``_cross_core``; no FLOP lost against the same
    step counted unsharded here."""
    from repro_torch.dist import local_ops
    from repro_torch.models import attention
    calls = {"own_rows": 0, "_cross_core": 0}
    for owner, name in ((local_ops.ServeShards, "own_rows"),
                        (attention, "_cross_core")):
        real = getattr(owner, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(owner, name, counted)
    record = TDR.run_cell(arch, "decode_32k", False, quant_mode=quant,
                          verbose=False, reduced=True)
    assert record["n_devices"] == 256 and record["shape"] == "decode_32k"
    assert record["quant"] == quant and record["fsdp"] is False
    assert calls["own_rows"] == 1 and calls["_cross_core"] > 0, calls
    coll = record["collective_bytes_per_device"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    for key in ("flops_per_device", "bytes_per_device",
                "argument_size_in_bytes", "output_size_in_bytes"):
        assert record[key] > 0
    cfg = tconfigs.reduced(tconfigs.get_config(arch, dtype="bfloat16"))
    unsharded = TDR.count_cell(cfg, tconfigs.SHAPES_BY_NAME["decode_32k"],
                               serve_quant=quant == "pann_serve")
    assert record["flops_per_device"] * 256 >= \
        unsharded["flops_per_device"]


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x7b"])
def test_reduced_windowed_decode_cell(arch, monkeypatch):
    """``decode_32k`` of the windowed configs at --reduced on the fake
    256-rank group: the decode state is made at the cell's 32,768
    positions, each windowed layer's cache a ring of min(32768, 16) rows
    and each global layer's 32,768 rows (gemma2's local and global
    layers; mixtral windowed in every layer, so its caches are the 16 rows
    the cell gave them before rings), and the step records."""
    from repro_torch.models import model as TMD
    from repro_torch.models import transformer as TT
    states = []
    real = TMD.init_decode_state

    def kept(*args, **kwargs):
        states.append(real(*args, **kwargs))
        return states[-1]

    monkeypatch.setattr(TMD, "init_decode_state", kept)
    record = TDR.run_cell(arch, "decode_32k", False, verbose=False,
                          reduced=True)
    assert record["n_devices"] == 256 and record["shape"] == "decode_32k"
    assert record["flops_per_device"] > 0
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    seq = tconfigs.SHAPES_BY_NAME["decode_32k"].seq_len
    specs = TMD.layer_specs(cfg)
    (state,) = states
    rows = [c.k.shape[1] for c in state.caches]
    assert rows == [TT.cache_rows(s, seq) for s in specs]
    assert rows == [16 if s.window else seq for s in specs]
    if arch == "gemma2-9b":
        assert sorted(set(rows)) == [16, seq]
