"""The port's ``ServeEngine`` serving the recurrent decoders under a
device mesh on CPU gloo ranks, against the one-process port engine and
the JAX package's engine.

ONE spawned group of 4 ranks for this file
(``_torch_dist_worker.spawn_group``) serves every case on a ("data",
"model") mesh of (2, 2), (1, 4) or (4, 1): reduced zamba2-1.2b at one
group of 6 layers (five ``mamba`` layers and one ``mamba_attn``, so the
shared attention + MLP block runs; 8 SSM heads, 4 KV heads) and reduced
rwkv6-1.6b widened to d_model 256 (4 wkv heads of 64; reduced it has 1),
2 layers, on 'ref', 'fused' and 'packed'. The stores are the JAX
package's, carried across (zamba2's with cache bits 4, rwkv6's with a
layerwise ladder and no KV cache).

Each rank holds its heads of the Mamba2 and wkv states; the recurrence
runs at one rank's shape (``ServeShards.place``). Held: rank 0's tokens
and every step's logits equal the one-process engine's bit for bit on
every mesh; the one-process tokens equal the reference engine's; each
rank's store share; the slots' shapes against ``slot_specs`` (the
states' heads over "model", the conv tail and the token shifts whole).
``ServeShards``' head and row slicing (``place``, ``take``, ``part``,
``k_rows``, ``heads_of``) is held on its own, without a group.
"""
import pytest
import torch

import test_torch_serve_mesh as SM
from repro_torch.dist import local_ops
from test_torch_common import one_torch_thread  # noqa: F401

STORES = {"zamba2_c4": ("zamba2-1.2b", 4, "uniform", {"num_layers": 6}),
          "rwkv6_lw": ("rwkv6-1.6b", None, "layerwise",
                       {"d_model": 256, "num_layers": 2})}
CASES = [((2, 2), "ref", "zamba2_c4"), ((2, 2), "fused", "rwkv6_lw"),
         ((2, 2), "packed", "zamba2_c4"),
         ((1, 4), "packed", "rwkv6_lw"), ((1, 4), "ref", "zamba2_c4"),
         ((1, 4), "fused", "zamba2_c4"),
         ((4, 1), "fused", "rwkv6_lw"), ((4, 1), "packed", "zamba2_c4"),
         ((4, 1), "ref", "rwkv6_lw")]
NAMES = [SM.case_name(*c) for c in CASES]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = SM.serve_group(str(tmp_path_factory.mktemp(
        "serve_mesh_recurrent")), STORES, CASES)
    return (out["ranks"], out["logits"], out["ones"], out["ref_tokens"],
            out["whole"])


@pytest.mark.parametrize("name", NAMES)
def test_rank0_bit_identical_to_one_process(served, name):
    SM.check_rank0_bit_identical(served, name)


@pytest.mark.parametrize("store", list(STORES))
def test_tokens_match_reference(served, store):
    SM.check_tokens_match_reference(
        served, [n for n in NAMES if SM.store_of(n) == store])


@pytest.mark.parametrize("name", NAMES)
def test_store_bytes_per_rank(served, name):
    SM.check_store_bytes_per_rank(served, name)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if SM.mesh_of(n) != (4, 1)])
def test_slots_follow_slot_specs(served, name):
    SM.check_slots_follow_slot_specs(served, name, STORES)


@pytest.mark.parametrize("data, model, data_rank, model_rank",
                         [(2, 2, 1, 0), (1, 4, 0, 3), (4, 1, 2, 0)])
def test_shards_place_take_part(data, model, data_rank, model_rank):
    """A rank's rows and heads placed among zeros at one rank's shape and
    taken back; a replicated per-head leaf's share; a row-parallel K
    shard cut from a whole input; a column-parallel output of split heads
    kept as it is (none of these calls a collective)."""
    batch, heads, hd = 4, 8, 3
    shards = local_ops.ServeShards(
        mesh=None, model=model, data=data, model_rank=model_rank,
        data_rank=data_rank, batch=batch, kv_heads=heads // model,
        kv_first=0, kv_gather=False, num_heads=heads, num_kv_heads=heads)
    rows, here = batch // data, heads // model
    assert shards.splits(heads) == (model > 1)
    assert shards.heads_here(heads) == here
    t = torch.arange(rows * here * hd, dtype=torch.float32).reshape(
        rows, here, hd) + 1
    full = shards.place(t, 1, heads)
    assert full.shape == (batch, heads, hd)
    mine = full[shards.rows, model_rank * here:(model_rank + 1) * here]
    assert torch.equal(mine, t)
    assert float(full.abs().sum()) == float(t.sum())    # zeros elsewhere
    assert torch.equal(shards.take(full, rows, 1, heads), t)
    leaf = torch.arange(heads * 2, dtype=torch.float32).reshape(heads, 2)
    assert torch.equal(shards.part(leaf, heads, 0),
                       leaf[model_rank * here:(model_rank + 1) * here])
    x = torch.arange(rows * heads * hd, dtype=torch.float32).reshape(
        rows, heads * hd)
    k = heads * hd // model
    assert torch.equal(shards.k_rows(x, k),
                       x[:, model_rank * k:(model_rank + 1) * k])
    if model > 1:
        with pytest.raises(ValueError):
            shards.k_rows(x[:, :k + 1], k)
        cols = x[:, :k]
        assert shards.heads_of(cols, heads, heads * hd) is cols
