"""The port's ``ServeEngine`` serving the MoE decoders under a device mesh
on CPU gloo ranks, against the one-process port engine and the JAX
package's engine.

ONE spawned group of 4 ranks for this file
(``_torch_dist_worker.spawn_group``) serves every case on a ("data",
"model") mesh of (2, 2), (1, 4) or (4, 1): reduced mixtral-8x7b and
reduced dbrx-132b widened to 8 heads, 4 KV heads and d_model 128 (4
experts, so 4 divides the KV heads and the experts), 2 layers each, on
'ref', 'fused' and 'packed'. The stores are the JAX package's, carried
across (mixtral's with cache bits 4, dbrx's with "auto" and a layerwise
ladder). The same group first runs ``models.mlp.apply_moe`` alone under
shards.

On a serving mesh the router stays whole on every rank and the experts
are split over "model" by expert (``serving.serving_shardings``), each
rank running its whole experts at one rank's shapes. Held: rank 0's
tokens and every step's logits equal the one-process engine's bit for bit
on every mesh; the one-process tokens equal the reference engine's; each
rank's store share and its local expert stacks (E / m whole experts);
the slots' shapes against ``slot_specs``; ``apply_moe`` alone under
shards bit for bit in that layout, and within 1e-6 * max|y| in the d_ff
split a "model" axis that does not divide the experts falls back to (its
``w_down`` partials summed over "model": bit for bit without a "model"
split).
"""
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
import test_torch_serve_mesh as SM
from repro_torch.dist import local_ops
from repro_torch.models import mlp
from test_torch_common import one_torch_thread  # noqa: F401

Y_REL = 1e-6
STORES = {"mixtral_c4": ("mixtral-8x7b", 4, "uniform", SM.WIDE),
          "dbrx_auto": ("dbrx-132b", "auto", "layerwise", SM.WIDE)}
CASES = [((2, 2), "ref", "mixtral_c4"), ((2, 2), "fused", "dbrx_auto"),
         ((2, 2), "packed", "mixtral_c4"),
         ((1, 4), "packed", "dbrx_auto"), ((1, 4), "ref", "mixtral_c4"),
         ((1, 4), "fused", "mixtral_c4"),
         ((4, 1), "fused", "dbrx_auto"), ((4, 1), "packed", "mixtral_c4"),
         ((4, 1), "ref", "dbrx_auto")]
NAMES = [SM.case_name(*c) for c in CASES]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("serve_mesh_moe"))
    out = SM.serve_group(tmp, STORES, CASES,
                         worker=("moe_units", "serve_mesh"))
    units = [dict(np.load(f"{tmp}/moe_units_{r}.npz"))
             for r in range(W.WORLD)]
    return (out["ranks"], out["logits"], out["ones"], out["ref_tokens"],
            out["whole"], units)


@pytest.mark.parametrize("name", NAMES)
def test_rank0_bit_identical_to_one_process(served, name):
    SM.check_rank0_bit_identical(served, name)


@pytest.mark.parametrize("store", list(STORES))
def test_tokens_match_reference(served, store):
    SM.check_tokens_match_reference(
        served, [n for n in NAMES if SM.store_of(n) == store])


@pytest.mark.parametrize("name", NAMES)
def test_store_bytes_per_rank(served, name):
    """Each rank's share of the store, the router whole; its local expert
    stacks are its E / m whole experts (d_ff whole)."""
    SM.check_store_bytes_per_rank(served, name)
    cfg = SM.port_cfg(*STORES[SM.store_of(name)][::3])
    e, m = cfg.moe.num_experts, SM.mesh_of(name)[1]
    d, ff = cfg.d_model, cfg.d_ff
    for r in served[0]:
        assert r[name]["moe_shapes"] == {
            "w_gate": [e // m, d, ff], "w_up": [e // m, d, ff],
            "w_down": [e // m, ff, d]}


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.startswith("mixtral_c4")])
def test_slots_follow_slot_specs(served, name):
    SM.check_slots_follow_slot_specs(served, name, STORES)


@pytest.mark.parametrize("layout", ["experts", "dff"])
@pytest.mark.parametrize("mesh", W.MOE_MESHES)
def test_moe_block_under_shards(served, mesh, layout):
    """``apply_moe`` on each rank's rows, the router whole, and its whole
    experts (bit for bit) or its d_ff slice of every expert (within
    1e-6 * max|y|, bit for bit without a "model" split): the data ranks'
    rows joined in rank order against one rank's."""
    d, m = mesh
    units = served[5]
    inp = {k: torch.from_numpy(v) for k, v in W.moe_block_inputs().items()}
    p = {"router": {"w": inp["router"]}, "w_gate": inp["w_gate"],
         "w_up": inp["w_up"], "w_down": inp["w_down"]}
    want, _ = mlp.apply_moe(inp["x"], p, W.moe_block_cfg())
    # rank r is (r // m, r % m): the model ranks of one data rank agree
    got = [units[r][f"moe_{d}x{m}_{layout}"] for r in range(W.WORLD)]
    for r in range(W.WORLD):
        assert np.array_equal(got[r], got[(r // m) * m])
    have = np.concatenate([got[i * m] for i in range(d)])
    if layout == "experts" or m == 1:
        assert np.array_equal(have, want.numpy())
    np.testing.assert_allclose(have, want.numpy(), rtol=0,
                               atol=Y_REL * float(want.abs().max()))
    assert local_ops.current_shards() is None
