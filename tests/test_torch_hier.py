"""PyTorch port: the collective layer's two-stage exchange
(``flashmoe_tpu_torch/parallel/ep.py``: ``_hier_stage``,
``_hierarchical_a2a``, ``_staged_wired``' per-hop codec, ``dcn_inner``)
against JAX's ``ep_moe_layer(..., dcn_inner=...)`` on the 8-device CPU
mesh, on the same numpy inputs.

f32 at 2e-4 (``tests/test_moe_layer.py``); with an fp8 hop on f32 rows
both sides decode the same fp8 payloads and the expert GEMMs sum them in
another order, so 1e-3.  Under a bf16 leg wire the fp8 hop encodes
bf16-valued rows, and XLA's jit computes ``x / scale`` as ``x * (1 /
scale)``: some of such values (291 of 262 144 normal ones) land on the
other side of an fp8 rounding boundary than in JAX's eager encode, which
the port's encode equals bit for bit.  That case is held at JAX's own fp8-hop tolerance
(``tests/test_multislice.py``: atol 0.25).  Without a wire the port's
two-stage output equals its flat one bit for bit, and a bootstrapped
runtime's blocking is what ``dcn_inner=None`` runs."""

import numpy as np
import pytest
import torch

from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from flashmoe_tpu_torch.runtime import bootstrap as tboot
from test_torch_ep import LAYER, TOL, _cfgs, assert_layer, jax_ep, \
    moe_params, tokens

FP8 = 1e-3
# name: (ep, dcn_inner, config fields, tolerance)
CASES = {
    "ep8_inner2": (8, 2, {}, TOL["f32"]),
    "ep8_inner4": (8, 4, {}, TOL["f32"]),
    "ep8_inner2_dcn_e4m3": (8, 2, dict(wire_dtype_dcn="e4m3",
                                       collect_stats=True), FP8),
    "ep8_inner4_dcn_e4m3": (8, 4, dict(wire_dtype_dcn="e4m3",
                                       collect_stats=True), FP8),
    "ep8_inner4_bf16_legs_dcn_e4m3": (8, 4, dict(
        wire_dtype="bf16", wire_dtype_combine="bf16",
        wire_dtype_dcn="e4m3"), 0.25),
    "ep4_inner2_chunked_dcn_e5m2": (4, 2, dict(
        num_experts=16, a2a_chunks=2, wire_dtype_dcn="e5m2"), FP8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_stage_exchange_matches_jax(case):
    ep, inner, fields, tol = CASES[case]
    jc, tc = _cfgs("f32", **{**LAYER, "sequence_len": 32 * ep, "ep": ep,
                             "drop_tokens": False, **fields})
    p = moe_params(tc, seed=inner)
    x = tokens(tc, seed=inner)
    want = jax_ep(p, x, jc, ep, dcn_inner=inner)
    tp = params_from_numpy(p, device="cpu")
    got = tep.ep_moe_layer(tp, torch.from_numpy(x), tc, local_mesh(ep),
                           dcn_inner=inner)
    wired = tc.wire_dtype_dcn is not None
    if tol > FP8:
        np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                                   atol=tol)
    else:
        assert_layer(got, want, tol)
    if not wired:
        flat = tep.ep_moe_layer(tp, torch.from_numpy(x), tc,
                                local_mesh(ep), dcn_inner=0)
        assert torch.equal(got.out, flat.out)
    else:
        # the knob is inert on the flat exchange (no cross-slice hop)
        flat = tep.ep_moe_layer(tp, torch.from_numpy(x), tc,
                                local_mesh(ep), dcn_inner=0)
        plain = tep.ep_moe_layer(tp, torch.from_numpy(x),
                                 tc.replace(wire_dtype_dcn=None),
                                 local_mesh(ep), dcn_inner=0)
        assert torch.equal(flat.out, plain.out)


def test_runtime_blocking_drives_the_layer(monkeypatch):
    """``dcn_inner=None`` reads the bootstrapped runtime's blocking of
    its own world (mocked two slices of 4): the same bits as an explicit
    ``dcn_inner=4``; 0 forces the flat exchange."""
    monkeypatch.setenv("FLASHMOE_MOCK_SLICES", "2")
    _, tc = _cfgs("f32", **{**LAYER, "sequence_len": 256, "ep": 8,
                            "drop_tokens": False,
                            "wire_dtype_dcn": "e4m3"})
    p = params_from_numpy(moe_params(tc, seed=3), device="cpu")
    x = torch.from_numpy(tokens(tc, seed=3))
    tboot.finalize()
    try:
        rt = tboot.initialize(tc, devices=8, device="cpu")
        assert rt.dcn_inner == 4
        mesh = local_mesh(8)
        auto = tep.ep_moe_layer(p, x, tc, mesh)
        explicit = tep.ep_moe_layer(p, x, tc, mesh, dcn_inner=4)
        flat = tep.ep_moe_layer(p, x, tc, mesh, dcn_inner=0)
        assert torch.equal(auto.out, explicit.out)
        assert not torch.equal(auto.out, flat.out)  # the fp8 hop
        # another world's mesh (2 ranks) runs flat
        small = tc.replace(ep=2, sequence_len=64)
        got = tep.ep_moe_layer(p, x[:64], small, local_mesh(2))
        want = tep.ep_moe_layer(p, x[:64], small, local_mesh(2),
                                dcn_inner=0)
        assert torch.equal(got.out, want.out)
    finally:
        tboot.finalize()
    assert np.isfinite(auto.out.numpy()).all()
