"""PyTorch port: quantized expert stores through expert parallelism, on the
CPU.  The collective layer and the fused layer (the kernel's plain
version, B5q's arm included) on int8 and e4m3 stores against the JAX
package's ``ep_moe_layer(use_pallas=False)`` on JAX's own store of the
same weights; the fused path's refusals; the payloads handed over at
every schedule, and the plain arm against the plain body on weights
dequantized beforehand; a quantized transformer forward.  No test here runs JAX's fused layer itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu import quant as jq
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu_torch import quant as tq
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel import fused
from flashmoe_tpu_torch.parallel.mesh import local_mesh
from test_torch_ep import (TOL, _cfgs, assert_close, assert_layer, jax0,
                           jax_ep, moe_params, tokens)

LAYER = dict(num_experts=8, expert_top_k=2, hidden_size=64,
             intermediate_size=128)
SCHEDULES = ("stream", "resident", "batched", "rowwin")


def _stores(p, qname):
    """JAX's quantized store of numpy params (as numpy), and the port's
    (asserted bit-equal to it)."""
    jstore = jax.tree_util.tree_map(np.asarray, jq.quantize_state(
        {k: jnp.asarray(v) for k, v in p.items()}, qname).params)
    tstore = tq.quantize_state(params_from_numpy(p, device="cpu"),
                               qname).params
    for k, v in jstore.items():
        got = tstore[k]
        if got.dtype == torch.float8_e4m3fn:
            got, v = got.view(torch.uint8), v.view(np.uint8)
        np.testing.assert_array_equal(got.numpy(), v, err_msg=k)
    return jstore, tstore


CASES = {
    # name: (store, ep, config fields)
    "int8_ep2_dropless": ("int8", 2, dict(drop_tokens=False)),
    "e4m3_ep4_gated_shared_stats": ("e4m3", 4, dict(
        capacity_factor=1.0, gated_ffn=True, hidden_act="silu",
        num_shared_experts=1, collect_stats=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ep_layers_on_quantized_store_match_jax(case, monkeypatch):
    """The collective layer, and the fused layer at every schedule name
    with the combine off and on, on a stored quantized state equal JAX's
    collective layer on JAX's store; the default schedule does not depend
    on the store; fake quantization of full-precision weights gives the stored
    state's outputs, and (with stats) JAX's quant_error."""
    qname, ep, fields = CASES[case]
    jc, tc = _cfgs(**LAYER, sequence_len=32 * ep, ep=ep, expert_quant=qname,
                   **fields)
    p = moe_params(tc, seed=ep)
    x = tokens(tc, seed=ep)
    jstore, tstore = _stores(p, qname)
    want = jax_ep(jstore, x, jc, ep)
    m = local_mesh(ep)
    tx = torch.from_numpy(x)
    coll = tep.ep_moe_layer(tstore, tx, tc, m)
    assert_layer(coll, want, TOL["f32"])
    fc = tc.replace(moe_backend="fused")
    assert fused.schedule_table(fc, ep)["schedule"] == (
        "batched" if ep >= 3 else "stream")
    for combine in ("0", "1"):
        monkeypatch.setenv("FLASHMOE_FUSED_COMBINE", combine)
        for schedule in SCHEDULES + (None,):
            got = fused.fused_ep_moe_layer(
                tstore, tx, fc.replace(fused_schedule=schedule), m)
            assert_layer(got, want, TOL["f32"])
            torch.testing.assert_close(got.out, coll.out, rtol=1e-6,
                                       atol=1e-6)
    tp = params_from_numpy(p, device="cpu")
    monkeypatch.setenv("FLASHMOE_FUSED_COMBINE", "0")
    fake = fused.fused_ep_moe_layer(tp, tx, fc, m)
    stored = fused.fused_ep_moe_layer(tstore, tx, fc, m)
    assert torch.equal(fake.out, stored.out)
    if tc.collect_stats:
        jfake = jax_ep(p, x, jc, ep)
        assert float(jfake.stats.quant_error) > 0
        for layer in (fake, tep.ep_moe_layer(tp, tx, tc, m)):
            assert_layer(layer, jfake, TOL["f32"])


def test_fused_path_refusals():
    """Per-K-group scales (JAX's message), a quantized store with the
    knob off, and shard arguments the kernel cannot take: payloads without
    scales, scales not [D * nLx, 1, N], scales beside full-precision
    weights, mixed stores."""
    _, tc = _cfgs(**LAYER, sequence_len=64, ep=2, moe_backend="fused",
                  expert_quant="int8")
    p = params_from_numpy(moe_params(tc, 0), device="cpu")
    x = torch.zeros(64, 64)
    grouped = tq.quantize_state(p, "int8", group_size=32).params
    with pytest.raises(ValueError, match="per-OUTPUT-CHANNEL quant scales "
                       "only"):
        fused.fused_ep_moe_layer(grouped, x, tc, local_mesh(2))
    with pytest.raises(ValueError, match="expert_quant is None"):
        fused.fused_ep_moe_layer(grouped, x, tc.replace(expert_quant=None),
                                 local_mesh(2))
    fi = fused.fused_inputs(tq.quantize_state(p, "int8").params, x, tc,
                            local_mesh(2))
    kw = {k: v for k, v in fi.kw.items() if k != "use_kernels"}
    for fn in (fused.fused_shard_plain, fused.fused_shard_cuda):
        with pytest.raises(ValueError, match="without its scales"):
            fn(*fi.args, **dict(kw, wdn_sc=None))
        with pytest.raises(ValueError, match="scales are"):
            fn(*fi.args, **dict(kw, wup_sc=kw["wup_sc"].reshape(
                8, 2, 64)[:, :1].expand(8, 2, 64)))
        full = fi.args[:3] + tuple(
            a.float() if a is not None and a.dtype == torch.int8 else a
            for a in fi.args[3:])
        with pytest.raises(ValueError, match="no quantized store"):
            fn(*full, **kw)
    e4 = fi.args[5].float().to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="one quantized store"):
        fused.fused_shard_cuda(*fi.args[:5], e4, *fi.args[6:], **kw)


@pytest.mark.parametrize("qname", ["int8", "e4m3"])
def test_every_schedule_hands_over_the_payloads(qname):
    """At every schedule name the layer hands the shard the 1-byte
    payloads with their [E, 1, N] scales (B5q's arguments), and the plain
    arm gives, bit for bit, the plain body's output on the weights
    dequantized beforehand (JAX's boundary dequantization)."""
    _, tc = _cfgs(**LAYER, sequence_len=64, ep=2, moe_backend="fused",
                  gated_ffn=True, hidden_act="silu", expert_quant=qname,
                  drop_tokens=False)
    p = params_from_numpy(moe_params(tc, 2), device="cpu")
    x = torch.from_numpy(tokens(tc, 2))
    store = tq.quantize_state(p, qname).params
    for schedule in SCHEDULES:
        fi = fused.fused_inputs(store, x, tc.replace(fused_schedule=schedule),
                                local_mesh(2))
        kw = {k: v for k, v in fi.kw.items() if k != "use_kernels"}
        assert kw["schedule"] == schedule
        for i, key in ((3, "wup_sc"), (5, "wdn_sc"), (7, "wg_sc")):
            assert fi.args[i].dtype == tq.resolve(qname)
            assert tuple(kw[key].shape) == (8, 1, fi.args[i].shape[-1])
        got = fused.fused_shard_plain(*fi.args, **kw)
        sc = {k: kw.pop(k) for k in ("wup_sc", "wdn_sc", "wg_sc")}
        args = list(fi.args)
        for i, key in ((3, "wup_sc"), (5, "wdn_sc"), (7, "wg_sc")):
            args[i] = tq.dequantize_channelwise(args[i], sc[key],
                                                torch.float32)
        assert torch.equal(got, fused.fused_shard_plain(*args, **kw))


def test_quantized_forward_matches_jax():
    """A 2-layer transformer on an int8 store (quantize_state over the
    tree): the port's forward on one device and over 4 ranks (collective
    and fused) against JAX's forward on JAX's store."""
    kw = dict(num_experts=8, expert_top_k=2, hidden_size=64,
              intermediate_size=64, num_layers=2, vocab_size=64,
              num_heads=2, sequence_len=16, drop_tokens=False, ep=4,
              expert_quant="int8")
    jc, tc = _cfgs(**kw)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda k: jtf.init_params(k, jc),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(s.shape[-2] if len(s.shape) > 1 else 1)
                   ).astype(np.float32), shapes)
    # jitted, JAX's scales may differ from its eager ones (and the
    # port's) in the last bit: XLA turns the division by qmax into a
    # product with its reciprocal
    jstore = jax.jit(lambda t: jq.quantize_state(t, "int8").params)(params)
    tstore = tq.quantize_state(params_from_numpy(params, device="cpu"),
                               "int8").params
    assert tq.quant_metadata(tstore) == jq.quant_metadata(jstore)
    tok = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    want, _ = jax0(jtf.forward, jstore, jnp.asarray(tok),
                   cfg=jc.replace(ep=1))
    one, _ = ttf.forward(tstore, torch.from_numpy(tok).long(),
                         tc.replace(ep=1))
    assert_close(one, want, TOL["f32"])
    for backend in ("collective", "fused"):
        got, _ = ttf.forward(tstore, torch.from_numpy(tok).long(),
                             tc.replace(moe_backend=backend),
                             mesh=local_mesh(4))
        torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-5)
