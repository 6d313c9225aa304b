"""PyTorch port: the fused expert-parallel layer, on the CPU through the
kernel's plain version.  Held against the port's collective layer (at all
four schedule names, the in-kernel combine on and off) and the JAX
package's ``ep_moe_layer(use_pallas=False)``, which JAX's own tests hold
equal to its fused layer; its maps and counts against JAX's exactly; its
schedule table and ``src_order`` checks against JAX's errors.  No test
here runs JAX's fused layer itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.ops import dispatch as jdsp
from flashmoe_tpu.ops.gate import router_xla
from flashmoe_tpu.parallel.topology import default_ring as jax_ring
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.ops import dispatch as tdsp
from flashmoe_tpu_torch.parallel import ep as tep
from flashmoe_tpu_torch.parallel import fused
from flashmoe_tpu_torch.parallel.mesh import Mesh, local_mesh
from test_torch_ep import TOL, assert_layer, jax_ep, moe_params, tokens

LAYER = dict(num_experts=8, expert_top_k=2, hidden_size=64,
             intermediate_size=64)
SCHEDULES = ("stream", "resident", "batched", "rowwin")


def _cfgs(**kw):
    return (JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, param_dtype=torch.float32,
                        **kw))


def _skewed(p, x, cfg):
    """Tokens pushed toward expert 0's gate column, so most of them route
    there and the other experts' tiles stay empty or short."""
    g = p["gate_w"][:, 0]
    return x + 4.0 * g[None, :] / np.linalg.norm(g) * np.sqrt(
        cfg.hidden_size)


CASES = {
    # name: (ep, config fields, skew)
    "ep2_cf1.25_cap80": (2, dict(capacity_factor=1.25), False),
    "ep4_cf1.0_gated_shared_stats": (4, dict(
        capacity_factor=1.0, gated_ffn=True, hidden_act="silu",
        num_shared_experts=1, collect_stats=True), False),
    "ep8_dropless_skewed": (8, dict(drop_tokens=False), True),
    "ep4_degrade_stats": (4, dict(degrade_unhealthy_experts=True,
                                  collect_stats=True), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_layer_matches_collective_and_jax(case, monkeypatch):
    """At every schedule name, with the combine off and on: the fused
    layer equals the port's collective layer, which equals JAX's."""
    ep, fields, skew = CASES[case]
    s_loc = 256 if ep == 2 else 32
    jc, tc = _cfgs(**LAYER, sequence_len=s_loc * ep, ep=ep, **fields)
    p = moe_params(tc, seed=ep)
    if tc.degrade_unhealthy_experts:
        p["w_down"][3, 0, 0] = np.nan  # expert 3 (on rank 1) is sick
    x = tokens(tc, seed=ep)
    if skew:
        x = _skewed(p, x, tc).astype(np.float32)
    if case == "ep2_cf1.25_cap80":
        table = fused.schedule_table(tc, ep)
        assert (table["cap_raw"], table["cap"]) == (80, 96)
    want = jax_ep(p, x, jc, ep)
    tp = params_from_numpy(p, device="cpu")
    m = local_mesh(ep)
    coll = tep.ep_moe_layer(tp, torch.from_numpy(x), tc, m)
    assert_layer(coll, want, TOL["f32"])
    for combine in ("0", "1"):
        monkeypatch.setenv("FLASHMOE_FUSED_COMBINE", combine)
        for schedule in SCHEDULES:
            got = fused.fused_ep_moe_layer(
                tp, torch.from_numpy(x),
                tc.replace(moe_backend="fused", fused_schedule=schedule), m)
            assert_layer(got, want, TOL["f32"])
            torch.testing.assert_close(got.out, coll.out, rtol=1e-6,
                                       atol=1e-6)
            if tc.degrade_unhealthy_experts:
                assert float(got.stats.masked_experts) == 4.0
    if skew:
        assert int(coll.expert_counts.max()) > 4 * int(
            coll.expert_counts.min())


def test_sorted_return_maps_and_counts_match_jax():
    """The token-sorted return maps (drops included) and the clamped send
    counts equal JAX's exactly."""
    jc, tc = _cfgs(**LAYER, sequence_len=64, capacity_factor=1.0)
    p = moe_params(tc, 3)
    x = tokens(tc, 3)
    r = router_xla(jnp.asarray(x), jnp.asarray(p["gate_w"]), jc)
    cap, k = 16, 2
    rows_pad = 256
    jplan = jdsp.make_plan(r.expert_idx, jc, cap)
    jpos, jw = jdsp.sorted_return_maps(jplan, r.combine_weights, jc, cap,
                                       rows_pad)
    tplan = tdsp.make_plan(torch.from_numpy(np.array(r.expert_idx)), tc,
                           cap)
    tpos, tw = tdsp.sorted_return_maps(
        tplan, torch.from_numpy(np.array(r.combine_weights)), tc, cap,
        rows_pad)
    assert not bool(tplan.valid.all())  # some assignments dropped
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(
        torch.clamp(tplan.counts, max=cap).numpy(),
        np.minimum(np.asarray(jplan.counts), cap))
    assert k * 64 <= rows_pad


def test_fused_shard_plain_exchanges_and_combines():
    """The plain kernel on stacked ranks: populated rows of the returned
    slabs are the FFN of what the owner received, rows past a count are
    zero, and the combined output is the weighted sum of sorted rows."""
    d, nlx, c, h, i = 2, 2, 32, 64, 64
    g = torch.Generator().manual_seed(0)
    x_send = torch.randn(d, d, nlx, c, h, generator=g)
    send_cnt = torch.tensor([[[5, 0], [32, 7]], [[1, 2], [0, 9]]])
    w_up = torch.randn(d * nlx, h, i, generator=g) / 8
    w_down = torch.randn(d * nlx, i, h, generator=g) / 8
    b_up, b_down = torch.zeros(d * nlx, i), torch.zeros(d * nlx, h)
    args = (send_cnt, fused.default_ring(d), x_send, w_up, b_up, w_down,
            b_down)
    y = fused.fused_shard_plain(*args, act_name="relu")
    # source 0's rows for owner 1, expert 1 (global expert 3)
    want = torch.relu(x_send[0, 1, 1, :7] @ w_up[3]) @ w_down[3]
    torch.testing.assert_close(y[0, 1, 1, :7], want)
    assert not y[0, 1, 1, 7:].any() and not y[1, 1, 0].any()
    # one sorted row per populated slot of each source, k = 2
    ret_pos = torch.zeros(d, d, nlx, c, dtype=torch.int32)
    w_sorted = torch.zeros(d, 128)
    for s in range(d):
        live = torch.arange(c) < send_cnt[s][..., None]
        n = int(live.sum())
        ret_pos[s][live] = torch.arange(n, dtype=torch.int32)
        w_sorted[s, :n] = 0.5
    out = fused.fused_shard_plain(*args, act_name="relu",
                                  recv_pos=ret_pos.transpose(0, 1),
                                  w_sorted=w_sorted, k=2)
    live = torch.arange(c) < send_cnt[0][..., None]
    rows = y[0][live]
    torch.testing.assert_close(out[0, 0], 0.5 * (rows[0] + rows[1]))
    assert out.shape == (d, 64, h)


def _shard_args(gated=True):
    """Small, consistent shard arguments: D 2, nLx 2, C 32, H = I = 64."""
    d, nlx, c, h, i = 2, 2, 32, 64, 64
    g = torch.Generator().manual_seed(1)
    args = dict(send_cnt=torch.full((d, d, nlx), 3), src_order=None,
                x_send=torch.randn(d, d, nlx, c, h, generator=g),
                w_up=torch.randn(d * nlx, h, i, generator=g),
                b_up=torch.zeros(d * nlx, i),
                w_down=torch.randn(d * nlx, i, h, generator=g),
                b_down=torch.zeros(d * nlx, h),
                w_gate=torch.randn(d * nlx, h, i, generator=g)
                if gated else None)
    kw = dict(act_name="silu", gated=gated,
              recv_pos=torch.zeros(d, d, nlx, c, dtype=torch.int32),
              w_sorted=torch.zeros(d, 128), k=2)
    return args, kw


BAD_SHARD_ARGS = {
    # name: (argument changes, keyword changes, message)
    "src_order_not_own_first": (dict(src_order=np.array([[1, 0], [1, 0]])),
                                {}, "row 0 must be a permutation"),
    "src_order_missing_source": (dict(src_order=np.array([[0, 0], [1, 0]])),
                                 {}, "row 0 must be a permutation"),
    "w_gate_shape": (dict(w_gate=torch.zeros(4, 64, 32)), {}, "w_gate is"),
    "w_gate_missing": (dict(w_gate=None), {}, "needs w_gate"),
    "w_down_shape": (dict(w_down=torch.zeros(4, 32, 64)), {}, "w_down is"),
    "b_up_shape": (dict(b_up=torch.zeros(4, 32)), {}, "b_up is"),
    "b_down_shape": (dict(b_down=torch.zeros(2, 64)), {}, "b_down is"),
    "send_cnt_shape": (dict(send_cnt=torch.zeros(2, 2)), {}, "send_cnt is"),
    "recv_pos_shape": ({}, dict(recv_pos=torch.zeros(2, 2, 2, 16)),
                       "recv_pos is"),
    "w_sorted_rows": ({}, dict(w_sorted=torch.zeros(2, 127)),
                      "multiple of k=2"),
}


@pytest.mark.parametrize("wrapper", ["plain", "cuda"])
@pytest.mark.parametrize("case", list(BAD_SHARD_ARGS))
def test_fused_shard_refuses_bad_arguments(case, wrapper):
    """Both shard wrappers refuse a malformed source order or a tensor of
    the wrong shape with ValueError before any work: in the kernel, an
    order that misses a source or a count that disagrees with the slabs
    would leave a wait unmet until it traps.  (The kernel's wrapper checks
    them before it asks for a CUDA tensor, so this runs on the CPU.)"""
    args, kw = _shard_args()
    changes, kw_changes, msg = BAD_SHARD_ARGS[case]
    args.update(changes)
    kw.update(kw_changes)
    fn = {"plain": fused.fused_shard_plain,
          "cuda": fused.fused_shard_cuda}[wrapper]
    with pytest.raises(ValueError, match=msg):
        fn(*args.values(), **kw)
    if wrapper == "plain":
        good, good_kw = _shard_args()
        assert fn(*good.values(), **good_kw).shape == (2, 64, 64)


def test_schedule_table_and_errors():
    """JAX's semantic error for 'batched' at one rank, the automatic
    choice, and the table's geometry."""
    _, tc = _cfgs(**LAYER, sequence_len=64, ep=1)
    with pytest.raises(ValueError, match="needs an ep world of >= 2"):
        fused._fused_schedule(1, "batched")
    assert fused._fused_schedule(1) == "stream"
    assert fused._fused_schedule(2) == "stream"
    assert fused._fused_schedule(4) == "batched"
    t = fused.schedule_table(tc.replace(fused_schedule="batched"), 1)
    assert t["schedule"] == "stream" and t["forced_infeasible"]
    assert t["feasible"] == {"batched": False, "resident": True,
                             "stream": True, "rowwin": True}
    meta = fused.schedule_metadata(tc.replace(ep=4), 4)
    assert meta["schedule"] == "batched" and meta["cap"] % 32 == 0
    assert meta["n_i_chunks"] == 1


def test_task_order_puts_up_tasks_first():
    """Every down task of a unit comes after all the up tasks it waits
    for, at every schedule; batched takes the own slab first."""
    so = fused.default_ring(3)
    for schedule in SCHEDULES:
        order = fused.task_order(so, 2, 2, 3, 2, schedule)
        assert order.shape == (3, 3 * 2 * 2 * 5, 2)
        for r in range(3):
            seen = set()
            for code, kg in order[r]:
                if kg >> 16:
                    assert all((code, j) in seen for j in range(3))
                else:
                    seen.add((code, kg & 0xffff))
            if schedule in ("batched", "rowwin"):
                first = order[r][: 2 * 2 * 5, 0] // (2 * 2)
                assert (first == r).all()


def test_src_order_checks_match_jax():
    """The default is JAX's ring; a malformed order raises JAX's errors."""
    np.testing.assert_array_equal(fused.default_ring(4), jax_ring(4))
    with pytest.raises(ValueError, match=r"src_order must be \[4, 4\]"):
        fused.check_src_order(np.zeros((4, 3), np.int32), 4)
    bad = fused.default_ring(4)
    bad[2] = [3, 2, 1, 0]
    with pytest.raises(ValueError, match="row 2 must be a permutation of "
                       "0..3 starting with 2"):
        fused.check_src_order(bad, 4)
    ok = np.array([[0, 2, 1], [1, 0, 2], [2, 1, 0]])
    assert (fused.check_src_order(torch.from_numpy(ok), 3) == ok).all()


def test_fused_layer_refusals():
    """Wire dtypes, quantized stores (both EP layers), a process mesh,
    and (through the config) wire knobs with the fused backend are
    refused."""
    _, tc = _cfgs(**LAYER, sequence_len=64, ep=2, wire_dtype="bf16")
    p = params_from_numpy(moe_params(tc, 0), device="cpu")
    x = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="cannot honor wire_dtype"):
        fused.fused_ep_moe_layer(p, x, tc, local_mesh(2))
    quantized = dict(p, w_up_qscale=torch.ones(8, 1, 64))
    for layer in (fused.fused_ep_moe_layer, tep.ep_moe_layer):
        with pytest.raises(ValueError, match="quantized expert"):
            layer(quantized, x, tc.replace(wire_dtype=None), local_mesh(2))
    with pytest.raises(NotImplementedError, match="multi-GPU transport"):
        fused.fused_ep_moe_layer(p, x, tc.replace(wire_dtype=None),
                                 Mesh(2, (0,), group=object()))
    with pytest.raises(ValueError, match="raw slabs"):
        tc.replace(moe_backend="fused")
    with pytest.raises(ValueError, match="fused_schedule"):
        tc.replace(fused_schedule="tiled")
