"""PyTorch port: quantized expert storage (``flashmoe_tpu_torch.quant``)
against the JAX package's ``flashmoe_tpu.quant`` on the same numpy
inputs: the codec bit for bit, the state and its metadata block, the
calibration, the config's refusals, and the single-device MoE layer on a
quantized store (CPU; the port runs its plain versions there)."""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu import quant as jq
from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.models.reference import init_moe_params
from flashmoe_tpu.ops.moe import moe_layer as jax_moe_layer
from flashmoe_tpu_torch import quant as tq
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from flashmoe_tpu_torch.ops.moe import moe_layer

# the packages export the function ``calibrate`` over the module's name
jcal = importlib.import_module("flashmoe_tpu.quant.calibrate")
tcal = importlib.import_module("flashmoe_tpu_torch.quant.calibrate")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's f32 oracle tolerance (tests/test_moe_layer.py)
TOL = 2e-4
LAYER = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=64, sequence_len=32, gated_ffn=True,
             hidden_act="silu")

_jax_layer = jax.jit(jax_moe_layer,
                     static_argnames=("cfg", "use_pallas", "interpret"))


def _cfgs(**kw):
    return (JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=torch.float32, param_dtype=torch.float32,
                        **kw))


def _np(t):
    """A port tensor as numpy; float8 as its raw bytes."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_np(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _weights(seed, shape=(3, 64, 96)):
    """f32 weights with channels of very different scales, an all-zero
    channel, a channel hitting +-127 exactly and a tiny value."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape)
         * rng.uniform(1e-3, 1e2, (1, 1, shape[-1]))).astype(np.float32)
    w[1, :, 5] = 0.0
    w[2, :, 9] = 127.0
    w[2, 0, 9] = -127.0
    w[0, 3, 7] = 1e-30
    return w


def _layer_params(jc, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_moe_params(k, jc),
                            jax.random.PRNGKey(0))
    p = {k: (rng.standard_normal(v.shape) / np.sqrt(v.shape[-2] if
                                                   v.ndim > 1 else 1)
             ).astype(np.float32) for k, v in shapes.items()}
    p["b_up"] *= 0.1
    p["b_down"] *= 0.1
    x = rng.standard_normal((jc.tokens, jc.hidden_size)).astype(np.float32)
    return p, x


def _quantized_pair(p, qname):
    """JAX's quantized store of numpy params, and the port's of the same
    params (asserted bit-equal)."""
    jstate = jq.quantize_state({k: jnp.asarray(v) for k, v in p.items()},
                               qname)
    tstate = tq.quantize_state(params_from_numpy(p, device="cpu"), qname)
    for k, v in jstate.params.items():
        np.testing.assert_array_equal(_np(tstate.params[k]), _jnp_np(v),
                                      err_msg=k)
    return jstate, tstate


@pytest.mark.parametrize("qname", ["int8", "e4m3"])
@pytest.mark.parametrize("group_size,clip", [(None, None), (16, None),
                                             (None, "percentile")],
                         ids=["channel", "group16", "clip"])
def test_codec_matches_jax_bit_for_bit(qname, group_size, clip):
    """Payloads and scales equal JAX's bit for bit, with zero channels,
    +-127, a tiny value, K-groups and an absmax clip; dequantization to f32
    and to bf16 too."""
    w = _weights(len(qname) + (group_size or 0))
    c = (np.percentile(np.abs(w), 99.0, axis=-2, keepdims=True)
         .astype(np.float32) if clip else None)
    jp, js = jq.quantize_channelwise(jnp.asarray(w), qname,
                                     group_size=group_size, clip=c)
    tp, ts = tq.quantize_channelwise(torch.from_numpy(w), qname,
                                     group_size=group_size,
                                     clip=None if c is None
                                     else torch.from_numpy(c))
    assert tp.dtype == tq.resolve(qname)
    np.testing.assert_array_equal(_np(tp), _jnp_np(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1, :, 5].min()) == 1.0  # the zero channel
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = jq.dequantize_channelwise(jp, js, jd).astype(jnp.float32)
        got = tq.dequantize_channelwise(tp, ts, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


@pytest.mark.parametrize("qname", ["int8", "e4m3"])
def test_roundtrip_and_its_error_match_jax(qname):
    w = _weights(3, (3, 128, 64))
    want = jq.roundtrip(jnp.asarray(w), qname)
    got = tq.roundtrip(torch.from_numpy(w), qname)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for gs in (None, 32):
        np.testing.assert_allclose(
            float(tq.roundtrip_error(torch.from_numpy(w), qname,
                                     group_size=gs)),
            float(jq.roundtrip_error(jnp.asarray(w), qname, group_size=gs)),
            rtol=1e-5)
    assert tq.weight_itemsize(qname, torch.bfloat16) == \
        jq.weight_itemsize(qname, jnp.bfloat16) == 1.0
    assert tq.weight_itemsize(None, torch.bfloat16) == \
        jq.weight_itemsize(None, jnp.bfloat16)
    assert tq.scale_overhead_bytes(qname, 64, 4) == \
        jq.scale_overhead_bytes(qname, 64, 4)
    assert tq.canonical_name(qname.upper()) == jq.canonical_name(qname)


def test_names_and_errors_match_jax():
    assert tq.QUANT_NAMES == jq.QUANT_NAMES
    for name in ("i8", "fp8", "float8_e4m3fn", None):
        assert tq.canonical_name(name) == jq.canonical_name(name)
    with pytest.raises(ValueError) as jerr:
        jq.canonical_name("int4")
    with pytest.raises(ValueError) as terr:
        tq.canonical_name("int4")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jq.quantize_channelwise(jnp.ones((2, 64, 8)), "int8", group_size=24)
    with pytest.raises(ValueError) as terr:
        tq.quantize_channelwise(torch.ones(2, 64, 8), "int8", group_size=24)
    assert str(terr.value) == str(jerr.value)


def _tree(jc, seed):
    """A 2-layer transformer tree from numpy, shapes from JAX's init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jtf.init_params(k, jc),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(s.shape[-2] if len(s.shape) > 1 else 1)
                   ).astype(np.float32), shapes)


MODEL = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=64, num_layers=2, vocab_size=128,
             num_heads=4, num_kv_heads=2, gated_ffn=True, hidden_act="silu",
             drop_tokens=False, sequence_len=16)


@pytest.mark.parametrize("kind", ["flat", "tree"])
@pytest.mark.parametrize("qname", ["int8", "e4m3"])
def test_state_metadata_and_bytes_match_jax(kind, qname):
    """quantize_state / dequantize_state on a flat MoE dict and on a
    2-layer transformer tree (one dense layer), the metadata block with
    its crc32, and the bytes saved, all equal to JAX's."""
    if kind == "flat":
        jc, _ = _cfgs(**LAYER)
        p, _ = _layer_params(jc, 1)
    else:
        jc, _ = _cfgs(**MODEL, moe_frequency=2)
        p = _tree(jc, 2)
    jtree = jax.tree_util.tree_map(jnp.asarray, p)
    jstate = jq.quantize_state(jtree, qname)
    tstate = tq.quantize_state(params_from_numpy(p, device="cpu"), qname)
    jl, jdef = jax.tree_util.tree_flatten_with_path(jstate.params)
    tl = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(_np, tstate.params,
                               is_leaf=lambda t: torch.is_tensor(t)))[0]
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(b, _jnp_np(a), err_msg=str(path))
    assert tstate.meta == jstate.meta
    assert tq.verify_quant_metadata(tstate.meta)
    assert not tq.verify_quant_metadata(dict(tstate.meta, dtype="int4"))
    assert tq.verify_quant_metadata(None) and tq.quant_metadata(p) is None
    assert tq.is_quantized(tstate.params) and not tq.is_quantized(
        params_from_numpy(p, device="cpu"))
    for full_j, full_t in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
        assert tq.quant_bytes_saved(tstate.params, full_t) == \
            jq.quant_bytes_saved(jstate.params, full_j)
    jback = jq.dequantize_state(jstate)
    tback = tstate.dequantize()
    jl = jax.tree_util.tree_leaves(jback)
    tl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        _np, tback, is_leaf=lambda t: torch.is_tensor(t)))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_calibration_matches_jax_on_a_shared_sample():
    """The same percentile wins and every candidate's output error agrees
    (the f32 sums run in another order); the clips equal JAX's
    ``jnp.percentile``; the winner's clip quantizes to JAX's payloads."""
    jc, tc = _cfgs(**LAYER)
    p, _ = _layer_params(jc, 4)
    p["w_up"][0, :3, :] *= 40.0  # heavy-tailed channels
    sample = np.random.default_rng(5).standard_normal(
        (256, jc.hidden_size)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    want = jcal.calibrate(jp, jc, "int8", sample=jnp.asarray(sample))
    got = tcal.calibrate(tp, tc, "int8", sample=torch.from_numpy(sample))
    assert got.percentile == want.percentile and got.qname == want.qname
    assert got.report.keys() == want.report.keys()
    for k in want.report:
        np.testing.assert_allclose(got.report[k], want.report[k],
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(got.output_rel_err, want.output_rel_err,
                               rtol=1e-5)
    for pct in (99.99, 99.5, 37.0):
        np.testing.assert_allclose(
            tcal._channel_percentile(tp["w_down"], pct).numpy(),
            np.asarray(jcal._channel_percentile(jp["w_down"], pct)),
            rtol=1e-6, atol=0)
    jq_state = jq.quantize_state(jp, "int8", calibration=want)
    tq_state = tq.quantize_state(tp, "int8", calibration=got)
    np.testing.assert_array_equal(tq_state.params["w_up"].numpy(),
                                  np.asarray(jq_state.params["w_up"]))
    g = torch.Generator().manual_seed(0)
    s = tcal.activation_sample(tc, 8, generator=g)
    assert s.shape == (8, 64) and s.dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(expert_quant="int4"), dict(expert_quant="int8", is_training=True),
    dict(expert_quant="e4m3", tp=2)], ids=["unknown", "training", "tp"])
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as terr:
        TorchConfig(**kw)
    assert str(terr.value) == str(jerr.value)
    for name in ("int8", "e4m3", "fp8"):
        assert TorchConfig(expert_quant=name,
                           moe_backend="fused").expert_quant == name


def _assert_layer(got, want, tol=TOL):
    np.testing.assert_allclose(got.out.float().numpy(),
                               np.asarray(want.out, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    if want.stats is not None:
        # the other fields' arm differs: JAX's use_pallas=False layer runs
        # a dropless config through its capacity arm
        np.testing.assert_allclose(float(got.stats.quant_error),
                                   float(want.stats.quant_error), rtol=1e-5,
                                   atol=1e-7)


LAYER_CASES = {
    "int8_dropless": ("int8", dict(drop_tokens=False)),
    "e4m3_capacity": ("e4m3", dict(capacity_factor=1.0)),
    "int8_dropless_gather_stats": ("int8", dict(
        drop_tokens=False, gather_fused=True, collect_stats=True)),
    "e4m3_shared": ("e4m3", dict(drop_tokens=False, num_shared_experts=1)),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_on_quantized_store_matches_jax(case):
    """``moe_layer`` on a stored quantized f32 state against JAX
    ``moe_layer(use_pallas=False)`` on JAX's own store of the same
    weights; fake quantization of the full-precision weights equals the
    stored state bit for bit, and its stats carry JAX's quant_error."""
    qname, fields = LAYER_CASES[case]
    kw = dict(LAYER, expert_quant=qname, **fields)
    jc, tc = _cfgs(**{k: v for k, v in kw.items() if k != "gather_fused"})
    tc = tc.replace(gather_fused=kw.get("gather_fused"))
    p, x = _layer_params(jc, len(case))
    jstate, tstate = _quantized_pair(p, qname)
    want = _jax_layer(jstate.params, jnp.asarray(x), jc, use_pallas=False)
    got = moe_layer(tstate.params, torch.from_numpy(x), tc)
    _assert_layer(got, want)
    fake = moe_layer(params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                     tc)
    assert torch.equal(fake.out, got.out)
    if tc.collect_stats:
        assert float(got.stats.quant_error) == 0.0  # a stored state
        jfake = _jax_layer({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jc, use_pallas=False)
        _assert_layer(fake, jfake)
        assert float(fake.stats.quant_error) > 0.0


def test_quant_off_refuses_a_quantized_store_as_jax_does():
    jc, tc = _cfgs(**LAYER, drop_tokens=False)
    p, x = _layer_params(jc, 7)
    jstate, tstate = _quantized_pair(p, "int8")
    with pytest.raises(ValueError) as jerr:
        _jax_layer(jstate.params, jnp.asarray(x), jc, use_pallas=False)
    with pytest.raises(ValueError) as terr:
        moe_layer(tstate.params, torch.from_numpy(x), tc)
    assert str(terr.value) == str(jerr.value)
    dense = tq.quantize_state(params_from_numpy(
        {k: v[:1] if k != "gate_w" else v for k, v in p.items()},
        device="cpu"), "int8").params
    d1 = tc.replace(num_experts=1, expert_top_k=1)
    with pytest.raises(ValueError, match="expert_quant is None"):
        moe_layer(dense, torch.from_numpy(x), d1)
    # a stored dense layer dequantizes under the knob
    got = moe_layer(dense, torch.from_numpy(x), d1.replace(
        expert_quant="int8"))
    want = moe_layer(tq.dequantize_state(dense), torch.from_numpy(x), d1)
    assert torch.equal(got.out, want.out)


def test_convert_carries_quantized_stores_across():
    """JAX's e4m3 and int8 payloads cross ``params_from_numpy`` bit for
    bit, with their dtypes."""
    jc, _ = _cfgs(**LAYER)
    p, _ = _layer_params(jc, 8)
    for qname, want in (("e4m3", torch.float8_e4m3fn), ("int8", torch.int8)):
        jstate = jq.quantize_state({k: jnp.asarray(v) for k, v in p.items()},
                                   qname)
        host = jax.tree_util.tree_map(np.asarray, jstate.params)
        got = params_from_numpy(host, device="cpu")
        assert got["w_up"].dtype == want
        assert got["w_up_qscale"].dtype == torch.float32
        for k, v in host.items():
            np.testing.assert_array_equal(_np(got[k]), _jnp_np(v))
    one = tensor_from_numpy(np.asarray(jnp.asarray([0.5, -448.0, 3.0],
                                                   jnp.float8_e4m3fn)),
                            device="cpu")
    assert one.float().tolist() == [0.5, -448.0, 3.0]


def test_quant_package_imports_no_jax():
    """The port's quant subpackage (walked by the port-wide import test
    too) imports neither JAX nor the JAX package."""
    root = os.path.join(REPO, "flashmoe_tpu_torch", "quant")
    files = sorted(os.path.join(root, n) for n in os.listdir(root)
                   if n.endswith(".py"))
    assert [os.path.basename(f) for f in files] == [
        "__init__.py", "calibrate.py", "core.py", "state.py"]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in
                    ("jax", "flashmoe_tpu")], (path, names)
