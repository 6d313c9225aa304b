"""PyTorch port: the MoE layer, the transformer and greedy generation
against the JAX package on the same weights and tokens (CPU; the port
runs its plain versions there), plus the port's import hygiene."""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.config import MoEConfig as JaxConfig
from flashmoe_tpu.models import generate as jgen
from flashmoe_tpu.models import presets as jpresets
from flashmoe_tpu.models import transformer as jtf
from flashmoe_tpu.models.reference import init_moe_params
from flashmoe_tpu.ops.moe import moe_layer as jax_moe_layer
from flashmoe_tpu_torch.config import MoEConfig as TorchConfig
from flashmoe_tpu_torch.convert import params_from_numpy
from flashmoe_tpu_torch.models import generate as tgen
from flashmoe_tpu_torch.models import presets as tpresets
from flashmoe_tpu_torch.models import transformer as ttf
from flashmoe_tpu_torch.models.reference import reference_moe
from flashmoe_tpu_torch.ops.moe import moe_layer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="f32", **kw):
    jd, td = _DT[dtype]
    return (JaxConfig(dtype=jd, param_dtype=jnp.float32, **kw),
            TorchConfig(dtype=td, param_dtype=torch.float32, **kw))


def _numpy_tree(init, jc, seed):
    """JAX's parameter tree (shapes from ``init``), filled from numpy:
    cheaper than running JAX's initializer.  JAX gets the numpy arrays,
    the port gets them through params_from_numpy."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        shape = leaf.shape
        if len(shape) == 1:  # norm weights
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        w = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return w.astype(np.float32)

    shapes = jax.eval_shape(lambda k: init(k, jc), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(fill, shapes)


def _layer_inputs(jc, seed=0):
    params = _numpy_tree(init_moe_params, jc, seed)
    x = np.random.default_rng(seed).standard_normal(
        (jc.tokens, jc.hidden_size)).astype(np.float32)
    return params, x


_jax_layer = jax.jit(jax_moe_layer,
                     static_argnames=("cfg", "use_pallas", "interpret"))

LAYER = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=64, sequence_len=32)
DROPLESS_SILU = dict(LAYER, drop_tokens=False, gated_ffn=True,
                     hidden_act="silu")


def _assert_layer(got, want, tol):
    np.testing.assert_allclose(got.out.float().numpy(),
                               np.asarray(want.out, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got.z_loss), float(want.z_loss),
                               rtol=1e-4)


def test_moe_layer_matches_pallas_interpret():
    """The dropless (ragged) arm against JAX's Pallas arm, kernels
    interpreted."""
    jc, tc = _cfgs(**DROPLESS_SILU, router_z_loss_coef=0.01)
    p, x = _layer_inputs(jc)
    want = _jax_layer(p, jnp.asarray(x), jc, use_pallas=True, interpret=True)
    got = moe_layer(params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                    tc)
    _assert_layer(got, want, 2e-4)


@pytest.mark.parametrize("dtype,kw,tol", [
    ("f32", DROPLESS_SILU, 2e-4),
    ("f32", dict(LAYER, drop_tokens=True, capacity_factor=0.5,
                 hidden_act="gelu"), 2e-4),
    ("f32", dict(DROPLESS_SILU, num_shared_experts=1), 2e-4),
    ("f32", dict(LAYER, num_experts=1, expert_top_k=1), 2e-4),
    ("bf16", DROPLESS_SILU, 5e-3),
], ids=["dropless_silu", "capacity_gelu_drops", "shared", "dense_e1",
        "dropless_bf16"])
def test_moe_layer_matches_xla_arm(dtype, kw, tol):
    """Both arms and the E == 1 path against JAX's use_pallas=False arm."""
    jc, tc = _cfgs(dtype, **kw, router_z_loss_coef=0.01)
    p, x = _layer_inputs(jc, seed=len(kw))
    want = _jax_layer(p, jnp.asarray(x, jc.dtype), jc, use_pallas=False)
    got = moe_layer(params_from_numpy(p, device="cpu"),
                    torch.from_numpy(x).to(tc.dtype), tc)
    _assert_layer(got, want, tol)


def test_moe_layer_matches_port_oracle_and_refuses_cpu_kernels():
    jc, tc = _cfgs(**DROPLESS_SILU)
    p, x = _layer_inputs(jc, seed=5)
    tp, tx = params_from_numpy(p, device="cpu"), torch.from_numpy(x)
    want, aux = reference_moe(tp, tx, tc)
    got = moe_layer(tp, tx, tc, use_kernels=False)
    torch.testing.assert_close(got.out, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got.aux_loss, aux * tc.aux_loss_coef,
                               rtol=1e-4, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        moe_layer(tp, tx, tc, use_kernels=True)


MODEL = dict(num_experts=4, expert_top_k=2, hidden_size=64,
             intermediate_size=64, num_layers=2, vocab_size=256,
             num_heads=4, num_kv_heads=2, gated_ffn=True, hidden_act="silu",
             rope_theta=1e6, drop_tokens=False, sequence_len=16)


def _model(moe_frequency):
    jc, tc = _cfgs(**MODEL, moe_frequency=moe_frequency)
    jp = _numpy_tree(jtf.init_params, jc, moe_frequency)
    return jc, tc, jp, params_from_numpy(jp, device="cpu")


def _prompt(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("moe_frequency", [1, 2])
def test_forward_logits_match_jax(moe_frequency):
    """Mixtral-shaped tiny model (GQA 4/2, SwiGLU, dropless) through the
    whole forward."""
    jc, tc, jp, tp = _model(moe_frequency)
    tok = _prompt(2, 12, seed=moe_frequency)
    want, waux = jax.jit(jtf.forward, static_argnums=(2,))(
        jp, jnp.asarray(tok), jc)
    got, gaux = ttf.forward(tp, torch.from_numpy(tok).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-4)


def test_prefill_and_decode_logits_match_jax():
    """Batched prefill, then every decode step's logits, at
    tests/test_generate.py's atol 1e-5."""
    jc, tc, jp, tp = _model(1)
    b, t0, steps = 2, 8, 3
    tok = _prompt(b, t0, seed=7)
    jprefill = jax.jit(jgen.prefill_batched, static_argnums=(1,))
    jdecode = jax.jit(jgen._decode_step, static_argnums=(1,))
    wl, jcache = jprefill(jp, jc, jnp.asarray(tok),
                          jgen.init_cache(jc, b, t0 + steps))
    cache = tgen.init_cache(tc, b, t0 + steps, "cpu")
    gl, cache = tgen.prefill_batched(tp, tc, torch.from_numpy(tok).long(),
                                     cache)
    for i in range(steps + 1):
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0,
                                   atol=1e-5, err_msg=f"step {i}")
        if i == steps:
            break
        nxt = np.argmax(np.asarray(wl), -1)
        wl, jcache = jdecode(jp, jc, jp["embed"][nxt][:, None, :], jcache,
                             jnp.int32(t0 + i))
        gl, cache = tgen._decode_step(tp, tc,
                                      tp["embed"][nxt][:, None, :], cache,
                                      t0 + i)


def test_greedy_generate_tokens_equal_jax():
    jc, tc, jp, tp = _model(2)
    tok = _prompt(2, 8, seed=11)
    want = jgen.generate(jp, jnp.asarray(tok), jc, max_new_tokens=4)
    got = tgen.generate(tp, torch.from_numpy(tok).long(), tc,
                        max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    loop = tgen.generate(tp, torch.from_numpy(tok).long(), tc,
                         max_new_tokens=4, prefill="loop")
    torch.testing.assert_close(loop, got, rtol=0, atol=0)


def test_sampled_generate_and_stop_tokens():
    """Sampling draws from the torch.Generator (top_k=1 is greedy); a stop
    token retires its row to pad_token; an unknown prefill arm raises."""
    _, tc, _, tp = _model(1)
    tok = torch.from_numpy(_prompt(2, 8, seed=3)).long()
    greedy = tgen.generate(tp, tok, tc, max_new_tokens=5)
    top1 = tgen.generate(tp, tok, tc, max_new_tokens=5, temperature=0.7,
                         top_k=1, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(top1, greedy, rtol=0, atol=0)
    draws = [tgen.generate(tp, tok, tc, max_new_tokens=5, temperature=1.0,
                           top_p=0.9,
                           generator=torch.Generator().manual_seed(9))
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    assert ((draws[0] >= 0) & (draws[0] < tc.vocab_size)).all()
    stop = int(greedy[0, 9])
    out = tgen.generate(tp, tok, tc, max_new_tokens=5, stop_tokens=(stop,),
                        pad_token=-1)
    row = out[0, 8:].tolist()
    first = row.index(stop)
    assert row[:first + 1] == greedy[0, 8:8 + first + 1].tolist()
    assert row[first + 1:] == [-1] * (4 - first)
    with pytest.raises(ValueError, match="prefill"):
        tgen.generate(tp, tok, tc, max_new_tokens=1, prefill="chunked")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "flashmoe_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = [(os.path.relpath(f, REPO), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] == "jax" or name == "flashmoe_tpu"
           or name.startswith("flashmoe_tpu.")]
    assert not bad, bad


@pytest.mark.parametrize("kw", [
    dict(num_experts=0), dict(expert_top_k=9), dict(hidden_size=100),
    dict(intermediate_size=100), dict(capacity_factor=0.0),
], ids=["experts", "top_k", "hidden", "intermediate", "capacity"])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as terr:
        TorchConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_config_refuses_unported_knobs_and_matches_capacity():
    from flashmoe_tpu_torch.parallel.mesh import Mesh

    for kw in (dict(dp=2), dict(sp=2), dict(pp=2)):
        (axis, n), = kw.items()
        assert getattr(TorchConfig(**kw), axis) == n  # ported: the mesh
        # across processes the axis waits for the multi-GPU transport
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Mesh(4, (0,), group=object(), **kw)
    assert TorchConfig(ep=2).ep == 2  # ported: parallel/
    assert TorchConfig(ep=2, tp=2).tp == 2  # ported: parallel/ep.py's tp
    for s in (1, 4, 100, 8192):
        for drop in (True, False):
            jc, tc = _cfgs(drop_tokens=drop, num_experts=64)
            assert tc.capacity_for(s) == jc.capacity_for(s)


@pytest.mark.parametrize("name", sorted(tpresets.PRESETS))
def test_presets_match_jax(name):
    j = jpresets.PRESETS[name]()
    t = tpresets.PRESETS[name]()
    for f in dataclasses.fields(t):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if isinstance(tv, torch.dtype):
            assert str(tv).split(".")[-1] == jnp.dtype(jv).name, f.name
        else:
            assert tv == jv, f.name
    assert t.moe_layer_indices == j.moe_layer_indices


def test_params_from_numpy_keeps_bf16():
    tree = {"a": [np.ones((2, 3), jnp.bfloat16)], "b": np.arange(3)}
    out = params_from_numpy(tree, device="cpu")
    assert out["a"][0].dtype == torch.bfloat16
    assert out["b"].tolist() == [0, 1, 2]


def test_entry_points_default_to_the_card():
    """Without a device argument, weights and caches go to the card (or
    follow the generator's device); on a machine without one, asking for
    it raises rather than quietly landing on the CPU."""
    tc = TorchConfig(**LAYER, dtype=torch.float32, num_heads=2,
                     num_layers=1, vocab_size=16)
    p = ttf.init_params(torch.Generator().manual_seed(0), tc)
    assert p["layers"][0]["moe"]["w_up"].device.type == "cpu"
    if torch.cuda.is_available():
        assert params_from_numpy({"a": np.ones(2)})["a"].is_cuda
        assert tgen.init_cache(tc, 1, 4).k.is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError)):
        params_from_numpy({"a": np.ones(2)})
    with pytest.raises((AssertionError, RuntimeError)):
        tgen.init_cache(tc, 1, 4)
