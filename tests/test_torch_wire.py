"""PyTorch port: the wire-dtype codec of the expert-parallel exchange
against ``flashmoe_tpu/ops/wire.py`` on the same numpy rows (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmoe_tpu.ops import wire as jwire
from flashmoe_tpu_torch.config import MoEConfig
from flashmoe_tpu_torch.ops import wire as twire

NAMES = ("bf16", "e4m3", "e5m2")


def _rows(seed=0):
    """[6, 64] f32 rows: random, a zero row, a tiny and a huge row."""
    x = np.random.default_rng(seed).standard_normal((6, 64)).astype(
        np.float32)
    x[1] = 0.0
    x[2] *= 1e-6
    x[3] *= 1e6
    return x


def test_names_match_jax():
    for name in (None, *jwire.WIRE_NAMES):
        assert twire.canonical_name(name) == jwire.canonical_name(name)
    for name in NAMES:
        assert twire.is_fp8(twire.resolve(name)) == jwire.is_fp8(
            jwire.resolve(name))
    assert twire.resolve(None) is None and not twire.is_fp8(None)
    with pytest.raises(ValueError, match="unknown wire dtype"):
        twire.resolve("int4")


@pytest.mark.parametrize("name", NAMES)
def test_codec_matches_jax(name):
    """Payload bits, scales, decoded rows and the round-trip error equal
    JAX's (both round to nearest even at the same values)."""
    x = _rows()
    jp, js = jwire.encode(jnp.asarray(x), jwire.resolve(name))
    tp, ts = twire.encode(torch.from_numpy(x), twire.resolve(name))
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.asarray(jp.astype(jnp.float32)))
    if js is None:
        assert ts is None
    else:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert float(ts[1]) == 1.0  # the zero row keeps scale 1
    np.testing.assert_array_equal(
        twire.decode(tp, ts, torch.float32).numpy(),
        np.asarray(jwire.decode(jp, js, jnp.float32)))
    np.testing.assert_array_equal(
        twire.roundtrip(torch.from_numpy(x), twire.resolve(name)).numpy(),
        np.asarray(jwire.roundtrip(jnp.asarray(x), jwire.resolve(name))))
    np.testing.assert_allclose(
        float(twire.roundtrip_error(torch.from_numpy(x),
                                    twire.resolve(name))),
        float(jwire.roundtrip_error(jnp.asarray(x), jwire.resolve(name))),
        rtol=1e-6)
    assert not twire.roundtrip(torch.from_numpy(x), twire.resolve(name))[1] \
        .any()


@pytest.mark.parametrize("name", ["e4m3", "e5m2"])
def test_nonfinite_rows_stay_nonfinite(name):
    x = _rows(1)
    x[0, 5] = np.nan
    x[4, 7] = np.inf
    rt = twire.roundtrip(torch.from_numpy(x), twire.resolve(name))
    assert not bool(torch.isfinite(rt[0]).all())
    assert not bool(torch.isfinite(rt[4]).all())
    assert bool(torch.isfinite(rt[[1, 2, 3, 5]]).all())


def test_config_checks_wires():
    kw = dict(num_experts=8, hidden_size=64, intermediate_size=64, ep=2)
    with pytest.raises(ValueError, match="unknown wire dtype"):
        MoEConfig(**kw, wire_dtype="int4")
    with pytest.raises(ValueError, match="raw slabs"):
        MoEConfig(**kw, wire_dtype="e4m3", moe_backend="fused")
    with pytest.raises(ValueError, match="raw slabs"):
        MoEConfig(**kw, wire_dtype_dcn="bf16", moe_backend="fused")
    cfg = MoEConfig(**kw, wire_dtype="e4m3", wire_dtype_combine="bf16",
                    wire_dtype_dcn="e5m2", dtype=torch.float32)
    assert cfg.wire_dtype == "e4m3"
