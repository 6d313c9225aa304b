"""PyTorch port: flash attention against the JAX package, on the same
numpy inputs (CPU; the port runs the kernel's plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test worker

from flashmoe_tpu.ops.attention import attention_xla, flash_attention
from flashmoe_tpu_torch.ops import attention as tatt

_attention_xla = jax.jit(attention_xla, static_argnames=("causal",))


def _qkv(b, n, nkv, t, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, t, d)).astype(np.float32)
    k = rng.standard_normal((b, nkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, nkv, t, d)).astype(np.float32)
    return q, k, v


def test_flash_matches_pallas_interpret():
    """The plain flash attention against the TPU kernel itself
    (interpret), f32 at tests/test_attention.py's 2e-4."""
    q, k, v = _qkv(1, 2, 2, 128, 64)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, block_q=64, block_k=64,
                           interpret=True)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("causal,n,nkv,t", [(True, 4, 4, 40),
                                            (False, 4, 4, 40),
                                            (True, 8, 2, 72)],
                         ids=["causal", "full", "gqa"])
def test_flash_matches_attention_xla(causal, n, nkv, t):
    """Against the XLA oracle with GQA heads repeated as jnp.repeat does;
    T is not a multiple of any block."""
    q, k, v = _qkv(2, n, nkv, t, 64, seed=t)
    kr, vr = (np.repeat(a, n // nkv, axis=1) for a in (k, v))
    want = _attention_xla(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                          causal=causal)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_kernel_refuses_what_it_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 2, 16, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_attention(q, k, v, use_kernels=True)
    with pytest.raises(ValueError, match="cuda"):
        tatt.flash_attention_cuda(q, k, v)
    for d in (260, 320):  # head dims past the kernel's 256
        qd, kd, vd = map(torch.from_numpy, _qkv(1, 2, 2, 16, d))
        with pytest.raises(ValueError, match="head dim"):
            tatt.flash_attention_cuda(qd, kd, vd)
    with pytest.raises(ValueError, match="shapes"):
        tatt.flash_attention(q, k[:, :, :8], v[:, :, :8])


@pytest.mark.parametrize("t", [200, 256])
@pytest.mark.parametrize("d", [32, 80, 96, 256])
def test_flash_plain_at_other_head_dims(d, t):
    """The kernel's other head dims (D % 8 == 0 up to 256): the plain
    flash attention, GQA, against JAX's ``attention_xla`` and, where T is
    a multiple of its 128-query block, its ``flash_attention`` in
    interpret mode, f32 at 2e-4."""
    q, k, v = _qkv(1, 4, 2, t, d, seed=d + t)
    kr, vr = (np.repeat(a, 2, axis=1) for a in (k, v))
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    want = _attention_xla(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                          causal=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    if t % 128 == 0:
        want = flash_attention(jnp.asarray(q), jnp.asarray(kr),
                               jnp.asarray(vr), causal=True, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("d", [8, 32, 80, 96, 192, 256])
def test_flash_args_take_every_kernel_head_dim(monkeypatch, d):
    """The launch's arguments carry D and the true D's scale, at every
    head dim the kernel takes."""
    from flashmoe_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 2, 24, d))
    args, o = tatt.flash_args(q, k, v)
    assert len(args) == len(_build.SIGNATURES["fm_flash_attention"])
    assert args[5:10] == (2, 4, 2, 24, d)
    assert args[10] == d ** -0.5 and o.shape == q.shape
    assert tatt.flash_head_dim_ok(d)


@pytest.mark.parametrize("d", [4, 36, 100, 250])
def test_flash_pad_keeps_the_true_head_dim(monkeypatch, d):
    """A head dim off the launch's step of 8: q, k and v copied with zero
    columns up to the next multiple, launched at the true D's scale; the
    kernel's arithmetic (``flash_walk_plain``) on those copies, cut to D
    columns, equals it at D (1e-6) and JAX's ``attention_xla`` at D (f32,
    2e-4)."""
    from flashmoe_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    qn, kn, vn = _qkv(1, 4, 2, 40, d, seed=d)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    qp, kp, vp = tatt.flash_pad(q, k, v)
    dp = -(-d // 8) * 8
    for a, b in ((q, qp), (k, kp), (v, vp)):
        assert b.shape[-1] == dp and tatt.flash_head_dim_ok(dp)
        assert torch.equal(b[..., :d], a) and not b[..., d:].any()
    args, o = tatt.flash_args(qp, kp, vp, scale=d ** -0.5)
    assert args[9] == dp and args[10] == d ** -0.5 and o.shape[-1] == dp
    got = tatt.flash_walk_plain(qp, kp, vp, scale=d ** -0.5)[..., :d]
    torch.testing.assert_close(got, tatt.flash_walk_plain(q, k, v),
                               rtol=1e-6, atol=1e-6)
    kr, vr = (np.repeat(a, 2, axis=1) for a in (kn, vn))
    want = _attention_xla(jnp.asarray(qn), jnp.asarray(kr), jnp.asarray(vr),
                          causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("d", [36, 320, 4, 64, 96, 256])
def test_flash_route_reaches_the_kernel_at_every_head_dim(monkeypatch, d):
    """On the kernel's route every head dim reaches
    ``flash_attention_cuda`` (here a stand-in: no card): no head dim is
    sent to the plain version by its shape; past 256 the kernel itself
    raises."""
    from flashmoe_tpu_torch.kernels import _build

    calls = []

    def kernel_fn(q, k, v, *, causal=True):
        calls.append(q.shape[-1])
        return tatt.flash_attention_plain(q, k, v, causal=causal)

    monkeypatch.setattr(_build, "use_kernels_for", lambda t, uk: True)
    monkeypatch.setattr(tatt, "flash_attention_cuda", kernel_fn)
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 20, d, seed=d))
    got = tatt.flash_attention(q, k, v)
    torch.testing.assert_close(got, tatt.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    assert calls == [d]
    assert tatt.flash_head_dim_ok(d) == (d % 8 == 0 and d <= 256)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_serving_cli_width_is_jaxs_on_every_device(monkeypatch, device):
    """``python -m flashmoe_tpu_torch.serving`` builds JAX's default
    model, ``--hidden 64`` (two heads of 32), on the card and on the CPU;
    the fabric drills' model is JAX's ``tiny_config()`` on every device."""
    from flashmoe_tpu.serving import loadgen as jload
    from flashmoe_tpu_torch.chaos import drill as tdrill
    from flashmoe_tpu_torch.serving import __main__ as tcli
    from flashmoe_tpu_torch.serving import loadgen as tload

    seen = {}

    class Built(Exception):
        pass

    def capture(**kw):
        seen.update(kw)
        raise Built

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tload, "tiny_config", capture)
    with pytest.raises(Built):
        tcli.main(["--device", device])
    assert seen["hidden"] == 64 == jload.tiny_config().hidden_size
    monkeypatch.undo()
    cfg = tdrill.fabric_drill_config()
    assert cfg == tload.tiny_config()
    assert cfg.resolved_head_dim == 32
