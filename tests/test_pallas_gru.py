"""Fused GRU kernel parity tests (Pallas interpreter on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sloika_tpu.nn as nn
from sloika_tpu.nn import pallas_gru

HI = jax.lax.Precision.HIGHEST
F32 = np.dtype(np.float32)


@pytest.fixture(scope="module")
def gru():
    layer = nn.Gru(8, 20, init=nn.truncated_normal(0.4), has_bias=True,
                   impl="xla")
    params = layer.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(0).normal(
        size=(30, 4, 8)).astype(np.float32))
    return layer, params, x


MASK = np.arange(30)[:, None] < np.array([20, 30, 11, 25])[None, :]


def _fused(layer, params, x, **kw):
    return pallas_gru.run_gru_fused(params, layer.input_proj(params, x),
                                    interpret=True, **kw)


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_matches_scan(gru, reverse):
    layer, params, x = gru
    ref = layer.apply(params, x, reverse=reverse)
    out = _fused(layer, params, x, reverse=reverse)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out), atol=1e-6)


def test_fused_masked(gru):
    layer, params, x = gru
    mask = jnp.asarray(MASK)
    ref = layer.apply(params, x, reverse=True, mask=mask)
    out = _fused(layer, params, x, reverse=True, mask=mask)
    d = np.abs(np.asarray(ref - out)) * MASK[:, :, None]
    assert d.max() < 1e-6


def test_fused_gradients_match_scan(gru):
    layer, params, x = gru

    g1 = jax.grad(lambda p: jnp.sum(_fused(layer, p, x) ** 2))(params)
    g2 = jax.grad(lambda p: jnp.sum(layer.apply(p, x) ** 2))(params)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   atol=1e-4)


def test_impl_in_layer(gru):
    """``Gru(impl="interpret")`` routes apply through the kernel."""
    layer, params, x = gru
    kernel_layer = nn.Gru(8, 20, has_bias=True, impl="interpret")
    np.testing.assert_allclose(np.asarray(layer.apply(params, x)),
                               np.asarray(kernel_layer.apply(params, x)),
                               atol=1e-6)


@pytest.mark.parametrize("impl, resolved", [("auto", "xla"), ("xla", "xla"),
                                            ("interpret", "interpret")])
def test_impl_resolved_when_the_layer_is_built(impl, resolved):
    """The layer resolves its implementation once, outside any jit: on the
    CPU "auto" is the XLA scan."""
    assert nn.Gru(8, 20, impl=impl).impl == resolved


def test_compiled_impl_refused_when_built_off_gpu():
    with pytest.raises(ValueError, match="GPU"):
        nn.Gru(8, 20, impl="pallas")


def test_fused_masked_gradients_match_scan(gru):
    """VJP through masked (variable-length) fused runs must match the scan."""
    layer, params, x = gru
    mask = jnp.asarray(MASK)

    def loss(apply):
        return lambda p: jnp.sum((apply(p) * mask[:, :, None]) ** 2)

    g1 = jax.grad(loss(lambda p: _fused(layer, p, x, reverse=True,
                                        mask=mask)))(params)
    g2 = jax.grad(loss(lambda p: layer.apply(p, x, reverse=True,
                                             mask=mask)))(params)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   atol=1e-4)


def test_batch_tail_rows_masked():
    """A batch that is not a multiple of the block rows: the last program's
    tail rows are masked out of loads and stores, forward and backward."""
    rs = np.random.RandomState(1)
    T, B, S = 9, pallas_gru.BLOCK_ROWS + 3, 12
    xp = jnp.asarray(rs.normal(size=(T, B, 3 * S)).astype(np.float32))
    sW = jnp.asarray(rs.normal(scale=0.3, size=(2, S, S)).astype(np.float32))
    sW2 = jnp.asarray(rs.normal(scale=0.3, size=(S, S)).astype(np.float32))
    mask = jnp.ones((T, B), jnp.int8)
    w = jnp.asarray(rs.normal(size=(T, B, S)).astype(np.float32))

    def loss(fn):
        return jax.value_and_grad(lambda *a: jnp.sum(fn(*a) * w),
                                  argnums=(0, 1, 2))(xp, sW, sW2)

    (v1, g1) = loss(lambda *a: pallas_gru.gru_fused(
        *a, mask, False, HI, F32, True))
    (v2, g2) = loss(lambda *a: pallas_gru.reference_scan(
        *a, mask, False, F32, HI))
    assert float(v1) == pytest.approx(float(v2), rel=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("S,Sp", [(1, 16), (16, 16), (17, 32), (110, 128),
                                  (142, 256)])
def test_padded_size(S, Sp):
    assert pallas_gru.padded_size(S) == Sp


def test_bfloat16_operands_match_reference():
    """bf16 matmul operands (the bfloat16 compute policy): the kernel and
    the plain scan round the same values, so they agree to f32 round-off
    of the accumulations."""
    rs = np.random.RandomState(2)
    T, B, S = 12, 5, 24
    xp = jnp.asarray(rs.normal(size=(T, B, 3 * S)).astype(np.float32))
    sW = jnp.asarray(rs.normal(scale=0.3, size=(2, S, S)).astype(np.float32))
    sW2 = jnp.asarray(rs.normal(scale=0.3, size=(S, S)).astype(np.float32))
    mask = jnp.ones((T, B), jnp.int8)
    bf = np.dtype(jnp.bfloat16)
    got = pallas_gru.gru_fused(xp, sW, sW2, mask, True, HI, bf, True)
    ref = pallas_gru.reference_scan(xp, sW, sW2, mask, True, bf, HI)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-2)


def test_reference_scan_matches_layer(gru):
    """The kernel's plain reference is the production XLA scan's maths."""
    layer, params, x = gru
    xp = layer.input_proj(params, x)
    mask = jnp.asarray(MASK)
    with jax.default_matmul_precision("highest"):
        ref = pallas_gru.reference_scan(xp, params["sW"], params["sW2"],
                                        mask.astype(jnp.int8), True, F32, HI)
        out = layer.apply(params, x, reverse=True, mask=mask)
    d = np.abs(np.asarray(ref - out)) * MASK[:, :, None]
    assert d.max() < 1e-6


def test_matmul_precision_follows_context():
    assert pallas_gru.matmul_precision() == jax.lax.Precision.DEFAULT
    with jax.default_matmul_precision("highest"):
        assert pallas_gru.matmul_precision() == HI


@pytest.mark.parametrize("Sp,dtype,wb", [(256, np.float32, 128),
                                         (256, jnp.bfloat16, 256),
                                         (128, np.float32, 128),
                                         (512, jnp.bfloat16, 256)])
def test_block_width_keeps_weight_blocks_in_shared_memory(Sp, dtype, wb):
    assert pallas_gru.block_width(Sp, dtype) == wb


@pytest.mark.parametrize("reverse", [False, True])
def test_column_blocks_match_reference(monkeypatch, reverse):
    """A hidden state split into several column blocks (the float32 path at
    padded width 256) gives the same forward and gradients."""
    monkeypatch.setattr(pallas_gru, "_WEIGHT_BLOCK_BYTES", 16 * 16 * 4)
    assert pallas_gru.block_width(64, np.float32) == 16
    rs = np.random.RandomState(3)
    T, B, S = 8, 5, 40                      # Sp = 64: 4 x 4 blocks of 16
    xp = jnp.asarray(rs.normal(size=(T, B, 3 * S)).astype(np.float32))
    sW = jnp.asarray(rs.normal(scale=0.2, size=(2, S, S)).astype(np.float32))
    sW2 = jnp.asarray(rs.normal(scale=0.2, size=(S, S)).astype(np.float32))
    mask = jnp.asarray((np.arange(T)[:, None]
                        < np.array([8, 5, 8, 3, 7])[None, :]).astype(np.int8))
    w = jnp.asarray(rs.normal(size=(T, B, S)).astype(np.float32))

    def loss(fn):
        return jax.value_and_grad(lambda *a: jnp.sum(fn(*a) * w),
                                  argnums=(0, 1, 2))(xp, sW, sW2)

    v1, g1 = loss(lambda *a: pallas_gru.gru_fused(
        *a, mask, reverse, HI, F32, True))
    v2, g2 = loss(lambda *a: pallas_gru.reference_scan(
        *a, mask, reverse, F32, HI))
    assert float(v1) == pytest.approx(float(v2), rel=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_kernel_shards_over_ambient_mesh():
    """Under an ambient 'data' mesh (parallel.mesh.under_mesh) the kernel
    runs per batch shard (shard_map); forward and gradients equal one
    device's."""
    from sloika_tpu.parallel import mesh as meshlib
    rs = np.random.RandomState(4)
    T, B, S = 6, 8, 20
    xp = jnp.asarray(rs.normal(size=(T, B, 3 * S)).astype(np.float32))
    sW = jnp.asarray(rs.normal(scale=0.3, size=(2, S, S)).astype(np.float32))
    sW2 = jnp.asarray(rs.normal(scale=0.3, size=(S, S)).astype(np.float32))
    mask = jnp.ones((T, B), jnp.int8)
    w = jnp.asarray(rs.normal(size=(T, B, S)).astype(np.float32))

    def loss(xp, sW, sW2):
        return jnp.sum(pallas_gru.gru_fused(xp, sW, sW2, mask, True, HI, F32,
                                            True) * w)

    grad = jax.value_and_grad(loss, argnums=(0, 1, 2))
    v1, g1 = jax.jit(grad)(xp, sW, sW2)
    v4, g4 = meshlib.under_mesh(jax.jit(grad), meshlib.make_mesh(4))(
        xp, sW, sW2)
    # the final sum is reduced across shards in another order
    assert float(v4) == pytest.approx(float(v1), abs=1e-4)
    for a, b in zip(g1, g4):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
