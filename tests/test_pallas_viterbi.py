"""Viterbi kernel parity tests (Pallas interpreter on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sloika_tpu.ops import decode_jax, decode_np
from sloika_tpu.ops.pallas import viterbi as pallas_viterbi


def _kernel(post, klen=5, **kw):
    return pallas_viterbi.viterbi(post, klen, interpret=True, **kw)


def _assert_same(a, b, rtol=0.0):
    (s1, p1, m1), (s2, p2, m2) = a, b
    if rtol:
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=rtol)
    else:
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))


@pytest.mark.parametrize("skip_pen", [0.0, 3.0])
def test_kernel_matches_xla(skip_pen):
    rs = np.random.RandomState(0xF00D)
    post = rs.dirichlet(np.full(1025, 0.05), size=(4, 40)).astype(np.float32)
    _assert_same(decode_jax.viterbi(jnp.asarray(post), 5, skip_pen=skip_pen),
                 _kernel(jnp.asarray(post), skip_pen=skip_pen), rtol=1e-6)


@pytest.mark.parametrize("skip_pen", [0.0, 3.0])
def test_derived_skip_max_tie_breaking(skip_pen):
    """The skip maximum derived from the step maxima must break ties like a
    direct first-wins argmax (the XLA decoder's); quantised posteriors make
    equal scores from distinct predecessors abundant."""
    rs = np.random.RandomState(7)
    post = rs.dirichlet(np.full(1025, 0.05), size=(3, 30)).astype(np.float32)
    post = np.round(post * 8) / 8 + 1e-3
    _assert_same(decode_jax.viterbi(jnp.asarray(post), 5, skip_pen=skip_pen),
                 _kernel(jnp.asarray(post), skip_pen=skip_pen))


def test_bfloat16_posterior_streaming_exact_after_rounding():
    """bf16 posterior input: the kernel upcasts after the load, so results
    are exact w.r.t. the bf16-rounded posterior — the kernel fed the same
    values in f32 must agree bit for bit."""
    rs = np.random.RandomState(11)
    post = rs.dirichlet(np.full(1025, 0.05), size=(3, 30)).astype(np.float32)
    post_bf = jnp.asarray(post).astype(jnp.bfloat16)
    _assert_same(_kernel(post_bf, skip_pen=3.0),
                 _kernel(post_bf.astype(jnp.float32), skip_pen=3.0))


def test_kernel_matches_numpy_oracle():
    rs = np.random.RandomState(42)
    post = rs.dirichlet(np.full(65, 0.1), size=(2, 25)).astype(np.float32)
    s, p, m = _kernel(jnp.asarray(post), klen=3, skip_pen=2.0)
    for b in range(2):
        ref_score, ref_path = decode_np.viterbi(post[b].astype(np.float64), 3,
                                                skip_pen=2.0)
        got = decode_jax.collapse_path(np.asarray(p[b]), np.asarray(m[b]))
        assert float(s[b]) == pytest.approx(ref_score, rel=1e-4)
        np.testing.assert_array_equal(got, ref_path)


@pytest.mark.parametrize("skip_pen", [0.0, 3.0])
@pytest.mark.parametrize("time_major", [False, True])
def test_time_major_entry(skip_pen, time_major):
    """The time-major entry reads the forward's native (T, B, nstate)
    layout; both entries must agree with the XLA decoder."""
    rs = np.random.RandomState(0xBEEF)
    post = rs.dirichlet(np.full(1025, 0.05), size=(3, 35)).astype(np.float32)
    post = np.round(post * 8) / 8 + 1e-3
    x = jnp.asarray(np.moveaxis(post, 0, 1) if time_major else post)
    _assert_same(decode_jax.viterbi(x, 5, skip_pen=skip_pen,
                                    time_major=time_major),
                 _kernel(x, skip_pen=skip_pen, time_major=time_major))


@pytest.mark.parametrize("B", [1, 3, 9])
def test_batch_tail_rows_masked(B):
    """Rows past the batch in the last program are masked out of every load
    and store: any batch size decodes like the XLA decoder."""
    assert pallas_viterbi.BLOCK_ROWS == 4     # 1, 3 and 9 leave a tail
    rs = np.random.RandomState(B)
    post = rs.dirichlet(np.full(65, 0.1), size=(B, 21)).astype(np.float32)
    _assert_same(decode_jax.viterbi(jnp.asarray(post), 3, skip_pen=1.0),
                 _kernel(jnp.asarray(post), klen=3, skip_pen=1.0), rtol=1e-6)


def test_skips_disabled():
    """An infinite skip penalty drops the skip branch statically."""
    rs = np.random.RandomState(2)
    post = rs.dirichlet(np.full(1025, 0.05), size=(2, 20)).astype(np.float32)
    s, p, m = _kernel(jnp.asarray(post), skip_pen=float("inf"))
    ref = decode_jax.viterbi(jnp.asarray(post), 5, skip_pen=1e30)
    _assert_same((s, p, m), ref, rtol=1e-6)


def test_log_domain_input():
    rs = np.random.RandomState(4)
    post = rs.dirichlet(np.full(1025, 0.05), size=(2, 20)).astype(np.float32)
    lpost = jnp.log(jnp.asarray(post) + 1e-10)
    _assert_same(_kernel(lpost, skip_pen=2.0, log=True),
                 decode_jax.viterbi(lpost, 5, skip_pen=2.0, log=True),
                 rtol=1e-6)


def _bases_caller(impl, mesh=None):
    from sloika_tpu import basecall as bc, nn

    layer = nn.Softmax(1, 1025, init=nn.truncated_normal(1.0),
                       has_bias=True)
    params = layer.init(jax.random.PRNGKey(0))
    return bc.Basecaller(layer, params, 5, batch_size=4, chunked=True,
                         chunk_size=64, overlap=8, viterbi_impl=impl,
                         output="bases", mesh=mesh)


def _signals():
    rs = np.random.RandomState(9)
    return [rs.normal(size=n).astype(np.float32) for n in (150, 90, 64)]


def test_basecaller_kernel_matches_xla():
    got = _bases_caller("interpret").basecall_signals(_signals())
    ref = _bases_caller("xla").basecall_signals(_signals())
    for a, b in zip(got, ref):
        assert a[0] == pytest.approx(b[0], rel=1e-6)
        np.testing.assert_array_equal(a[1], b[1])


def test_basecaller_kernel_under_shard_map():
    """With a mesh the kernel runs under shard_map, one batch shard per
    device; calls must equal the single-device kernel."""
    from sloika_tpu.parallel import mesh as meshlib
    got = _bases_caller("interpret", meshlib.make_mesh(4)).basecall_signals(
        _signals())
    ref = _bases_caller("interpret").basecall_signals(_signals())
    for a, b in zip(got, ref):
        assert a[0] == pytest.approx(b[0], rel=1e-6)
        np.testing.assert_array_equal(a[1], b[1])
