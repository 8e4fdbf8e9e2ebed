"""Banded remap DP parity tests against the exact DP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sloika_tpu.ops import remap_banded, remap_jax


def _make_case(rs, nframes, nposs, T, P, nstate=66, jitter=3, stay_p=0.5):
    B = len(nframes)
    lt = np.full((B, T, nstate), np.log(1e-6), dtype=np.float32)
    seq_pad = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        npos, tb = nposs[b], nframes[b]
        seq = rs.randint(1, nstate, size=npos).astype(np.int32)
        seq_pad[b, :npos] = seq
        mask[b, :npos] = True
        base = np.clip((np.arange(tb) * (npos - 1) // max(tb - 1, 1))
                       + rs.randint(-jitter, jitter + 1, size=tb), 0, npos - 1)
        base = np.maximum.accumulate(base)
        post = np.full((tb, nstate), 1e-4)
        for t in range(tb):
            if t > 0 and base[t] == base[t - 1] and rs.rand() < stay_p:
                post[t, 0] = 1.0
            else:
                post[t, seq[base[t]]] = 1.0
        post /= post.sum(1, keepdims=True)
        lt[b, :tb] = np.log(post)
        stay = np.full(nstate, np.log(1e-10), np.float32)
        stay[0] = 0.0
        lt[b, tb:] = stay
    return lt, seq_pad, mask


@pytest.mark.parametrize("W", [48, 64, 128])
def test_banded_matches_exact_on_near_linear_paths(W):
    rs = np.random.RandomState(11)
    nframes = np.array([400, 300, 250], np.int32)
    nposs = np.array([200, 150, 90], np.int32)
    T, P = 400, 256
    lt, seq_pad, mask = _make_case(rs, nframes, nposs, T, P)
    zeros = np.zeros((len(nframes), P), np.float32)

    s_e, p_e = remap_jax.map_to_sequence(
        jnp.asarray(lt), jnp.asarray(seq_pad), jnp.float32(3.0), zeros,
        zeros, jnp.asarray(mask))
    s_b, p_b = remap_banded.map_to_sequence_banded(
        jnp.asarray(lt), jnp.asarray(seq_pad), jnp.float32(3.0), zeros,
        zeros, jnp.asarray(mask), jnp.asarray(nframes), jnp.asarray(nposs),
        W)
    for b, tb in enumerate(nframes):
        assert float(s_b[b]) == pytest.approx(float(s_e[b]), rel=1e-5)
        np.testing.assert_array_equal(np.asarray(p_b[b])[:tb],
                                      np.asarray(p_e[b])[:tb])


def test_banded_with_priors():
    from sloika_tpu.util import geometric_prior
    rs = np.random.RandomState(23)
    nframes = np.array([300], np.int32)
    nposs = np.array([150], np.int32)
    T, P, W = 300, 256, 64
    lt, seq_pad, mask = _make_case(rs, nframes, nposs, T, P)
    p0 = np.zeros((1, P), np.float32)
    p1 = np.zeros((1, P), np.float32)
    p0[0, :150] = geometric_prior(150, 25.0)
    p1[0, :150] = geometric_prior(150, 25.0, rev=True)

    s_e, p_e = remap_jax.map_to_sequence(
        jnp.asarray(lt), jnp.asarray(seq_pad), jnp.float32(3.0),
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask))
    s_b, p_b = remap_banded.map_to_sequence_banded(
        jnp.asarray(lt), jnp.asarray(seq_pad), jnp.float32(3.0),
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask),
        jnp.asarray(nframes), jnp.asarray(nposs), W)
    assert float(s_b[0]) == pytest.approx(float(s_e[0]), rel=1e-5)
    np.testing.assert_array_equal(np.asarray(p_b[0])[:300],
                                  np.asarray(p_e[0])[:300])


def test_band_narrower_than_deviation_degrades_gracefully():
    """With a band too narrow for the jitter the path stays valid (monotone,
    in range) even though it can differ from the exact one."""
    rs = np.random.RandomState(7)
    nframes = np.array([300], np.int32)
    nposs = np.array([200], np.int32)
    lt, seq_pad, mask = _make_case(rs, nframes, nposs, 300, 256, jitter=20)
    zeros = np.zeros((1, 256), np.float32)
    s_b, p_b = remap_banded.map_to_sequence_banded(
        jnp.asarray(lt), jnp.asarray(seq_pad), jnp.float32(3.0), zeros,
        zeros, jnp.asarray(mask), jnp.asarray(nframes), jnp.asarray(nposs),
        32)
    path = np.asarray(p_b[0])[:300]
    assert path.min() >= 0 and path.max() < 200
    assert np.all(np.diff(path) >= 0)


def _slip_case(rs, nframes, nposs, T, P, nstate=66):
    """Paths that advance ~1 position per frame and jump forward by 3 every
    40 frames (genuine slips)."""
    B = len(nframes)
    lt = np.full((B, T, nstate), np.log(1e-6), dtype=np.float32)
    seq_pad = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        npos, tb = nposs[b], nframes[b]
        seq = rs.randint(1, nstate, size=npos).astype(np.int32)
        seq_pad[b, :npos] = seq
        mask[b, :npos] = True
        pos = 0
        post = np.full((tb, nstate), 1e-4)
        for t in range(tb):
            if t > 0 and t % 40 == 0:
                pos = min(pos + 3, npos - 1)
            elif t > 0 and rs.rand() < 0.8:
                pos = min(pos + 1, npos - 1)
            post[t, seq[pos]] = 1.0
        post /= post.sum(1, keepdims=True)
        lt[b, :tb] = np.log(post)
        lt[b, tb:] = np.log(1e-10)
        lt[b, tb:, 0] = 0.0
    return lt, seq_pad, mask


def _exact_and_banded(lt, seq_pad, mask, nframes, nposs, W, slip=3.0):
    zeros = np.zeros(seq_pad.shape, np.float32)
    args = (jnp.asarray(lt), jnp.asarray(seq_pad), jnp.float32(slip),
            jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(mask))
    exact = remap_jax.map_to_sequence(*args)
    banded = remap_banded.map_to_sequence_banded(
        *args, jnp.asarray(nframes), jnp.asarray(nposs), W)
    return exact, banded


@pytest.mark.parametrize("W", [64, 128])
def test_banded_slips_match_exact(W):
    """Paths with genuine slips (jumps >= 2) survive banding: the slip scan
    over the window matches the exact DP."""
    rs = np.random.RandomState(5)
    nframes = np.array([220, 200], np.int32)
    nposs = np.array([180, 160], np.int32)
    lt, seq_pad, mask = _slip_case(rs, nframes, nposs, 220, 256)
    (s_e, p_e), (s_b, p_b) = _exact_and_banded(lt, seq_pad, mask, nframes,
                                               nposs, W, slip=2.0)
    for b, tb in enumerate(nframes):
        assert float(s_b[b]) == pytest.approx(float(s_e[b]), rel=1e-5)
        np.testing.assert_array_equal(np.asarray(p_b[b])[:tb],
                                      np.asarray(p_e[b])[:tb])


@pytest.mark.parametrize("seed", [44, 45])
def test_full_window_equals_exact_dp(seed):
    """A window as wide as the padded sequence (W == P) makes the banded DP
    exact: on fully random posteriors, where banding assumptions do not
    hold, scores and paths equal remap_jax.map_to_sequence."""
    rs = np.random.RandomState(seed)
    B, T, P, nstate = 3, 300, 160, 66
    nframes = np.array([300, 250, 180], np.int32)
    nposs = np.array([150, 100, 60], np.int32)
    lt = np.log(rs.dirichlet(np.ones(nstate), size=(B, T))).astype(np.float32)
    seq_pad = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        seq_pad[b, :nposs[b]] = rs.randint(1, nstate, size=nposs[b])
        mask[b, :nposs[b]] = True
        lt[b, nframes[b]:] = np.log(1e-10)
        lt[b, nframes[b]:, 0] = 0.0
    (s_e, p_e), (s_b, p_b) = _exact_and_banded(lt, seq_pad, mask, nframes,
                                               nposs, P, slip=2.0)
    for b in range(B):
        assert float(s_b[b]) == pytest.approx(float(s_e[b]), rel=1e-5)
        np.testing.assert_array_equal(np.asarray(p_b[b]), np.asarray(p_e[b]))


@pytest.mark.parametrize("W", [48, 64])
def test_banded_under_shard_map(W):
    """The banded DP is row-parallel: run per batch shard under shard_map
    (one shard per device) it equals the unsharded DP."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS
    from sloika_tpu.parallel import mesh as meshlib

    rs = np.random.RandomState(31)
    nframes = np.array([400, 300, 250, 350], np.int32)
    nposs = np.array([200, 150, 90, 180], np.int32)
    lt, seq_pad, mask = _make_case(rs, nframes, nposs, 400, 256)
    zeros = jnp.zeros(seq_pad.shape, jnp.float32)
    args = (jnp.asarray(lt), jnp.asarray(seq_pad), zeros, zeros,
            jnp.asarray(mask), jnp.asarray(nframes), jnp.asarray(nposs))

    def banded(lt_, ss_, p0_, p1_, pm_, nf_, np_):
        return remap_banded.map_to_sequence_banded(
            lt_, ss_, jnp.float32(3.0), p0_, p1_, pm_, nf_, np_, W)

    s_ref, p_ref = banded(*args)
    row, rowp = PS("data"), PS("data", None)
    s_sh, p_sh = shard_map(
        banded, mesh=meshlib.make_mesh(4),
        in_specs=(PS("data", None, None), rowp, rowp, rowp, rowp, row, row),
        out_specs=(row, rowp), check_vma=False)(*args)
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_ref),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(p_sh), np.asarray(p_ref))


def test_remapper_banded_mesh_matches_single_device():
    """Remapper(band=W, mesh=...) partitions the banded DP over the batch
    axis through XLA's SPMD partitioner: mapping paths equal one device."""
    from sloika_tpu.models import build
    from sloika_tpu.parallel import mesh as meshlib
    from sloika_tpu.remap import Remapper

    layer = build("raw_0.98_rgrgr", klen=5, sd=0.5, nfeature=1, winlen=11,
                  stride=5)
    params = layer.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(3)
    sigs = [rs.normal(size=rs.randint(300, 400)).astype(np.float32)
            for _ in range(4)]
    refs = [bytes(b"ACGT"[c] for c in rs.randint(0, 4, size=80))
            for _ in range(4)]
    one = Remapper(layer, params, 5, batch_size=4, band=48)
    four = Remapper(layer, params, 5, batch_size=4, band=48,
                    mesh=meshlib.make_mesh(4))
    for a, b in zip(one.remap_signals(sigs, refs),
                    four.remap_signals(sigs, refs)):
        assert a[0] == pytest.approx(b[0], rel=1e-5)
        np.testing.assert_array_equal(a[2], b[2])
