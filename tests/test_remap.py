"""Remapper (batched device remapping) tests on synthetic models/data."""
import jax
import numpy as np
import pytest

import sloika_tpu.module_tools as smt
from sloika_tpu import bio, remap
from sloika_tpu.data import raw_chunkify


@pytest.fixture(scope="module")
def small_transducer():
    """Identity-ish model: conv stride 2 + softmax over 3-mer states."""
    init = smt.truncated_normal(0.4)
    layer = smt.Serial([
        smt.Convolution(1, 16, 5, 2, init=init, has_bias=True),
        smt.Softmax(16, 65, init=init, has_bias=True),
    ])
    params = layer.init(jax.random.PRNGKey(3))
    return layer, params


def test_remapper_produces_reference_schema(small_transducer):
    layer, params = small_transducer
    rs = np.random.RandomState(0)
    rm = remap.Remapper(layer, params, 3, slip=5.0, prior=(10.0, 10.0),
                        batch_size=2)
    sigs = [rs.normal(size=(n,)).astype(np.float32) for n in (600, 900, 450)]
    refs = [bytes(rs.choice([65, 67, 71, 84], size=n).astype(np.uint8))
            for n in (80, 120, 60)]
    out = rm.remap_signals(sigs, refs)
    assert len(out) == 3
    for (sig, ref, res) in zip(sigs, refs, out):
        score, mapping_table, path, seq = res
        assert raw_chunkify.mapping_table_is_registered(sig, mapping_table)
        # path is monotone over positions of the (3-mer) sequence
        assert np.all(np.diff(path) >= 0)
        assert path.max() < len(ref) - 2
        assert set(mapping_table.dtype.names) == {
            'start', 'length', 'seq_pos', 'move', 'kmer', 'good_emission'}
        # kmers in the table come from the reference at the mapped positions
        kmers = np.array(bio.seq_to_kmers(ref, 3))
        np.testing.assert_array_equal(mapping_table['kmer'],
                                      kmers[mapping_table['seq_pos']])


def test_remapper_batched_equals_single(small_transducer):
    layer, params = small_transducer
    rs = np.random.RandomState(7)
    sigs = [rs.normal(size=(n,)).astype(np.float32) for n in (500, 700)]
    refs = [bytes(rs.choice([65, 67, 71, 84], size=n).astype(np.uint8))
            for n in (70, 100)]
    rm2 = remap.Remapper(layer, params, 3, slip=4.0, batch_size=2)
    rm1 = remap.Remapper(layer, params, 3, slip=4.0, batch_size=1)
    out2 = rm2.remap_signals(sigs, refs)
    out1 = [rm1.remap_signals([s], [r])[0] for s, r in zip(sigs, refs)]
    for (s2, m2, p2, _), (s1, m1, p1, _) in zip(out2, out1):
        assert s2 == pytest.approx(s1, rel=1e-4)
        np.testing.assert_array_equal(p2, p1)


def test_events_identity_chunkify(tmp_path):
    """Event-domain identity chunking against a simulated mapped read."""
    from sloika_tpu.data import batching, simulate
    from sloika_tpu.data.fast5 import Fast5

    _, (fn,) = simulate.simulate_read_set(str(tmp_path), 1,
                                          genome_len=20000, read_len=2000)
    with Fast5(fn) as f5:
        ev, _ = f5.get_any_mapping_data("template")
    ev = batching.trim_ends_and_filter(ev, (50, 10), 1200, 500)
    assert ev is not None
    chunks, labels, bad = batching.chunkify(ev, 500, 5, False, "per-read")
    n = len(ev) // 500
    assert chunks.shape == (n, 500, 4)
    assert labels.shape == (n, 500)
    assert bad.shape == (n, 500)
    # stays (no seq_pos change) are labelled blank
    stays = np.apply_along_axis(np.ediff1d, 1,
                                ev[:n * 500]['seq_pos'].reshape(n, 500),
                                to_begin=1) == 0
    np.testing.assert_array_equal(labels == 0, stays)
    assert labels.max() <= 1024


def test_band_miss_fallback_escalates(small_transducer):
    """Reads whose banded path misses a sequence-end anchor are re-run with
    a 4x band and finally the exact DP; clean reads are not re-run."""
    layer, params = small_transducer
    rm = remap.Remapper(layer, params, 3, batch_size=4, band=64)
    calls = []

    def fake_dispatch(sigs, refs, idx, band, dac=False):
        calls.append((tuple(int(i) for i in idx), band))
        return {"sigs": sigs, "refs": refs, "idx": idx, "band": band,
                "dac": dac}

    def fake_collect(rec, out):
        for b, i in enumerate(rec["idx"]):
            npos = len(rec["refs"][b]) - 2
            # read 0 converges only under the exact DP; read 1 is clean
            if i == 0 and rec["band"] is not None:
                path = np.zeros(50, dtype=np.int32)       # stuck at start
            else:
                path = np.linspace(0, npos - 1, 50).astype(np.int32)
            out[i] = (-1.0, None, path, np.arange(npos))

    rm._dispatch_batch = fake_dispatch
    rm._collect_batch = fake_collect
    sigs = [np.zeros(500, dtype=np.float32)] * 2
    refs = [b"A" * 400, b"A" * 400]
    out = rm.remap_signals(sigs, refs)

    bands = [band for (_, band) in calls]
    assert bands[0] == 64                       # initial banded pass, both
    assert calls[0][0] == (0, 1)
    assert bands[1:] == [256, None]             # escalation then exact
    assert all(c[0] == (0,) for c in calls[1:])  # only the missing read
    assert out[0][2].max() == 397               # exact DP result kept
    assert out[1][2].max() == 397


def test_remapper_on_virtual_mesh(small_transducer):
    """Mesh-sharded remapping (data-parallel preprocessing, SURVEY.md §2.4)
    must reproduce the single-device results, including the non-multiple
    batch padded up to a whole number of shards."""
    from sloika_tpu.parallel import mesh as meshlib
    layer, params = small_transducer
    rs = np.random.RandomState(11)
    sigs = [rs.normal(size=(n,)).astype(np.float32)
            for n in (600, 900, 450, 700, 500)]
    refs = [bytes(rs.choice([65, 67, 71, 84], size=n).astype(np.uint8))
            for n in (80, 120, 60, 100, 70)]
    mesh = meshlib.make_mesh(8)
    sharded = remap.Remapper(layer, params, 3, slip=5.0, batch_size=8,
                             mesh=mesh)
    plain = remap.Remapper(layer, params, 3, slip=5.0, batch_size=8)
    out_s = sharded.remap_signals(sigs, refs)
    out_p = plain.remap_signals(sigs, refs)
    for (ss, ms, ps, _), (sp, mp, pp, _) in zip(out_s, out_p):
        assert ss == pytest.approx(sp, rel=1e-4)
        np.testing.assert_array_equal(ps, pp)
        np.testing.assert_array_equal(ms, mp)


def test_remapper_on_virtual_mesh_banded(small_transducer):
    """Mesh + banded DP: the shard_map-wrapped banded path must reproduce
    the unsharded banded results."""
    from sloika_tpu.parallel import mesh as meshlib
    layer, params = small_transducer
    rs = np.random.RandomState(13)
    sigs = [rs.normal(size=(n,)).astype(np.float32)
            for n in (900, 1100, 800, 1000)]
    refs = [bytes(rs.choice([65, 67, 71, 84], size=n).astype(np.uint8))
            for n in (150, 200, 140, 180)]
    mesh = meshlib.make_mesh(4)
    sharded = remap.Remapper(layer, params, 3, slip=5.0, batch_size=4,
                             band=96, mesh=mesh)
    plain = remap.Remapper(layer, params, 3, slip=5.0, batch_size=4, band=96)
    out_s = sharded.remap_signals(sigs, refs)
    out_p = plain.remap_signals(sigs, refs)
    for (ss, _, ps, _), (sp, _, pp, _) in zip(out_s, out_p):
        assert ss == pytest.approx(sp, rel=1e-4)
        np.testing.assert_array_equal(ps, pp)


def test_dac_wire_matches_host_normalised(small_transducer):
    """remap_dac_signals (flat int16 wire + device normalisation) is
    bit-identical to remap_signals fed the host-normalised equivalent
    computed with the same f32 op order."""
    layer, params = small_transducer
    rs = np.random.RandomState(7)
    dacs, sigs, refs = [], [], []
    for n, rlen in [(600, 80), (900, 120), (450, 60)]:
        d = rs.randint(-400, 400, size=n).astype(np.int16)
        offset = np.float32(rs.uniform(-5, 5))
        scale = np.float32(rs.uniform(0.05, 0.2))
        s = (d.astype(np.float32) + offset) * scale
        med = np.float32(np.median(s))
        from sloika_tpu import maths
        mad = np.float32(maths.mad(s))
        dacs.append((d, (offset, scale, med, mad)))
        sigs.append(((d.astype(np.float32) + offset) * scale - med) / mad)
        refs.append(bytes(rs.choice([65, 67, 71, 84],
                                    size=rlen).astype(np.uint8)))
    rm = remap.Remapper(layer, params, 3, slip=5.0, prior=(10.0, 10.0),
                        batch_size=2)
    a = rm.remap_signals(sigs, refs)
    b = rm.remap_dac_signals(dacs, refs)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]                       # score, exactly
        np.testing.assert_array_equal(ra[2], rb[2])  # path
        np.testing.assert_array_equal(
            np.asarray(ra[1].tolist(), dtype=object),
            np.asarray(rb[1].tolist(), dtype=object))


def test_dac_wire_on_virtual_mesh(small_transducer):
    """The DAC remap wire under a ('data',) mesh matches the unsharded
    path (replicated flat buffer, row-sharded starts/lengths/norms)."""
    import jax
    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs the virtual multi-device mesh")
    from sloika_tpu.parallel import mesh as meshlib
    layer, params = small_transducer
    rs = np.random.RandomState(8)
    dacs, refs = [], []
    for n, rlen in [(500, 70)] * 4:
        d = rs.randint(-400, 400, size=n).astype(np.int16)
        offset, scale = np.float32(0.5), np.float32(0.1)
        s = (d.astype(np.float32) + offset) * scale
        from sloika_tpu import maths
        dacs.append((d, (offset, scale, np.float32(np.median(s)),
                         np.float32(maths.mad(s)))))
        refs.append(bytes(rs.choice([65, 67, 71, 84],
                                    size=rlen).astype(np.uint8)))
    mesh = meshlib.make_mesh(4)
    sharded = remap.Remapper(layer, params, 3, slip=5.0, batch_size=4,
                             mesh=mesh)
    plain = remap.Remapper(layer, params, 3, slip=5.0, batch_size=4)
    a = plain.remap_dac_signals(dacs, refs)
    b = sharded.remap_dac_signals(dacs, refs)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]
        np.testing.assert_array_equal(ra[2], rb[2])


def test_dac_flat_buffer_group_guard(small_transducer, monkeypatch):
    """A DAC batch whose flat sample buffer would exceed the buffer cap
    (int32 read starts; one bounded host->device copy per batch) is split
    into halves BEFORE any device program is built."""
    layer, params = small_transducer
    rm = remap.Remapper(layer, params, 3, batch_size=4, band=64)
    calls = []

    def fake_dispatch(sigs, refs, idx, band, dac=False):
        calls.append(tuple(int(i) for i in idx))
        return {"sigs": sigs, "refs": refs, "idx": idx, "band": band,
                "dac": dac}

    def fake_collect(rec, out):
        for b, i in enumerate(rec["idx"]):
            npos = len(rec["refs"][b]) - 2
            path = np.linspace(0, npos - 1, 50).astype(np.int32)
            out[i] = (-1.0, None, path, np.arange(npos))

    rm._dispatch_batch = fake_dispatch
    rm._collect_batch = fake_collect
    # a cap below the bucket floor forces splitting all the way down to
    # singleton batches — every device batch stays under the cap's intent
    monkeypatch.setattr(remap, "_MAX_GROUP_SAMPLES", 2000)
    norm4 = (np.float32(0), np.float32(0.1), np.float32(0), np.float32(1))
    dacs = [(np.zeros(800, np.int16), norm4)] * 4
    refs = [b"A" * 400] * 4
    out = rm.remap_dac_signals(dacs, refs)
    assert all(o is not None for o in out)
    assert all(len(c) <= 2 for c in calls) and len(calls) >= 2

    # a single read over the hard 2 GB bound is refused outright
    class Huge(object):
        def __len__(self):
            return 2 ** 31
    with pytest.raises(AssertionError, match="2 GB"):
        rm._run_batch_safe([(Huge(), norm4)], [b"A" * 400],
                           np.array([0]), [None], 64, dac=True)


def test_remap_pipelines_batches(small_transducer):
    """The remap loop keeps one batch in flight: batch g+1 is dispatched
    BEFORE batch g's results are pulled, overlapping host work with the
    device DP (VERDICT r3 #2; the basecall ship-pipelining pattern)."""
    layer, params = small_transducer
    rm = remap.Remapper(layer, params, 3, batch_size=2, band=64)
    events = []

    def fake_dispatch(sigs, refs, idx, band, dac=False):
        events.append(("dispatch", tuple(int(i) for i in idx)))
        return {"sigs": sigs, "refs": refs, "idx": idx, "band": band,
                "dac": dac}

    def fake_collect(rec, out):
        events.append(("collect", tuple(int(i) for i in rec["idx"])))
        for b, i in enumerate(rec["idx"]):
            npos = len(rec["refs"][b]) - 2
            path = np.linspace(0, npos - 1, 50).astype(np.int32)
            out[i] = (-1.0, None, path, np.arange(npos))

    rm._dispatch_batch = fake_dispatch
    rm._collect_batch = fake_collect
    sigs = [np.zeros(500, dtype=np.float32)] * 6
    refs = [b"A" * 400] * 6
    out = rm.remap_signals(sigs, refs)
    assert all(o is not None for o in out)
    assert events == [("dispatch", (0, 1)), ("dispatch", (2, 3)),
                      ("collect", (0, 1)), ("dispatch", (4, 5)),
                      ("collect", (2, 3)), ("collect", (4, 5))]
