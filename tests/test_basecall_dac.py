"""DAC-input basecall path: device windowing/normalisation parity tests.

The transfer-lean input mode (Basecaller.basecall_dac_reads) ships raw
int16 DAC samples and normalises on device with the exact float32 op order
``((dac + offset) * scale - med) / mad`` — these tests pin that it produces
*identical* calls to basecall_signals fed the same-op-order host-normalised
signal, and that load_raw_dac matches load_raw_signal's trimming and
normalisation (reference raw_worker, basecall.py:88-121).
"""
import os

import jax
import numpy as np
import pytest

from sloika_tpu import basecall as bc
from sloika_tpu import nn


@pytest.fixture(scope="module")
def small_model():
    init = nn.truncated_normal(0.4)
    layer = nn.Serial([
        nn.Convolution(1, 8, 7, 2, init=init, has_bias=True),
        nn.Reverse(nn.Gru(8, 8, init=init, has_bias=True)),
        nn.Gru(8, 8, init=init, has_bias=True),
        nn.Softmax(8, 65, init=init, has_bias=True),
    ])
    params = layer.init(jax.random.PRNGKey(5))
    return layer, params


def _synthetic_reads(rs, lens):
    reads, sigs = [], []
    for L in lens:
        dac = rs.randint(-2000, 2000, size=L).astype(np.int16)
        off = np.float32(rs.randint(-10, 10))
        sc = np.float32(rs.uniform(0.05, 0.2))
        scaled = (dac.astype(np.float32) + off) * sc
        med = np.float32(np.median(scaled))
        mad = np.float32(1.4826 * np.median(np.abs(scaled - np.median(scaled))))
        reads.append((dac, (off, sc, med, mad)))
        sigs.append((scaled - med) / mad)
    return reads, sigs


@pytest.mark.parametrize("lens", [(3000,), (2500, 900, 4100)])
def test_dac_reads_match_host_normalised_signals(small_model, lens):
    layer, params = small_model
    rs = np.random.RandomState(17)
    reads, sigs = _synthetic_reads(rs, lens)
    caller = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                           chunk_size=1024, overlap=128, output="bases")
    out_sig = caller.basecall_signals(sigs)
    out_dac = caller.basecall_dac_reads(reads)
    assert len(out_sig) == len(out_dac) == len(lens)
    for (s1, c1), (s2, c2) in zip(out_sig, out_dac):
        assert s1 == pytest.approx(s2, rel=1e-6)
        np.testing.assert_array_equal(c1, c2)


def test_load_raw_dac_matches_load_raw_signal(simulated_reads):
    """Same trim decisions; normalised values within float32 rounding of the
    reference loader (which scales to pA in float64 before the f32 cast)."""
    checked = 0
    for fn in simulated_reads[:3]:
        a = bc.load_raw_signal(fn)
        b = bc.load_raw_dac(fn)
        assert (a is None) == (b is None)
        if a is None:
            continue
        (sn_a, sig), (sn_b, dac, (off, sc, med, mad)) = a, b
        assert sn_a == sn_b
        assert len(sig) == len(dac)
        norm = ((dac.astype(np.float32) + off) * sc - med) / mad
        np.testing.assert_allclose(norm, sig, rtol=0, atol=2e-5)
        checked += 1
    assert checked > 0


def test_remap_oom_fallback_halves_batch(monkeypatch):
    """Device-memory exhaustion during a remap batch must fall back to
    halved batches instead of failing the run."""
    from sloika_tpu import remap as remap_mod

    calls = []

    class FakeRemapper(remap_mod.Remapper):
        def __init__(self):   # bypass model setup
            self.batch_size = 4
            self.kmer_len = 5
            self._oom_sizes = set()

        def _dispatch_batch(self, sigs, refs, idx, band, dac=False):
            calls.append(len(sigs))
            if len(sigs) > 1:
                raise RuntimeError("RESOURCE_EXHAUSTED: Ran out of memory "
                                   "in memory space hbm.")
            return {"sigs": sigs, "refs": refs, "idx": idx, "band": band,
                    "dac": dac}

        def _collect_batch(self, rec, out):
            out[rec["idx"][0]] = ("ok", None, None, rec["refs"][0])

    r = FakeRemapper()
    out = [None] * 4
    r._run_batch_safe([np.zeros(8)] * 4, [b"ACGT"] * 4, [0, 1, 2, 3],
                      out, 512)
    assert all(o is not None for o in out)
    # failing sizes are memoised: the second half skips the known-bad 2
    assert calls == [4, 2, 1, 1, 1, 1]


def test_basecall_cli_dac_mode(tmp_path, small_model, simulated_reads):
    """--dac on drives the DAC input path end-to-end through the CLI."""
    import subprocess
    import sys as _sys
    from sloika_tpu import serialize
    layer, params = small_model
    ckpt = str(tmp_path / "model.npz")
    serialize.save_checkpoint(ckpt, layer, params)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("SLOIKA_TPU_COMPUTE_DTYPE", None)
    outfile = str(tmp_path / "calls.fa")
    cp = subprocess.run(
        [_sys.executable, "-m", "sloika_tpu.cli.basecall", "raw", ckpt,
         os.path.dirname(simulated_reads[0]), "--kmer_len", "3",
         "--limit", "2", "--chunked", "--chunk_size", "2048",
         "--device_collapse", "on", "--dac", "on", "--output", outfile],
        env=env, capture_output=True, text=True, timeout=900)
    assert cp.returncode == 0, cp.stderr
    fa = open(outfile).read()
    assert fa.count(">") >= 1


def test_dac_reads_on_virtual_mesh(small_model):
    """DAC mode sharded over the 8-device virtual mesh (window jobs over
    the batch axis, the Viterbi kernel under shard_map) must equal the
    unsharded result."""
    import jax as _jax
    from sloika_tpu.parallel import mesh as meshlib
    assert _jax.device_count() >= 8
    layer, params = small_model
    rs = np.random.RandomState(23)
    reads, sigs = _synthetic_reads(rs, (2500, 900, 4100))
    kw = dict(batch_size=8, chunked=True, chunk_size=1024, overlap=128,
              output="bases", viterbi_impl="interpret")
    single = bc.Basecaller(layer, params, 3, **kw)
    sharded = bc.Basecaller(layer, params, 3, mesh=meshlib.make_mesh(8),
                            **kw)
    out1 = single.basecall_dac_reads(reads)
    out2 = sharded.basecall_dac_reads(reads)
    for (s1, c1), (s2, c2) in zip(out1, out2):
        assert s1 == pytest.approx(s2, rel=1e-6)
        np.testing.assert_array_equal(c1, c2)


def test_delta_wire_matches_int16_wire(small_model):
    """The lossless int8-delta input encoding must reconstruct the exact
    signal on device: identical calls to the raw int16 wire, including
    reads with deltas beyond int8 (the exception sideband)."""
    layer, params = small_model
    rs = np.random.RandomState(31)
    reads, _ = _synthetic_reads(rs, (2500, 900, 4100))
    # inject jumps that overflow int8 deltas
    for d, _n in reads:
        d[::97] = np.clip(d[::97].astype(np.int32) + 900, -32768, 32767)
    kw = dict(batch_size=4, chunked=True, chunk_size=1024, overlap=128,
              output="bases")
    out_raw = bc.Basecaller(layer, params, 3, wire="int16",
                            **kw).basecall_dac_reads(reads)
    out_delta = bc.Basecaller(layer, params, 3, wire="delta",
                              **kw).basecall_dac_reads(reads)
    for (s1, c1), (s2, c2) in zip(out_raw, out_delta):
        assert s1 == pytest.approx(s2, rel=1e-6)
        np.testing.assert_array_equal(c1, c2)


def test_dac_read_grouping_matches_single_group(small_model, monkeypatch):
    """With the flat-buffer cap forcing multiple read groups, calls must be
    identical to the single-group result (group boundaries are read
    boundaries; stitching spans groups through the shared results dict)."""
    layer, params = small_model
    rs = np.random.RandomState(41)
    reads, _ = _synthetic_reads(rs, (2500, 900, 4100, 1300))
    caller = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                           chunk_size=1024, overlap=128, output="bases")
    base = caller.basecall_dac_reads(reads)
    monkeypatch.setattr(bc, "_MAX_GROUP_SAMPLES", 3000)
    grouped = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                            chunk_size=1024, overlap=128,
                            output="bases").basecall_dac_reads(reads)
    for (s1, c1), (s2, c2) in zip(base, grouped):
        assert s1 == pytest.approx(s2, rel=1e-6)
        np.testing.assert_array_equal(c1, c2)


def test_delta_wire_extreme_oscillation_exact(small_model):
    """Worst case for the MXU prefix-sum's exactness: rail-to-rail
    alternating DAC extremes make EVERY delta a +/-65535 exception.  The
    split-exception reconstruction must still be bit-exact (its per-pass
    absolute sums stay < 2^24 regardless of accumulation order)."""
    layer, params = small_model
    L = 3000
    dac = np.where(np.arange(L) % 2 == 0, -32768, 32767).astype(np.int16)
    # a mild tail so the windows aren't all identical
    dac[L // 2:] = (np.arange(L - L // 2) % 700 - 350).astype(np.int16)
    off, sc = np.float32(0), np.float32(0.01)
    scaled = (dac.astype(np.float32) + off) * sc
    med = np.float32(np.median(scaled))
    mad = np.float32(1.4826 * np.median(np.abs(scaled - np.median(scaled))))
    reads = [(dac, (off, sc, med, mad))]
    kw = dict(batch_size=4, chunked=True, chunk_size=1024, overlap=128,
              output="bases")
    out_raw = bc.Basecaller(layer, params, 3, wire="int16",
                            **kw).basecall_dac_reads(reads)
    out_delta = bc.Basecaller(layer, params, 3, wire="delta",
                              **kw).basecall_dac_reads(reads)
    assert out_raw[0][0] == pytest.approx(out_delta[0][0], rel=1e-6)
    np.testing.assert_array_equal(out_raw[0][1], out_delta[0][1])


@pytest.mark.parametrize("lens", [(100,), (1024,), (1025,), (897,),
                                  (130, 5000)])
def test_dac_edge_lengths_match_signal_path(small_model, lens):
    """Reads shorter than a window / exactly one window / one sample over
    the core must produce the same calls through both input paths."""
    layer, params = small_model
    rs = np.random.RandomState(53)
    reads, sigs = _synthetic_reads(rs, lens)
    caller = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                           chunk_size=1024, overlap=128, output="bases")
    out_sig = caller.basecall_signals(sigs)
    out_dac = caller.basecall_dac_reads(reads)
    for (s1, c1), (s2, c2) in zip(out_sig, out_dac):
        assert s1 == pytest.approx(s2, rel=1e-6)
        np.testing.assert_array_equal(c1, c2)


def test_dac_empty_read_list(small_model):
    layer, params = small_model
    caller = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                           chunk_size=1024, overlap=128, output="bases")
    assert caller.basecall_dac_reads([]) == []


def test_dac_pipeline_groups_match_single_group(small_model, monkeypatch):
    """The ship-pipeline grouping (prefetch worker shipping group g+1
    while group g computes) is bit-identical to the single-group path,
    including the fixed full-group buffer size and the bucketed final
    group."""
    layer, params = small_model
    rs = np.random.RandomState(23)
    reads, _ = _synthetic_reads(rs, (2500, 900, 4100, 1300, 2200))
    caller = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                           chunk_size=1024, overlap=128, output="bases")
    base = caller.basecall_dac_reads(reads)
    monkeypatch.setattr(bc, "_PIPE_GROUP_SAMPLES", 4000)
    piped = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                          chunk_size=1024, overlap=128,
                          output="bases").basecall_dac_reads(reads)
    serial = bc.Basecaller(layer, params, 3, batch_size=4, chunked=True,
                           chunk_size=1024, overlap=128, output="bases",
                           pipeline_ship=False).basecall_dac_reads(reads)
    for (s1, c1), (s2, c2), (s3, c3) in zip(base, piped, serial):
        assert s1 == pytest.approx(s2, rel=1e-6)
        np.testing.assert_array_equal(c1, c2)
        assert s1 == pytest.approx(s3, rel=1e-6)
        np.testing.assert_array_equal(c1, c3)
