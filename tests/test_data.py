"""Data-pipeline tests: fast5 reader golden values, time->sample conversion,
bio/kmer algebra, maths, fileio, features — ported from the reference's unit
suite (test_fast5.py, test_raw_chunkify_utils.py, test_bio.py, test_maths.py,
test_fileio.py).
"""
import os

import numpy as np
import pytest

from sloika_tpu import bio, maths, util
from sloika_tpu.data import batching, fileio, raw_chunkify
from sloika_tpu.data.fast5 import Fast5, iterate_fast5

READS = "/root/reference/data/reads"
STRANDS = "/root/reference/data/strands.txt"


# ---------------------------------------------------------------------------
# fast5 reader — golden values from reference test_fast5.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,nsamples", [
    ("read3", 51129), ("read6", 55885), ("read2", 69443), ("read1", 114400)])
def test_raw_read_lengths(reference_reads, name, nsamples):
    with Fast5(os.path.join(READS, name + ".fast5")) as f5:
        assert len(f5.get_read(raw=True)) == nsamples


def test_mapping_data_golden(reference_reads):
    with Fast5(os.path.join(READS, "read6.fast5")) as f5:
        ev, attrs = f5.get_any_mapping_data("template")
        assert len(ev) == 10750
        assert "move" in ev.dtype.names
        assert attrs["direction"] in "+-"
        assert len(attrs["reference"]) > 0


def test_filename_short(reference_reads):
    with Fast5(os.path.join(READS, "read6.fast5")) as f5:
        assert f5.filename_short == "read6"


def test_iterate_with_strand_list(reference_reads):
    if not os.path.exists(STRANDS):
        pytest.skip("no strand list")
    files = list(iterate_fast5(READS, strand_list=STRANDS, paths=True))
    listed = set(np.atleast_1d(fileio.readtsv(STRANDS)["filename"]))
    assert {os.path.basename(f) for f in files} == set(listed)


def test_section_events(reference_reads):
    with Fast5(os.path.join(READS, "read6.fast5")) as f5:
        ev = f5.get_section_events("template")
        assert len(ev) > 1000
        assert {"mean", "stdv", "start", "length"} <= set(ev.dtype.names)


# ---------------------------------------------------------------------------
# time -> sample conversion (reference test_raw_chunkify_utils.py golden)
# ---------------------------------------------------------------------------

def test_convert_mapping_times_to_samples():
    events = np.array(
        [(99.80953125, 11355.1985, 0.00075, b'TTTGCC', 1),
         (102.37074939, 11355.19925, 0.0025, b'TTTGCC', 0),
         (88.89286377, 11355.20175, 0.0015, b'TTGCCG', 1),
         (89.49268066, 11355.20325, 0.0015, b'TTGCCG', 0),
         (104.62006274, 11355.20475, 0.00125, b'TGCCGA', 1)],
        dtype=[('mean', '<f8'), ('start', '<f8'), ('length', '<f8'),
               ('kmer', 'S6'), ('move', '<i8')])
    raw = np.array([96.99039185, 98.42995239, 97.71017212, 97.53022705,
                    97.35028198, 95.73077637, 95.5508313, 99.14973267,
                    98.9697876, 101.30907349, 104.72802979, 104.72802979,
                    102.56868896, 106.52748047, 103.10852417, 101.84890869,
                    103.10852417, 100.94918335, 95.37088623, 100.76923828,
                    90.87225952, 89.97253418, 87.45330322, 88.53297363,
                    88.89286377, 87.63324829, 90.51236938, 89.97253418,
                    87.99313843, 90.51236938, 87.45330322, 90.51236938,
                    101.48901855, 105.08791992, 107.06731567, 107.78709595,
                    101.66896362, 96.27061157, 96.27061157, 95.37088623,
                    90.87225952, 79.35577515, 86.01374268, 94.11127075,
                    71.97802734, 71.25824707, 74.31731323, 71.79808228,
                    73.9574231])
    out = raw_chunkify.convert_mapping_times_to_samples(events, 45420787,
                                                        4000.0)
    assert out.dtype.names == events.dtype.names
    assert out['start'].dtype == np.int64
    for e in out:
        got = raw[e['start']:e['start'] + e['length']].mean()
        assert util.is_close(got, e['mean'])


def test_registration_helpers():
    sig = np.arange(100, dtype=np.float32)
    mt = np.zeros(5, dtype=[('start', '<i8'), ('length', '<i8')])
    mt['start'] = [0, 20, 40, 60, 80]
    mt['length'] = 20
    assert raw_chunkify.mapping_table_is_registered(sig, mt)
    sig2, mt2 = raw_chunkify.trim_signal_and_mapping(sig, mt, 10, 90)
    assert raw_chunkify.mapping_table_is_registered(sig2, mt2)
    assert len(sig2) == 80


def test_label_helper_functions():
    arr = np.array([3, 3, 5, 5, 5, 2])
    out = raw_chunkify.replace_repeats_with_zero(arr.copy())
    np.testing.assert_array_equal(out, [3, 0, 5, 0, 0, 2])
    arr = np.array([0, 3, 0, 0, 5, 0])
    np.testing.assert_array_equal(raw_chunkify.fill_zeros_with_prev(arr),
                                  [0, 3, 3, 3, 5, 5])
    arr = np.array([1, 0, 2, 0, 0, 3])
    np.testing.assert_array_equal(
        raw_chunkify.index_of_previous_non_zero(arr), [0, 0, 2, 2, 2, 5])


# ---------------------------------------------------------------------------
# kmer algebra (reference test_bio.py patterns)
# ---------------------------------------------------------------------------

def test_all_kmers_and_mapping():
    kmers = bio.all_kmers(2)
    assert len(kmers) == 16
    assert kmers[0] == 'AA' and kmers[-1] == 'TT'
    mapping = bio.kmer_mapping(2)
    assert mapping['AC'] == 1
    bk = bio.all_kmers(2, alphabet=b'ACGT')
    assert bk[1] == b'AC'


def test_kmer_state_array_matches_mapping():
    seq = b'ACGTACGTAACCGGTT'
    states = bio.kmer_state_array(seq, 3)
    mapping = bio.kmer_mapping(3, alphabet=b'ACGT')
    expect = [mapping[k] for k in bio.seq_to_kmers(seq, 3)]
    np.testing.assert_array_equal(states, expect)


def test_kmer_array_to_states_centre_extraction():
    arr = np.array([b'TTTGCC', b'TTGCCG'], dtype='S6')
    states = batching.kmer_array_to_states(arr, 4, index_from=1)
    mapping = bio.kmer_mapping(4, alphabet=b'ACGT')
    # centre 4-mer of a 6-mer: offset (6-4+1)//2 = 1
    assert states[0] == mapping[b'TTGC'] + 1
    assert states[1] == mapping[b'TGCC'] + 1


def test_reverse_complement():
    assert bio.reverse_complement('ACGT') == 'ACGT'
    assert bio.reverse_complement('AACG') == 'CGTT'
    assert bio.complement('A') == 'T'


def test_kmers_to_sequence():
    assert bio.kmers_to_sequence(['ATA', 'TAT', 'ATG', 'TGC']) == 'ATATGC'
    # stays collapse unless always_move
    assert bio.kmers_to_sequence(['AAA', 'AAA', 'AAT']) == 'AAAT'
    assert bio.kmers_to_sequence(['AAA', 'AAA'], always_move=True) == 'AAAA'


def test_de_bruijn():
    seq = bio.de_bruijn(2, 3, pad=True)
    s = ''.join(str(x) for x in seq)
    subs = {s[i:i + 3] for i in range(len(s) - 2)}
    assert len(subs) == 8  # all 2^3 subsequences present


def test_max_overlap_and_moves():
    kmers = ['ACGT', 'CGTA', 'ACGT', 'ACGT']
    moves = bio.max_overlap(kmers)
    assert moves == [1, 3, 0]
    assert all(bio.moves_compatible(kmers, moves))


def test_kmer_transitions():
    trans = bio.kmer_transitions(['ACG'], 2)
    dests = {d for _, d in trans['ACG']}
    assert 'ACG' in dests          # move 0
    assert 'CGA' in dests          # move 1
    assert 'GTT' in dests          # move 2


# ---------------------------------------------------------------------------
# maths / util / fileio
# ---------------------------------------------------------------------------

def test_med_mad():
    x = np.array([1.0, 2.0, 3.0, 4.0, 100.0])
    med, mad = maths.med_mad(x)
    assert med == 3.0
    assert mad == pytest.approx(1.4826)


def test_studentise_handles_constant_columns():
    x = np.ones((10, 3))
    x[:, 1] = np.arange(10)
    out = maths.studentise(x, axis=0)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out[:, 0], 0.0)


def test_geometric_prior():
    p = util.geometric_prior(5, 2.0)
    probs = np.exp(p)
    assert probs[0] == pytest.approx(1.0 / 3.0)
    assert np.all(np.diff(p) < 0)
    prev = util.geometric_prior(5, 2.0, rev=True)
    np.testing.assert_allclose(prev, p[::-1])


def test_trim_array():
    x = np.arange(10)
    np.testing.assert_array_equal(util.trim_array(x, 2, 3), x[2:7])
    np.testing.assert_array_equal(util.trim_array(x, 0, 0), x)


def test_tsv_roundtrip(tmp_path):
    arr = np.array([('read1.fast5', 1.5, 3), ('read2.fast5', 2.5, 4)],
                   dtype=[('filename', 'U20'), ('score', 'f8'), ('n', 'i8')])
    path = str(tmp_path / "test.tsv")
    fileio.savetsv(path, arr)
    back = fileio.readtsv(path, fields=['filename', 'score'])
    assert list(back['filename']) == ['read1.fast5', 'read2.fast5']
    np.testing.assert_allclose(back['score'], arr['score'])
    assert fileio.file_has_fields(path, ['filename', 'n'])
    assert not fileio.file_has_fields(path, ['missing'])


def test_features_from_events():
    from sloika_tpu.data import features
    ev = np.zeros(5, dtype=[('mean', 'f8'), ('stdv', 'f8'), ('length', 'f8')])
    ev['mean'] = [1, 2, 4, 7, 11]
    ev['stdv'] = 1.0
    ev['length'] = 0.01
    out = features.from_events(ev, tag='', normalise=False)
    assert out.shape == (5, 4)
    np.testing.assert_allclose(out[:, 3], [1, 2, 3, 4, 0])


def test_trim_open_pore():
    rs = np.random.RandomState(0)
    quiet = rs.normal(0, 0.1, size=5000)
    loud = rs.normal(0, 5.0, size=10000)
    signal = np.concatenate([quiet, loud, quiet])
    trimmed = batching.trim_open_pore(signal, max_op_fraction=0.3)
    assert len(trimmed) < len(signal)
    assert len(trimmed) >= 10000


def test_load_labelled_chunks_all_zero_weights_fails_loudly(tmp_path):
    """A chunk file where every chunk was zero-weighted (aggressive blank
    filter) must raise a clear error at load time, not hand the training
    sampler NaN selection probabilities."""
    import numpy as np
    import pytest
    from sloika_tpu.data import hdf5 as hdf5_mod

    path = str(tmp_path / "chunks.hdf5")
    chunks = np.zeros((4, 16, 1), np.float32)
    labels = np.zeros((4, 16), np.int32)       # all blanks
    bad = np.zeros((4, 16), bool)
    hdf5_mod.create_labelled_chunks_hdf5(
        path, 0.0, {"kmer": 5, "trim": (0, 0)}, [chunks], [labels], [bad])
    with pytest.raises(ValueError, match="zero"):
        hdf5_mod.load_labelled_chunks(path)


def test_interpolated_labels_use_read_local_coordinates(simulated_reads,
                                                        tmp_path):
    """A mapping summary can store genomic coordinates (genome_start) while
    seq_pos is read-local against the per-read fasta: interpolation must
    use local coordinates (attrs ref_start=0/ref_stop=len(ref)), not
    genomic ones, or every interpolated label is garbage."""
    import shutil
    import h5py
    import numpy as np
    from sloika_tpu.data.fast5 import Fast5
    from sloika_tpu.data import raw_chunkify

    fn = str(tmp_path / "genomic.fast5")
    shutil.copy(simulated_reads[0], fn)
    with h5py.File(fn, "r+") as h5:
        summ = h5["Analyses/AlignToRef_000/Summary/"
                  "current_space_map_template"]
        summ.attrs["genome_start"] = np.int64(4031059)
        summ.attrs["genome_end"] = np.int64(4031059 + 700)

    with Fast5(fn) as f5:
        ev, att = f5.get_any_mapping_data("template")
        sample_rate = f5.sample_rate
        start_sample = f5.raw_start_sample
    assert att["ref_start"] == 0
    assert att["ref_stop"] == len(att["reference"])
    assert att["genome_start"] == 4031059   # genomic coords still exposed

    ev = raw_chunkify.convert_mapping_times_to_samples(
        ev, start_sample, sample_rate)
    interp = raw_chunkify.interpolate_labels(ev, att)
    mid = (ev["start"][0] + ev["start"][-1]) // 2
    labels = interp(np.array([ev["start"][0] + 1, mid]), k=5)
    assert np.all(labels >= 1) and np.all(labels <= 4 ** 5)
