"""bench.py accuracy scoring: every read with a usable in-file reference is
scored or carries an explicit skip reason (VERDICT r3 #7 — a regression can
never silently shrink the scored set again)."""
import glob
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

def _import_bench():
    """Import bench.py without its import-time compute-dtype setdefault
    leaking into this process's environment (subprocess-spawning tests
    later in the suite would inherit bfloat16, which CPU XLA's dot op
    rejects)."""
    had = "SLOIKA_TPU_COMPUTE_DTYPE" in os.environ
    import bench
    if not had:
        os.environ.pop("SLOIKA_TPU_COMPUTE_DTYPE", None)
    return bench


FULL = ["sim_full_0.fast5", "sim_full_1.fast5"]
NOREF = ["sim_noref.fast5"]
FRAGMENT = "sim_fragment.fast5"


def _call_with_errors(seq, rs, rate=0.05):
    """A basecall of ``seq`` with ~``rate`` substitutions."""
    seq = np.frombuffer(seq, np.uint8).copy()
    hit = rs.rand(len(seq)) < rate
    seq[hit] = np.frombuffer(b"ACGT", np.uint8)[rs.randint(0, 4, hit.sum())]
    return seq.tobytes().decode()


@pytest.fixture(scope="module")
def read_set(simulated_reads, tmp_path_factory):
    """Simulated reads as the bench scores them: two with full in-file
    references, one without, one whose reference is a 172-base fragment;
    calls are the true sequences with 5% substitutions (the fragment read's
    call is 5 bases)."""
    import shutil
    import h5py

    outdir = tmp_path_factory.mktemp("scored_reads")
    rs = np.random.RandomState(0)
    seqs = {}
    for name, src in zip(FULL + NOREF + [FRAGMENT], simulated_reads):
        fn = str(outdir / name)
        shutil.copy(src, fn)
        with h5py.File(fn, "r+") as h5:
            fa = h5["Analyses/Alignment_000/Aligned_template/Fasta"]
            seq = fa[()].decode().splitlines()[1].encode()
            if name in NOREF:
                del h5["Analyses/Alignment_000"]
            elif name == FRAGMENT:
                del h5["Analyses/Alignment_000/Aligned_template/Fasta"]
                h5["Analyses/Alignment_000/Aligned_template"] \
                    .create_dataset("Fasta", data=">frag\n{}\n".format(
                        seq[100:272].decode()))
        seqs[name] = _call_with_errors(seq, rs)
    # like a read whose signal is mostly open pore: a ~5-base call
    seqs[FRAGMENT] = seqs[FRAGMENT][100:105]
    return str(outdir), seqs


def _refs(outdir):
    from sloika_tpu.data.fast5 import Fast5
    refs = {}
    for fn in sorted(glob.glob(outdir + "/*.fast5")):
        name = os.path.basename(fn)
        try:
            with Fast5(fn) as f5:
                ref = f5.get_reference_fasta()
            refs[name] = b"".join(
                l for l in ref.splitlines()
                if not l.startswith(b">")).decode()
        except Exception:
            refs[name] = None
    return refs


@pytest.fixture(scope="module")
def scored(read_set):
    outdir, seqs = read_set
    refs = _refs(outdir)
    return _import_bench().score_reads(seqs, refs), refs


def test_every_read_scored_or_reasoned(scored):
    (mean, per_read, skipped, mean_local), refs = scored
    scored_names = {n for n in per_read if not n.endswith(":mode")}
    for name in refs:
        assert name in scored_names or name in skipped, \
            "{} silently dropped".format(name)


def test_reads_with_full_references_are_scored(scored):
    (mean, per_read, skipped, mean_local), refs = scored
    for name in FULL:
        assert name in per_read, skipped.get(name)
        assert per_read[name] > 0.8
    assert mean is not None and mean > 0.8


def test_reads_without_references_have_reasons(scored):
    (mean, per_read, skipped, mean_local), refs = scored
    for name in NOREF:
        assert skipped[name] == "no in-file reference"


def test_fragment_read_scored_or_explicitly_gated(scored):
    """A read whose in-file reference is a 172-base fragment of its call is
    either scored in fragment mode or skipped with the explicit unalignable
    reason — never silently absent."""
    (mean, per_read, skipped, mean_local), refs = scored
    assert FRAGMENT in per_read or "unalignable" in skipped.get(FRAGMENT, "")


def test_bases_weighting():
    bench = _import_bench()
    # two reads: 20-base perfect alignment and 80-base all-mismatch
    seqs = {"a": "ACGTACGTACGTACGTACGT", "b": "C" * 80}
    refs = {"a": "ACGTACGTACGTACGTACGT", "b": "A" * 80}
    mean, per_read, skipped, _ = bench.score_reads(seqs, refs)
    assert per_read["a"] == 1.0 and per_read["b"] == 0.0
    # reads-weighted would be 0.5; bases-weighted is 20/100
    assert mean == pytest.approx(0.2, abs=1e-6)


def test_local_metric_covered(read_set):
    """score_reads(local=True) produces a local mean near the semiglobal
    one (the documented bwa-semantics delta) and records a skip reason for
    any read present in the global mean but unalignable locally."""
    bench = _import_bench()
    outdir, seqs = read_set
    mean, per_read, skipped, mean_local = bench.score_reads(
        seqs, _refs(outdir), local=True)
    assert mean_local is not None
    # bwa-like local accuracy soft-clips bad call ends: >= semiglobal,
    # within the documented ~+1.3-point band
    assert mean <= mean_local <= mean + 0.02
