"""End-to-end workflow test (the reference's ``make workflow``,
Makefile:18-21): chunkify the bundled reads, train for a few iterations,
validate, and basecall — exercising every pipeline stage.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REF_READS = "/root/reference/data/reads"


@pytest.fixture(scope="module")
def repo_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    # CPU XLA has no bf16 dot: never inherit a compute-dtype override
    env.pop("SLOIKA_TPU_COMPUTE_DTYPE", None)
    return env


def _run(args, env):
    res = subprocess.run([sys.executable, "-m"] + args, env=env,
                         capture_output=True, text=True, cwd="/root/repo")
    assert res.returncode == 0, "{} failed:\n{}\n{}".format(
        args, res.stdout[-2000:], res.stderr[-2000:])
    return res


@pytest.mark.slow
def test_full_workflow(tmp_path, repo_env, reference_reads):
    chunks = str(tmp_path / "chunks.hdf5")
    # 1. chunkify raw reads using in-file mapping tables
    _run(["sloika_tpu.cli.chunkify", "raw_identity", REF_READS, chunks,
          "--chunk_len", "500", "--kmer_len", "5", "--min_length", "2500",
          "--downsample_factor", "5", "--overwrite"], repo_env)
    assert os.path.exists(chunks)

    import h5py
    with h5py.File(chunks, "r") as h5:
        assert set(h5.keys()) >= {"bad", "chunks", "labels", "weights"}
        nchunk, chunk_len, nfeat = h5["chunks"].shape
        assert chunk_len == 500 and nfeat == 1
        assert h5["labels"].shape == (nchunk, 100)  # downsampled by 5
        assert h5.attrs["kmer"] == 5

    # 2. train a tiny raw model for a handful of iterations
    out = str(tmp_path / "training")
    _run(["sloika_tpu.cli.train", "raw", "raw_0.98_rgrgr", out, chunks,
          "--niteration", "4", "--batch_size", "8", "--save_every", "2",
          "--drop", "5", "--quiet", "--seed", "1", "--overwrite"], repo_env)
    final = os.path.join(out, "model_final.npz")
    assert os.path.exists(final)
    assert os.path.exists(final + ".json")

    # 3. validate the trained model
    res = _run(["sloika_tpu.cli.validate", final, chunks,
                "--batch_size", "8"], repo_env)
    assert "accuracy" in res.stdout

    # 4. basecall with the (untrained) model — exercises the CLI path
    fasta = str(tmp_path / "calls.fa")
    _run(["sloika_tpu.cli.basecall", "raw", final, REF_READS,
          "--limit", "2", "--output", fasta, "--batch", "2"], repo_env)
    text = open(fasta).read()
    assert text.startswith(">")

    # 5. dump the model to interchange JSON and reload it
    dump = str(tmp_path / "model.json")
    _run(["sloika_tpu.cli.dump_json", final, "--out_file", dump], repo_env)
    obj = json.load(open(dump))
    assert obj["type"] == "serial"

    # 6. verify (shape-fuzz) a model definition
    _run(["sloika_tpu.cli.verify", "tiny_gru", "--kmer_len", "4",
          "--nfeature", "4", "--winlen", "3", "--stride", "1"], repo_env)


@pytest.mark.slow
def test_events_workflow(tmp_path, repo_env, reference_reads):
    """Event-domain pipeline: identity chunkify -> train -> validate."""
    chunks = str(tmp_path / "ev_chunks.hdf5")
    _run(["sloika_tpu.cli.chunkify", "identity", REF_READS, chunks,
          "--chunk_len", "200", "--kmer_len", "4", "--min_length", "600",
          "--trim", "20", "five".replace("five", "5"),
          "--overwrite"], repo_env)
    import h5py
    with h5py.File(chunks, "r") as h5:
        nchunk, chunk_len, nfeat = h5["chunks"].shape
        assert chunk_len == 200 and nfeat == 4
        assert h5["labels"].shape == (nchunk, 200)

    out = str(tmp_path / "ev_training")
    _run(["sloika_tpu.cli.train", "events", "tiny_gru", out, chunks,
          "--niteration", "3", "--batch_size", "8", "--save_every", "3",
          "--drop", "5", "--winlen", "3", "--quiet", "--overwrite"],
         repo_env)
    assert os.path.exists(os.path.join(out, "model_final.npz"))

    res = _run(["sloika_tpu.cli.validate",
                os.path.join(out, "model_final.npz"), chunks,
                "--batch_size", "8"], repo_env)
    assert "accuracy" in res.stdout


@pytest.mark.slow
def test_remap_workflow(tmp_path, repo_env, reference_reads):
    """Remap-mode data generation through the real CLIs
    (reference chunkify_raw.py:392-461): extract per-read references from
    the bundled fast5s, remap two reads with the imported pretrained model,
    and check the HDF5 schema plus the strand-list quality columns."""
    refs = str(tmp_path / "refs.fa")
    _run(["sloika_tpu.cli.extract_reference", REF_READS, "--output", refs],
         repo_env)
    assert ">" in open(refs).read()

    # restrict to the two smallest reads to keep the CPU DP quick
    strand_list = str(tmp_path / "strands.txt")
    with open(strand_list, "w") as fh:
        fh.write("filename\nread4.fast5\nread5.fast5\n")

    chunks = str(tmp_path / "remap_chunks.hdf5")
    slist = str(tmp_path / "remap_strands.tsv")
    _run(["sloika_tpu.cli.chunkify", "raw_remap", REF_READS, chunks,
          "/root/reference/models/pretrained.pkl", refs,
          "--chunk_len", "500", "--kmer_len", "5",
          "--downsample_factor", "5", "--batch", "2",
          "--input_strand_list", strand_list,
          "--output_strand_list", slist, "--overwrite"], repo_env)

    import h5py
    with h5py.File(chunks, "r") as h5:
        assert set(h5.keys()) >= {"bad", "chunks", "labels", "weights"}
        nchunk, chunk_len, nfeat = h5["chunks"].shape
        assert nchunk > 10 and chunk_len == 500 and nfeat == 1
        assert h5["labels"].shape == (nchunk, 100)
        assert h5.attrs["kmer"] == 5

    header = open(slist).readline().split()
    assert header == ["filename", "nblocks", "score", "nstay", "seqlen",
                      "start", "end"]
    rows = [l.split() for l in open(slist).readlines()[1:]]
    assert len(rows) == 2
    for r in rows:
        assert float(r[2]) > 0          # -score/nblocks, reference format
        assert int(r[4]) > 1000         # reference length


@pytest.mark.slow
def test_events_remap_workflow(tmp_path, repo_env, reference_reads):
    """Event-domain remap chunkify through the CLI
    (reference chunkify_with_remap.py): needs an event transducer model —
    train a tiny one for a step, then remap with it (the pipeline contract
    is schema + strand list, not accuracy)."""
    refs = str(tmp_path / "refs.fa")
    _run(["sloika_tpu.cli.extract_reference", REF_READS, "--output", refs],
         repo_env)

    # tiny event transducer: identity-chunk then 1-iteration train
    chunks0 = str(tmp_path / "seed_chunks.hdf5")
    _run(["sloika_tpu.cli.chunkify", "identity", REF_READS, chunks0,
          "--chunk_len", "200", "--kmer_len", "4", "--min_length", "600",
          "--overwrite"], repo_env)
    out = str(tmp_path / "seed_training")
    _run(["sloika_tpu.cli.train", "events", "tiny_gru", out, chunks0,
          "--niteration", "1", "--batch_size", "4", "--save_every", "1",
          "--drop", "2", "--winlen", "3", "--quiet", "--overwrite"],
         repo_env)
    model = os.path.join(out, "model_final.npz")

    strand_list = str(tmp_path / "strands.txt")
    with open(strand_list, "w") as fh:
        fh.write("filename\nread4.fast5\nread5.fast5\n")
    chunks = str(tmp_path / "ev_remap_chunks.hdf5")
    slist = str(tmp_path / "ev_remap_strands.tsv")
    _run(["sloika_tpu.cli.chunkify", "remap", REF_READS, chunks, model, refs,
          "--chunk_len", "200", "--kmer_len", "4", "--batch", "2",
          "--input_strand_list", strand_list,
          "--output_strand_list", slist, "--overwrite"], repo_env)

    import h5py
    with h5py.File(chunks, "r") as h5:
        assert set(h5.keys()) >= {"bad", "chunks", "labels", "weights"}
        nchunk, chunk_len, nfeat = h5["chunks"].shape
        assert nchunk > 0 and chunk_len == 200 and nfeat == 4
    assert len(open(slist).readlines()) >= 2
