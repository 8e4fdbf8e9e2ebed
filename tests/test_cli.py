"""CLI smoke tests (subprocess, CPU)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest


@pytest.fixture(scope="module")
def env():
    e = dict(os.environ)
    e["JAX_PLATFORMS"] = "cpu"
    e["PYTHONPATH"] = "/root/repo:" + e.get("PYTHONPATH", "")
    # CPU XLA has no bf16 dot: never inherit a compute-dtype override
    e.pop("SLOIKA_TPU_COMPUTE_DTYPE", None)
    return e


def _run(args, env, expect_rc=0):
    res = subprocess.run([sys.executable, "-m"] + args, env=env,
                         capture_output=True, text=True, cwd="/root/repo")
    assert res.returncode == expect_rc, (res.stdout[-800:], res.stderr[-800:])
    return res


def test_verify_cli(env):
    res = _run(["sloika_tpu.cli.verify", "raw_1.00_rGr", "--kmer_len", "4",
                "--stride", "2", "--nbatch", "2"], env)
    assert "parameters" in res.stdout and "OK" in res.stdout


def test_verify_all_zoo_models(env):
    for name, kw in [("tiny_gru", ["--nfeature", "4", "--winlen", "3"]),
                     ("baseline_lstm", ["--nfeature", "4", "--winlen", "3"]),
                     ("raw_0.98_rgrgr", ["--stride", "5"])]:
        _run(["sloika_tpu.cli.verify", name, "--kmer_len", "4",
              "--nbatch", "1"] + kw, env)


def test_align_cli(tmp_path, env):
    rs = np.random.RandomState(0)
    ref = "".join(rs.choice(list("ACGT"), 800))
    # corrupt lightly
    q = "".join(c if rs.rand() > 0.05 else "ACGT"[rs.randint(4)] for c in ref)
    (tmp_path / "refs.fa").write_text(">r1\n{}\n".format(ref))
    calls = tmp_path / "calls.fa"
    calls.write_text(">r1 score -12, 4000 samples to 800 bases\n{}\n".format(q))
    res = _run(["sloika_tpu.cli.align", "--reference",
                str(tmp_path / "refs.fa"), str(calls)], env)
    assert "Mean accuracy" in res.stdout
    assert os.path.exists(str(tmp_path / "calls.samacc"))
    assert os.path.exists(str(tmp_path / "calls.summary"))


def test_extract_reference_cli(tmp_path, env, simulated_reads):
    out = tmp_path / "refs.fa"
    _run(["sloika_tpu.cli.extract_reference",
          os.path.dirname(simulated_reads[0]),
          "--output", str(out), "--limit", "5"], env)
    text = out.read_text()
    assert text.count(">") >= 2


def test_get_refs_from_sam_cli(tmp_path, env):
    sam = tmp_path / "aln.sam"
    sam.write_text("@SQ\tSN:chr\tLN:4000\n"
                   "readA\t0\tchr\t101\t60\t300M\t*\t0\t0\t{}\t*\tNM:i:3\n"
                   .format("A" * 300))
    ref = tmp_path / "genome.fa"
    ref.write_text(">chr\n{}\n".format("ACGT" * 1000))
    res = _run(["sloika_tpu.cli.get_refs_from_sam", str(ref), str(sam),
                "--pad", "10"], env)
    assert res.stdout.startswith(">readA")


def test_basecall_events_studentise_model_falls_back(tmp_path, env,
                                                     simulated_reads):
    """CLI surface for VERDICT r3 #8: basecalling an event model containing
    Studentise through the batched/chunked path must not crash with the
    bare NotImplementedError — it downgrades to exact per-read mode with a
    clear message and still emits FASTA."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, "/root/repo")
    from sloika_tpu import nn, serialize

    layer = nn.Serial([nn.Studentise(4),
                       nn.FeedForward(4, 16, init=nn.truncated_normal(0.3),
                                      has_bias=True),
                       nn.Softmax(16, 1025, has_bias=True)])
    params = layer.init(jax.random.PRNGKey(0))
    ck = str(tmp_path / "studentise.npz")
    serialize.save_checkpoint(ck, layer, params)

    out_fa = str(tmp_path / "calls.fa")
    res = _run(["sloika_tpu.cli.basecall", "events", ck,
                os.path.dirname(simulated_reads[0]), "--limit", "2",
                "--chunked",
                "--output", out_fa], env)
    assert "Studentise" in res.stderr and "per-read" in res.stderr
    fasta = open(out_fa).read()
    assert fasta.startswith(">")
