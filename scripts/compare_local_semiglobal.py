"""Bound the local-vs-semiglobal evaluation delta (VERDICT r3 missing #2).

The reference scores basecalls with bwa mem — LOCAL alignment that
soft-clips low-quality call ends — while this repo's evaluator is
semiglobal with free reference end gaps.  This script scores the committed
golden basecalls (pretrained model, exact decode) of every
reference-bearing bundled read under BOTH metrics and prints the per-read
and aggregate deltas; the result is recorded in docs/PERF.md
("Evaluation metric definition").

CPU:  JAX_PLATFORMS=cpu \
    python scripts/compare_local_semiglobal.py
"""
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

READS = "/root/reference/data/reads"
GOLDEN = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                      "golden_calls.npz")


def main():
    from sloika_tpu import align
    from sloika_tpu.data.fast5 import Fast5

    z = np.load(GOLDEN)
    rows = []
    for fn in sorted(glob.glob(READS + "/*.fast5")):
        name = os.path.basename(fn)[:-len(".fast5")]
        try:
            with Fast5(fn) as f5:
                fasta = f5.get_reference_fasta()
        except Exception:
            continue
        ref = b"".join(l for l in fasta.splitlines()
                       if not l.startswith(b">"))
        seq = z["seq_" + name].item()
        if isinstance(seq, bytes):
            seq = seq.decode()
        sem = align.accuracy_metrics(name, seq, name, ref)
        loc = align.local_accuracy_metrics(name, seq, name, ref)
        rows.append((name, len(seq), len(ref), sem, loc))

    print("{:8} {:>7} {:>7} {:>10} {:>10} {:>8} {:>9} {:>9}".format(
        "read", "call", "ref", "semiglob", "local", "delta",
        "sem_cov", "loc_cov"))
    deltas = []
    for name, nq, nr, sem, loc in rows:
        sa = None if sem is None else sem["accuracy"]
        la = None if loc is None else loc["accuracy"]
        d = None if (sa is None or la is None) else la - sa
        if d is not None:
            deltas.append(d)
        print("{:8} {:>7} {:>7} {:>10} {:>10} {:>8} {:>9} {:>9}".format(
            name, nq, nr,
            "-" if sa is None else "{:.4f}".format(sa),
            "-" if la is None else "{:.4f}".format(la),
            "-" if d is None else "{:+.4f}".format(d),
            "-" if sem is None else "{:.3f}".format(sem["coverage"]),
            "-" if loc is None else "{:.3f}".format(loc["coverage"])))
    if deltas:
        print("mean delta (local - semiglobal): {:+.4f}   max |delta|: "
              "{:.4f}".format(float(np.mean(deltas)),
                              float(np.max(np.abs(deltas)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
