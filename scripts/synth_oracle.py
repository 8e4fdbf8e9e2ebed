"""Information-ceiling oracle for the synthetic-chemistry experiments.

Exact Viterbi decode of simulated reads given the TRUE per-kmer level
table and the TRUE event segmentation (the two things a trained model
has to infer) — only the Gaussian noise is unknown.  The resulting
accuracy is the information ceiling of the chemistry: no decoder can
beat it, so the gap between it and the trained model's holdout accuracy
is attributable to the model class, not to the task
(docs/training_quality/README.md, round-5 synthetic-scale section).

DP structure: one event per kmer position (the simulator emits no skips;
stays are absorbed by the known segmentation), so the state graph is the
de Bruijn step graph over 4**klen kmers — predecessors of kmer ``k``
are ``{a * 4**(klen-1) + k // 4}`` under bio.kmer_state_array's
lexicographic coding (first base most significant).  Emission for event
``t`` with observed mean ``m_t`` over ``d_t`` samples:
``-(m_t - level[k])**2 * d_t / (2 * noise**2)`` (the event mean of white
noise has variance ``noise**2 / d_t``); constant terms drop.

Usage: python scripts/synth_oracle.py [n_reads] [noise_sd] [idio]
Writes docs/training_quality/r5_oracle.json when run from the repo root
with default arguments; prints one JSON line regardless.

CPU-only (numpy).
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sloika_tpu import align                      # noqa: E402
from sloika_tpu.data import simulate              # noqa: E402

KLEN = 5
NBASE = 4


def oracle_decode(signal, dwells, levels, noise_sd):
    """Exact max-likelihood kmer path given true segmentation + levels.

    :returns: int32 kmer-code path, one per event
    """
    starts = np.concatenate([[0], np.cumsum(dwells)[:-1]])
    means = np.add.reduceat(signal.astype(np.float64), starts) / dwells
    K = NBASE ** KLEN
    nsuf = K // NBASE
    # emission log-lik (up to constants), (nevents, K)
    emis = -(means[:, None] - levels[None, :].astype(np.float64)) ** 2 \
        * (dwells[:, None] / (2.0 * noise_sd ** 2))
    score = emis[0].copy()
    back = np.zeros((len(means), nsuf), dtype=np.int8)   # argmax leading base
    for t in range(1, len(means)):
        sp = score.reshape(NBASE, nsuf)          # sp[a, s] = score[a*nsuf+s]
        a = sp.argmax(axis=0)
        back[t] = a
        score = emis[t] + np.repeat(sp[a, np.arange(nsuf)], NBASE)
    path = np.empty(len(means), dtype=np.int32)
    path[-1] = int(score.argmax())
    for t in range(len(means) - 1, 0, -1):
        suf = path[t] // NBASE
        path[t - 1] = int(back[t, suf]) * nsuf + suf
    return path


def path_to_seq(path):
    first = path[0]
    digits = [(first // NBASE ** (KLEN - 1 - j)) % NBASE for j in range(KLEN)]
    bases = digits + [int(k % NBASE) for k in path[1:]]
    return "".join("ACGT"[b] for b in bases)


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    noise_sd = float(sys.argv[2]) if len(sys.argv) > 2 else 0.25
    idio = float(sys.argv[3]) if len(sys.argv) > 3 else 0.10
    genome = simulate.random_genome(400000, seed=0)
    levels = simulate.pore_model(KLEN, idio=idio)
    rs = np.random.RandomState(33)
    accs = []
    for i in range(n_reads):
        read = simulate.simulate_read(genome[300000:], rs, read_len=6000,
                                      kmer_len=KLEN, levels=levels,
                                      noise_sd=noise_sd)
        path = oracle_decode(read["signal"], read["dwells"], levels, noise_sd)
        seq = path_to_seq(path)
        m = align.accuracy_metrics("call", seq, "ref",
                                   read["sequence"].decode())
        accs.append(float(m["accuracy"]))
    out = {"n_reads": n_reads, "noise_sd": noise_sd, "idio": idio,
           "oracle_mean_accuracy": round(float(np.mean(accs)), 4),
           "oracle_min": round(float(np.min(accs)), 4),
           "oracle_max": round(float(np.max(accs)), 4)}
    print(json.dumps(out))
    if len(sys.argv) <= 1:
        art = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "docs", "training_quality",
            "r5_oracle.json")
        with open(art, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
