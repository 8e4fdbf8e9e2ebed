"""Generate the golden-basecall regression fixtures (tests/data/golden_calls.npz).

Oracle path, deliberately independent of the batched device pipeline:
per-read unpadded JAX forward (batch 1) of the imported reference
``pretrained.pkl`` + the *numpy* Viterbi oracle (ops/decode_np.py) on the
floored posteriors — the reference decode path (decode.py:39-93,
basecall.py:26-51) re-run read by read.

The committed fixture pins the exact call-state sequence for each bundled
read; tests/test_golden_basecall.py asserts the production batched exact-mode
pipeline reproduces them verbatim (the reference golden-value pattern,
/root/reference/test/unit/test_decode.py:201-241, scaled to whole reads).

Run (CPU, ~2 min):  JAX_PLATFORMS=cpu \
    python scripts/make_golden_calls.py
"""
import glob
import os
import sys

import numpy as np

MIN_PROB = 1e-5
SKIP = 5.0
PRETRAINED = "/root/reference/models/pretrained.pkl"
READS = "/root/reference/data/reads"
OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "golden_calls.npz")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sloika_tpu import basecall as bc
    from sloika_tpu import bio
    from sloika_tpu.compat import theano_pickle
    from sloika_tpu.ops import decode_np

    layer, params = theano_pickle.load_model(PRETRAINED)
    fwd = jax.jit(layer.apply)

    out = {}
    kmers = bio.all_kmers(5)
    for fn in sorted(glob.glob(READS + "/*.fast5")):
        name, sig = bc.load_raw_signal(fn)
        post = np.asarray(fwd(params, jnp.asarray(
            sig.reshape(-1, 1, 1).astype(np.float32))))[:, 0]
        post = MIN_PROB + (1.0 - MIN_PROB) * post
        score, call = decode_np.viterbi(post, 5, skip_pen=SKIP)
        out["call_" + name] = np.asarray(call, dtype=np.int16)
        out["score_" + name] = np.float64(score)
        seq = bio.kmers_to_sequence([kmers[i] for i in call],
                                    always_move=True)
        out["seq_" + name] = np.bytes_(seq)
        print("{}: {} samples -> {} calls, {} bases, score {:.1f}".format(
            name, len(sig), len(call), len(seq), score))

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print("wrote", os.path.normpath(OUT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
