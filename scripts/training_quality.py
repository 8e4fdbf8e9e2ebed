"""Round-3 training-to-quality experiment (VERDICT.md next-round #2).

Proves the framework trains to *quality* on real data, end to end, in one
device process:

1. extract in-file references for the 5 reference-bearing bundled reads;
2. device-remap the 4 training reads (read2/5/6/7) with the imported
   pretrained model and chunk them (chunk 2000, stride 5) — the reference
   workflow's data path (example_training.sh:21-40);
3. remap the held-out read (read4) the same way for a held-out validation
   chunk set;
4. train raw_0.98_rgrgr from random init with the fused multi-step
   trainer (reference iteration budget class: the transducer bootstrap
   alone takes ~3k iterations, CLAUDE.md);
5. validate every checkpoint against the held-out read's chunks (the
   climbing curve);
6. basecall the held-out read with the random initialisation, the trained
   model, and the imported pretrained model; score each against the
   in-file reference.

Writes OUTDIR/summary.json and OUTDIR/experiment.log; the committed copy
lives in docs/ (see STATUS.md "training_quality").

Usage:  python scripts/training_quality.py OUTDIR [NITERATION]
"""
import glob
import json
import os
import sys
import time

import numpy as np

PRETRAINED = "/root/reference/models/pretrained.pkl"
READS = "/root/reference/data/reads"
TRAIN_READS = ["read2", "read5", "read6", "read7"]
VAL_READ = "read4"
KLEN = 5
SEED = 1


def log(fh, msg):
    line = "[{}] {}".format(time.strftime("%H:%M:%S"), msg)
    print(line, flush=True)
    fh.write(line + "\n")
    fh.flush()


def write_refs_and_strands(outdir, fh):
    from sloika_tpu.data.fast5 import Fast5
    refs_fa = os.path.join(outdir, "refs.fa")
    have = []
    with open(refs_fa, "wb") as out:
        for fn in sorted(glob.glob(READS + "/*.fast5")):
            name = os.path.basename(fn)[:-len(".fast5")]
            try:
                with Fast5(fn) as f5:
                    fasta = f5.get_reference_fasta()
            except Exception:
                log(fh, "no in-file reference for {} (skipped)".format(name))
                continue
            seq = b"".join(l for l in fasta.splitlines()
                           if not l.startswith(b">"))
            out.write(b">" + name.encode() + b"\n" + seq + b"\n")
            have.append(name)
    assert VAL_READ in have and all(r in have for r in TRAIN_READS)
    train_sl = os.path.join(outdir, "train_strands.txt")
    with open(train_sl, "w") as f:
        f.write("filename\n")
        for r in TRAIN_READS:
            f.write(r + ".fast5\n")
    val_sl = os.path.join(outdir, "val_strands.txt")
    with open(val_sl, "w") as f:
        f.write("filename\n" + VAL_READ + ".fast5\n")
    return refs_fa, train_sl, val_sl


def chunkify(outdir, refs_fa, strand_list, tag, fh, trim_start=200):
    from sloika_tpu.cli import chunkify as chunkify_cli
    out = os.path.join(outdir, "chunks_{}.hdf5".format(tag))
    t0 = time.time()
    band = os.environ.get("SLOIKA_TQ_BAND")   # CPU smoke runs: XLA banded
    chunkify_cli.main([
        "raw_remap", READS, out, PRETRAINED, refs_fa,
        "--chunk_len", "2000", "--kmer_len", str(KLEN),
        "--downsample_factor", "5", "--batch", "8",
        "--trim", str(trim_start), "50",
        "--input_strand_list", strand_list,
        "--output_strand_list", os.path.join(
            outdir, "strands_{}.txt".format(tag)),
        "--overwrite"] + (["--band", band] if band else []))
    log(fh, "chunkified {} in {:.1f}s -> {}".format(tag, time.time() - t0,
                                                    out))
    return out


#: chunk-offset augmentation: re-chunk the SAME training reads with the
#: chunk grid shifted by fractions of a chunk (via the chunkify CLI's own
#: --trim start), quadrupling the distinct-window training set.  The
#: held-out validation read is chunked once, at the default trim.
TRAIN_TRIM_OFFSETS = [200, 700, 1200, 1700]


def chunkify_train_augmented(outdir, refs_fa, strand_list, fh):
    import h5py
    parts = []
    for off in TRAIN_TRIM_OFFSETS:
        parts.append(chunkify(outdir, refs_fa, strand_list,
                              "train_off{}".format(off), fh,
                              trim_start=off))
    out = os.path.join(outdir, "chunks_train.hdf5")
    arrays = {"chunks": [], "labels": [], "bad": [], "weights": []}
    attrs = None
    for p in parts:
        with h5py.File(p, "r") as h5:
            for k in arrays:
                arrays[k].append(h5[k][:])
            attrs = dict(h5["/"].attrs)
    with h5py.File(out, "w") as h5:
        for k, v in arrays.items():
            h5.create_dataset(k, data=np.concatenate(v), compression="gzip")
        for k, v in attrs.items():
            h5["/"].attrs[k] = v
    log(fh, "merged {} offset chunkifies -> {}".format(len(parts), out))
    return out


def read4_signal():
    from sloika_tpu import basecall as bc
    from sloika_tpu.data.fast5 import Fast5
    fn = os.path.join(READS, VAL_READ + ".fast5")
    dac = bc.load_raw_dac(fn)
    with Fast5(fn) as f5:
        fasta = f5.get_reference_fasta()
    ref = b"".join(l for l in fasta.splitlines() if not l.startswith(b">"))
    return dac, ref.decode()


def basecall_accuracy(layer, params, dac, ref, fh, tag):
    from sloika_tpu import align, basecall as bc
    caller = bc.Basecaller(layer, params, KLEN, batch_size=16, chunked=True,
                           chunk_size=8192, overlap=400, output="bases")
    out = caller.basecall_dac_reads([(dac[1], dac[2])])
    if out[0] is None:
        log(fh, "basecall[{}]: no call".format(tag))
        return {"accuracy": None, "bases": 0}
    score, codes = out[0]
    seq = "".join("ACGT"[c] for c in codes)
    row = align.accuracy_metrics(VAL_READ, seq, VAL_READ, ref)
    acc = None if row is None else round(float(row["accuracy"]), 4)
    log(fh, "basecall[{}]: {} bases, accuracy {}".format(tag, len(seq), acc))
    return {"accuracy": acc, "bases": len(seq),
            "coverage": None if row is None else round(
                float(row["coverage"]), 4)}


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/training_quality_r3"
    niteration = int(sys.argv[2]) if len(sys.argv) > 2 else 16000
    os.makedirs(outdir, exist_ok=True)
    fh = open(os.path.join(outdir, "experiment.log"), "w")

    import jax
    log(fh, "backend: {} devices: {}".format(jax.default_backend(),
                                             jax.devices()))
    # warm up the device->host path
    import jax.numpy as jnp
    np.asarray(jax.jit(lambda: jnp.ones(4))())

    refs_fa, train_sl, val_sl = write_refs_and_strands(outdir, fh)
    train_h5 = chunkify_train_augmented(outdir, refs_fa, train_sl, fh)
    val_h5 = chunkify(outdir, refs_fa, val_sl, "val", fh)

    from sloika_tpu.data import hdf5
    train_data = hdf5.load_labelled_chunks(train_h5)
    val_data = hdf5.load_labelled_chunks(val_h5)
    log(fh, "train chunks: {}  val chunks: {}".format(
        len(train_data["chunks"]), len(val_data["chunks"])))

    # --- train (fused multi-step; fixed chunk length) ------------------
    from sloika_tpu.cli import train as train_cli
    training_dir = os.path.join(outdir, "training")
    save_every = 1000
    t0 = time.time()
    train_cli.main([
        "raw", "raw_0.98_rgrgr", training_dir, train_h5,
        "--niteration", str(niteration), "--batch_size", "100",
        "--steps_per_dispatch", "10", "--save_every", str(save_every),
        "--chunk_len_range", "1.0", "1.0", "--seed", str(SEED),
        "--overwrite"])
    train_dt = time.time() - t0
    log(fh, "trained {} iterations in {:.1f}s ({:.0f} chunks/s)".format(
        niteration, train_dt, niteration * 100 / train_dt))

    # --- held-out validation curve over the checkpoints ----------------
    from sloika_tpu import serialize, training
    curve = []
    ckpts = sorted(glob.glob(os.path.join(training_dir,
                                          "model_checkpoint_*.npz")))
    # when save_every divides niteration the last checkpoint IS the final
    # params — don't validate the same iteration twice
    if niteration % save_every == 0 and ckpts:
        ckpts = ckpts[:-1]
    for ck in ckpts + [os.path.join(training_dir, "model_final.npz")]:
        layer, params, _ = serialize.load_checkpoint(ck)
        loss, acc = training.validate(layer, params, val_data,
                                      batch_size=100, drop=20, quiet=True)
        it = (niteration if ck.endswith("model_final.npz")
              else int(ck.rsplit("_", 1)[1][:-4]) * save_every)
        curve.append({"iteration": it, "val_loss": round(float(loss), 4),
                      "val_accuracy": round(float(acc), 4)})
        log(fh, "checkpoint {}: val loss {:.4f} acc {:.2%}".format(
            it, loss, acc))

    # --- basecall the held-out read: init vs trained vs pretrained -----
    dac, ref = read4_signal()
    from sloika_tpu.models import build
    init_layer = build("raw_0.98_rgrgr", klen=KLEN, sd=0.5, nfeature=1,
                       winlen=11, stride=5)
    init_params = init_layer.init(jax.random.PRNGKey(SEED))
    res_init = basecall_accuracy(init_layer, init_params, dac, ref, fh,
                                 "random-init")
    layer, params, _ = serialize.load_checkpoint(
        os.path.join(training_dir, "model_final.npz"))
    res_final = basecall_accuracy(layer, params, dac, ref, fh, "trained")
    # best post-bootstrap checkpoint by val loss (frame accuracy peaks
    # DURING the blank-marginal phase and is not a basecall proxy —
    # docs/training_quality/best_ckpt_basecall.log)
    post = [c for c in curve if c["iteration"] >= 4000]
    res_best = None
    if post:
        best_it = min(post, key=lambda c: c["val_loss"])["iteration"]
        ck = (os.path.join(training_dir, "model_final.npz")
              if best_it >= niteration else
              os.path.join(training_dir, "model_checkpoint_{:05d}.npz"
                           .format(best_it // save_every)))
        layer_b, params_b, _ = serialize.load_checkpoint(ck)
        res_best = basecall_accuracy(layer_b, params_b, dac, ref, fh,
                                     "best-val-it{}".format(best_it))
        res_best["iteration"] = best_it
    from sloika_tpu.compat import theano_pickle
    p_layer, p_params = theano_pickle.load_model(PRETRAINED)
    res_pre = basecall_accuracy(p_layer, p_params, dac, ref, fh,
                                "pretrained")

    summary = {
        "train_reads": TRAIN_READS, "val_read": VAL_READ,
        "niteration": niteration, "batch_size": 100,
        "steps_per_dispatch": 10,
        "train_chunks": int(len(train_data["chunks"])),
        "val_chunks": int(len(val_data["chunks"])),
        "train_seconds": round(train_dt, 1),
        "train_chunks_per_sec": round(niteration * 100 / train_dt, 1),
        "train_trim_offsets": TRAIN_TRIM_OFFSETS,
        "val_curve": curve,
        "holdout_basecall": {"random_init": res_init, "trained": res_final,
                             "best_val_ckpt": res_best,
                             "pretrained": res_pre},
    }
    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(fh, "summary: " + json.dumps(summary))
    fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
