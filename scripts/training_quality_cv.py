"""Cross-validated fine-tuning with proper inner validation: hold out
each reference-bearing read as the TEST read, early-stop on guarded
tail regions of the training reads, fine-tune the pretrained model on
the remaining seven reads, and score the test read's basecall once at
the selected checkpoint.

Checkpoint selection never sees the test read: an earlier version
validated on the holdout's own chunks (circular — its "never degrades"
property was selection on test labels; caught in review).  Validation
is the guarded tail-region split over all training reads
(tq.build_region_split) — a single held-out validation READ proved too
noisy to select with.  read7 is excluded as a test read — its 172-base
fragment reference cannot score a whole-read basecall — but stays in
every training set.

Every fold runs SEEDS independent fine-tunes (different training
sampler seeds) so the tiny per-fold deltas carry a spread, not just a
point estimate (round-4 verdict: "+0.002 has no error bars").  Data
build and the pretrained baseline are shared across seeds within a
fold; per-checkpoint diagnostic basecalls are thinned (the selected
checkpoint is always basecalled after selection).

Usage:  python scripts/training_quality_cv.py OUTDIR [seed,seed,...]
Writes OUTDIR/cv_summary.json.
"""
import json
import os
import sys
import time

import numpy as np

# explicit f32 policy before sloika_tpu imports (see training_quality_r4)
os.environ.setdefault("SLOIKA_TPU_COMPUTE_DTYPE", "float32")

sys.path.insert(0, os.path.dirname(__file__))
import training_quality_r4 as tq

#: test reads (every read with a scorable in-file reference)
FOLDS = ["read2", "read4", "read5", "read6"]
SEEDS = [1, 2, 3]
NITER, SAVE, RATE = 3000, 100, 1e-5


def run_fold(outdir, fold, fh, seeds):
    tq.TEST_READ = fold
    fold_dir = os.path.join(outdir, fold)
    os.makedirs(fold_dir, exist_ok=True)

    p_layer, p_params = tq.load_pretrained()
    # region scheme: train on every non-test read, early-stop on guarded
    # tail regions of the same reads (tq.build_region_split)
    train_h5, val_h5, ref_source = tq.build_data(
        fold_dir, p_layer, p_params, fh, scheme="region")

    from sloika_tpu.data import hdf5
    train_data = hdf5.load_labelled_chunks(train_h5)
    val_data = hdf5.load_labelled_chunks(val_h5)
    tq.log(fh, "[{}] train chunks: {}  val chunks: {}".format(
        fold, len(train_data["chunks"]), len(val_data["chunks"])))

    dac, ref = tq.holdout_signal()
    res_pre = tq.basecall_accuracy(p_layer, p_params, dac, ref, fh,
                                   fold + ":pretrained")
    row = {
        "fold": fold,
        "train_chunks": int(len(train_data["chunks"])),
        "pretrained_accuracy": res_pre["accuracy"],
        "seeds": [],
    }
    for seed in seeds:
        run = tq.run_finetune(fold_dir, train_h5, val_data, dac, ref, fh,
                              niteration=NITER, save_every=SAVE, rate=RATE,
                              tag="finetune_s{}".format(seed), seed=seed,
                              basecall_every=10 ** 6)
        best = run["best"]
        srow = {"seed": seed,
                "val_loss_init": run["val_curve"][0]["val_loss"]}
        if best is None:      # every checkpoint non-finite: report as-is
            srow.update({"finetuned_accuracy": None, "best_iteration": None,
                         "val_loss_best": None, "delta": None})
        else:
            srow.update({
                "finetuned_accuracy": best["holdout"]["accuracy"],
                "best_iteration": best["iteration"],
                "val_loss_best": best["val_loss"],
                "delta": (None if (best["holdout"]["accuracy"] is None
                                   or res_pre["accuracy"] is None)
                          else round(best["holdout"]["accuracy"]
                                     - res_pre["accuracy"], 4)),
            })
        row["seeds"].append(srow)
        tq.log(fh, "[{} seed {}] {}".format(fold, seed, json.dumps(srow)))

    deltas = [s["delta"] for s in row["seeds"] if s["delta"] is not None]
    if deltas:
        row["delta_mean"] = round(float(np.mean(deltas)), 4)
        row["delta_min"] = round(float(np.min(deltas)), 4)
        row["delta_max"] = round(float(np.max(deltas)), 4)
        row["delta_std"] = round(float(np.std(deltas)), 4)
    return row


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/tq_cv"
    seeds = ([int(s) for s in sys.argv[2].split(",")]
             if len(sys.argv) > 2 else SEEDS)
    os.makedirs(outdir, exist_ok=True)
    fh = open(os.path.join(outdir, "cv.log"), "w")
    import jax
    tq.log(fh, "backend: {} devices: {}".format(jax.default_backend(),
                                                jax.devices()))
    import jax.numpy as jnp
    np.asarray(jax.jit(lambda: jnp.ones(4))())

    folds = []
    for fold in FOLDS:
        t0 = time.time()
        folds.append(run_fold(outdir, fold, fh, seeds))
        tq.log(fh, "[{}] fold done in {:.0f}s: {}".format(
            fold, time.time() - t0, json.dumps(folds[-1])))
        with open(os.path.join(outdir, "cv_summary.json"), "w") as f:
            json.dump({"folds": folds, "niteration": NITER,
                       "learning_rate": RATE, "seeds": seeds}, f, indent=1)

    deltas = [s["delta"] for f in folds for s in f["seeds"]
              if s["delta"] is not None]
    summary = {"folds": folds, "niteration": NITER, "learning_rate": RATE,
               "seeds": seeds,
               "mean_delta": round(float(np.mean(deltas)), 4),
               "improved_runs": int(sum(d > 0 for d in deltas)),
               "degraded_runs": int(sum(d < 0 for d in deltas)),
               "n_runs": len(deltas)}
    with open(os.path.join(outdir, "cv_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    tq.log(fh, "CV summary: " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
