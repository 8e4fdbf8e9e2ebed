"""Headline benchmark: basecalling throughput per device.

Basecalls the bundled reference reads (tiled to fill a batch) with the
imported reference ``pretrained.pkl`` through the full device pipeline
(forward + on-device Viterbi + on-device collapse) and reports bases/s per
device, plus training and remap throughput.  Utilisation shares divide by
the peaks of ``sloika_tpu.backend.PEAKS`` for the device in use, and are
null for a device the table does not know.
"""
import glob
import json
import os
import sys
import time

import numpy as np

# bfloat16 matmuls for the throughput configuration (must be set before
# sloika_tpu.config is imported); the JSON line reports the achieved
# accuracy alongside the throughput so the trade is visible.
os.environ.setdefault("SLOIKA_TPU_COMPUTE_DTYPE", "bfloat16")

PRETRAINED = "/root/reference/models/pretrained.pkl"
READS = "/root/reference/data/reads"


def main():
    import jax
    from sloika_tpu import backend, basecall as bc
    from sloika_tpu.compat import theano_pickle

    backend.init_compile_cache()
    layer, params = theano_pickle.load_model(PRETRAINED)
    # window batches of 1024 x 16384-sample windows (to be re-tuned for
    # the device's memory); output="bases" collapses calls on device and
    # transfers packed 2-bit base codes (~25x less device->host traffic)
    B = 1024
    caller = bc.Basecaller(layer, params, 5, batch_size=B, chunked=True,
                           chunk_size=16384, overlap=400, output="bases")

    # DAC input mode: ship raw int16 samples once per read (no f32
    # window-duplicated batches -- ~2.4x less host->device traffic) and
    # window+normalise on device; calls are identical to the host-normalised
    # signal path (tests/test_basecall_dac.py)
    reads, read_files = [], []
    for fn in sorted(glob.glob(READS + "/*.fast5")):
        r = bc.load_raw_dac(fn)
        if r is not None:
            reads.append((r[1], r[2]))
            read_files.append(fn)
    if not reads:
        print(json.dumps({"metric": "basecall_bases_per_sec_per_chip",
                          "value": 0.0, "unit": "bases/s",
                          "error": "no reads"}))
        return 1
    # tile to a workload that fills several pipeline groups (~49M samples
    # = 3 full 16.8M-sample ship groups): the prefetch worker overlaps
    # group g+1's transfer with group g's compute, and the interleaved
    # size sweep measured 600 reads ~16% faster per sample than 300 (the
    # un-overlapped first ship and the tail group amortise)
    nreads = (B * 300) // 512
    sigs = (reads * ((nreads // len(reads)) + 1))[:nreads]
    nsamples = sum(len(d) for d, _ in sigs)

    out = caller.basecall_dac_reads(sigs)        # compile + warm
    times = []
    nrep = 10
    for _ in range(nrep):
        t0 = time.time()
        out = caller.basecall_dac_reads(sigs)
        times.append(time.time() - t0)
    dt = min(times)
    dt_mean = sum(times) / nrep

    nbases = sum(len(c[1]) for c in out if c is not None)
    samples_per_sec = nsamples / dt
    bases_per_sec = nbases / dt

    # analytic model FLOPs (nn/flops.py) x achieved sample rate, over the
    # device's published bf16 peak where the peaks table knows the device
    from sloika_tpu.nn import flops as flops_mod
    f_sample = flops_mod.flops_per_input_frame(layer, params)
    achieved_flops = samples_per_sec * f_sample

    acc_mean, acc_per_read, acc_skipped, acc_mean_local = _accuracy(
        out[:len(reads)], read_files)
    dev_rate, dev_ms = _device_capability(caller, reads)
    print(json.dumps({
        "metric": "basecall_bases_per_sec_per_chip",
        "value": round(bases_per_sec, 1),
        "unit": "bases/s",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "card": backend.card_info(),
        "samples_per_sec": round(samples_per_sec, 1),
        "reads": len(sigs),
        "config": "chunked B={} C=16384 bf16 dac-input (best of {} reps)".format(B, nrep),
        "mean_bases_per_sec": round(nbases / dt_mean, 1),
        # bases-weighted mean over every read with a usable in-file
        # reference; read7's 172-base fragment reference is scored in
        # fragment mode (aligned into the call, >=90% fragment coverage)
        # and unscorable reads carry an explicit reason — nothing is
        # silently dropped (tests/test_bench_accuracy.py)
        "accuracy_mean": acc_mean,
        # same calls under bwa-like LOCAL alignment (soft-clipped ends);
        # the reference's own metric definition — expected ~+0.8 points
        # above the semiglobal number (docs/PERF.md)
        "accuracy_mean_local": acc_mean_local,
        "accuracy_per_read": acc_per_read,
        "accuracy_skipped": acc_skipped,
        # fused device program alone (inputs resident, no output pulls):
        # the gap to samples_per_sec is the host's share
        "device_samples_per_sec": dev_rate,
        "device_dispatch_ms": dev_ms,
        "model_flops_per_sample": round(f_sample, 1),
        "achieved_tflops": round(achieved_flops / 1e12, 3),
        "mfu_pct_bf16_peak": _share(achieved_flops),
        **_train_throughput(),
        "remap_samples_per_sec": _remap_throughput(),
    }))
    return 0


def _share(flops_per_sec):
    """Percent of the device's published bf16 peak, or None when the peaks
    table does not know the device."""
    from sloika_tpu import backend
    peaks = backend.peaks()
    if peaks is None:
        return None
    return round(100.0 * flops_per_sec / peaks["bf16_flops_per_s"], 2)


def _device_capability(caller, reads):
    """Host-independent rate of the fused device program (window +
    normalise + forward + Viterbi + collapse): inputs resident on device,
    several dispatches per sync, outputs never pulled (only the final
    (B, 18) uint8 header, to sync).

    :returns: (samples_per_sec, ms_per_dispatch) — samples counted as the
        windows' total length (includes ~5%% window-overlap duplication,
        like the device program itself does).
    """
    import time as _time
    import jax.numpy as jnp
    from sloika_tpu import basecall as bc

    C, B = caller.chunk_size, caller.batch_size
    read_lens = [len(d) for d, _ in reads]
    offsets = np.concatenate([[0], np.cumsum(read_lens)]).astype(np.int64)
    S = bc._round_up(bc.bucket_length(int(offsets[-1]) + C, min_len=1 << 20),
                     1024)
    flat = np.zeros(S, np.int16)
    for (d, _), o in zip(reads, offsets):
        flat[o:o + len(d)] = d
    flat_d = caller._ship_flat(flat, S)
    jobs = [(r, w, int(offsets[r]) + start, ln)
            for r, w, start, ln, _ in bc._window_jobs(read_lens, C,
                                                      caller.overlap)]
    # exactly one full device batch (tile jobs if the read set is small)
    jobs = (jobs * (B // len(jobs) + 1))[:B]
    starts = jnp.asarray(np.array([j[2] for j in jobs], np.int32))
    lengths = jnp.asarray(np.array([j[3] for j in jobs], np.int32))
    norms = jnp.asarray(np.array([reads[j[0]][1] for j in jobs], np.float32))
    run = caller._forward_decode_dac(S)
    header, recs = run(caller.params, flat_d, starts, lengths, norms)
    np.asarray(header)                       # compile + warm + sync
    NDISP = 8
    t0 = _time.time()
    for _ in range(NDISP):
        header, recs = run(caller.params, flat_d, starts, lengths, norms)
    np.asarray(header)                       # sync (tiny pull)
    dt = (_time.time() - t0) / NDISP
    nsamp = int(np.sum([j[3] for j in jobs]))
    return round(nsamp / dt, 1), round(1e3 * dt, 2)


def score_reads(seqs, refs, local=False):
    """Score every read that has a usable in-file reference; bases-weighted
    mean accuracy + explicit skip reasons (nothing is silently dropped).

    :param seqs: {read name: called sequence}
    :param refs: {read name: reference sequence or None if the fast5 has no
        in-file reference}
    :param local: also compute the bwa-like LOCAL (Smith-Waterman)
        accuracy mean for globally-scored reads (~3 s per full read)
    :returns: (weighted mean accuracy or None, {name: accuracy},
        {name: skip reason}, local mean accuracy or None)

    Reads whose in-file reference is only a short *fragment* of the read
    (read7 carries a 172-base fragment for a 14k-sample read) are scored in
    fragment mode: the fragment is aligned INTO the call (roles swapped)
    and must be covered >=90%, so the metric is the call's local accuracy
    over the fragment — the normal query-coverage gate can never apply to
    a fragment reference.  The mean is weighted by aligned bases (alignment
    columns), not by reads, so a 170-base fragment cannot move the summary
    the way a 10-kb read does.
    """
    from sloika_tpu import align

    per_read, skipped, accs, weights = {}, {}, [], []
    local_accs, local_w = [], []
    for name in sorted(set(seqs) | set(refs)):
        ref, seq = refs.get(name), seqs.get(name)
        if ref is None:
            skipped[name] = "no in-file reference"
            continue
        if seq is None:
            skipped[name] = "no basecall produced"
            continue
        row = align.accuracy_metrics(name, seq, name, ref)
        mode = "global"
        if row is None and len(ref) < 0.6 * len(seq):
            # fragment reference: align it into the call instead
            row = align.accuracy_metrics(name, ref, name, seq,
                                         min_coverage=0.9)
            mode = "fragment"
        if row is None:
            skipped[name] = ("unalignable or coverage-gated "
                             "(call {} bases, reference {} bases)".format(
                                 len(seq), len(ref)))
            continue
        per_read[name] = round(float(row["accuracy"]), 4)
        accs.append(float(row["accuracy"]))
        weights.append(float(row["match"] + row["mismatch"]
                             + row["insertion"] + row["deletion"]))
        if mode == "fragment":
            per_read[name + ":mode"] = "fragment"
        elif local:
            # bwa-semantics cross-check: exact affine Smith-Waterman
            # (soft-clips bad call ends like the reference's bwa mem
            # evaluator; docs/PERF.md "Evaluation metric definition")
            lrow = align.local_accuracy_metrics(name, seq, name, ref)
            if lrow is not None:
                local_accs.append(float(lrow["accuracy"]))
                local_w.append(float(lrow["match"] + lrow["mismatch"]
                                     + lrow["insertion"]
                                     + lrow["deletion"]))
            else:
                # keep the two means comparable: a read in the global
                # mean but not the local one is recorded, not silent
                skipped[name + ":local"] = "local alignment unalignable"
    if not accs:
        return None, per_read, skipped, None
    mean = float(np.average(accs, weights=weights))
    mean_local = (round(float(np.average(local_accs, weights=local_w)), 4)
                  if local_accs else None)
    return round(mean, 4), per_read, skipped, mean_local


def _accuracy(calls, read_files):
    """Mean alignment accuracy of the unique reads' calls against their
    in-file references (guards the throughput number against silent
    accuracy regressions).

    ``read_files[i]`` is the fast5 the i-th call came from — the pairing is
    positional against the SAME loaded-read list main basecalled, so a
    loader skip can never shift calls onto the wrong reference.
    """
    from sloika_tpu.data.fast5 import Fast5

    refs, seqs = {}, {}
    for fn, call in zip(read_files, calls):
        name = os.path.basename(fn)
        seqs[name] = "".join("ACGT"[c] for c in call[1])
        try:
            with Fast5(fn) as f5:
                ref = f5.get_reference_fasta()
        except Exception:
            refs[name] = None
            continue
        seq = b"".join(l for l in ref.splitlines()
                       if not l.startswith(b">"))
        refs[name] = seq.decode()
    return score_reads(seqs, refs, local=True)


def _remap_throughput():
    """Third metric: device remapping samples/s (the reference's slowest
    stage — 'a few hours' for a read set, example_training.sh:24-31).
    Bundled reads tiled to fill one batch-64 dispatch."""
    import time as _time
    import jax
    from sloika_tpu import basecall as bc
    from sloika_tpu.compat import theano_pickle
    from sloika_tpu.data.fast5 import Fast5
    from sloika_tpu.remap import Remapper

    layer, params = theano_pickle.load_model(PRETRAINED)
    sigs, refs = [], []
    for fn in sorted(glob.glob(READS + "/*.fast5")):
        r = bc.load_raw_dac(fn)
        if r is None:
            continue
        try:
            with Fast5(fn) as f5:
                ref = f5.get_reference_fasta()
        except Exception:
            continue
        seq = b"".join(l for l in ref.splitlines() if not l.startswith(b">"))
        if len(seq) < 100:
            continue
        sigs.append((r[1], r[2]))
        refs.append(seq)
    if not sigs:
        return None
    # several batch-64 dispatches so the cross-batch pipeline engages
    # (dispatch g+1 before pulling g; a single batch cannot overlap)
    reps = -(-64 * 4 // len(sigs))
    sigs, refs = sigs * reps, refs * reps
    remapper = Remapper(layer, params, 5, batch_size=64)
    # DAC wire: raw int16 samples + device normalisation (bit-identical to
    # the host-normalised path fed the same constants; half the h2d bytes
    # and none of the length-bucket padding bytes)
    remapper.remap_dac_signals(sigs, refs)      # compile + warm
    best = None
    for _ in range(3):
        t0 = _time.time()
        remapper.remap_dac_signals(sigs, refs)
        dt = _time.time() - t0
        best = dt if best is None else min(best, dt)
    return round(sum(len(s) for s, _ in sigs) / best, 1)


def _train_throughput():
    """Secondary metric: training chunks/s/chip at reference defaults
    (batch 100 x 2000-sample chunks, raw_0.98_rgrgr-class model;
    train_network.py:42-64), with analytic fwd+bwd FLOPs
    (nn/flops.py training_flops_per_input_frame, XLA
    cost-analysis-validated) x achieved rate over the device's peak.
    """
    import jax
    import jax.numpy as jnp
    from sloika_tpu.models import build
    from sloika_tpu.nn import flops as flops_mod
    from sloika_tpu import optim, training

    layer = build("raw_0.98_rgrgr", klen=5, sd=0.5, nfeature=1, winlen=11,
                  stride=5)
    params = layer.init(jax.random.PRNGKey(0))
    opt_init, opt_update = optim.adamski()
    opt_state = opt_init(params)
    # fused dispatch groups (training.make_train_multi_step, identical maths
    # to single steps; cli/train.py --steps_per_dispatch)
    K = 10
    step = training.make_train_multi_step(layer, opt_update, min_prob=1e-30,
                                          drop=20)
    rs = np.random.RandomState(0)
    B, T = 100, 2000
    x = jnp.asarray(rs.normal(size=(K, T, B, 1)).astype(np.float32))
    labels = jnp.asarray(
        rs.randint(0, 1025, size=(K, T // 5, B)).astype(np.int32))
    w = jnp.ones((K, T // 5, B), jnp.float32)
    lrs = jnp.full(K, 1e-3, jnp.float32)
    params, opt_state, loss, acc = step(params, opt_state, x, labels, w, lrs)
    jax.block_until_ready(loss)
    t0 = time.time()
    nrep = 12
    for _ in range(nrep):
        params, opt_state, loss, acc = step(params, opt_state, x, labels, w,
                                            lrs)
    jax.block_until_ready(loss)
    chunks_per_sec = B * K / ((time.time() - t0) / nrep)
    f_chunk = T * flops_mod.training_flops_per_input_frame(layer, params)
    achieved = chunks_per_sec * f_chunk
    return {
        "training_chunks_per_sec": round(chunks_per_sec, 1),
        "training_flops_per_chunk": round(f_chunk, 1),
        "training_achieved_tflops": round(achieved / 1e12, 3),
        "training_mfu_pct_bf16_peak": _share(achieved),
    }


if __name__ == "__main__":
    sys.exit(main())
