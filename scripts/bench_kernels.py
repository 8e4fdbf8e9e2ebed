#!/usr/bin/env python3
"""Hand-written kernels against what XLA makes of the plain version, on the
GPU, at the bench shapes, interleaved in one process.

    python scripts/bench_kernels.py [--sections viterbi,gru,train,basecall,remap]
                                    [--sweep] [--reps N] [--out FILE]

* viterbi  — isolated stage: the Pallas kernel (bfloat16 posterior stream)
  vs ``decode_jax.viterbi`` (float32, as the XLA path streams it) on a
  (3277, 1024, 1025) posterior, with parity of the two on float32 input;
* gru      — isolated stage: one GRU layer forward at T=3277, B=1024,
  S=110 and 142, kernel vs XLA scan;
* train    — end to end: ``make_train_multi_step`` on raw_0.98_rgrgr,
  B=100 x 2000 samples, 10 steps per dispatch, GRU kernel vs XLA scan;
* basecall — end to end: ``Basecaller.basecall_dac_reads`` on raw_1.00_rGr,
  B=1024 x C=16384, bfloat16, kernels (GRU + Viterbi) vs XLA for both;
* remap    — ``Remapper`` at batch 64 on 50k-110k-sample reads, exact DP vs
  the band-768 DP with its anchor-widen retries: compile (first call) and
  warm time, and the share of reads whose path stays inside the band.

Times are wall-clock around work that ends in ``block_until_ready``; each
pair is measured A, B, B, A and the median of each side is reported.
Every line names the card (nvidia-smi name and power limit).
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("SLOIKA_TPU_COMPUTE_DTYPE", "bfloat16")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

RESULTS = {}


def log(*a):
    print(*a, flush=True)


def timed(fn, reps):
    import jax
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return ts


def abba(name, fa, fb, reps, labels=("kernel", "xla")):
    """Warm both, then time A B B A ``reps`` times each; report medians."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fa())
    ca = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fb())
    cb = time.perf_counter() - t0
    ta, tb = [], []
    for i in range(reps):
        first, second = (fa, fb) if i % 2 == 0 else (fb, fa)
        t1 = timed(first, 1)
        t2 = timed(second, 1)
        (ta if first is fa else tb).extend(t1)
        (tb if first is fa else ta).extend(t2)
    ma, mb = float(np.median(ta)), float(np.median(tb))
    RESULTS[name] = {labels[0] + "_s": ma, labels[1] + "_s": mb,
                     labels[0] + "_first_call_s": ca,
                     labels[1] + "_first_call_s": cb,
                     labels[0] + "_all_s": ta, labels[1] + "_all_s": tb}
    log("[{}] {} {:.4f} s, {} {:.4f} s (median of {}; first calls {:.2f} s /"
        " {:.2f} s); {}/{} = {:.3f}".format(
            name, labels[0], ma, labels[1], mb, reps, ca, cb, labels[0],
            labels[1], ma / mb))
    return ma, mb


def set_rnn_impl(layer, impl):
    from sloika_tpu import nn
    if isinstance(layer, nn.Gru):
        layer.impl = impl
    for sub in getattr(layer, "layers", ()):
        set_rnn_impl(sub, impl)
    if hasattr(layer, "layer"):
        set_rnn_impl(layer.layer, impl)


def section_viterbi(reps, sweep):
    import jax
    import jax.numpy as jnp
    from sloika_tpu.ops import decode_jax
    from sloika_tpu.ops.pallas import viterbi as pv

    T, B, K1 = 3277, 1024, 1025
    key = jax.random.PRNGKey(0)
    post32 = jax.jit(lambda k: jax.nn.softmax(
        2.0 * jax.random.normal(k, (T, B, K1)), axis=-1))(key)
    post16 = post32.astype(jnp.bfloat16)
    jax.block_until_ready(post16)

    # parity on float32 input: every row
    s1, p1, m1 = pv.viterbi(post32, 5, skip_pen=5.0, time_major=True)
    s2, p2, m2 = decode_jax.viterbi(post32, 5, skip_pen=5.0, time_major=True)
    same = np.asarray(jnp.all(p1 == p2, axis=1) & jnp.all(m1 == m2, axis=1))
    ds = float(jnp.max(jnp.abs(s1 - s2) / jnp.abs(s2)))
    log("[viterbi parity] kernel vs XLA, float32 input (3277, 1024, 1025): "
        "{} of {} rows identical paths; max rel score diff {:.3g}".format(
            int(same.sum()), B, ds))
    RESULTS["viterbi_parity"] = {"identical_rows": int(same.sum()),
                                 "rows": B, "max_rel_score_diff": ds}
    del s1, p1, m1, s2, p2, m2

    variants = [(pv.BLOCK_ROWS, pv.NUM_WARPS)]
    if sweep:
        variants += [(8, 4), (8, 8), (2, 4)]
    for bb, nw in variants:
        # the kernel reads the module constants at trace time
        pv.BLOCK_ROWS, pv.NUM_WARPS = bb, nw
        jax.clear_caches()
        fk = lambda: pv.viterbi(post16, 5, skip_pen=5.0, time_major=True)
        ts = timed(fk, 1) + timed(fk, reps)
        log("[viterbi kernel] bf16 stream BB={} warps={}: first {:.3f} s, "
            "median {:.4f} s".format(bb, nw, ts[0], np.median(ts[1:])))
        RESULTS["viterbi_kernel_bb{}_w{}".format(bb, nw)] = float(
            np.median(ts[1:]))
    pv.BLOCK_ROWS, pv.NUM_WARPS = variants[0]
    jax.clear_caches()
    fk = lambda: pv.viterbi(post16, 5, skip_pen=5.0, time_major=True)
    fx = lambda: decode_jax.viterbi(post32, 5, skip_pen=5.0, time_major=True)
    try:
        abba("viterbi stage B=1024", fk, fx, reps)
    except Exception as e:          # the XLA decode may not fit
        log("[viterbi stage B=1024] XLA decode failed: {}".format(
            str(e).splitlines()[0][:300]))
        RESULTS["viterbi_xla_error"] = str(e).splitlines()[0][:300]
    stats = jax.devices()[0].memory_stats() or {}
    log("[memory] viterbi section peak_bytes_in_use {}".format(
        stats.get("peak_bytes_in_use")))


def section_gru(reps, sweep):
    import jax
    import jax.numpy as jnp
    from sloika_tpu import nn
    from sloika_tpu.nn import pallas_gru
    import sloika_tpu.module_tools as smt

    T, B = 3277, 1024
    rs = np.random.RandomState(0)
    for S, I in ((110, 128), (142, 110)):
        params = nn.Gru(I, S, init=smt.truncated_normal(0.5),
                        has_bias=True).init(jax.random.PRNGKey(S))
        x = jnp.asarray(rs.normal(size=(T, B, I)).astype(np.float32))
        lens = jnp.full((B,), T, jnp.int32)

        def run(impl, I=I, S=S, params=params, x=x):
            layer = nn.Gru(I, S, has_bias=True, impl=impl)
            f = jax.jit(lambda p, x: layer.apply_with_lengths(p, x, lens)[0])
            return lambda: f(params, x)
        variants = [(pallas_gru.BLOCK_ROWS, pallas_gru.NUM_WARPS)]
        if sweep:
            variants += [(16, 4), (32, 8)]
        for bb, nw in variants[1:]:
            pallas_gru.BLOCK_ROWS, pallas_gru.NUM_WARPS = bb, nw
            fk = run("pallas")
            ts = timed(fk, 1) + timed(fk, reps)
            log("[gru kernel] S={} BB={} warps={}: median {:.4f} s".format(
                S, bb, nw, np.median(ts[1:])))
            RESULTS["gru_S{}_bb{}_w{}".format(S, bb, nw)] = float(
                np.median(ts[1:]))
        pallas_gru.BLOCK_ROWS, pallas_gru.NUM_WARPS = variants[0]
        fk, fx = run("pallas"), run("xla")
        out_k, out_x = fk(), fx()
        err = float(jnp.max(jnp.abs(out_k - out_x)))
        log("[gru parity] S={} bf16 forward kernel vs XLA scan: max abs "
            "diff {:.3g}".format(S, err))
        abba("gru forward S={} T={} B={}".format(S, T, B), fk, fx, reps)


def section_train(reps):
    import jax
    import jax.numpy as jnp
    from sloika_tpu import optim, training
    from sloika_tpu.models import build

    K, B, T = 10, 100, 2000
    rs = np.random.RandomState(0)
    xs = jnp.asarray(rs.normal(size=(K, T, B, 1)).astype(np.float32))
    ls = jnp.asarray(rs.randint(0, 1025, size=(K, T // 5, B)).astype(
        np.int32))
    ws = jnp.ones((K, T // 5, B), jnp.float32)
    lrs = jnp.full(K, 1e-3, jnp.float32)
    opt_init, opt_update = optim.adamski()
    fns = {}
    for impl in ("pallas", "xla"):
        layer = build("raw_0.98_rgrgr", klen=5, sd=0.5, nfeature=1,
                      winlen=11, stride=5)
        set_rnn_impl(layer, impl)
        params = layer.init(jax.random.PRNGKey(0))
        step = training.make_train_multi_step(layer, opt_update,
                                              min_prob=1e-30, drop=20)
        state = {"p": params, "s": opt_init(params)}

        def f(step=step, state=state):
            state["p"], state["s"], loss, acc = step(
                state["p"], state["s"], xs, ls, ws, lrs)
            return loss
        fns[impl] = f
    a, b = abba("train dispatch K=10 B=100 T=2000", fns["pallas"],
                fns["xla"], reps)
    log("[train] chunks/s: kernel {:.0f}, xla {:.0f}".format(
        K * B / a, K * B / b))


def section_basecall(reps):
    import chip_smoke as cs
    from sloika_tpu import basecall as bc

    layer, params = cs.build("raw_1.00_rGr", 1)
    reads = cs.basecall_reads(128, 16384, 400, 1)
    dacs = [(r["dac"], r["norm4"]) for r in reads]
    nsamp = sum(len(d) for d, _ in dacs)
    callers = {}
    for impl in ("pallas", "xla"):
        lay, _ = cs.build("raw_1.00_rGr", 1)
        set_rnn_impl(lay, impl)
        callers[impl] = bc.Basecaller(lay, params, 5, batch_size=1024,
                                      chunked=True, chunk_size=16384,
                                      overlap=400, output="bases",
                                      viterbi_impl=impl)
    outs = {}

    def run(impl):
        def f():
            outs[impl] = callers[impl].basecall_dac_reads(dacs)
            return 0
        return f
    try:
        a, b = abba("basecall e2e B=1024 C=16384 bf16 DAC", run("pallas"),
                    run("xla"), reps)
        log("[basecall] samples/s: kernel {:.0f}, xla {:.0f}".format(
            nsamp / a, nsamp / b))
        same = sum(int(np.array_equal(x[1], y[1]))
                   for x, y in zip(outs["pallas"], outs["xla"]))
        log("[basecall] kernel vs xla calls identical on {} of {} "
            "reads".format(same, len(dacs)))
    except Exception as e:
        log("[basecall] failed: {}".format(str(e).splitlines()[0][:300]))
        RESULTS["basecall_error"] = str(e).splitlines()[0][:300]


def section_remap(reps):
    import chip_smoke as cs
    from sloika_tpu.remap import Remapper

    layer, params = cs.build("raw_1.00_rGr", 1)
    reads = cs.simulate_reads(64, 50000, 110000, 4)
    dacs = [(r["dac"], r["norm4"]) for r in reads]
    refs = [r["sequence"] for r in reads]
    nsamp = sum(len(d) for d, _ in dacs)
    # both as users run them: the banded Remapper re-runs reads whose path
    # misses a sequence-end anchor with wider bands, then the exact DP
    rms = {band: Remapper(layer, params, 5, batch_size=64, band=band)
           for band in (768, None)}
    outs = {}

    def run(band):
        def f():
            outs[band] = rms[band].remap_dac_signals(dacs, refs)
            return 0
        return f
    a, b = abba("remap batch 64", run(768), run(None), reps,
                labels=("band768_retries", "exact"))
    log("[remap] samples/s: band768 with retries {:.0f}, exact {:.0f}".format(
        nsamp / a, nsamp / b))
    same = sum(int(np.array_equal(x[2], y[2]))
               for x, y in zip(outs[768], outs[None]))
    # the band's first pass alone: which reads it keeps (no retry)
    alone = Remapper(layer, params, 5, batch_size=64, band=768)
    alone.fallback = False
    first = alone.remap_dac_signals(dacs, refs)
    tol = 768 // 2
    kept = sum(int(o[2].min() <= tol and o[2].max() >= len(o[3]) - 1 - tol)
               for o in first)
    first_same = sum(int(np.array_equal(x[2], y[2]))
                     for x, y in zip(first, outs[None]))
    log("[remap] band 768: {} of {} reads stay inside the band on the first "
        "pass (no retry), {} of {} first-pass paths equal the exact path; "
        "with retries {} of {} equal".format(kept, len(dacs), first_same,
                                             len(dacs), same, len(dacs)))
    RESULTS["remap_band768"] = {"reads": len(dacs), "inside_band": kept,
                                "first_pass_equal_exact": first_same,
                                "with_retries_equal_exact": same}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections",
                    default="viterbi,gru,train,basecall,remap")
    ap.add_argument("--sweep", action="store_true",
                    help="also time block-size / warp variants")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/bench_kernels.json")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        sys.exit("bench_kernels: needs the GPU (default backend is {!r})"
                 .format(jax.default_backend()))
    from sloika_tpu import backend
    backend.init_compile_cache()
    card = backend.card_info()
    log("[device] {} ({}); nvidia-smi: {}".format(
        jax.devices()[0].device_kind, len(jax.devices()), card))
    RESULTS["card"] = card
    RESULTS["device_kind"] = jax.devices()[0].device_kind
    sections = {"viterbi": lambda: section_viterbi(args.reps, args.sweep),
                "gru": lambda: section_gru(args.reps, args.sweep),
                "train": lambda: section_train(args.reps),
                "basecall": lambda: section_basecall(args.reps),
                "remap": lambda: section_remap(args.reps)}
    failed = []
    for sec in args.sections.split(","):
        t0 = time.time()
        try:
            sections[sec]()
        except Exception as e:      # report and go on to the next section
            failed.append(sec)
            log("[section] {} FAILED: {!r}".format(sec, e)[:2000])
        log("[section] {} done in {:.1f} s".format(sec, time.time() - t0))
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(RESULTS, fh, indent=1)
    log("[device] nvidia-smi: {}".format(card))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
