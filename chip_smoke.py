#!/usr/bin/env python3
"""Smoke test of the main paths on the GPU, through the library entry points
the CLIs call.

    python chip_smoke.py               # one card: basecall, kernels,
                                       # training, remap
    python chip_smoke.py --four-cards  # four cards: data-parallel training and
                                       # mesh-sharded basecall vs one card

One card, at full model width with seeded random weights and seeded
simulated reads (``sloika_tpu.data.simulate``; no file is read):

* basecall — ``Basecaller`` on ``raw_1.00_rGr`` (128/110/142/110, stride 5),
  chunked B=1024 x C=16384, bfloat16, DAC input, device collapse;
* kernels — the Viterbi kernel against the numpy decoder on a subset of a
  real-width batch, and the GRU kernel (forward and gradient, both
  directions) against the plain XLA scan, each at the tolerances printed
  beside the result;
* training — ``training.train`` on ``raw_0.98_rgrgr``, B=100 x 2000 samples,
  fused steps; the held-out loss must be finite and must fall;
* remap — ``Remapper`` at batch 64 on simulated reads against their own
  sequences, and the paths it returns for the shortest reads against the
  numpy oracle.

Every phase prints its result and peak device memory.  The last line is
one JSON object naming the device.  Any failure exits non-zero; so does a
default backend other than the GPU.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

KLEN = 5
STRIDE = 5

#: Viterbi kernel vs numpy decoder: scores agree to this relative error;
#: paths are identical unless the kernel's path scores as a tie of the
#: numpy optimum within the same tolerance (float32 logs differ in the last
#: bit between the card's and numpy's log)
VITERBI_SCORE_RTOL = 1e-5
#: GRU kernel vs XLA scan under jax.default_matmul_precision("highest"):
#: (max abs error of the outputs, max error of each gradient relative to
#: its largest entry).  float32 operands run IEEE float32 in both, so only
#: summation order differs; bfloat16 operands round the state to 8 bits of
#: mantissa every step, so one rounding flip propagates through the chain.
GRU_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}
#: remap DP (float32 on the card) vs the float64 numpy oracle: paths are
#: identical unless the card's path, rescored in float64, ties the optimum
#: within this relative error
REMAP_SCORE_RTOL = 1e-5


def remap_score_tol(nframes, npos, score, slip):
    """Bound on the float32 DP's score error: one rounding (2^-24 relative)
    per frame of the largest magnitude the DP handles, the running score
    plus the slip scan's offset ``slip * npos``.  The max over rounded
    candidates drifts upward, so the float32 score can sit above the
    float64 optimum (on 10k-frame reads by about a tenth of this bound);
    run in float64, the same XLA DP gives the oracle's score and path."""
    return nframes * 2.0 ** -24 * (abs(score) + slip * npos)


def require(ok, message):
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not ok:
        raise RuntimeError(message)


def result_line(devices):
    """The last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def require_gpu():
    import jax
    if jax.default_backend() != "gpu":
        sys.stderr.write("chip_smoke: the default JAX backend is {!r}, not "
                         "'gpu'; this test runs only on the card\n".format(
                             jax.default_backend()))
        sys.exit(2)


def log(*args):
    print(*args, flush=True)


def peak_memory(label, devices=None):
    import jax
    devices = devices or jax.devices()[:1]
    peaks = []
    for d in devices:
        stats = d.memory_stats() or {}
        peaks.append(stats.get("peak_bytes_in_use"))
    log("[memory] after {}: peak_bytes_in_use {}".format(label, " ".join(
        "not reported" if p is None else "{} ({:.2f} GB)".format(p, p / 1e9)
        for p in peaks)))
    return peaks


# ---------------------------------------------------------------------------
# Seeded inputs
# ---------------------------------------------------------------------------

def simulate_reads(n, lo, hi, seed):
    """``n`` simulated reads of ``lo``..``hi`` samples: (signal f32, dac
    int16, norm4, sequence bytes) each."""
    from sloika_tpu import maths
    from sloika_tpu.basecall import scale_dac_f32
    from sloika_tpu.data import simulate

    rs = np.random.RandomState(seed)
    genome = simulate.random_genome(1 << 21, seed=seed)
    levels = simulate.pore_model(KLEN)
    reads = []
    for _ in range(n):
        L = int(rs.randint(lo, hi + 1))
        read = simulate.simulate_read(genome, rs, read_len=int(L / 8) + 100,
                                      kmer_len=KLEN, levels=levels)
        require(len(read["signal"]) >= L, "simulated read too short")
        # the bases whose kmers start inside the first L samples
        nk = int(np.searchsorted(np.cumsum(read["dwells"]), L)) + 1
        seq = read["sequence"][:nk + KLEN - 1]
        dac = np.clip(np.round(read["signal"][:L] * 300.0 + 2000.0),
                      -32768, 32767).astype(np.int16)
        offset, scale = np.float32(0.0), np.float32(1.0)
        s = scale_dac_f32(dac, offset, scale)
        norm4 = (offset, scale, np.float32(np.median(s)),
                 np.float32(maths.mad(s)))
        reads.append({"dac": dac, "norm4": norm4, "sequence": seq,
                      "dwells": read["dwells"][:nk],
                      "codes": read["codes"][:nk]})
    return reads


def normalised(read):
    from sloika_tpu.basecall import normalise_dac_f32
    return normalise_dac_f32(read["dac"], read["norm4"]).astype(np.float32)


def build(model, seed):
    import jax
    from sloika_tpu.models import build as build_model
    layer = build_model(model, klen=KLEN, sd=0.5, nfeature=1, winlen=11,
                        stride=STRIDE)
    return layer, layer.init(jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# Basecall
# ---------------------------------------------------------------------------

def basecall_reads(nreads, chunk, overlap, seed):
    """Reads that split into exactly 8 windows each (one full batch)."""
    core = chunk - 2 * overlap
    lo, hi = 2 * overlap + 7 * core + 1, 2 * overlap + 8 * core
    return simulate_reads(nreads, lo, hi, seed)


def phase_basecall(batch=1024, chunk=16384, overlap=400, seed=1):
    from sloika_tpu import basecall as bc
    layer, params = build("raw_1.00_rGr", seed)
    t0 = time.time()
    reads = basecall_reads(batch // 8, chunk, overlap, seed)
    dacs = [(r["dac"], r["norm4"]) for r in reads]
    log("[basecall] simulated {} reads in {:.1f} s".format(
        len(reads), time.time() - t0))
    caller = bc.Basecaller(layer, params, KLEN, batch_size=batch,
                           chunked=True, chunk_size=chunk, overlap=overlap,
                           output="bases")
    nsamples = sum(len(d) for d, _ in dacs)
    t0 = time.time()
    out = caller.basecall_dac_reads(dacs)
    t_first = time.time() - t0
    log("[basecall] first call (compile + run) {:.2f} s".format(t_first))
    t0 = time.time()
    out = caller.basecall_dac_reads(dacs)
    t_warm = time.time() - t0
    for o in out:
        require(o is not None, "a read was not basecalled")
        score, codes = o
        require(np.isfinite(score), "non-finite basecall score")
        require(len(codes) > 0 and int(np.max(codes)) < 4,
                "empty or invalid base codes")
    nbases = sum(len(o[1]) for o in out)
    log("[basecall] raw_1.00_rGr B={} C={} bf16 DAC: {} reads, {} samples, "
        "{} bases; first call (compile) {:.2f} s, warm call {:.3f} s "
        "({:.0f} samples/s)".format(batch, chunk, len(dacs), nsamples,
                                    nbases, t_first, t_warm,
                                    nsamples / t_warm))
    return caller, reads, out


def viterbi_path_score(lp, path, moved, skip_pen, nbase=4):
    """float64 score of a given path under log posteriors ``lp`` (T, 1+K)."""
    K = lp.shape[1] - 1
    lp = lp.astype(np.float64)
    t = np.arange(1, len(path))
    step = (path[:-1] % (K // nbase)) == (path[1:] // nbase)
    move = lp[t, 1 + path[1:]] - np.where(step, 0.0, skip_pen)
    return lp[0, 1 + path[0]] + np.sum(np.where(moved[1:], move, lp[t, 0]))


def check_viterbi(caller, reads, rows=(0, 341, 682, 1023), impl="pallas"):
    """Kernel vs numpy decoder on rows of one real-width posterior batch
    (the basecall phase's first window batch)."""
    import jax
    import jax.numpy as jnp
    from sloika_tpu import basecall as bc
    from sloika_tpu.ops import decode_jax, decode_np
    from sloika_tpu.ops.pallas import viterbi as pv

    C, B = caller.chunk_size, caller.batch_size
    sigs = [normalised(r) for r in reads]
    jobs = bc._window_jobs([len(s) for s in sigs], C, caller.overlap)[:B]
    x = np.zeros((C, B, 1), np.float32)
    lengths = np.ones(B, np.int32)
    for b, (r, _, start, ln, _) in enumerate(jobs):
        x[:ln, b, 0] = sigs[r][start:start + ln]
        lengths[b] = ln
    post, _ = jax.jit(caller._floored_masked_post)(
        caller.params, jnp.asarray(x), jnp.asarray(lengths))
    score, path, moved = pv.viterbi(post, KLEN, skip_pen=caller.skip,
                                    time_major=True,
                                    interpret=impl == "interpret")
    score, path, moved = (np.asarray(a) for a in (score, path, moved))
    post_np = np.asarray(post.astype(jnp.float32))
    exact = 0
    for b in rows:
        b = min(b, B - 1)
        ref_score, ref_calls = decode_np.viterbi(post_np[:, b], KLEN,
                                                 skip_pen=caller.skip)
        tol = VITERBI_SCORE_RTOL * abs(ref_score)
        require(abs(score[b] - ref_score) <= tol,
                "Viterbi score row {}: kernel {} numpy {}".format(
                    b, score[b], ref_score))
        calls = decode_jax.collapse_path(path[b], moved[b])
        if list(calls) == list(ref_calls):
            exact += 1
        else:
            lp = np.log(post_np[:, b] + 1e-10)
            ps = viterbi_path_score(lp, path[b], moved[b], caller.skip)
            require(abs(ps - ref_score) <= tol,
                    "Viterbi path row {} differs and is not a tie ({} vs "
                    "{})".format(b, ps, ref_score))
    log("[parity] Viterbi kernel vs numpy decoder, posterior {} {}: {} rows, "
        "{} identical paths, the rest ties; scores within rtol {}".format(
            post.dtype, tuple(post.shape), len(rows), exact,
            VITERBI_SCORE_RTOL))


def check_gru(impl="pallas", T=3277, B=32, widths=(110, 142),
              grad_shape=(400, 100, 96), seed=3):
    """GRU kernel vs the plain XLA scan, forward at the basecall widths and
    gradient at the training shape, for float32 and bfloat16 operands."""
    import jax
    import jax.numpy as jnp
    from sloika_tpu.nn import pallas_gru

    interpret = impl == "interpret"
    hi = jax.lax.Precision.HIGHEST
    rs = np.random.RandomState(seed)

    def inputs(T, B, S):
        xp = jnp.asarray(rs.normal(size=(T, B, 3 * S)).astype(np.float32))
        sW = jnp.asarray(rs.normal(scale=1.0 / np.sqrt(2 * S),
                                   size=(2, S, S)).astype(np.float32))
        sW2 = jnp.asarray(rs.normal(scale=1.0 / np.sqrt(2 * S),
                                    size=(S, S)).astype(np.float32))
        lens = rs.randint(T // 2, T + 1, size=B)
        mask = jnp.asarray((np.arange(T)[:, None] < lens[None, :])
                           .astype(np.int8))
        return xp, sW, sW2, mask

    with jax.default_matmul_precision("highest"):
        for name, dtype in (("float32", np.dtype(np.float32)),
                            ("bfloat16", np.dtype(jnp.bfloat16))):
            out_tol, grad_tol = GRU_TOL[name]
            for S, reverse in zip(widths, (True, False)):
                xp, sW, sW2, mask = inputs(T, B, S)
                got = jax.jit(lambda *a: pallas_gru.gru_fused(
                    *a, reverse, hi, dtype, interpret))(xp, sW, sW2, mask)
                ref = jax.jit(lambda *a: pallas_gru.reference_scan(
                    *a, reverse, dtype, hi))(xp, sW, sW2, mask)
                valid = np.asarray(mask)[:, :, None] != 0
                err = float(np.max(np.abs(np.where(
                    valid, np.asarray(got) - np.asarray(ref), 0.0))))
                log("[parity] GRU forward {} T={} B={} S={}: max abs err "
                    "{:.3g} (tol {})".format(name, T, B, S, err, out_tol))
                require(err <= out_tol, "GRU forward parity failed")
            Tg, Bg, Sg = grad_shape
            xp, sW, sW2, mask = inputs(Tg, Bg, Sg)
            w = jnp.asarray(rs.normal(size=(Tg, Bg, Sg)).astype(np.float32)
                            ) * mask[:, :, None]

            def loss(fn):
                return jax.jit(jax.grad(
                    lambda xp, sW, sW2: jnp.sum(fn(xp, sW, sW2) * w),
                    argnums=(0, 1, 2)))

            for reverse in (True, False):
                g_k = loss(lambda *a: pallas_gru.gru_fused(
                    *a, mask, reverse, hi, dtype, interpret))(xp, sW, sW2)
                g_r = loss(lambda *a: pallas_gru.reference_scan(
                    *a, mask, reverse, dtype, hi))(xp, sW, sW2)
                for gname, a, b in zip(("dxp", "dsW", "dsW2"), g_k, g_r):
                    a, b = np.asarray(a), np.asarray(b)
                    rel = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                    log("[parity] GRU gradient {} {} reverse={} T={} B={} "
                        "S={}: max err / max |ref| {:.3g} (tol {})".format(
                            name, gname, reverse, Tg, Bg, Sg, rel, grad_tol))
                    require(rel <= grad_tol, "GRU gradient parity failed")
# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def training_data(nchunks, chunk_len, seed):
    """Labelled chunks cut from simulated reads: the kmer state (1-based)
    at the frame where it starts, blank (0) elsewhere."""
    nlab = chunk_len // STRIDE
    per_read = 40
    reads = simulate_reads(-(-nchunks // per_read), per_read * chunk_len,
                           per_read * chunk_len + 1000, seed)
    chunks, labels = [], []
    for r in reads:
        sig = normalised(r)
        starts = np.concatenate([[0], np.cumsum(r["dwells"])[:-1]])
        lab = np.zeros(len(sig) // STRIDE + 1, np.int32)
        lab[starts // STRIDE] = r["codes"] + 1
        for c in range(per_read):
            chunks.append(sig[c * chunk_len:(c + 1) * chunk_len])
            labels.append(lab[c * nlab:(c + 1) * nlab])
    n = nchunks
    return {"chunks": np.stack(chunks[:n])[:, :, None],
            "labels": np.stack(labels[:n]),
            "bad": np.zeros((n, nlab), bool),
            "weights": np.full(n, 1.0 / n)}


def phase_training(batch=100, chunk_len=2000, nchunks=1000, niteration=60,
                   steps_per_dispatch=10, seed=2):
    import jax
    import jax.numpy as jnp
    from sloika_tpu import training

    layer, params = build("raw_0.98_rgrgr", seed)
    data = training_data(nchunks, chunk_len, seed)
    held = {k: v[:2 * batch] for k, v in data.items()}
    before, _ = training.validate(layer, params, held, batch_size=batch,
                                  drop=20, quiet=True)
    t0 = time.time()
    trained, _ = training.train(
        layer, jax.tree_util.tree_map(jnp.array, params), data,
        batch_size=batch, chunk_len_range=(1.0, 1.0), drop=20,
        niteration=niteration, steps_per_dispatch=steps_per_dispatch,
        seed=seed, quiet=True, save_every=10 ** 9)
    jax.block_until_ready(trained)
    dt = time.time() - t0
    after, _ = training.validate(layer, trained, held, batch_size=batch,
                                 drop=20, quiet=True)
    log("[training] raw_0.98_rgrgr B={} x {} samples, {} steps ({} per "
        "dispatch) in {:.2f} s incl. compile; held loss {:.4f} -> "
        "{:.4f}".format(batch, chunk_len, niteration, steps_per_dispatch,
                        dt, before, after))
    require(np.isfinite(before) and np.isfinite(after), "non-finite loss")
    require(after < before, "training loss did not fall")
# ---------------------------------------------------------------------------
# Remap
# ---------------------------------------------------------------------------

def remap_path_score(lt, seq, path, slip, p0, p1):
    """float64 score of a remap path (reference transducer.py semantics)."""
    lt = lt.astype(np.float64)
    emit = lt[np.arange(len(path)), seq[path]]
    jump = np.diff(path)
    i = np.arange(1, len(path))
    step_score = np.where(jump == 0, lt[i, 0],
                          emit[1:] - slip * np.maximum(jump - 1, 0))
    return (p0[path[0]] + max(emit[0], lt[0, 0]) + np.sum(step_score)
            + p1[path[-1]])


def check_remap(layer, params, reads, slip=5.0, prior=25.0):
    """Paths ``Remapper.remap_dac_signals`` returns vs the numpy oracle.

    The oracle is given the log posteriors the Remapper's DP was given:
    the DP entry points are wrapped so that each compiled call also sends
    its (log posteriors, sequence states) to the host.  A read's last
    capture is the one its returned path came from (the anchor-widen
    retries of a banded run come after the first pass)."""
    import jax
    from sloika_tpu import bio, remap, util
    from sloika_tpu.ops import remap_banded, remap_jax, remap_np

    captured = []

    def capturing(fn):
        def wrapped(lt, seq_states, *args):
            jax.debug.callback(
                lambda a, s: captured.append((np.asarray(a), np.asarray(s))),
                lt, seq_states)
            return fn(lt, seq_states, *args)
        return wrapped

    saved = remap_jax.map_to_sequence, remap_banded.map_to_sequence_banded
    remap_jax.map_to_sequence = capturing(saved[0])
    remap_banded.map_to_sequence_banded = capturing(saved[1])
    try:
        remapper = remap.Remapper(layer, params, KLEN, slip=slip,
                                  prior=(prior, prior),
                                  batch_size=len(reads))
        out = remapper.remap_dac_signals(
            [(r["dac"], r["norm4"]) for r in reads],
            [r["sequence"] for r in reads])
        jax.effects_barrier()
    finally:
        remap_jax.map_to_sequence, remap_banded.map_to_sequence_banded = saved

    identical = 0
    for r, (score, _, path, seq) in zip(reads, out):
        n = len(seq)
        rows = [(lt, i) for lt, states in captured
                for i in range(len(states))
                if np.array_equal(states[i, :n], seq)
                and (n == states.shape[1] or states[i, n] == 0)]
        require(rows, "no captured log posteriors for a remapped read")
        lt, i = rows[-1]
        lt = lt[i, :len(path)]
        p0 = util.geometric_prior(n, prior).astype(np.float32)
        p1 = util.geometric_prior(n, prior, rev=True).astype(np.float32)
        ref_score, ref_path = remap_np.map_to_sequence(lt, seq, slip, p0, p1)
        score_tol = remap_score_tol(len(lt), n, ref_score, slip)
        got = remap_path_score(lt, seq, path, slip, p0, p1)
        log("[parity] remap read of {} frames, {} positions: score Remapper "
            "{:.4f} numpy {:.4f} (diff {:.4f}, float32 bound {:.4f}); path "
            "{}, its float64 score {:.4f}".format(
                len(lt), n, score, ref_score, score - ref_score, score_tol,
                "identical" if np.array_equal(path, ref_path) else "differs",
                got))
        require(abs(score - ref_score) <= score_tol,
                "remap score: Remapper {} numpy {}".format(score, ref_score))
        if np.array_equal(path, ref_path):
            identical += 1
        else:
            require(abs(got - ref_score) <= REMAP_SCORE_RTOL * abs(ref_score),
                    "remap path differs and is not a tie ({} vs {})".format(
                        got, ref_score))
    log("[parity] remap: Remapper (band {}) vs numpy oracle on the same log "
        "posteriors: {} reads, {} identical paths, the rest ties within "
        "rtol {} (float64 rescoring); scores within the float32 "
        "bound".format(remapper.band, len(reads), identical,
                       REMAP_SCORE_RTOL))
    return identical


def phase_remap(batch=64, lo=50000, hi=110000, seed=4, ncheck=3):
    from sloika_tpu.remap import Remapper

    layer, params = build("raw_1.00_rGr", 1)
    reads = simulate_reads(batch, lo, hi, seed)
    remapper = Remapper(layer, params, KLEN, batch_size=batch)
    dacs = [(r["dac"], r["norm4"]) for r in reads]
    refs = [r["sequence"] for r in reads]
    t0 = time.time()
    out = remapper.remap_dac_signals(dacs, refs)
    t_first = time.time() - t0
    t0 = time.time()
    out = remapper.remap_dac_signals(dacs, refs)
    t_warm = time.time() - t0
    for o in out:
        require(o is not None and np.isfinite(o[0]), "remap failed")
    nsamples = sum(len(d) for d, _ in dacs)
    log("[remap] Remapper batch {} band {}: {} reads, {} samples; first call "
        "{:.2f} s, warm call {:.3f} s ({:.0f} samples/s)".format(
            batch, remapper.band, len(dacs), nsamples, t_first, t_warm,
            nsamples / t_warm))
    shortest = sorted(reads, key=lambda r: len(r["dac"]))[:ncheck]
    check_remap(layer, params, shortest)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def phase_four_cards(ncards=4, batch=100, chunk_len=2000, nsteps=3,
                     bc_batch=1024, chunk=16384, overlap=400, seed=5):
    """Data-parallel training step and mesh-sharded basecall on ``ncards``
    cards against one card, on the same global batch."""
    import jax
    import jax.numpy as jnp
    from sloika_tpu import basecall as bc, optim, training
    from sloika_tpu.parallel import mesh as meshlib

    devices = jax.devices()[:ncards]
    require(len(devices) == ncards, "need {} devices".format(ncards))
    mesh = meshlib.make_mesh(ncards)

    # training: same batches, one card vs the mesh
    layer, params = build("raw_0.98_rgrgr", seed)
    data = training_data(batch * nsteps, chunk_len, seed)
    # SGD, so parameter differences track gradient differences (ADAMski's
    # first steps are sign-like and turn float noise in near-zero gradients
    # into lr-sized parameter differences)
    opt_init, opt_update = optim.sgd(0.9)
    results = []
    for m in (None, mesh):
        step = training.make_train_step(layer, opt_update, min_prob=1e-30,
                                        drop=20, mesh=m)
        p = jax.tree_util.tree_map(jnp.array, params)
        s = opt_init(p)
        losses = []
        for i in range(nsteps):
            sl = slice(i * batch, (i + 1) * batch)
            x = np.ascontiguousarray(np.moveaxis(data["chunks"][sl], 0, 1))
            lab = np.ascontiguousarray(data["labels"][sl].T)
            w = np.ones_like(lab, np.float32)
            if m is not None:
                x = meshlib.put_host_batch(x, meshlib.batch_sharding(m))
                lab = meshlib.put_host_batch(lab, meshlib.batch2_sharding(m))
                w = meshlib.put_host_batch(w, meshlib.batch2_sharding(m))
                require(len(x.sharding.device_set) == ncards,
                        "a batch is not sharded over every card")
            p, s, loss, _ = step(p, s, x, lab, w, jnp.float32(1e-3))
            losses.append(float(loss))
        results.append((losses, p))
    (l1, p1), (l4, p4) = results
    leaves4 = jax.tree_util.tree_leaves(p4)
    require(all(len(a.sharding.device_set) == ncards for a in leaves4),
            "parameters are not replicated over the mesh")
    dloss = max(abs(a - b) / abs(a) for a, b in zip(l1, l4))
    dparam = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                 for a, b in zip(jax.tree_util.tree_leaves(p1), leaves4))
    log("[four-cards] training step raw_0.98_rgrgr B={} on {} cards vs 1: "
        "losses {} vs {}; max rel loss diff {:.3g} (tol 1e-3), max abs "
        "param diff after {} steps {:.3g} (tol 1e-4)".format(
            batch, ncards, [round(v, 5) for v in l4],
            [round(v, 5) for v in l1], dloss, nsteps, dparam))
    require(dloss <= 1e-3 and dparam <= 1e-4, "data-parallel training differs")
    # basecall: the same reads on one card and sharded over the mesh
    blayer, bparams = build("raw_1.00_rGr", seed)
    reads = basecall_reads(bc_batch // 8, chunk, overlap, seed)
    dacs = [(r["dac"], r["norm4"]) for r in reads]
    outs, times = [], []
    for m in (None, mesh):
        caller = bc.Basecaller(blayer, bparams, KLEN, batch_size=bc_batch,
                               chunked=True, chunk_size=chunk,
                               overlap=overlap, output="bases", mesh=m)
        caller.basecall_dac_reads(dacs)
        t0 = time.time()
        outs.append(caller.basecall_dac_reads(dacs))
        times.append(time.time() - t0)
    same = sum(int(a[0] == b[0] and np.array_equal(a[1], b[1]))
               for a, b in zip(*outs))
    peaks = peak_memory("four-card phases", devices)
    log("[four-cards] basecall B={} C={} on {} cards vs 1: {} of {} reads "
        "identical; warm call {:.3f} s vs {:.3f} s".format(
            bc_batch, chunk, ncards, same, len(dacs), times[1], times[0]))
    require(same == len(dacs), "sharded basecall differs from one card")
    require(all(p is None or p > 0 for p in peaks), "a card was never used")
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card training and basecall "
                             "paths and their one-card comparisons")
    args = parser.parse_args(argv)

    # the served configuration: bfloat16 matmuls (read when
    # sloika_tpu.config is first imported)
    os.environ.setdefault("SLOIKA_TPU_COMPUTE_DTYPE", "bfloat16")
    require_gpu()
    import jax
    from sloika_tpu import backend

    cache = backend.init_compile_cache()
    card = backend.card_info()
    log("[device] {} x {} ({}); nvidia-smi: {}".format(
        len(jax.devices()), jax.devices()[0].device_kind,
        jax.default_backend(), card))
    log("[device] compile cache: {}".format(cache))
    log("[device] peaks: {}".format(backend.peaks()))

    if args.four_cards:
        log("[phase] four cards")
        phase_four_cards()
        devices = jax.devices()[:4]
    else:
        log("[phase] basecall")
        caller, reads, _ = phase_basecall()
        peak_memory("basecall")
        log("[phase] Viterbi parity")
        check_viterbi(caller, reads)
        del caller
        peak_memory("Viterbi parity")
        log("[phase] GRU parity")
        check_gru()
        peak_memory("GRU parity")
        log("[phase] training")
        phase_training()
        peak_memory("training")
        log("[phase] remap")
        phase_remap()
        peak_memory("remap")
        devices = jax.devices()[:1]
    log("[device] nvidia-smi: {}".format(card))
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
