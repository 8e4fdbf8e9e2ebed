"""Batched device basecalling.

Redesign of the reference's per-read process-pool basecaller
(/root/reference/bin/basecall_network.py, sloika/basecall.py): instead of one
Theano forward per read per worker process, reads are length-bucketed,
tail-padded, and run through the jitted forward + Viterbi decode as batches
on the device.  Length-masked scans (nn.core.Layer.apply_with_lengths) make
the padded batch bit-equivalent to per-read runs; padded frames are replaced
by one-hot stays, which are neutral for the decoded (argmax-rooted) path.

Decode dispatch mirrors reference ``decode_post`` (basecall.py:26-51):
transducer models use the kmer Viterbi with skip penalty; non-transducer
models fall back to the host-side legacy decoder.
"""
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from sloika_tpu import backend, bio, maths, util
from sloika_tpu.config import sloika_dtype
from sloika_tpu.data import batching
from sloika_tpu.data import features as features_mod
from sloika_tpu.ops import decode_jax, decode_np, olddecode
from sloika_tpu.parallel import mesh as meshlib
from sloika_tpu.variables import nstate, DEFAULT_ALPHABET

_ETA = 1e-10

#: DAC mode groups consecutive reads so one flat device sample buffer stays
#: bounded (128 MB int16; int32 window offsets can never overflow)
_MAX_GROUP_SAMPLES = 1 << 26

#: DAC pipeline group target (~16.8M samples = 32 MB int16): sized so one
#: group yields ~one full 1024-window device batch at the production
#: C=16384, and small enough that shipping group g+1 on the prefetch
#: worker overlaps group g's device compute + output pulls
_PIPE_GROUP_SAMPLES = 1 << 24


def _infer_stride(layer):
    """Total temporal downsampling factor of a layer graph."""
    from sloika_tpu import nn
    if isinstance(layer, nn.Serial):
        s = 1
        for l in layer.layers:
            s *= _infer_stride(l)
        return s
    if isinstance(layer, (nn.Convolution, nn.MaxPool)):
        return layer.stride
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return _infer_stride(layer.layer)
    if isinstance(layer, nn.Parallel):
        return _infer_stride(layer.layers[0])
    return 1


def _contains_studentise(layer):
    """True if the layer graph contains a Studentise layer anywhere."""
    from sloika_tpu import nn
    if isinstance(layer, nn.Studentise):
        return True
    if isinstance(layer, (nn.Serial, nn.Parallel)):
        return any(_contains_studentise(l) for l in layer.layers)
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return _contains_studentise(layer.layer)
    return False


def _round_up(n, k):
    return ((n + k - 1) // k) * k


def bucket_length(n, min_len=2048, factor=1.5):
    """Smallest bucketed length >= n (geometric buckets bound compilations
    to O(log max_len / log factor))."""
    b = min_len
    while b < n:
        b = int(np.ceil(b * factor))
    return b


def _window_jobs(read_lens, chunk_size, overlap):
    """The canonical chunked-mode window split: window ``w`` of read ``r``
    covers samples ``[w*core, w*core + C)`` with ``core = C - 2*overlap``.

    Single source of truth for job generation AND seam stitching — every
    chunked path (signals, bases, DAC) and :meth:`Basecaller._stitch_bases`
    derive their windowing from this function, so they cannot desynchronise.

    :returns: list of (read, window, start, length, nwin_of_read)
    """
    C, V = chunk_size, overlap
    core = C - 2 * V
    assert core > 0, "chunk_size must exceed 2*overlap"
    jobs = []
    for r, L in enumerate(read_lens):
        nwin = max(1, -(-max(L - 2 * V, 1) // core))
        for w in range(nwin):
            start = w * core
            jobs.append((r, w, start, min(C, L - start), nwin))
    return jobs


def bucket_batch(b, cap, mesh_size=1):
    """Smallest power-of-two >= b (capped at the configured batch size, and
    a multiple of the mesh size): batch dimensions are bucketed so a
    remainder batch — e.g. the final 37 windows of a read set — reuses a
    cached program instead of paying a fresh XLA compile per distinct
    batch size."""
    p = 1
    while p < b:
        p *= 2
    p = min(p, max(cap, b))
    return _round_up(max(p, b), mesh_size)


class Basecaller(object):
    """Batched basecaller for a transducer model.

    :param layer, params: the network
    :param kmer_len: kmer length of the output state space
    :param transducer: decode with the kmer-transducer Viterbi
    :param bad: model has a bad state at column 0
    :param min_prob: posterior probability floor
    :param skip: transducer skip penalty
    :param batch_size: reads decoded per device dispatch

    The non-transducer path (``transducer=False``) decodes on the host and
    must pull the full (T', B, nstate) posteriors off the device — on a
    slow host link this dominates the runtime.  It exists for parity with
    the reference's legacy event models (basecall_network.py:26-51); all
    throughput modes (chunked/bases) require transducer decoding.
    """

    def __init__(self, layer, params, kmer_len, transducer=True, bad=False,
                 min_prob=1e-5, skip=5.0, trans=None,
                 alphabet=DEFAULT_ALPHABET, batch_size=8,
                 chunked=False, chunk_size=8192, overlap=400, stride=None,
                 viterbi_impl="auto", mesh=None, output="states",
                 post_dtype="auto", wire="int16", pipeline_ship=True):
        self.layer = layer
        self.params = params
        self.kmer_len = kmer_len
        self.transducer = transducer
        self.bad = bad
        self.min_prob = min_prob
        self.skip = skip
        self.trans = trans
        self.alphabet = alphabet
        self.nbase = len(alphabet)
        self.batch_size = batch_size
        expected = nstate(kmer_len, transducer=transducer, bad_state=bad,
                          nbase=self.nbase)
        assert layer.size == expected, \
            "model emits {} states, decode expects {}".format(layer.size, expected)
        self._fwd_cache = {}
        self.chunked = chunked
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.model_stride = stride or _infer_stride(layer)
        # 'auto': the Pallas kernel on a GPU (register-resident DP state,
        # int8 traceback codes), XLA on the CPU (backend.resolve_impl)
        self.viterbi_impl = backend.resolve_impl(viterbi_impl)
        kernel = self.viterbi_impl in ("pallas", "interpret")
        #: optional ('data',) mesh: window/read batches are sharded over the
        #: batch axis and decoded across all devices (params replicated)
        self.mesh = mesh
        if mesh is not None and batch_size % mesh.size != 0:
            self.batch_size = _round_up(batch_size, mesh.size)
        #: "states" returns kmer-state calls (bit-parity with per-read
        #: decoding; the reference convention).  "bases" (chunked transducer
        #: mode only) collapses calls to 2-bit base codes *on device* and
        #: transfers four packed codes per byte — ~25x less device->host
        #: traffic than the int16 state path.
        assert output in ("states", "bases")
        if output == "bases":
            assert chunked and transducer and self.nbase == 4, \
                "bases output requires chunked transducer mode (ACGT)"
        self.output = output
        #: Studentise mixes statistics over the whole (time, batch) block,
        #: so padded/windowed batches are undefined for it
        #: (reference layers.py:161-189 normalises each full read).  Fall
        #: back to exact per-read unpadded forwards — the reference's own
        #: per-read-per-process execution model — instead of surfacing the
        #: NotImplementedError from apply_with_lengths.
        self.studentise_fallback = _contains_studentise(layer)
        if self.studentise_fallback and (chunked or output == "bases"):
            sys.stderr.write(
                "Model contains a Studentise layer: batched padded/chunked "
                "decoding is undefined for it; falling back to exact "
                "per-read basecalling (slower).\n")
            self.chunked = False
            self.output = "states"
        #: dtype the posterior streams to the Pallas Viterbi kernel in.
        #: "auto" follows config.compute_dtype: when the model's matmuls
        #: already run in bfloat16, streaming the posterior at bfloat16
        #: halves the kernel's dominant device-memory read (and the
        #: forward's posterior write) at little additional precision cost;
        #: the DP itself stays f32 after the in-kernel upcast.  Forced f32
        #: for the XLA impl (its whole DP would otherwise run in bf16).
        from sloika_tpu import config as _config
        if post_dtype == "auto":
            self.post_dtype = (jnp.bfloat16
                               if (_config.compute_dtype == jnp.bfloat16
                                   and kernel)
                               else jnp.float32)
        else:
            self.post_dtype = {"float32": jnp.float32,
                               "bfloat16": jnp.bfloat16}[str(post_dtype)]
            assert not (self.post_dtype == jnp.bfloat16 and not kernel), \
                "bfloat16 posterior streaming requires the Pallas kernel"
        #: DAC-mode input encoding: "int16" (default) ships the raw
        #: samples; "delta" a lossless int8 delta stream (+ exception
        #: sideband, one payload/one transfer) reconstructed on device —
        #: half the host->device bytes, bit-identical calls; opt-in.
        assert wire in ("delta", "int16")
        self.wire = wire
        #: ship group g+1 on a prefetch worker while group g computes
        #: (DAC mode; False serialises ships for A/B timing or
        #: single-threaded hosts)
        self.pipeline_ship = pipeline_ship

    # -- device programs -------------------------------------------------

    def _make_viterbi_fn(self):
        """Time-major Viterbi dispatch for the configured implementation."""
        skip, nbase, klen = self.skip, self.nbase, self.kmer_len
        # both take *time-major* (T, B, nstate) posteriors; the Pallas
        # kernel consumes that layout natively (and takes the log
        # in-kernel), so neither a transposed nor a log copy of the full
        # posterior tensor is ever materialised in device memory
        if self.viterbi_impl != "xla":
            from sloika_tpu.ops.pallas import viterbi as pallas_viterbi
            interpret = self.viterbi_impl == "interpret"
            fn = lambda p: pallas_viterbi.viterbi(
                p, klen, skip_pen=skip, nbase=nbase, time_major=True,
                interpret=interpret)
            if self.mesh is not None:
                # a pallas_call is an opaque custom call to the SPMD
                # partitioner — shard_map it over the batch axis so each
                # device decodes its own batch shard (the DP itself has no
                # cross-batch communication)
                from jax import shard_map
                P = jax.sharding.PartitionSpec
                fn = shard_map(fn, mesh=self.mesh,
                               in_specs=P(None, "data", None),
                               out_specs=(P("data"), P("data", None),
                                          P("data", None)),
                               check_vma=False)
            return fn
        return lambda p: decode_jax.viterbi(
            p, klen, skip_pen=skip, nbase=nbase, time_major=True)

    def _floored_masked_post(self, params, x, lengths):
        """Forward pass + min_prob floor + pad-frame masking (+ the
        configured posterior streaming dtype): the shared front half of
        every decode program."""
        post, out_lengths = self.layer.apply_with_lengths(params, x, lengths)
        post = self.min_prob + (1.0 - self.min_prob) * post
        T = post.shape[0]
        frame_mask = jnp.arange(T)[:, None] < out_lengths[None, :]
        stay = jnp.zeros((post.shape[2],), post.dtype).at[0].set(1.0)
        post = jnp.where(frame_mask[:, :, None], post, stay)
        if self.transducer and self.post_dtype != post.dtype:
            # cast fuses into the producer: the (T, B, nstate) posterior is
            # *written* to device memory at this dtype and streamed to the
            # Viterbi kernel at it (upcast to f32 in-kernel)
            post = post.astype(self.post_dtype)
        return post, out_lengths

    def _forward_decode(self, bucket_len):
        """Jitted posterior + Viterbi program for one bucket length."""
        if bucket_len in self._fwd_cache:
            return self._fwd_cache[bucket_len]

        transducer = self.transducer
        klen = self.kmer_len
        viterbi_fn = self._make_viterbi_fn()

        jit_kwargs = {}
        if self.mesh is not None:
            rep = meshlib.replicated(self.mesh)
            jit_kwargs = dict(
                in_shardings=(rep, meshlib.batch_sharding(self.mesh),
                              jax.sharding.NamedSharding(
                                  self.mesh, jax.sharding.PartitionSpec("data"))))

        emit_bases = self.output == "bases"
        f_splits = (self.overlap // self.model_stride,
                    (self.chunk_size - self.overlap) // self.model_stride)

        floored = self._floored_masked_post

        def run(params, x, lengths):
            post, out_lengths = floored(params, x, lengths)
            if transducer:
                score, path, moved = viterbi_fn(post)
                if emit_bases:
                    return (out_lengths, score) + _move_records(
                        path, moved, klen, f_splits)
                # pack (path, moved) into one int16 tensor to halve the
                # device->host transfer: sign = moved, magnitude = state + 1
                packed = jnp.where(moved, path + 1, -(path + 1)).astype(jnp.int16)
                return None, out_lengths, score, packed, None
            post_b = jnp.moveaxis(post, 1, 0)       # (B, T, nstate)
            return post_b, out_lengths, None, None, None

        # under the mesh the GRU kernel shards itself over the batch axis
        run = meshlib.under_mesh(jax.jit(run, **jit_kwargs), self.mesh)
        self._fwd_cache[bucket_len] = run
        return run

    def _forward_decode_dac(self, sig_bucket):
        """Jitted DAC-mode program: window gather + normalisation +
        posterior + Viterbi + collapse, for one padded flat-signal length.

        The transfer-lean input path: the host ships each read's *unscaled*
        int16 DAC samples once (2 bytes/sample, no window-overlap
        duplication — ~2.4x less host->device traffic than f32 windows) plus
        4 normalisation constants per window; windowing and the exact
        float32 normalisation arithmetic ``((dac + offset) * scale - med) /
        mad`` run on device (bit-identical to the same f32 ops on host,
        tests/test_basecall_dac.py).  Outputs are coalesced into a single
        (B, 18) uint8 header (score f32 | first int16 | counts 3x int32,
        little-endian) plus the packed base codes, so the host pays two
        device->host round trips per batch instead of four.
        """
        key = ("dac", sig_bucket)
        if key in self._fwd_cache:
            return self._fwd_cache[key]
        assert self.output == "bases" and self.transducer
        C = self.chunk_size
        klen = self.kmer_len
        viterbi_fn = self._make_viterbi_fn()
        f_splits = (self.overlap // self.model_stride,
                    (C - self.overlap) // self.model_stride)
        floored = self._floored_masked_post

        def run(params, flat, starts, lengths, norms):
            # flat (S,) int16 padded by >= C zeros (dynamic_slice never
            # clamp-shifts a window start); starts/lengths (B,); norms (B, 4)
            win = jax.vmap(
                lambda s: jax.lax.dynamic_slice(flat, (s,), (C,)))(starts)
            v = win.T.astype(jnp.float32)                  # (C, B)
            off, sc = norms[:, 0][None, :], norms[:, 1][None, :]
            med, mad = norms[:, 2][None, :], norms[:, 3][None, :]
            x = ((v + off) * sc - med) / mad
            t = jnp.arange(C, dtype=jnp.int32)[:, None]
            x = jnp.where(t < lengths[None, :], x, 0.0)
            x = x[:, :, None].astype(sloika_dtype)
            post, _ = floored(params, x, lengths)
            score, path, moved = viterbi_fn(post)
            first, counts, recs = _move_records(path, moved, klen, f_splits)
            B = score.shape[0]
            header = jnp.concatenate([
                jax.lax.bitcast_convert_type(
                    score.astype(jnp.float32), jnp.uint8),        # (B, 4)
                jax.lax.bitcast_convert_type(first, jnp.uint8),   # (B, 2)
                jax.lax.bitcast_convert_type(
                    counts, jnp.uint8).reshape(B, 12),            # (B, 12)
            ], axis=1)
            return header, recs

        jit_kwargs = {}
        if self.mesh is not None:
            P = jax.sharding.PartitionSpec
            rep = meshlib.replicated(self.mesh)
            dsh = jax.sharding.NamedSharding(self.mesh, P("data"))
            dsh2 = jax.sharding.NamedSharding(self.mesh, P("data", None))
            # flat signal replicated (one copy per device); window jobs
            # sharded over the batch axis
            jit_kwargs = dict(in_shardings=(rep, rep, dsh, dsh, dsh2))

        run = meshlib.under_mesh(jax.jit(run, **jit_kwargs), self.mesh)
        self._fwd_cache[key] = run
        return run

    # -- public API ------------------------------------------------------

    def basecall_to_sequences(self, signals):
        """Basecall to 2-bit base-code arrays: list of (score, codes) where
        ``codes`` indexes the alphabet.  Works for any output mode; in
        "bases" mode this is the native (fastest) form."""
        out = self.basecall_signals(signals)
        if self.output == "bases":
            return out
        kmers = bio.all_kmers(self.kmer_len, alphabet=self.alphabet)
        lut = np.zeros(256, np.uint8)
        for i, c in enumerate(bytearray(self.alphabet)):
            lut[c] = i
        res = []
        for o in out:
            if o is None:
                res.append(None)
                continue
            score, call = o
            seq = bio.kmers_to_sequence([kmers[i] for i in call],
                                        always_move=self.transducer)
            res.append((score, lut[np.frombuffer(seq, dtype=np.uint8)]))
        return res

    def basecall_signals(self, signals):
        """Basecall a list of normalised 1-D signals (or feature matrices).

        :param signals: list of (T,) or (T, F) float arrays, already
            normalised
        :returns: list of (score, call) per read, where call is the kmer
            state sequence
        """
        if self.studentise_fallback:
            return self._basecall_per_read_exact(signals)
        if self.chunked and self.transducer:
            if self.output == "bases":
                return self._basecall_chunked_bases(signals)
            return self._basecall_chunked(signals)
        out = [None] * len(signals)
        order = np.argsort([len(s) for s in signals])
        for lo in range(0, len(order), self.batch_size):
            idx = order[lo:lo + self.batch_size]
            self._run_batch([signals[i] for i in idx], idx, out)
        return out

    def _basecall_per_read_exact(self, signals):
        """Studentise fallback: one unpadded forward per read (batch 1,
        exact length — whole-read statistics, the reference's per-read
        semantics) + host decode.  One compile per distinct read length."""
        out = []
        # cache the jitted forward on the instance: a fresh jit per call
        # would discard the compiled programs between CLI read blocks and
        # re-pay the per-length compile each time
        fwd = self._fwd_cache.get("per_read_exact")
        if fwd is None:
            fwd = self._fwd_cache["per_read_exact"] = \
                jax.jit(self.layer.apply)
        for s in signals:
            try:
                nfeat = 1 if s.ndim == 1 else s.shape[1]
                x = jnp.asarray(np.ascontiguousarray(
                    s.reshape(len(s), 1, nfeat), dtype=sloika_dtype))
                post = np.asarray(fwd(self.params, x)).astype(np.float32)
                out.append(decode_post_host(
                    post, self.kmer_len, self.transducer, self.bad,
                    self.min_prob, self.skip, self.trans, nbase=self.nbase))
            except Exception as e:          # per-read fault masking
                sys.stderr.write("basecall failed: {!r}\n".format(e))
                out.append(None)
        return out

    # -- chunked mode ----------------------------------------------------

    def _basecall_chunked_bases(self, signals):
        """Transfer-lean throughput mode: collapse the Viterbi path to base
        codes *on device* and pull only packed 2-bit codes.

        Per window the host receives score (f32), opening state (int16),
        base counts at the seam boundaries (3x int32) and ~2 bits per
        called base (four codes per byte, trimmed to the batch's actual
        base count) — ~25x less device->host traffic than the per-frame
        int16 path.

        Seam semantics: each move's base emission is computed against its
        predecessor *within the same window's decode*, whereas the states
        path collapses across the stitched pair.  The two differ only at
        seams where the overlapping decodes disagree (the zone chunked mode
        already treats as approximate); measured accuracy is equal to
        within 0.05% on the bundled reads.
        """
        C = self.chunk_size

        jobs = [(r, w, start, signals[r][start:start + C], ln)
                for r, w, start, ln, _ in _window_jobs(
                    [len(s) for s in signals], C, self.overlap)]

        run = self._forward_decode(C)
        inflight = []
        for lo in range(0, len(jobs), self.batch_size):
            batch = jobs[lo:lo + self.batch_size]
            B = len(batch)
            Bp = bucket_batch(B, self.batch_size,
                              1 if self.mesh is None else self.mesh.size)
            nfeat = 1 if signals[0].ndim == 1 else signals[0].shape[1]
            x = np.zeros((C, Bp, nfeat), dtype=sloika_dtype)
            lengths = np.ones(Bp, dtype=np.int32)
            for b, (_, _, _, sl, ln) in enumerate(batch):
                x[:ln, b] = sl.reshape(ln, nfeat)
                lengths[b] = ln
            _, score, first, counts, recs = run(
                self.params, jnp.asarray(x), jnp.asarray(lengths))
            inflight.append((batch, score, first, counts, recs))

        results = {}
        for batch, score, first, counts, recs in inflight:
            score = np.asarray(score)
            first = np.asarray(first)
            counts = np.asarray(counts)
            # trim the byte transfer to this batch's real base count
            # (bucketed so distinct slice shapes stay bounded)
            nmax = int(counts[:len(batch), 2].max(initial=0))
            L = min(recs.shape[1], _round_up(max(-(-nmax // 4), 1), 512))
            recs_np = _unpack_codes(np.asarray(recs[:, :L]))
            for b, (r, w, start, _, ln) in enumerate(batch):
                results[(r, w)] = (float(score[b]), int(first[b]),
                                   counts[b], recs_np[b])

        return self._stitch_bases(results, [len(s) for s in signals])

    def _stitch_bases(self, results, read_lens):
        """Concatenate per-window base emissions at the seam boundaries
        (windowing comes from :func:`_window_jobs`, the same split that
        generated the decode jobs).

        :param results: {(read, window): (score, first_state, counts, codes)}
        :param read_lens: sample length per read
        """
        k = self.kmer_len
        out = [None] * len(read_lens)
        parts, total_score = [], 0.0
        for r, w, start, ln, nwin in _window_jobs(read_lens,
                                                  self.chunk_size,
                                                  self.overlap):
            sc, first, counts, recs = results[(r, w)]
            total_score += sc
            lo = 0 if w == 0 else int(counts[0])
            hi = int(counts[2]) if w == nwin - 1 else int(counts[1])
            if w == 0:
                # opening call contributes its full kmer
                parts.append(((first >> (2 * np.arange(k - 1, -1, -1)))
                              & 3).astype(np.uint8))
            parts.append(recs[lo:max(lo, hi)])
            if w == nwin - 1:
                out[r] = (total_score, np.concatenate(parts))
                parts, total_score = [], 0.0
        return out

    def basecall_dac_reads(self, reads):
        """Transfer-lean basecalling from raw int16 DAC samples
        (:func:`load_raw_dac`): windowing and normalisation run on device
        (see :meth:`_forward_decode_dac`).

        Calls are identical to ``basecall_signals`` fed the same-op-order
        host-normalised f32 signal (tests/test_basecall_dac.py); vs the
        reference loader's float64 pA scaling the inputs differ by <=2 ulp.
        Requires chunked transducer "bases" mode.  With a mesh, window jobs
        shard over the batch axis (flat signal replicated) and the Pallas
        Viterbi runs under shard_map.

        Reads are packed into ~16.8M-sample pipeline groups
        (``_PIPE_GROUP_SAMPLES``, ~one full 1024-window batch at the
        production C); a single prefetch worker builds and ships group
        g+1's buffer while group g's window batches run and their outputs
        pull.

        :param reads: list of (dac (T,) int16, (offset, scale, med, mad))
        :returns: list of (score, base codes) per read
        """
        assert not self.studentise_fallback, \
            ("DAC mode windows the signal on device; a model containing "
             "Studentise needs whole-read statistics — use basecall_signals "
             "(the exact per-read fallback)")
        assert self.output == "bases", "DAC mode requires output='bases'"
        C = self.chunk_size

        # consecutive reads are grouped into ship-pipeline units: device
        # memory and int32 window offsets are O(group), not O(read set),
        # and the prefetch worker below overlaps group g+1's host->device
        # transfer with group g's device compute + output pulls
        read_lens = [len(d) for d, _ in reads]
        pipe = min(_PIPE_GROUP_SAMPLES, _MAX_GROUP_SAMPLES)
        groups, cur, acc = [], [], 0
        for r, L in enumerate(read_lens):
            # a single read larger than the target forms its own group (it
            # cannot be split across flat buffers).  Window starts are
            # int32, so a group's flat buffer must stay below 2^31
            # samples; reads whose padded buffer would cross 2^30 samples
            # (2 GB of int16) are refused, which keeps every window start
            # and the 1.5x bucket ladder well inside int32.
            assert _round_up(L + C, 1 << 20) <= 2 ** 30, (
                "single DAC read of {} samples needs a >2 GB device buffer; "
                "split the read or use basecall_signals".format(L))
            if cur and acc + L + C > pipe:
                groups.append(cur)
                cur, acc = [], 0
            cur.append(r)
            acc += L
        if cur:
            groups.append(cur)

        def build_ship(group, is_full):
            """Build + ship one group's flat sample buffer (runs on the
            prefetch worker so the transfer overlaps the previous group's
            device work; one worker keeps ship order deterministic)."""
            glens = [read_lens[r] for r in group]
            offsets = np.concatenate([[0],
                                      np.cumsum(glens)]).astype(np.int64)
            need = int(offsets[-1]) + C
            # Full pipeline groups (closed by target overflow, and the
            # packing invariant guarantees acc + C <= pipe) all share ONE
            # fixed buffer size — one compiled program, <= one read-length
            # of shipped padding.  The final (and any oversized-singleton)
            # group falls back to the geometric ladder, bounding total
            # compiled-program count.  Multiple of 1024: the delta wire's
            # prefix sum reshapes the buffer into 1024-lane rows.
            if is_full and need <= pipe + C:
                S = _round_up(pipe + C, 1024)
            elif need > pipe + C:
                # oversized single-read group: exact 1 MiB grid, NOT the
                # geometric ladder — the ladder's 1.5x padding could push
                # a <2 GB read past the bound the entry assert enforces
                # (one program per distinct huge-read size; such reads are
                # rare)
                S = _round_up(need, 1 << 20)
            else:
                S = _round_up(bucket_length(need, min_len=1 << 20), 1024)
            flat = np.zeros(S, np.int16)
            for r, o in zip(group, offsets):
                flat[o:o + read_lens[r]] = reads[r][0]
            return glens, offsets, S, self._ship_flat(flat, S)

        pool = (ThreadPoolExecutor(max_workers=1)
                if len(groups) > 1 and self.pipeline_ship else None)
        results = {}
        try:
            nxt = pool.submit(build_ship, groups[0],
                              len(groups) > 1) if pool else None
            for gi, group in enumerate(groups):
                if pool:
                    glens, offsets, S, flat_d = nxt.result()
                    if gi + 1 < len(groups):
                        nxt = pool.submit(build_ship, groups[gi + 1],
                                          gi + 2 < len(groups))
                else:
                    glens, offsets, S, flat_d = build_ship(
                        group, gi + 1 < len(groups))

                jobs = [(group[gr], w, int(offsets[gr]) + start, ln)
                        for gr, w, start, ln, _ in _window_jobs(
                            glens, C, self.overlap)]

                run = self._forward_decode_dac(S)
                inflight = []
                for lo in range(0, len(jobs), self.batch_size):
                    batch = jobs[lo:lo + self.batch_size]
                    Bp = bucket_batch(
                        len(batch), self.batch_size,
                        1 if self.mesh is None else self.mesh.size)
                    starts = np.zeros(Bp, np.int32)
                    lengths = np.ones(Bp, np.int32)
                    norms = np.zeros((Bp, 4), np.float32)
                    norms[:, 3] = 1.0   # pad rows: mad=1 (no 0/0)
                    for b, (r, w, start, ln) in enumerate(batch):
                        starts[b] = start
                        lengths[b] = ln
                        norms[b] = reads[r][1]
                    header, recs = run(self.params, flat_d,
                                       jnp.asarray(starts),
                                       jnp.asarray(lengths),
                                       jnp.asarray(norms))
                    inflight.append((batch, header, recs))

                for batch, header, recs in inflight:
                    hdr = np.asarray(header)                  # one pull
                    score = hdr[:, 0:4].copy().view(np.float32)[:, 0]
                    first = hdr[:, 4:6].copy().view(np.int16)[:, 0]
                    counts = hdr[:, 6:18].copy().view(np.int32)
                    nmax = int(counts[:len(batch), 2].max(initial=0))
                    L = min(recs.shape[1],
                            _round_up(max(-(-nmax // 4), 1), 512))
                    recs_np = _unpack_codes(np.asarray(recs[:, :L]))
                    for b, (r, w, _, _) in enumerate(batch):
                        results[(r, w)] = (float(score[b]), int(first[b]),
                                           counts[b], recs_np[b])
        finally:
            if pool:
                # cancel any not-yet-started ship so an exception mid-group
                # does not leave an orphaned 32 MB transfer queued
                pool.shutdown(wait=False, cancel_futures=True)
        return self._stitch_bases(results, read_lens)

    def _ship_flat(self, flat, S):
        """Ship a flat int16 sample buffer to the device under the
        configured wire encoding; returns a device int16 array.

        ``wire="delta"``: a lossless int8 delta stream + (index, value)
        exception sideband (sentinel -128; nanopore DAC deltas fit int8 for
        ~99.3% of samples) halves the wire bytes; the device reconstructs
        ONCE per group with an exact integer prefix sum, and the
        reconstructed buffer feeds every window batch of the group.
        """
        if self.wire != "delta":
            return jax.device_put(jnp.asarray(flat), self._rep_sharding())
        d = np.diff(flat.astype(np.int32), prepend=np.int32(0))
        big = (d > 127) | (d < -127)
        d8 = d.astype(np.int8)
        d8[big] = -128                       # sentinel; real value below
        exc_idx = np.nonzero(big)[0].astype(np.int32)
        exc_val = d[big].astype(np.int32)
        Ep = bucket_length(max(len(exc_idx), 1), min_len=256)
        # padding exceptions write delta 0 at S-1 (zero-padding region:
        # harmless, duplicates all write the same value)
        pad = Ep - len(exc_idx)
        exc_idx = np.concatenate([exc_idx, np.full(pad, S - 1, np.int32)])
        exc_val = np.concatenate([exc_val, np.zeros(pad, np.int32)])
        # one payload = one host->device transfer: [d8 | idx bytes | val
        # bytes] (little-endian sideband, bitcast apart on device)
        payload = np.concatenate([d8, exc_idx.view(np.int8),
                                  exc_val.view(np.int8)])

        key = ("reconstruct", S, Ep)
        if key not in self._fwd_cache:
            def reconstruct(payload):
                d8 = payload[:S]
                tail = payload[S:].reshape(2, Ep, 4)
                exc_idx = jax.lax.bitcast_convert_type(tail[0], jnp.int32)
                exc_val = jax.lax.bitcast_convert_type(tail[1], jnp.int32)
                # Exact prefix sum as blocked triangular matmuls (a 1-D
                # cumsum over ~16M elements lowers to a slow reduce-window).
                #
                # Unconditional exactness, independent of the matmul's
                # accumulation order: every dot's terms are bf16-exact
                # integers whose ABSOLUTE sum stays < 2^24 (so any partial
                # sum is exact), by splitting exception deltas into
                # v = 512*hi + lo with |hi| <= 128, |lo| <= 256 and running
                # the small deltas (|d8| <= 127), hi and lo as three
                # separate single-pass bf16 dots; the recombination and the
                # cross-block offsets are int32, where the (potentially
                # large but cancelling) components are exact by
                # construction.
                W = 1024
                base = jnp.where(d8 == jnp.int8(-128), jnp.int8(0), d8)
                a = base.astype(jnp.bfloat16).reshape(-1, W)
                vf = exc_val.astype(jnp.float32)
                v_hi = jnp.round(vf / 512.0)
                v_lo = vf - 512.0 * v_hi
                hi = jnp.zeros(d8.shape[0], jnp.bfloat16).at[exc_idx].set(
                    v_hi.astype(jnp.bfloat16)).reshape(-1, W)
                lo = jnp.zeros(d8.shape[0], jnp.bfloat16).at[exc_idx].set(
                    v_lo.astype(jnp.bfloat16)).reshape(-1, W)
                tri = jnp.triu(jnp.ones((W, W), jnp.bfloat16))
                dot = lambda m: jax.lax.dot_general(
                    m, tri, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32).astype(jnp.int32)
                row = dot(a) + 512 * dot(hi) + dot(lo)    # in-block cumsum
                offs = jnp.concatenate(
                    [jnp.zeros(1, jnp.int32), jnp.cumsum(row[:, -1])[:-1]])
                return (row + offs[:, None]).reshape(-1).astype(jnp.int16)
            kw = {}
            if self.mesh is not None:
                kw = dict(out_shardings=self._rep_sharding())
            self._fwd_cache[key] = jax.jit(reconstruct, **kw)
        return self._fwd_cache[key](jnp.asarray(payload))

    def _rep_sharding(self):
        if self.mesh is None:
            return None
        return meshlib.replicated(self.mesh)

    def _basecall_chunked(self, signals):
        """Throughput mode: split reads into fixed overlapping windows,
        decode all windows as uniform-shape device batches, stitch the
        per-window calls at window-core boundaries.

        One compiled program regardless of read length; Viterbi traceback
        memory is bounded by (batch x chunk_frames x nkmer).  Calls can
        differ from exact full-read decoding within ~overlap samples of the
        seams (like any chunked basecaller); use ``chunked=False`` for
        bit-parity with per-read decoding.
        """
        C, V = self.chunk_size, self.overlap
        d = self.model_stride

        wjobs = _window_jobs([len(s) for s in signals], C, V)
        jobs = [(r, w, start, signals[r][start:start + C], ln)
                for r, w, start, ln, _ in wjobs]

        run = self._forward_decode(C)
        results = {}
        # two passes: dispatch every batch (async device work), then collect
        # — device compute overlaps the host-side transfers and stitching of
        # earlier batches instead of serialising per batch
        inflight = []
        for lo in range(0, len(jobs), self.batch_size):
            batch = jobs[lo:lo + self.batch_size]
            B = len(batch)
            Bp = bucket_batch(B, self.batch_size,
                              1 if self.mesh is None else self.mesh.size)
            nfeat = 1 if signals[0].ndim == 1 else signals[0].shape[1]
            x = np.zeros((C, Bp, nfeat), dtype=sloika_dtype)
            lengths = np.ones(Bp, dtype=np.int32)
            for b, (_, _, _, sl, ln) in enumerate(batch):
                x[:ln, b] = sl.reshape(ln, nfeat)
                lengths[b] = ln
            _, out_lengths, score, packed, _ = run(
                self.params, jnp.asarray(x), jnp.asarray(lengths))
            inflight.append((batch, out_lengths, score, packed))
        for batch, out_lengths, score, packed in inflight:
            out_lengths = np.asarray(out_lengths)
            score = np.asarray(score)
            packed = np.asarray(packed)   # int16: (state+1) signed by moved
            for b, (r, w, start, _, ln) in enumerate(batch):
                results[(r, w)] = (float(score[b]), packed[b],
                                   int(out_lengths[b]))

        out = [None] * len(signals)
        call_parts, total_score = [], 0.0
        for r, w, start, ln, nwin in wjobs:
            sc, packed, nframes = results[(r, w)]
            total_score += sc
            path = np.abs(packed[:nframes]) - 1
            moved = packed[:nframes] > 0
            # core frame range of this window
            f_lo = 0 if w == 0 else V // d
            f_hi = nframes if w == nwin - 1 else (C - V) // d
            if w == 0:
                keep = moved[f_lo:f_hi].copy()
                keep[0] = True     # opening state of the read
            else:
                keep = moved[f_lo:f_hi]
            call_parts.append(path[f_lo:f_hi][keep])
            if w == nwin - 1:
                out[r] = (total_score, np.concatenate(call_parts))
                call_parts, total_score = [], 0.0
        return out

    def _run_batch(self, sigs, idx, out):
        B = len(sigs)
        Bp = bucket_batch(B, self.batch_size,
                          1 if self.mesh is None else self.mesh.size)
        lengths = np.ones(Bp, dtype=np.int32)
        lengths[:B] = [len(s) for s in sigs]
        T = bucket_length(int(lengths.max()))
        nfeat = 1 if sigs[0].ndim == 1 else sigs[0].shape[1]
        x = np.zeros((T, Bp, nfeat), dtype=sloika_dtype)
        for b, s in enumerate(sigs):
            x[:len(s), b] = s.reshape(len(s), nfeat)

        run = self._forward_decode(T)
        post_b, out_lengths, score, packed, _ = run(
            self.params, jnp.asarray(x), jnp.asarray(lengths))
        out_lengths = np.asarray(out_lengths)

        if self.transducer:
            score = np.asarray(score)
            packed = np.asarray(packed)
            for b, i in enumerate(idx):
                nev = int(out_lengths[b])
                path = np.abs(packed[b, :nev]).astype(np.int32) - 1
                moved = packed[b, :nev] > 0
                call = decode_jax.collapse_path(path, moved)
                out[i] = (float(score[b]), call)
        else:
            post_b = np.asarray(post_b)
            for b, i in enumerate(idx):
                post = post_b[b, :int(out_lengths[b])][:, None, :]
                out[i] = decode_post_host(post, self.kmer_len, False,
                                          self.bad, self.min_prob, self.skip,
                                          self.trans, nbase=self.nbase,
                                          floored=True)


def _move_records(path, moved, klen, f_splits):
    """Device-side collapse of a Viterbi path to packed 2-bit base codes.

    Emission sizes follow ``bio.kmers_to_sequence``'s maximal-overlap rule
    (always_move, bio.py:133-183): a move emits one base when the previous
    kmer matches at shift 1, else two (within-window Viterbi moves are
    steps/skips, so shifts > 2 cannot occur — a "skip" between
    homopolymer-compatible kmers correctly collapses to one base, matching
    the host-side collapse).  Emitted codes are compacted to the front in
    frame order (stable sort on the validity key — no scatter) and packed
    four per byte, so the device->host transfer is ~2 bits per called base
    (~25x less than the per-frame int16 path).

    :param path: (B, T') kmer states;  :param moved: (B, T') move mask
    :param f_splits: two static frame indices (the seam boundaries); the
        returned counts give the number of *bases* emitted before each,
        plus the total
    :returns: (first_state (B,) int16, counts (B, 3) int32,
        packed (B, ceil(2T'/4)) uint8 — four 2-bit codes per byte,
        first code in the high bits)
    """
    B, Tp = path.shape
    npow = 4 ** (klen - 1)
    prev = jnp.concatenate([path[:, :1], path[:, :-1]], axis=1)
    match1 = (prev % npow) == (path // 4)
    nnew2 = moved & jnp.logical_not(match1)
    base2 = (path % 4).astype(jnp.uint8)
    base1 = ((path // 4) % 4).astype(jnp.uint8)

    nb = moved.astype(jnp.int32) + nnew2.astype(jnp.int32)
    cum = jnp.cumsum(nb, axis=1)
    counts = jnp.stack([cum[:, min(f_splits[0], Tp) - 1],
                        cum[:, min(f_splits[1], Tp) - 1],
                        cum[:, -1]], axis=1)

    # interleave (optional first base, entered base) per frame, then push
    # invalid slots to the back with ONE int32 sort: the key packs
    # (invalid, slot index, code) so order stays stable by frame and the
    # codes ride along in the low bits — no argsort + index gather pass
    slot1 = jnp.where(nnew2, base1.astype(jnp.int32), jnp.int32(4))
    slot2 = jnp.where(moved, base2.astype(jnp.int32), jnp.int32(4))
    idx = jnp.arange(2 * Tp, dtype=jnp.int32)
    pairs = jnp.stack([slot1, slot2], axis=2).reshape(B, 2 * Tp)
    keys = jnp.where(pairs == 4, jnp.int32(1) << 29, jnp.int32(0)) \
        | (idx << 3) | pairs
    skeys = jax.lax.sort(keys, dimension=1, is_stable=False)
    codes = jnp.where(skeys >> 29 != 0, jnp.int32(0),
                      skeys & 3).astype(jnp.uint8)

    pad = (-2 * Tp) % 4
    if pad:
        codes = jnp.concatenate(
            [codes, jnp.zeros((B, pad), jnp.uint8)], axis=1)
    c = codes.reshape(B, -1, 4)
    packed = ((c[:, :, 0] << 6) | (c[:, :, 1] << 4)
              | (c[:, :, 2] << 2) | c[:, :, 3]).astype(jnp.uint8)
    return path[:, 0].astype(jnp.int16), counts, packed


def _unpack_codes(packed):
    """Host-side expansion of packed bytes to 2-bit base codes (see
    :func:`_move_records`)."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty(packed.shape + (4,), np.uint8)
    out[..., 0] = packed >> 6
    out[..., 1] = (packed >> 4) & 3
    out[..., 2] = (packed >> 2) & 3
    out[..., 3] = packed & 3
    return out.reshape(packed.shape[:-1] + (-1,))


def decode_post_host(post, kmer_len, transducer, bad, min_prob, skip=5.0,
                     trans=None, nbase=4, floored=False):
    """Host-side decode dispatch (reference basecall.py:26-51)."""
    assert post.shape[2] == nstate(kmer_len, transducer=transducer,
                                   bad_state=bad, nbase=nbase)
    if floored:
        post = np.squeeze(post, axis=1)
        if bad and not transducer:
            maxcall = np.argmax(post, axis=1)
            post = post[maxcall > 0, 1:]
            post = post / np.sum(post, axis=1, keepdims=True)
    else:
        post = decode_np.prepare_post(post, min_prob=min_prob,
                                      drop_bad=bad and not transducer)
    if transducer:
        return decode_np.viterbi(post, kmer_len, skip_pen=skip, nbase=nbase)
    assert nbase == 4, "Modified bases not supported by old decoder"
    trans = olddecode.estimate_transitions(post, trans=trans)
    return olddecode.decode_profile(post, trans=np.log(_ETA + trans), log=False)


# ---------------------------------------------------------------------------
# Read loading (host side)
# ---------------------------------------------------------------------------

def load_raw_signal(fast5_file, trim=(200, 50), open_pore_fraction=0.3):
    """Raw read -> normalised signal (reference raw_worker semantics,
    basecall.py:88-121).  Returns (short_name, signal) or None."""
    try:
        from sloika_tpu.data.fast5 import Fast5
        with Fast5(fast5_file) as f5:
            signal = f5.get_read(raw=True)
            sn = f5.filename_short
    except Exception as e:
        sys.stderr.write("Error getting raw data for file {}\n{!r}\n".format(
            fast5_file, e))
        return None
    signal = batching.trim_open_pore(signal, open_pore_fraction)
    signal = util.trim_array(signal, *trim)
    if signal.size == 0:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    return sn, batching.normalise_raw_signal(signal)


def scale_dac_f32(dac, offset, scale):
    """pA-scale int16 DAC samples with the exact f32 op order the device
    uses: ``(dac_f32 + offset) * scale``.  Single source of truth for the
    first half of the DAC wire's bit-identity contract."""
    return (dac.astype(np.float32) + np.float32(offset)) * np.float32(scale)


def normalise_dac_f32(dac, norm4):
    """Host reference of the device-side DAC normalisation
    ``((dac + offset) * scale - med) / mad``.  Every DAC wire
    (basecall, remap) promises bit-identity with exactly this op order —
    any host-side reconstruction of the normalised signal must call this
    function, never re-derive the expression."""
    offset, scale, med, mad = (np.float32(v) for v in norm4)
    return (scale_dac_f32(dac, offset, scale) - med) / mad


def load_raw_dac(fast5_file, trim=(200, 50), open_pore_fraction=0.3):
    """Raw read -> *unscaled* int16 DAC samples + normalisation constants,
    for the transfer-lean device-normalised basecall path
    (:meth:`Basecaller.basecall_dac_reads`).

    Trimming (open-pore + edge) follows :func:`load_raw_signal` exactly; the
    per-read constants are computed from the float32-op-order scaled signal
    ``(dac_f32 + offset) * scale`` — the same arithmetic the device performs
    — so the device-normalised windows are bit-identical to host
    normalisation with this op order (within 1-2 ulp of the reference's
    float64 pA scaling, fast5.py channel scaling).

    :returns: (short_name, dac (T,) int16, (offset, scale, med, mad) f32)
        or None
    """
    try:
        from sloika_tpu.data.fast5 import Fast5
        with Fast5(fast5_file) as f5:
            grp = f5.get_read(raw=True, group=True)
            dac = grp["Signal"][:].astype(np.int16)
            meta = f5.channel_meta
            sn = f5.filename_short
    except Exception as e:
        sys.stderr.write("Error getting raw data for file {}\n{!r}\n".format(
            fast5_file, e))
        return None
    offset = np.float32(meta["offset"])
    scale = np.float32(float(meta["range"]) / float(meta["digitisation"]))
    scaled = scale_dac_f32(dac, offset, scale)
    start, end = batching.trim_open_pore(scaled, open_pore_fraction,
                                         return_range=True)
    start, stop = start + trim[0], end - trim[1]
    if stop <= start:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    dac = dac[start:stop]
    s = scaled[start:stop]
    med = np.float32(np.median(s))
    mad = np.float32(maths.mad(s))
    return sn, dac, (offset, scale, med, mad)


def load_event_features(fast5_file, section="template",
                        segmentation="Segmentation", trim=(50, 10)):
    """Event read -> feature matrix (reference events_worker semantics,
    basecall.py:54-85).  Returns (short_name, features) or None."""
    try:
        from sloika_tpu.data.fast5 import Fast5
        with Fast5(fast5_file) as f5:
            ev = f5.get_section_events(section, analysis=segmentation)
            sn = f5.filename_short
    except Exception as e:
        sys.stderr.write("Error getting events for section {!r} in file {}\n"
                         "{!r}\n".format(section, fast5_file, e))
        return None
    ev = util.trim_array(ev, *trim)
    if ev.size == 0:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    return sn, features_mod.from_events(ev, tag='')


class SeqPrinter(object):
    """Format decoded kmer paths as FASTA (reference basecall.py:124-163)."""

    def __init__(self, kmer_len, datatype="events", transducer=False,
                 fname=None, alphabet=DEFAULT_ALPHABET, fh=None):
        self.kmers = bio.all_kmers(kmer_len, alphabet=alphabet)
        self.transducer = transducer
        self.datatype = datatype
        alpha = alphabet.encode() if isinstance(alphabet, str) else alphabet
        self._alpha_lut = np.frombuffer(alpha, dtype=np.uint8)
        if fh is not None:
            # caller-supplied stream (e.g. a StringIO capturing records for
            # the multi-host gather, cli/basecall.py)
            self.fh = fh
            self.close_fh = False
        elif fname is None:
            self.fh = sys.stdout
            self.close_fh = False
        else:
            self.fh = open(fname, 'w')
            self.close_fh = True

    def close(self):
        if self.close_fh:
            self.fh.close()

    def write(self, read_name, score, call, nev):
        kmer_path = [self.kmers[i] for i in call]
        seq = bio.kmers_to_sequence(kmer_path, always_move=self.transducer)
        if isinstance(seq, bytes):
            seq = seq.decode('ascii')
        self.fh.write(">{} score {:.0f}, {} {} to {} bases\n".format(
            read_name, score, nev, self.datatype, len(seq)))
        self.fh.write(seq + '\n')
        return len(seq)

    def write_codes(self, read_name, score, codes, nev):
        """Write a 2-bit base-code array (Basecaller output="bases")."""
        seq = self._alpha_lut[np.asarray(codes, dtype=np.uint8)]
        seq = seq.tobytes().decode('ascii')
        self.fh.write(">{} score {:.0f}, {} {} to {} bases\n".format(
            read_name, score, nev, self.datatype, len(seq)))
        self.fh.write(seq + '\n')
        return len(seq)
