"""Batched signal remapping against known references.

Redesign of the reference remap path (batch.py:143-160,
chunkify_raw.py:260-296): instead of one Theano forward + Cython DP per read
per process, reads are bucketed and the model forward *and* the
map-to-sequence Viterbi both run on the device in batches
(:mod:`sloika_tpu.ops.remap_jax`, :mod:`sloika_tpu.ops.remap_banded`).

The output mapping table has the same schema as the reference
(start/length/seq_pos/move/kmer/good_emission) so the downstream chunking
pipeline is shared.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from sloika_tpu import backend, bio, util
from sloika_tpu.config import sloika_dtype
from sloika_tpu.ops import remap_banded, remap_jax
from sloika_tpu.parallel import mesh as meshlib
from sloika_tpu.basecall import (bucket_length, normalise_dac_f32,
                                 _round_up, _MAX_GROUP_SAMPLES)
from sloika_tpu.variables import DEFAULT_ALPHABET

_LOG_ETA = np.float32(np.log(1e-10))


class Remapper(object):
    """Batched remapper for a transducer model.

    :param layer, params: the network
    :param kmer_len: kmer length of the model state space
    :param min_prob: posterior floor before the DP
    :param slip: slip penalty (log space, >= 0)
    :param prior: (initial, final) geometric prior means (None = flat)
    """

    def __init__(self, layer, params, kmer_len, min_prob=1e-5, slip=5.0,
                 prior=(25.0, 25.0), alphabet=DEFAULT_ALPHABET, batch_size=4,
                 band="auto", mesh=None):
        self.layer = layer
        self.params = params
        self.kmer_len = kmer_len
        self.min_prob = min_prob
        self.slip = slip
        self.prior = prior
        self.alphabet = alphabet
        #: optional ('data',) mesh: read batches are sharded over the batch
        #: axis (data-parallel preprocessing, SURVEY.md §2.4)
        self.mesh = mesh
        if mesh is not None and batch_size % mesh.size != 0:
            from sloika_tpu.parallel.mesh import round_up
            batch_size = round_up(batch_size, mesh.size)
        self.batch_size = batch_size
        #: band width in sequence positions; None = exact O(T x P) DP.  The
        #: banded DP is exact whenever the true path stays within band/2 of
        #: the linear frame->position interpolation (tests/test_remap_banded).
        #: "auto" is the platform's choice in backend.REMAP_BAND.  Short
        #: references (npos <= band) always use the exact DP — banding buys
        #: nothing and exactness is free.
        if band == "auto":
            band = backend.remap_band()
        self.band = band
        #: re-run reads whose banded path misses a sequence-end anchor with
        #: progressively wider bands (band benchmarking turns this off)
        self.fallback = True
        #: cross-batch pipelining (dispatch g+1 before pulling g); the
        #: switch exists for interleaved A/B measurement (scripts/
        #: bench_remap_pipeline.py) — leave on in production.
        #: pipeline_depth = batches in flight (1 measured best: depth 2
        #: adds HBM pressure without hiding more of the wire)
        self.pipeline = True
        self.pipeline_depth = 1
        self._cache = {}
        #: compiled-program shapes known to exhaust HBM (see _oom_key)
        self._oom_sizes = set()

    def _program(self, T, P, band, S=None):
        """Build the jitted remap program.

        ``S is None``: takes a host-normalised (T, B, F) float batch.
        ``S`` set (DAC wire): takes a flat (S,) int16 sample buffer plus
        per-read (start, length, norm4) and gathers + normalises on device
        with the exact f32 op order ``((dac + offset)·scale − med)/mad`` —
        bit-identical to the host path fed the same constants
        (tests/test_remap.py::test_dac_wire_matches_host_normalised), at
        half the wire bytes and none of the bucket-padding bytes.
        """
        key = (T, P, band, S)
        if key in self._cache:
            return self._cache[key]
        layer, min_prob = self.layer, self.min_prob

        jit_kwargs = {}
        if self.mesh is not None:
            rep = meshlib.replicated(self.mesh)
            row = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec("data"))
            rowp = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec("data", None))
            xsh = (rep if S is not None
                   else meshlib.batch_sharding(self.mesh))
            starts_sh = (row,) if S is not None else ()
            jit_kwargs = dict(in_shardings=(
                (rep, xsh) + starts_sh + (row,)
                + ((rowp,) if S is not None else ())
                + (rowp, rowp, rowp, rowp, rep)))

        def dp(params, x, lengths, seq_states, pos_mask, p0, p1, slip):
            post, out_lengths = layer.apply_with_lengths(params, x, lengths)
            post = min_prob + (1.0 - min_prob) * post
            ltrans = jnp.log(post)
            Tp = ltrans.shape[0]
            frame_mask = jnp.arange(Tp)[:, None] < out_lengths[None, :]
            # one-hot stay padding in log space
            stay_row = jnp.full((ltrans.shape[2],), _LOG_ETA).at[0].set(0.0)
            ltrans = jnp.where(frame_mask[:, :, None], ltrans, stay_row)
            lt = jnp.moveaxis(ltrans, 1, 0)
            if band is not None and P > band:
                npos = jnp.sum(pos_mask, axis=1).astype(jnp.int32)
                score, path = remap_banded.map_to_sequence_banded(
                    lt, seq_states, slip, p0, p1, pos_mask, out_lengths,
                    npos, band)
            else:
                score, path = remap_jax.map_to_sequence(
                    lt, seq_states, slip, p0, p1, pos_mask)
            # transfer-lean path wire: ship the opening position (int32)
            # plus move deltas, int16 (half the pull bytes of the int32
            # path) whenever every possible move fits — any move, slips
            # included, is < npos <= P, so the int16 form is exact for
            # P < 2^15 and the dtype switches statically to int32 for
            # longer references (a wrap could otherwise corrupt paths
            # silently).  The host reconstructs with a cumsum.
            move_dtype = jnp.int16 if seq_states.shape[1] < (1 << 15) \
                else jnp.int32
            moves = (path[:, 1:] - path[:, :-1]).astype(move_dtype)
            return out_lengths, score, path[:, 0].astype(jnp.int32), moves

        if S is None:
            run = jax.jit(dp, **jit_kwargs)
        else:
            def run(params, flat, starts, lengths, norms, seq_states,
                    pos_mask, p0, p1, slip):
                # per-read gather from the flat int16 buffer + normalise
                rows = jax.vmap(
                    lambda s: jax.lax.dynamic_slice(flat, (s,), (T,)))(
                        starts).astype(jnp.float32)            # (B, T)
                offset = norms[:, 0:1]
                scale = norms[:, 1:2]
                med = norms[:, 2:3]
                mad = norms[:, 3:4]
                x = ((rows + offset) * scale - med) / mad
                valid = jnp.arange(T)[None, :] < lengths[:, None]
                x = jnp.where(valid, x, 0.0).astype(sloika_dtype)
                x = x.T[:, :, None]                            # (T, B, 1)
                return dp(params, x, lengths, seq_states, pos_mask, p0, p1,
                          slip)

            run = jax.jit(run, **jit_kwargs)
        # under the mesh the GRU kernel shards itself over the batch axis
        run = meshlib.under_mesh(run, self.mesh)
        self._cache[key] = run
        return run

    def remap_signals(self, signals, references):
        """Remap normalised signals against reference sequences.

        :param signals: list of (T,) normalised float arrays
        :param references: list of bytes sequences
        :returns: list of (score, mapping_table, path, seq) per read
            (reference raw_remap return convention, chunkify_raw.py:260-296)
        """
        return self._remap(signals, references, dac=False)

    def remap_dac_signals(self, reads, references):
        """Transfer-lean remapping from raw int16 DAC samples
        (:func:`sloika_tpu.basecall.load_raw_dac` tuples): normalisation
        runs on device with the exact host f32 op order, so results are
        bit-identical to :meth:`remap_signals` fed the same constants — at
        half the wire bytes and none of the length-bucket padding bytes.

        :param reads: list of (dac (L,) int16, (offset, scale, med, mad))
        """
        return self._remap(list(reads), references, dac=True)

    @staticmethod
    def _sig_len(s, dac):
        return len(s[0]) if dac else len(s)

    def _oom_key(self, sigs, refs, band, dac):
        """Shape key for HBM-exhaustion memoisation: matches the compiled
        program's shape — (batch, bucketed frames, bucketed positions,
        band, wire) — so an OOM on long reads does not demote short-read
        batches of the same size."""
        return (len(sigs),
                bucket_length(max(self._sig_len(s, dac) for s in sigs)),
                bucket_length(max(len(r) for r in refs) - self.kmer_len + 1,
                              min_len=256),
                band, dac)

    def _remap(self, signals, references, dac):
        assert len(signals) == len(references)
        out = [None] * len(signals)
        order = np.argsort([self._sig_len(s, dac) for s in signals])
        # Cross-batch pipeline: dispatch batch g+1 BEFORE pulling batch g,
        # so batch g+1's host buffer build and batch g's path pull +
        # mapping-table build overlap the device DP in flight (the
        # basecall ship-pipelining pattern).  Up to pipeline_depth extra
        # batches are in flight, each adding only its input and output
        # buffers to peak device memory — the DP intermediates of a
        # finished program are already freed.
        pending = []
        depth = self.pipeline_depth if self.pipeline else 0
        for lo in range(0, len(order), self.batch_size):
            idx = order[lo:lo + self.batch_size]
            self._dispatch_batch_safe([signals[i] for i in idx],
                                      [references[i] for i in idx], idx,
                                      self.band, dac, pending, out)
            while len(pending) > depth:
                self._collect_batch(pending.pop(0), out)
        while pending:
            self._collect_batch(pending.pop(0), out)
        # Anchor check: a correctly banded path must reach both sequence
        # ends (the band is exact only when it covers the true path).
        # Reads whose path misses an anchor by more than band/2 are re-run
        # with a 4x band, then the exact DP — rare, so throughput stays
        # banded (measured: 1 of the 5 bundled reads needs the 2048 band).
        band = self.band
        while band is not None and self.fallback:
            tol = band // 2
            retry = []
            for i, o in enumerate(out):
                if o is None:
                    continue
                path, seq = o[2], o[3]
                if len(seq) > band and (
                        path.min() > tol or
                        path.max() < len(seq) - 1 - tol):
                    retry.append(i)
            if not retry:
                break
            band = band * 4 if band * 4 < max(
                len(out[i][3]) for i in retry) else None
            for lo in range(0, len(retry), self.batch_size):
                idx = retry[lo:lo + self.batch_size]
                self._run_batch_safe([signals[i] for i in idx],
                                     [references[i] for i in idx], idx, out,
                                     band, dac)
        return out

    def _run_batch_safe(self, sigs, refs, idx, out, band, dac=False):
        """Synchronous dispatch+collect under the memory guards (used by
        the anchor-widen retries, which are rare and need results in
        hand)."""
        self._submit_safe(
            sigs, refs, idx, band, dac,
            lambda s, r, i: self._collect_batch(
                self._dispatch_batch(s, r, i, band, dac), out))

    def _dispatch_batch_safe(self, sigs, refs, idx, band, dac, pending,
                             out):
        """Guarded async dispatch for the pipelined main loop: successful
        dispatches are appended to ``pending`` for later collection."""
        self._submit_safe(
            sigs, refs, idx, band, dac,
            lambda s, r, i: pending.append(
                self._dispatch_batch(s, r, i, band, dac)))

    def _submit_safe(self, sigs, refs, idx, band, dac, submit):
        """Run ``submit(sigs, refs, idx)`` under the batch guards, with
        device-memory-exhaustion fallback: the traceback is O(events x
        band) per read, so a large batch of long reads can exceed device
        memory at compile time — halve the batch and retry instead of
        failing the run.  Known-failing shapes are remembered so later
        batches skip straight to halves (a failed compile costs seconds
        each time); the key matches the compiled program's shape —
        (batch, bucketed frames, bucketed positions, band) — so an OOM on
        long reads does not demote short-read batches of the same size."""
        if dac and len(sigs) > 1:
            # keep the flat int16 sample buffer bounded like the basecall
            # DAC groups (128 MB): int32 read starts index it, and one
            # bounded buffer per batch keeps the host->device copy small
            T = bucket_length(max(self._sig_len(s, True) for s in sigs))
            total = sum(self._sig_len(s, True) for s in sigs)
            if bucket_length(total + T, min_len=1 << 18) > \
                    _MAX_GROUP_SAMPLES:
                h = len(sigs) // 2
                self._submit_safe(sigs[:h], refs[:h], idx[:h], band, dac,
                                  submit)
                self._submit_safe(sigs[h:], refs[h:], idx[h:], band, dac,
                                  submit)
                return
        if dac and len(sigs) == 1:
            # an un-splittable single read: refuse a buffer whose starts
            # would approach the int32 limit
            L = self._sig_len(sigs[0], True)
            assert bucket_length(L + bucket_length(L),
                                 min_len=1 << 18) <= 2 ** 30, (
                "single remap read of {} samples needs a >2 GB device "
                "buffer; split the read or use remap_signals".format(L))
        key = self._oom_key(sigs, refs, band, dac)
        if key not in self._oom_sizes:
            try:
                return submit(sigs, refs, idx)
            except Exception as e:
                oom = ("RESOURCE_EXHAUSTED" in str(e)
                       or "Ran out of memory" in str(e))
                if not oom or len(sigs) <= 1:
                    raise
                self._oom_sizes.add(key)
                sys.stderr.write(
                    "Remap batch of {} exceeds device memory; retrying as "
                    "two halves\n".format(len(sigs)))
        h = len(sigs) // 2
        self._submit_safe(sigs[:h], refs[:h], idx[:h], band, dac, submit)
        self._submit_safe(sigs[h:], refs[h:], idx[h:], band, dac, submit)

    def _dispatch_batch(self, sigs, refs, idx, band, dac=False):
        B = len(sigs)
        # pad the batch to a whole number of mesh shards (padding rows are
        # all-zero signals/references; their results are discarded)
        Bp = B if self.mesh is None else -(-B // self.mesh.size) * \
            self.mesh.size
        lengths = np.ones(Bp, dtype=np.int32)
        lengths[:B] = [self._sig_len(s, dac) for s in sigs]
        T = bucket_length(int(lengths.max()))
        if dac:
            # flat int16 sample buffer: only real samples ride the wire (no
            # bucket padding), halved again by int16 vs f32.  T zeros of
            # tail margin keep the device's fixed-size dynamic_slice windows
            # in-bounds (dynamic_slice clamps the start otherwise, which
            # would shift the last read's window).
            starts = np.zeros(Bp, np.int32)
            off = 0
            for b, (d, _) in enumerate(sigs):
                starts[b] = off
                off += len(d)
            S = _round_up(bucket_length(off + T, min_len=1 << 18), 1024)
            flat = np.zeros(S, np.int16)
            for b, (d, _) in enumerate(sigs):
                flat[starts[b]:starts[b] + len(d)] = d
            norms = np.zeros((Bp, 4), np.float32)
            norms[:, 3] = 1.0           # padding rows: mad=1 (no 0/0)
            for b, (_, n4) in enumerate(sigs):
                norms[b] = n4
        else:
            nfeat = 1 if sigs[0].ndim == 1 else sigs[0].shape[1]
            x = np.zeros((T, Bp, nfeat), dtype=sloika_dtype)
            for b, s in enumerate(sigs):
                x[:len(s), b] = s.reshape(len(s), nfeat)

        seqs = [bio.kmer_state_array(r, self.kmer_len, self.alphabet) + 1
                for r in refs]
        npos = np.array([len(s) for s in seqs], dtype=np.int32)
        P = bucket_length(int(npos.max()), min_len=256)
        seq_states = np.zeros((Bp, P), dtype=np.int32)
        pos_mask = np.zeros((Bp, P), dtype=bool)
        pos_mask[B:, 0] = True          # padding rows: one dummy position
        p0 = np.zeros((Bp, P), dtype=np.float32)
        p1 = np.zeros((Bp, P), dtype=np.float32)
        for b, s in enumerate(seqs):
            n = len(s)
            seq_states[b, :n] = s
            pos_mask[b, :n] = True
            if self.prior[0] is not None:
                p0[b, :n] = util.geometric_prior(n, self.prior[0])
            if self.prior[1] is not None:
                p1[b, :n] = util.geometric_prior(n, self.prior[1], rev=True)

        if dac:
            run = self._program(T, P, band, S=S)
            out_lengths, score, path0, moves16 = run(
                self.params, jnp.asarray(flat), jnp.asarray(starts),
                jnp.asarray(lengths), jnp.asarray(norms),
                jnp.asarray(seq_states), jnp.asarray(pos_mask),
                jnp.asarray(p0), jnp.asarray(p1), jnp.float32(self.slip))
        else:
            run = self._program(T, P, band)
            out_lengths, score, path0, moves16 = run(
                self.params, jnp.asarray(x), jnp.asarray(lengths),
                jnp.asarray(seq_states), jnp.asarray(pos_mask),
                jnp.asarray(p0), jnp.asarray(p1), jnp.float32(self.slip))
        # async: the device arrays are NOT pulled here — _collect_batch
        # does that, so a caller can dispatch the next batch first
        return {"sigs": sigs, "refs": refs, "idx": idx, "seqs": seqs,
                "band": band, "dac": dac, "out_lengths": out_lengths,
                "score": score, "path0": path0, "moves16": moves16}

    def _collect_batch(self, rec, out):
        """Pull a dispatched batch's results and build its mapping tables;
        an execution-time HBM exhaustion falls back to synchronous
        halves."""
        sigs, refs, idx, dac = (rec["sigs"], rec["refs"], rec["idx"],
                                rec["dac"])
        try:
            out_lengths = np.asarray(rec["out_lengths"])
            score = np.asarray(rec["score"])
            path0 = np.asarray(rec["path0"])
            moves16 = np.asarray(rec["moves16"])
        except Exception as e:
            oom = ("RESOURCE_EXHAUSTED" in str(e)
                   or "Ran out of memory" in str(e))
            if not oom or len(sigs) <= 1:
                raise
            # memoise the failing shape like the dispatch-time fallback, so
            # later same-shape batches skip straight to halves
            self._oom_sizes.add(self._oom_key(sigs, refs, rec["band"], dac))
            sys.stderr.write(
                "Remap batch of {} exceeded device memory at execution; "
                "retrying as two halves\n".format(len(sigs)))
            h = len(sigs) // 2
            self._run_batch_safe(sigs[:h], refs[:h], idx[:h], out,
                                 rec["band"], dac)
            self._run_batch_safe(sigs[h:], refs[h:], idx[h:], out,
                                 rec["band"], dac)
            return

        # reconstruct paths from the int16 move-delta wire (exact cumsum)
        path = np.empty((len(path0), moves16.shape[1] + 1), np.int64)
        path[:, 0] = path0
        np.cumsum(moves16, axis=1, out=path[:, 1:])
        path[:, 1:] += path0[:, None]

        for b, i in enumerate(idx):
            nev = int(out_lengths[b])
            if dac:
                # the mapping table only needs the signal's length/trim
                # geometry; reconstruct the normalised signal with the same
                # f32 op order the device used
                d, norm4 = sigs[b]
                sig_b = normalise_dac_f32(d, norm4).astype(sloika_dtype)
            else:
                sig_b = sigs[b]
            out[i] = build_mapping_table(
                float(score[b]), path[b, :nev], rec["seqs"][b], sig_b,
                self.kmer_len, refs[b], alphabet=self.alphabet)


def build_mapping_table(score, path, seq, signal, kmer_len, read_ref,
                        alphabet=DEFAULT_ALPHABET):
    """Synthesise a reference-schema mapping table from a remap path
    (chunkify_raw.py:277-296)."""
    from sloika_tpu.data.raw_chunkify import trim_signal_and_mapping

    kmers = np.array(bio.seq_to_kmers(read_ref, kmer_len))
    mapping_dtype = [
        ('start', '<i8'), ('length', '<i8'), ('seq_pos', '<i8'),
        ('move', '<i8'), ('kmer', 'S{}'.format(kmer_len)),
        ('good_emission', '?'),
    ]
    nev = len(path)
    mapping_table = np.zeros(nev, dtype=mapping_dtype)
    stride = int(np.ceil(signal.shape[0] / float(nev)))
    mapping_table['start'] = (np.arange(0, nev, dtype=np.int64) * stride
                              - stride // 2)
    mapping_table['length'] = stride
    mapping_table['seq_pos'] = path
    mapping_table['move'] = np.ediff1d(path, to_begin=1)
    mapping_table['kmer'] = kmers[path]
    mapping_table['good_emission'] = True

    _, mapping_table = trim_signal_and_mapping(signal, mapping_table, 0,
                                               len(signal))
    return score, mapping_table, np.asarray(path), seq
