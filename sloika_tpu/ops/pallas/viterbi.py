"""Pallas (Triton route) kernel for the kmer-transducer Viterbi decode.

Same maths and tie-breaking as :func:`sloika_tpu.ops.decode_jax.viterbi`
(reference decode.py:39-93), laid out for a GPU:

* each program owns ``BB`` batch rows and runs the whole DP inside the
  kernel (``fori_loop`` over time), so the (BB, K) score vector never
  leaves registers; one launch replaces the XLA scan's per-step kernels;
* the log of the posterior is taken in the kernel, so no second full-size
  log tensor is materialised; the posterior may stream as bfloat16 and is
  upcast to float32 before any arithmetic;
* the step maximum over the ``nbase`` leading-base groups is a reduction
  over a (BB, nbase, K/nbase) view of the scores; the skip maximum is
  derived from the step maxima (the ``nbase**2`` skip groups nest inside
  the step groups), with the first-wins tie-break of a direct argmax;
* the traceback is one 8-bit *code* per destination state instead of an
  int32 predecessor index: -1 = stay, g in [0, nbase) = step from group g,
  nbase + g = skip from group g.  The predecessor is rebuilt in the
  backward pass as ``g * nrem + state // n``.  Four codes (plus one) are
  packed into each int32 word: an int8 array of the traceback's 2^31 to
  2^32 elements (B=1024 windows) would get 32-bit element offsets from the
  Triton lowering, which overflow; int32 words keep every offset in range;
* the backward pass runs in the same program after the forward loop: it
  reads back its own rows' codes, one gathered byte per row and step, and
  writes the state path and move mask directly in (B, T) layout;
* the stay column (column 0 of the 1025-wide posterior row) is loaded as
  its own (BB,) stream, so every other load is a power-of-two (BB, K)
  block, as Triton requires.
"""
from functools import partial

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sloika_tpu import variables as sv

_ETA = 1e-10

#: batch rows per program and warps per program: 4 rows on 4 warps
#: measured fastest at B=1024 on an H100 (256 programs; docs/PERF.md)
BLOCK_ROWS = 4
NUM_WARPS = 4


def _expand(x, n):
    """(BB, m) -> (BB, m*n) with out[:, i] = x[:, i // n]."""
    BB, m = x.shape
    return jnp.broadcast_to(x[:, :, None], (BB, m, n)).reshape(BB, m * n)


def _group_max(p, n):
    """(max, first-wins arg-group) over ``n`` leading-base groups of the
    (BB, K) scores: mx[:, r] = max_g p[:, g*(K/n) + r]."""
    BB, K = p.shape
    p3 = p.reshape(BB, n, K // n)
    mx = jnp.max(p3, axis=1)
    g = jax.lax.broadcasted_iota(jnp.int32, p3.shape, 1)
    am = jnp.min(jnp.where(p3 == mx[:, None, :], g, n), axis=1)
    return mx, am


def _kernel(post_ref, tb_ref, score_ref, path_ref, moved_ref, *, T, B, BB,
            K, nbase, skip_pen, take_log, interpret):
    nstep, nskip = nbase, nbase * nbase
    rows = pl.program_id(0) * BB + jnp.arange(BB, dtype=jnp.int32)
    # rows past B (the last program's tail) are masked out of every load
    # and store
    valid = rows < B
    cols = jnp.arange(K, dtype=jnp.int32)
    vmask = jnp.broadcast_to(valid[:, None], (BB, K))
    words = jnp.arange(K // 4, dtype=jnp.int32)
    wmask = jnp.broadcast_to(valid[:, None], (BB, K // 4))
    shift = 8 * jax.lax.broadcasted_iota(jnp.int32, (BB, K // 4, 4), 2)

    def load_post(t):
        lpk = plgpu.load(post_ref.at[t, rows[:, None], 1 + cols[None, :]],
                         mask=vmask, other=1.0)
        lps = plgpu.load(post_ref.at[t, rows, 0], mask=valid, other=1.0)
        lpk = lpk.astype(jnp.float32)
        lps = lps.astype(jnp.float32)
        if take_log:
            lpk = jnp.log(lpk + _ETA)
            lps = jnp.log(lps + _ETA)
        return lpk, lps

    def fwd(t, v):
        lpk, lps = load_post(t)
        mx_step, am_step = _group_max(v, nstep)
        if skip_pen == float("inf"):
            m, c = mx_step, am_step
        else:
            # skip group h = g*nstep + q nests inside step group g:
            # reduce the step maxima over q, tie-break on the smallest h
            nrem = K // nskip
            ms3 = mx_step.reshape(BB, nstep, nrem)
            mx_skip = jnp.max(ms3, axis=1)
            q = jax.lax.broadcasted_iota(jnp.int32, ms3.shape, 1)
            h = am_step.reshape(BB, nstep, nrem) * nstep + q
            am_skip = jnp.min(jnp.where(ms3 == mx_skip[:, None, :], h, nskip),
                              axis=1)
            # both branches depend on the destination only through its
            # step group, so decide step vs skip at that resolution
            sk = _expand(mx_skip, nstep) - skip_pen
            better = mx_step > sk
            m = jnp.where(better, mx_step, sk)
            c = jnp.where(better, am_step, nstep + _expand(am_skip, nstep))
        new = lpk + _expand(m, nstep)
        stay = v + lps[:, None]
        code = jnp.where(new > stay, _expand(c, nstep), -1)
        packed = jnp.sum((code + 1).reshape(BB, K // 4, 4) << shift, axis=2)
        plgpu.store(tb_ref.at[t, rows[:, None], words[None, :]], packed,
                    mask=wmask)
        return jnp.maximum(new, stay)

    v0, _ = load_post(0)
    v = jax.lax.fori_loop(1, T, fwd, v0)

    score = jnp.max(v, axis=1)
    last = jnp.min(jnp.where(v == score[:, None], cols[None, :], K), axis=1)
    plgpu.store(score_ref.at[rows], score, mask=valid)
    if not interpret:
        # the codes this program's threads stored above are read back
        # below, by other threads of the same program
        plgpu.debug_barrier()

    def back(i, state):
        t = T - 1 - i
        w = plgpu.load(tb_ref.at[t, rows, state // 4], mask=valid, other=0)
        c = ((w >> (8 * (state % 4))) & 255) - 1
        moved = c >= 0
        prev = jnp.where(c < nstep,
                         c * (K // nstep) + state // nstep,
                         (c - nstep) * (K // nskip) + state // nskip)
        plgpu.store(path_ref.at[rows, t], state, mask=valid)
        plgpu.store(moved_ref.at[rows, t], moved.astype(jnp.int8), mask=valid)
        return jnp.where(moved, prev, state)

    first = jax.lax.fori_loop(0, T - 1, back, last)
    plgpu.store(path_ref.at[rows, 0], first, mask=valid)
    plgpu.store(moved_ref.at[rows, 0], jnp.zeros((BB,), jnp.int8),
                mask=valid)


@partial(jax.jit, static_argnames=("klen", "skip_pen", "log", "nbase",
                                   "time_major", "interpret"))
def viterbi(post, klen, skip_pen=0.0, log=False, nbase=4, time_major=False,
            interpret=False):
    """Drop-in replacement for :func:`sloika_tpu.ops.decode_jax.viterbi`.

    :param post: (B, T, nstate) posteriors — or, with ``time_major``,
        (T, B, nstate), the model forward's native layout, read without a
        transpose.  Probabilities unless ``log`` (the log is then taken in
        the kernel).  float32 or bfloat16.
    :param interpret: run the kernel in the Pallas interpreter (CPU tests)
    :returns: (score (B,), path (B, T) int32, moved (B, T) bool)
    """
    if not time_major:
        post = jnp.moveaxis(post, 1, 0)
    T, B, nst = post.shape
    K = sv.nkmer(klen, nbase=nbase)
    assert nst == K + 1, "posterior has {} states, expected {}".format(
        nst, K + 1)
    BB = BLOCK_ROWS
    kernel = partial(_kernel, T=T, B=B, BB=BB, K=K, nbase=nbase,
                     skip_pen=float(skip_pen), take_log=not log,
                     interpret=interpret)
    _, score, path, moved = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(B, BB),),
        out_shape=[
            jax.ShapeDtypeStruct((T, B, K // 4), jnp.int32),  # traceback
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B, T), jnp.int32),
            jax.ShapeDtypeStruct((B, T), jnp.int8),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="viterbi_transducer",
    )(post)
    return score, path, moved.astype(bool)
