"""Fused GRU recurrence as Pallas (Triton route) kernels.

Under an XLA ``while`` loop every GRU step costs several kernel launches
for two small matmuls and a few gates.  Here each program owns ``BB``
batch rows and loops over time inside the kernel (``fori_loop``): the
hidden state stays in registers and the recurrent weights are re-read
from L1/L2 each step, so a whole layer is one launch.

Semantics are those of :class:`sloika_tpu.nn.rnn.Gru` with the standard
``sigmoid``/``tanh`` gates (reference layers.py:1010-1021).  The hidden
size ``S`` is zero-padded to a power of two ``Sp`` for ``pl.dot``; this is
exact: a padded unit has zero weights and a zero initial state, so
``z = r = 0.5`` and ``hbar = tanh(0) = 0`` keep it at 0.  Loads and stores
of the unpadded (T, B, 3S) / (T, B, S) arrays are masked, so no padded
copy of an activation is made.  The state is held as column blocks whose
weight blocks fit shared memory (:func:`block_width`).

Differentiation goes through a ``jax.custom_vjp``.  The backward kernel
walks time in reverse, recomputes the gates from (xp_t, h_{t-1}), carries
the state cotangent in registers and writes the input-projection cotangent
plus ``r * h_{t-1}``; the recurrent-weight cotangents are then two large
(S, T*B) x (T*B, S) matmuls in XLA.

Masked-step contract: the emitted value at a masked position is the
*carried* state (the XLA scan emits the freshly computed value there) —
padded-position outputs are unspecified and consumers must mask them.

Matmul precision follows the caller: bfloat16 operands when
``config.compute_dtype`` is bfloat16, otherwise float32 operands at the
precision ``jax.default_matmul_precision`` names (TF32 on the tensor cores
unless "highest"/"float32" asks for IEEE float32).
"""
import operator
from functools import partial, reduce

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sloika_tpu import config
from sloika_tpu.parallel import mesh as meshlib

#: batch rows per program (``pl.dot`` needs at least 16) and warps per
#: program: 16 rows on 8 warps measured fastest at S=110 and S=142 on an
#: H100 (docs/PERF.md); 4 warps spill registers at the padded width 256
BLOCK_ROWS = 16
NUM_WARPS = 8


def padded_size(S):
    """Power-of-two hidden width the kernels compute at (>= 16)."""
    return max(16, 1 << (int(S) - 1).bit_length())


#: one (Wb, Wb) block of a recurrent weight matrix is a ``pl.dot`` operand
#: in shared memory; blocks stay within 128 KB (bfloat16: Wb <= 256,
#: float32: Wb <= 128), so a padded width of 256 runs as 2 x 2 blocks in
#: float32
_WEIGHT_BLOCK_BYTES = 1 << 17


def block_width(Sp, dtype):
    """Column-block width of the kernels' hidden state for weights of
    ``dtype``."""
    wb = Sp
    while wb * wb * np.dtype(dtype).itemsize > _WEIGHT_BLOCK_BYTES:
        wb //= 2
    return wb


def _dot(a, b, precision, transpose_b=False):
    dims = (((1,), (1 if transpose_b else 0,)), ((), ()))
    return jax.lax.dot_general(a.astype(b.dtype), b, dims,
                               precision=precision,
                               preferred_element_type=jnp.float32)


def _matmul(xs, w_ref, gate, precision, transpose=False):
    """``x @ W`` (or ``x @ W.T``) for the state held as column blocks
    ``xs`` (a tuple of (BB, Wb) arrays) and gate ``gate``'s (Sp, Sp)
    weights, one (Wb, Wb) weight block per ``pl.dot``."""
    nb = len(xs)
    wb = xs[0].shape[1]

    def blk(i, j):
        return w_ref[gate, i * wb:(i + 1) * wb, j * wb:(j + 1) * wb]

    if transpose:
        return tuple(reduce(operator.add, (
            _dot(xs[j], blk(i, j), precision, transpose_b=True)
            for j in range(nb))) for i in range(nb))
    return tuple(reduce(operator.add, (_dot(xs[i], blk(i, j), precision)
                                       for i in range(nb)))
                 for j in range(nb))


def _map(fn, *blocks):
    return tuple(fn(*b) for b in zip(*blocks))


def _step_gates(xz, xr, xh, h, w_ref, precision):
    """Recompute (z, r, hbar) for one step from xp_t and h_{t-1}."""
    z = _map(lambda x, y: jax.nn.sigmoid(x + y), xz,
             _matmul(h, w_ref, 0, precision))
    r = _map(lambda x, y: jax.nn.sigmoid(x + y), xr,
             _matmul(h, w_ref, 1, precision))
    rh = _map(lambda a, b: a * b, r, h)
    hbar = _map(lambda x, y: jnp.tanh(x + y), xh,
                _matmul(rh, w_ref, 2, precision))
    return z, r, hbar


class _Tile(object):
    """Row/column indexing of one program's (BB, Sp) tile of a
    (T, B, n*S) array as ``nb`` column blocks of width ``wb``, with the
    padding and the batch tail masked."""

    def __init__(self, B, S, BB, wb, nb):
        self.rows = pl.program_id(0) * BB + jnp.arange(BB, dtype=jnp.int32)
        self.valid = self.rows < B
        self.cols = jnp.arange(wb, dtype=jnp.int32)
        self.S, self.wb, self.nb = S, wb, nb

    def _idx(self, t, gate, k):
        local = k * self.wb + self.cols
        mask = self.valid[:, None] & (local < self.S)[None, :]
        return (t, self.rows[:, None],
                gate * self.S + local[None, :]), mask

    def load(self, ref, t, gate=0):
        out = []
        for k in range(self.nb):
            idx, mask = self._idx(t, gate, k)
            out.append(plgpu.load(ref.at[idx], mask=mask, other=0.0))
        return tuple(out)

    def store(self, ref, t, vals, gate=0):
        for k, val in enumerate(vals):
            idx, mask = self._idx(t, gate, k)
            plgpu.store(ref.at[idx], val, mask=mask)

    def step_mask(self, mask_ref, t):
        m = plgpu.load(mask_ref.at[t, self.rows], mask=self.valid, other=0)
        return (m != 0)[:, None]

    def zeros(self, BB):
        return tuple(jnp.zeros((BB, self.wb), jnp.float32)
                     for _ in range(self.nb))


def _fwd_kernel(xp_ref, mask_ref, w_ref, out_ref, *, T, B, S, BB, wb, nb,
                reverse, precision):
    tile = _Tile(B, S, BB, wb, nb)

    def step(i, h):
        t = T - 1 - i if reverse else i
        z, _, hbar = _step_gates(tile.load(xp_ref, t, 0),
                                 tile.load(xp_ref, t, 1),
                                 tile.load(xp_ref, t, 2), h, w_ref, precision)
        m = tile.step_mask(mask_ref, t)
        new = _map(lambda z, h, hb: jnp.where(m, z * h + (1 - z) * hb, h),
                   z, h, hbar)
        tile.store(out_ref, t, new)
        return new

    jax.lax.fori_loop(0, T, step, tile.zeros(BB))


def _bwd_kernel(xp_ref, mask_ref, w_ref, hout_ref, g_ref, dxp_ref, rh_ref,
                *, T, B, S, BB, wb, nb, reverse, precision):
    tile = _Tile(B, S, BB, wb, nb)

    def step(j, dh):
        i = T - 1 - j                     # scan step, visited last to first
        t = T - 1 - i if reverse else i
        t_prev = jnp.minimum(t + 1, T - 1) if reverse else jnp.maximum(t - 1, 0)
        h_prev = _map(lambda h: jnp.where(i > 0, h, 0.0),
                      tile.load(hout_ref, t_prev))
        m = tile.step_mask(mask_ref, t)
        z, r, hbar = _step_gates(tile.load(xp_ref, t, 0),
                                 tile.load(xp_ref, t, 1),
                                 tile.load(xp_ref, t, 2), h_prev, w_ref,
                                 precision)
        dht = _map(lambda a, b: a + b, dh, tile.load(g_ref, t))
        # a masked step copied h through: its cotangent goes straight on
        dh_eff = _map(lambda d: jnp.where(m, d, 0.0), dht)
        dz = _map(lambda d, hp, hb, z: d * (hp - hb) * z * (1 - z),
                  dh_eff, h_prev, hbar, z)
        da = _map(lambda d, z, hb: d * (1 - z) * (1 - hb * hb),
                  dh_eff, z, hbar)
        drh = _matmul(da, w_ref, 2, precision, transpose=True)
        dr = _map(lambda d, hp, r: d * hp * r * (1 - r), drh, h_prev, r)
        dz_h = _matmul(dz, w_ref, 0, precision, transpose=True)
        dr_h = _matmul(dr, w_ref, 1, precision, transpose=True)
        dh_prev = _map(
            lambda de, z, d_rh, r, a, b, d: (de * z + d_rh * r + a + b
                                             + jnp.where(m, 0.0, d)),
            dh_eff, z, drh, r, dz_h, dr_h, dht)
        tile.store(dxp_ref, t, dz, 0)
        tile.store(dxp_ref, t, dr, 1)
        tile.store(dxp_ref, t, da, 2)
        tile.store(rh_ref, t, _map(lambda a, b: a * b, r, h_prev))
        return dh_prev

    jax.lax.fori_loop(0, T, step, tile.zeros(BB))


def _call(kernel, args, out_shape, interpret, name, dtype, **kw):
    """Run ``kernel`` over the (T, B, ...) ``args`` (the recurrent weights,
    ``args[2]``, replicated); under an ambient ``'data'`` mesh each device
    runs it on its own batch shard."""
    def call(*args):
        T, B, threeS = args[0].shape
        S = threeS // 3
        Sp = padded_size(S)
        wb = block_width(Sp, dtype)
        shapes = jax.tree_util.tree_map(
            lambda o: jax.ShapeDtypeStruct((T, B) + o.shape[2:], o.dtype),
            out_shape)
        return pl.pallas_call(
            partial(kernel, T=T, B=B, S=S, BB=BLOCK_ROWS, wb=wb,
                    nb=Sp // wb, **kw),
            grid=(pl.cdiv(B, BLOCK_ROWS),),
            out_shape=shapes,
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
            interpret=interpret,
            name=name,
        )(*args)

    mesh = meshlib.data_mesh()
    if mesh is None:
        return call(*args)
    P = jax.sharding.PartitionSpec
    return jax.shard_map(
        call, mesh=mesh,
        in_specs=tuple(P() if i == 2 else P(None, "data")
                       for i in range(len(args))),
        out_specs=jax.tree_util.tree_map(lambda o: P(None, "data"),
                                         out_shape),
        check_vma=False)(*args)


def _gate_weights(sW, sW2, dtype):
    """(3, Sp, Sp) zero-padded, transposed recurrent weights [z, r, h]:
    ``h @ w[g]`` is the step's state matmul for gate g."""
    S = sW2.shape[0]
    w = jnp.stack([sW[0].T, sW[1].T, sW2.T])
    Sp = padded_size(S)
    return jnp.pad(w, ((0, 0), (0, Sp - S), (0, Sp - S))).astype(dtype)


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def gru_fused(xp, sW, sW2, mask, reverse, precision, dtype, interpret):
    """mask: int8 (T, B); pass all-ones for unmasked runs."""
    T, B, threeS = xp.shape
    return _call(_fwd_kernel,
                 (xp, mask, _gate_weights(sW, sW2, dtype)),
                 jax.ShapeDtypeStruct((T, B, threeS // 3), jnp.float32),
                 interpret, "gru_forward", dtype, reverse=reverse,
                 precision=precision)


def _fwd(xp, sW, sW2, mask, reverse, precision, dtype, interpret):
    out = gru_fused(xp, sW, sW2, mask, reverse, precision, dtype, interpret)
    return out, (xp, sW, sW2, mask, out)


def _bwd(reverse, precision, dtype, interpret, res, g):
    xp, sW, sW2, mask, h_out = res
    T, B, threeS = xp.shape
    S = threeS // 3
    dxp, rh = _call(_bwd_kernel,
                    (xp, mask, _gate_weights(sW, sW2, dtype), h_out, g),
                    (jax.ShapeDtypeStruct((T, B, threeS), jnp.float32),
                     jax.ShapeDtypeStruct((T, B, S), jnp.float32)),
                    interpret, "gru_backward", dtype, reverse=reverse,
                    precision=precision)
    zero = jnp.zeros((1, B, S), h_out.dtype)
    if reverse:
        h_prev = jnp.concatenate([h_out[1:], zero], axis=0)
    else:
        h_prev = jnp.concatenate([zero, h_out[:-1]], axis=0)
    # recurrent-weight cotangents: one (S, T*B) x (T*B, S) product each
    wgrad = lambda d, a: jnp.einsum("tbo,tbi->oi", d.astype(dtype),
                                    a.astype(dtype), precision=precision,
                                    preferred_element_type=jnp.float32)
    dsW = jnp.stack([wgrad(dxp[:, :, :S], h_prev),
                     wgrad(dxp[:, :, S:2 * S], h_prev)])
    dsW2 = wgrad(dxp[:, :, 2 * S:], rh)
    return dxp, dsW.astype(sW.dtype), dsW2.astype(sW2.dtype), None


gru_fused.defvjp(_fwd, _bwd)


def reference_scan(xp, sW, sW2, mask, reverse, dtype, precision):
    """Plain XLA scan of the same recurrence (the parity reference): matmul
    operands in ``dtype`` at ``precision``, float32 accumulation."""
    S = sW2.shape[0]

    def dot(a, W):
        return jnp.dot(a.astype(dtype), W.T.astype(dtype),
                       precision=precision,
                       preferred_element_type=jnp.float32)

    def step(h, inp):
        lp, m = inp
        z = jax.nn.sigmoid(lp[:, :S] + dot(h, sW[0]))
        r = jax.nn.sigmoid(lp[:, S:2 * S] + dot(h, sW[1]))
        hbar = jnp.tanh(lp[:, 2 * S:] + dot(r * h, sW2))
        new = jnp.where(m[:, None] != 0, z * h + (1 - z) * hbar, h)
        return new, new

    h0 = jnp.zeros((xp.shape[1], S), jnp.float32)
    return jax.lax.scan(step, h0, (xp, mask), reverse=reverse)[1]


def matmul_precision():
    """The float32 matmul precision currently asked of JAX (read at trace
    time): HIGHEST for "highest"/"float32", else DEFAULT (TF32 on GPU)."""
    p = jax.config.jax_default_matmul_precision
    return (jax.lax.Precision.HIGHEST
            if str(p).lower() in ("highest", "float32", "precision.highest")
            else jax.lax.Precision.DEFAULT)


def run_gru_fused(params, xp, reverse=False, mask=None, interpret=False):
    """Run the fused GRU over a precomputed input projection.

    :param params: Gru parameter pytree (gate-major sW (2,S,S), sW2 (S,S))
    :param xp: (T, B, 3S) input projection (x @ iW^T + b)
    :param mask: optional (T, B) bool valid-step mask
    """
    mask = (jnp.ones(xp.shape[:2], jnp.int8) if mask is None
            else mask.astype(jnp.int8))
    dtype = np.dtype(config.compute_dtype)
    return gru_fused(xp.astype(jnp.float32), params["sW"], params["sW2"],
                     mask, reverse, matmul_precision(), dtype, interpret)
