"""Recurrent layers as `jax.lax.scan` programs.

JAX equivalents of the recurrent zoo in
/root/reference/sloika/layers.py (Recurrent :468, Scrn :523, Lstm :599,
LstmCIFG :700, LstmO :801, Forget :886, Gru :952, Mut1 :1024, Mut2 :1123,
Mut3 :1226, Genmut :1334).

Design decisions:

* The input projection (``x @ iW^T + b``) is hoisted out of the scan and
  computed as one large ``(time*batch, insize) x (insize, ngate*size)``
  matmul on the tensor cores; the scan body only contains the
  state-dependent matmul.  Identical math to the reference's per-step fused
  tensordots (layers.py:677-691).
* ``Reverse`` runs cells with ``lax.scan(reverse=True)`` instead of the
  reference's flip-run-flip (layers.py:1449-1450) — no data movement.
* Fused gate parameters are stored gate-major ``(ngate, size, fan)``, the
  same layout as the reference's JSON export, so JSON dump -> load is exact.

Deliberate fixes of documented reference bugs (do-not-replicate list):
``Scrn.step`` double-counts ``sV`` and drops the fast-fast term
(layers.py:595); ``Forget.__init__`` never assigns ``gatefun``
(layers.py:907); ``Lstm`` ``json``/``set_params`` disagree on bias packing
(layers.py:637 vs :668).  Here the forget bias lands on the forget gate and
serialisation is self-inverse.
"""
import abc

import jax
import jax.numpy as jnp
import numpy as np

from sloika_tpu import activations, backend
from sloika_tpu.config import jax_dtype
from sloika_tpu.nn.core import (Layer, register, zeros_init, affine,
                                activation_name, activation_from_name)

_FORGET_BIAS = 2.0


def _flat(W):
    """(ngate, size, fan) -> (ngate*size, fan) for a fused matmul."""
    return W.reshape((-1, W.shape[-1]))


class RNNBase(Layer):
    """Base for scan-based recurrent layers."""

    def apply(self, params, x, reverse=False, mask=None):
        """Run the recurrence.

        :param mask: optional (T, B) bool; masked steps leave the carried
            state untouched.  With tail padding this makes a ``reverse``
            scan start at each sequence's true end — the key to exact
            batched decoding of variable-length reads.
        """
        xp = self.input_proj(params, x)
        state0 = self.initial_state(params, x.shape[1])

        if mask is None:
            def step_fn(state, xt):
                return self.step(params, xt, state)
            _, out = jax.lax.scan(step_fn, state0, xp, reverse=reverse)
        else:
            # Contract for masked steps: the carried STATE reverts, but the
            # emitted output value at a masked position is unspecified —
            # this scan emits the freshly computed value, the fused Pallas
            # GRU emits the carried state.  Consumers must mask padded
            # positions (apply_with_lengths callers do); parity tests
            # compare under the mask.
            def step_fn(state, xm):
                xt, m = xm
                new_state, out = self.step(params, xt, state)
                new_state = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(m[:, None], a, b), new_state, state)
                return new_state, out
            _, out = jax.lax.scan(step_fn, state0, (xp, mask), reverse=reverse)
        return out

    def apply_with_lengths(self, params, x, lengths):
        T = x.shape[0]
        mask = jnp.arange(T)[:, None] < lengths[None, :]
        return self.apply(params, x, mask=mask), lengths

    @abc.abstractmethod
    def input_proj(self, params, x):
        """Precompute the input-dependent part of the step for all timesteps."""

    @abc.abstractmethod
    def initial_state(self, params, nbatch):
        """Zero state carried through the scan."""

    @abc.abstractmethod
    def step(self, params, xt, state):
        """One timestep: returns (new_state, output_t)."""

    # -- shared serialisation helpers ------------------------------------

    def _json_config(self):
        res = {"activation": activation_name(self.fun),
               "size": self.size, "insize": self.insize,
               "bias": self.has_bias}
        if hasattr(self, "gatefun"):
            res["gate"] = activation_name(self.gatefun)
        return res

    @classmethod
    def _from_json(cls, obj):
        kwargs = {"has_bias": obj.get("bias", False)}
        if "activation" in obj:
            kwargs["fun"] = activation_from_name(obj["activation"])
        if "gate" in obj:
            kwargs["gatefun"] = activation_from_name(obj["gate"])
        if "peep" in obj:
            kwargs["has_peep"] = obj["peep"]
        layer = cls(obj["insize"], obj["size"], **kwargs)
        params = layer._params_from_json(obj["params"]) if "params" in obj else None
        return layer, params


@register("recurrent")
class Recurrent(RNNBase):
    """Vanilla RNN: ``state' = f(x iW^T + state sW^T + b)``
    (reference layers.py:468-520)."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, name="Recurrent"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.fun = fun
        self._init = init

    def init(self, key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {
            "iW": self._init(k1, (self.size, self.insize)) / np.sqrt(self.insize + self.size),
            "sW": self._init(k2, (self.size, self.size)) / np.sqrt(2.0 * self.size),
            "b": (self._init(k3, (self.size,)) if self.has_bias
                  else jnp.zeros((self.size,), jax_dtype)),
        }

    def input_proj(self, params, x):
        return affine(x, params["iW"], params["b"])

    def initial_state(self, params, nbatch):
        return jnp.zeros((nbatch, self.size), jax_dtype)

    def step(self, params, xt, state):
        new = self.fun(xt + affine(state, params["sW"]))
        return new, new


@register("GRU")
class Gru(RNNBase):
    """Gated Recurrent Unit with fused z/r weights and a separate candidate
    matrix ``sW2`` (reference layers.py:952-1021).

    Gate order (gate-major): ``iW = [z; r; h]``, ``sW = [z; r]``.
    """

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid, name="GRU",
                 impl="auto"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.fun = fun
        self.gatefun = gatefun
        self._init = init
        #: recurrence implementation, resolved here by
        #: backend.resolve_impl: "auto" is the fused Pallas kernel
        #: (nn.pallas_gru) on a GPU, the XLA scan on the CPU; "interpret"
        #: runs the kernel in the interpreter
        self.impl = backend.resolve_impl(impl)

    def apply(self, params, x, reverse=False, mask=None):
        standard = (self.fun is activations.tanh
                    and self.gatefun is activations.sigmoid)
        if self.impl != "xla" and standard:
            from sloika_tpu.nn import pallas_gru
            xp = self.input_proj(params, x)
            return pallas_gru.run_gru_fused(
                params, xp, reverse=reverse, mask=mask,
                interpret=self.impl == "interpret")
        return super().apply(params, x, reverse=reverse, mask=mask)

    def init(self, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        S, I = self.size, self.insize
        return {
            "iW": self._init(k1, (3, S, I)) / np.sqrt(I + S),
            "sW": self._init(k2, (2, S, S)) / np.sqrt(2.0 * S),
            "sW2": self._init(k3, (S, S)) / np.sqrt(2.0 * S),
            "b": (self._init(k4, (3, S)) if self.has_bias
                  else jnp.zeros((3, S), jax_dtype)),
        }

    def input_proj(self, params, x):
        return affine(x, _flat(params["iW"]), params["b"].reshape(-1))

    def initial_state(self, params, nbatch):
        return jnp.zeros((nbatch, self.size), jax_dtype)

    def step(self, params, xt, state):
        S = self.size
        vS = affine(state, _flat(params["sW"]))
        vT = xt[:, :2 * S] + vS
        z = self.gatefun(vT[:, :S])
        r = self.gatefun(vT[:, S:])
        y = affine(r * state, params["sW2"])
        hbar = self.fun(xt[:, 2 * S:] + y)
        new = z * state + (1 - z) * hbar
        return new, new


@register("LSTM")
class Lstm(RNNBase):
    """LSTM with peepholes, Currennt-style fused weights
    (reference layers.py:599-697).

    Gate order (gate-major): 0=update candidate, 1=input gate, 2=forget gate,
    3=output gate.  The forget bias (+2.0) initialises gate 2.
    """

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 has_peep=False, fun=activations.tanh,
                 gatefun=activations.sigmoid, name="LSTM"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.has_peep = has_peep
        self.fun = fun
        self.gatefun = gatefun
        self._init = init

    _NGATE = 4
    _FORGET_GATE = 2
    _NPEEP = 3

    def init(self, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        S, I, G = self.size, self.insize, self._NGATE
        b = jnp.zeros((G, S), jax_dtype)
        if self.has_bias:
            b = self._init(k3, (G, S))
            b = b.at[self._FORGET_GATE].add(_FORGET_BIAS)
        p = (self._init(k4, (self._NPEEP, S)) / np.sqrt(S) if self.has_peep
             else jnp.zeros((self._NPEEP, S), jax_dtype))
        return {
            "iW": self._init(k1, (G, S, I)) / np.sqrt(I + S),
            "sW": self._init(k2, (G, S, S)) / np.sqrt(2.0 * S),
            "b": b,
            "p": p,
        }

    def input_proj(self, params, x):
        return affine(x, _flat(params["iW"]), params["b"].reshape(-1))

    def initial_state(self, params, nbatch):
        z = jnp.zeros((nbatch, self.size), jax_dtype)
        return (z, z)  # (output, cell state)

    def step(self, params, xt, state):
        S = self.size
        out_prev, cell = state
        # without has_peep the peephole weights stay identically zero: keep
        # them out of differentiation so the optimiser cannot drift them
        p = (params["p"] if self.has_peep
             else jax.lax.stop_gradient(params["p"]))
        sumW = xt + affine(out_prev, _flat(params["sW"]))
        g0, g1, g2, g3 = (sumW[:, i * S:(i + 1) * S] for i in range(4))
        new_cell = cell * self.gatefun(g2 + cell * p[1])
        new_cell += self.fun(g0) * self.gatefun(g1 + cell * p[0])
        out = self.fun(new_cell) * self.gatefun(g3 + new_cell * p[2])
        return (out, new_cell), out

    def _json_config(self):
        return {**super()._json_config(), "peep": self.has_peep}


@register("LSTM-CIFG")
class LstmCIFG(RNNBase):
    """LSTM with coupled input-forget gates (reference layers.py:700-798).

    Gate order: 0=update candidate, 1=forget gate, 2=output gate; the input
    gate is ``1 - forget``.
    """

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 has_peep=False, fun=activations.tanh,
                 gatefun=activations.sigmoid, name="CoupledLSTM"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.has_peep = has_peep
        self.fun = fun
        self.gatefun = gatefun
        self._init = init

    def init(self, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        S, I = self.size, self.insize
        b = jnp.zeros((3, S), jax_dtype)
        if self.has_bias:
            b = self._init(k3, (3, S)).at[1].add(_FORGET_BIAS)
        p = (self._init(k4, (2, S)) / np.sqrt(S) if self.has_peep
             else jnp.zeros((2, S), jax_dtype))
        return {
            "iW": self._init(k1, (3, S, I)) / np.sqrt(I + S),
            "sW": self._init(k2, (3, S, S)) / np.sqrt(2.0 * S),
            "b": b,
            "p": p,
        }

    def input_proj(self, params, x):
        return affine(x, _flat(params["iW"]), params["b"].reshape(-1))

    def initial_state(self, params, nbatch):
        z = jnp.zeros((nbatch, self.size), jax_dtype)
        return (z, z)

    def step(self, params, xt, state):
        S = self.size
        out_prev, cell = state
        p = (params["p"] if self.has_peep
             else jax.lax.stop_gradient(params["p"]))
        sumW = xt + affine(out_prev, _flat(params["sW"]))
        g0, g1, g2 = (sumW[:, i * S:(i + 1) * S] for i in range(3))
        forget = self.gatefun(g1 + cell * p[0])
        new_cell = cell * forget + self.fun(g0) * (1 - forget)
        out = self.fun(new_cell) * self.gatefun(g2 + new_cell * p[1])
        return (out, new_cell), out

    def _json_config(self):
        return {**super()._json_config(), "peep": self.has_peep}


@register("LSTM-O")
class LstmO(RNNBase):
    """LSTM with peepholes but no output gate (reference layers.py:801-883).

    Gate order: 0=update candidate, 1=input gate, 2=forget gate.
    """

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 has_peep=False, fun=activations.tanh,
                 gatefun=activations.sigmoid, name="TransparentLSTM"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.has_peep = has_peep
        self.fun = fun
        self.gatefun = gatefun
        self._init = init

    def init(self, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        S, I = self.size, self.insize
        b = jnp.zeros((3, S), jax_dtype)
        if self.has_bias:
            b = self._init(k3, (3, S)).at[2].add(_FORGET_BIAS)
        p = (self._init(k4, (3, S)) / np.sqrt(S) if self.has_peep
             else jnp.zeros((3, S), jax_dtype))
        return {
            "iW": self._init(k1, (3, S, I)) / np.sqrt(I + S),
            "sW": self._init(k2, (3, S, S)) / np.sqrt(2.0 * S),
            "b": b,
            "p": p,
        }

    def input_proj(self, params, x):
        return affine(x, _flat(params["iW"]), params["b"].reshape(-1))

    def initial_state(self, params, nbatch):
        return jnp.zeros((nbatch, self.size), jax_dtype)

    def step(self, params, xt, state):
        S = self.size
        p = (params["p"] if self.has_peep
             else jax.lax.stop_gradient(params["p"]))
        sumW = xt + affine(state, _flat(params["sW"]))
        g0, g1, g2 = (sumW[:, i * S:(i + 1) * S] for i in range(3))
        new = state * self.gatefun(g2 + state * p[2])
        new += self.fun(g0 + state * p[0]) * self.gatefun(g1 + state * p[1])
        return new, new

    def _json_config(self):
        return {**super()._json_config(), "peep": self.has_peep}


@register("forget gate")
class Forget(RNNBase):
    """Minimal forget-gate RNN (reference layers.py:886-949; with the
    unassigned-``gatefun`` bug fixed).

    Gate order: 0=forget gate (forget bias here), 1=update candidate.
    """

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid,
                 name="ForgetfulRNN"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.fun = fun
        self.gatefun = gatefun
        self._init = init

    def init(self, key):
        k1, k2, k3 = jax.random.split(key, 3)
        S, I = self.size, self.insize
        b = jnp.zeros((2, S), jax_dtype)
        if self.has_bias:
            b = self._init(k3, (2, S)).at[0].add(_FORGET_BIAS)
        return {
            "iW": self._init(k1, (2, S, I)) / np.sqrt(I + S),
            "sW": self._init(k2, (2, S, S)) / np.sqrt(2.0 * S),
            "b": b,
        }

    def input_proj(self, params, x):
        return affine(x, _flat(params["iW"]), params["b"].reshape(-1))

    def initial_state(self, params, nbatch):
        return jnp.zeros((nbatch, self.size), jax_dtype)

    def step(self, params, xt, state):
        S = self.size
        vT = xt + affine(state, _flat(params["sW"]))
        forget = self.gatefun(vT[:, :S])
        new = state * forget + (1.0 - forget) * self.fun(vT[:, S:])
        return new, new


@register("SCRN")
class Scrn(RNNBase):
    """Structurally Constrained RNN (arXiv:1412.7753, eqs 4-6; reference
    layers.py:523-596 with the ``sV + iV + sV`` double-count bug fixed to
    ``sV + iV + fV``).

        slow' = (1 - a) * (x isW^T) + a * slow
        fast' = fun(slow' sfW^T + x ifW^T + fast ffW^T)
        out   = [fast', slow']
    """

    def __init__(self, insize, fast_size, slow_size, init=zeros_init,
                 alpha=0.95, fun=activations.sigmoid,
                 name="StructurallyConstrainedRNN"):
        self._insize, self._name = insize, name
        self.fast_size = fast_size
        self.slow_size = slow_size
        self._size = fast_size + slow_size
        self.alpha = alpha
        self.fun = fun
        self._init = init
        self.has_bias = False

    def init(self, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        I, F, S = self.insize, self.fast_size, self.slow_size
        return {
            "isW": self._init(k1, (S, I)) / np.sqrt(S + I),
            "sfW": self._init(k2, (F, S)) / np.sqrt(F + S),
            "ifW": self._init(k3, (F, I)) / np.sqrt(F + I),
            "ffW": self._init(k4, (F, F)) / np.sqrt(2.0 * F),
        }

    def input_proj(self, params, x):
        iU = affine(x, params["isW"])
        iV = affine(x, params["ifW"])
        return jnp.concatenate([iU, iV], axis=2)

    def initial_state(self, params, nbatch):
        return jnp.zeros((nbatch, self.size), jax_dtype)

    def step(self, params, xt, state):
        F, S = self.fast_size, self.slow_size
        fast, slow = state[:, :F], state[:, F:]
        iU, iV = xt[:, :S], xt[:, S:]
        slow_out = (1.0 - self.alpha) * iU + self.alpha * slow
        sV = affine(slow_out, params["sfW"])
        fV = affine(fast, params["ffW"])
        fast_out = self.fun(sV + iV + fV)
        new = jnp.concatenate([fast_out, slow_out], axis=1)
        return new, new

    def _json_config(self):
        return {"activation": activation_name(self.fun),
                "size": self.size, "fast_size": self.fast_size,
                "slow_size": self.slow_size, "insize": self.insize,
                "alpha": float(self.alpha)}

    @classmethod
    def _from_json(cls, obj):
        layer = cls(obj["insize"], obj["fast_size"], obj["slow_size"],
                    alpha=obj.get("alpha", 0.95),
                    fun=activation_from_name(obj.get("activation", "sigmoid")))
        params = layer._params_from_json(obj["params"]) if "params" in obj else None
        return layer, params


class _MutBase(RNNBase):
    """Shared machinery for the Jozefowicz MUT variants
    (reference layers.py:1024-1331; generalised to vector inputs via the
    feed-forward ``u`` term)."""

    _XMATS = ()   # (name, used) input weight matrices
    _HMATS = ()   # state weight matrices

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid, name="MUT"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.fun = fun
        self.gatefun = gatefun
        self._init = init

    def init(self, key):
        S, I = self.size, self.insize
        names = list(self._XMATS) + list(self._HMATS)
        keys = jax.random.split(key, len(names) + 4)
        params = {}
        for k, nm in zip(keys, names):
            fan_in = I if nm.startswith("W_x") else S
            params[nm] = self._init(k, (S, fan_in)) / np.sqrt(fan_in + S)
        kz, kr, kh, ku = keys[len(names):]
        if self.has_bias:
            params["b_z"] = self._init(kz, (S,)) + _FORGET_BIAS
            params["b_r"] = self._init(kr, (S,))
            params["b_h"] = self._init(kh, (S,))
            params["b_u"] = self._init(ku, (S,))
        else:
            for nm in ("b_z", "b_r", "b_h", "b_u"):
                params[nm] = jnp.zeros((S,), jax_dtype)
        return params

    def initial_state(self, params, nbatch):
        return jnp.zeros((nbatch, self.size), jax_dtype)

    def _json_params(self, params):
        return dict(params)


@register("MUT1")
class Mut1(_MutBase):
    """MUT1:  u = f(x W_xu + b_u);  z = g(x W_xz + b_z);
    r = g(x W_xr + h W_hr + b_r);
    h' = f((r*h) W_hh + u + b_h) * z + (1 - z) * h
    (reference layers.py:1024-1120)."""

    _XMATS = ("W_xu", "W_xz", "W_xr")
    _HMATS = ("W_hr", "W_hh")

    def input_proj(self, params, x):
        u = self.fun(affine(x, params["W_xu"], params["b_u"]))
        z = self.gatefun(affine(x, params["W_xz"], params["b_z"]))
        rx = affine(x, params["W_xr"], params["b_r"])
        return jnp.concatenate([u, z, rx], axis=2)

    def step(self, params, xt, state):
        S = self.size
        u, z, rx = xt[:, :S], xt[:, S:2 * S], xt[:, 2 * S:]
        r = self.gatefun(rx + affine(state, params["W_hr"]))
        y = affine(r * state, params["W_hh"])
        new = self.fun(y + u + params["b_h"]) * z + (1 - z) * state
        return new, new


@register("MUT2")
class Mut2(_MutBase):
    """MUT2:  u = f(x W_xu + b_u);  r = g(u + h W_hr + b_r);
    z = g(x W_xz + h W_hz + b_z);
    h' = f((r*h) W_hh + x W_xh + b_h) * z + (1 - z) * h
    (reference layers.py:1123-1223)."""

    _XMATS = ("W_xu", "W_xz", "W_xh")
    _HMATS = ("W_hz", "W_hr", "W_hh")

    def input_proj(self, params, x):
        u = self.fun(affine(x, params["W_xu"], params["b_u"]))
        zx = affine(x, params["W_xz"], params["b_z"])
        v = affine(x, params["W_xh"])
        return jnp.concatenate([u, zx, v], axis=2)

    def step(self, params, xt, state):
        S = self.size
        u, zx, v = xt[:, :S], xt[:, S:2 * S], xt[:, 2 * S:]
        z = self.gatefun(zx + affine(state, params["W_hz"]))
        r = self.gatefun(u + affine(state, params["W_hr"]) + params["b_r"])
        y = affine(r * state, params["W_hh"])
        new = self.fun(y + v + params["b_h"]) * z + (1 - z) * state
        return new, new


@register("MUT3")
class Mut3(_MutBase):
    """MUT3:  r = g(x W_xr + h W_hr + b_r);
    z = g(x W_xz + f(h) W_hz + b_z);
    h' = f((r*h) W_hh + x W_xh + b_h) * z + (1 - z) * h
    (reference layers.py:1226-1331; the reference computes a ``u`` term that
    its step never uses — ``W_xu``/``b_u`` are kept as parameters for
    interchange but excluded from the computation, as XLA would DCE them).
    """

    _XMATS = ("W_xu", "W_xz", "W_xr", "W_xh")
    _HMATS = ("W_hz", "W_hr", "W_hh")

    def input_proj(self, params, x):
        zx = affine(x, params["W_xz"], params["b_z"])
        rx = affine(x, params["W_xr"], params["b_r"])
        v = affine(x, params["W_xh"])
        return jnp.concatenate([zx, rx, v], axis=2)

    def step(self, params, xt, state):
        S = self.size
        zx, rx, v = xt[:, :S], xt[:, S:2 * S], xt[:, 2 * S:]
        z = self.gatefun(zx + affine(self.fun(state), params["W_hz"]))
        r = self.gatefun(rx + affine(state, params["W_hr"]))
        y = affine(r * state, params["W_hh"])
        new = self.fun(y + v + params["b_h"]) * z + (1 - z) * state
        return new, new


@register("Genmut")
class Genmut(RNNBase):
    """Generalised MUT1 with fused 3-gate weights
    (reference layers.py:1334-1417).

    Gate order: 0=u (candidate input), 1=r (reset), 2=z (keep).
    """

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid,
                 name="GeneralisedMUT1"):
        self._insize, self._size, self._name = insize, size, name
        self.has_bias = has_bias
        self.fun = fun
        self.gatefun = gatefun
        self._init = init

    def init(self, key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        S, I = self.size, self.insize
        return {
            "xW": self._init(k1, (3, S, I)) / np.sqrt(I + S),
            "sW": self._init(k2, (3, S, S)) / np.sqrt(2.0 * S),
            "sW2": self._init(k3, (S, S)) / np.sqrt(2.0 * S),
            "b": (self._init(k4, (3, S)) if self.has_bias
                  else jnp.zeros((3, S), jax_dtype)),
            "b2": (self._init(k5, (S,)) if self.has_bias
                   else jnp.zeros((S,), jax_dtype)),
        }

    def input_proj(self, params, x):
        return affine(x, _flat(params["xW"]), params["b"].reshape(-1))

    def initial_state(self, params, nbatch):
        return jnp.zeros((nbatch, self.size), jax_dtype)

    def step(self, params, xt, state):
        S = self.size
        iT = xt + affine(state, _flat(params["sW"]))
        u = self.fun(iT[:, :S])
        r = self.gatefun(iT[:, S:2 * S])
        z = self.gatefun(iT[:, 2 * S:])
        y = affine(r * state, params["sW2"])
        new = self.fun(y + u + params["b2"]) * z + (1 - z) * state
        return new, new
