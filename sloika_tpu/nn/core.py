"""Core abstractions of the TPU-native layer library.

Design (deliberately different from the reference's Theano object graph,
/root/reference/sloika/layers.py:32-88):

* A :class:`Layer` is a *static configuration object*.  It holds sizes,
  activation functions and hyper-parameters — never parameters.
* Parameters live in plain nested-dict pytrees, created by ``layer.init(rng)``
  and consumed by the pure function ``layer.apply(params, x)``.
* ``x`` is time-major ``(time, batch, features)`` — the same convention as the
  reference (layers.py:13) and the right layout for ``jax.lax.scan``.
* JSON interchange (``to_json``/``from_json``) uses the same type names and
  parameter shapes as the reference's per-layer ``json()`` methods so model
  dumps are interoperable.  Unlike the reference (whose Lstm ``json``/
  ``set_params`` disagree about bias packing), dump -> load here is an exact
  inverse.

Parameters are stored *gate-major*: fused weights have shape
``(ngate, size, fan_in)`` matching the reference's JSON export layout.
"""
import abc

import jax
import jax.numpy as jnp
import numpy as np

from sloika_tpu import activations
from sloika_tpu.config import jax_dtype, compute_dtype


# ---------------------------------------------------------------------------
# Initialisers.  An initialiser is ``f(key, shape) -> array``.
# ---------------------------------------------------------------------------

def zeros_init(key, shape):
    """Default initialiser of the reference (layers.py:21-22)."""
    return jnp.zeros(shape, dtype=jax_dtype)


def truncated_normal(sd):
    """Xavier-style truncated normal (+/- 2 sigma), reference
    module_tools.truncated_normal (module_tools.py:9-13)."""
    def init(key, shape):
        return (sd * jax.random.truncated_normal(key, -2.0, 2.0, shape)
                ).astype(jax_dtype)
    return init


# ---------------------------------------------------------------------------
# Compute helpers
# ---------------------------------------------------------------------------

def affine(x, W, b=None):
    """``x @ W.T (+ b)`` over the trailing feature axis.

    ``W`` has reference layout ``(out_features, in_features)``.  The matmul is
    performed in :data:`sloika_tpu.config.compute_dtype` (bfloat16 on request)
    with float32 accumulation — this is the op that lands on the tensor
    cores.
    """
    if compute_dtype != jnp.float32:
        y = jax.lax.dot_general(
            x.astype(compute_dtype), W.astype(compute_dtype),
            dimension_numbers=(((x.ndim - 1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
    else:
        y = jnp.tensordot(x, W, axes=((x.ndim - 1,), (1,)))
    if b is not None:
        y = y + b
    return y


# ---------------------------------------------------------------------------
# Layer base class and JSON registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(json_type):
    """Class decorator registering a layer under its JSON ``type`` string."""
    def deco(cls):
        cls.json_type = json_type
        _REGISTRY[json_type] = cls
        return cls
    return deco


class Layer(metaclass=abc.ABCMeta):
    """Static layer configuration; see module docstring."""

    json_type = None
    _name = "Layer"

    @property
    def insize(self):
        return self._insize

    @property
    def size(self):
        return self._size

    @property
    def name(self):
        return self._name

    @abc.abstractmethod
    def init(self, key):
        """Create this layer's parameter pytree."""

    @abc.abstractmethod
    def apply(self, params, x):
        """Run the layer on time-major input ``(time, batch, features)``."""

    def apply_with_lengths(self, params, x, lengths):
        """Run on a batch of tail-padded variable-length sequences.

        ``lengths`` is an int32 (batch,) vector of true lengths.  Returns
        ``(y, out_lengths)``.  Positions beyond a sequence's output length
        are unspecified.  The default covers position-wise layers; layers
        that mix information across time or batch override (RNNs mask their
        scans; convolutions transform the lengths) or refuse (Studentise).
        """
        return self.apply(params, x), lengths

    # -- serialisation ----------------------------------------------------

    def to_json(self, params=None):
        """JSON-compatible description; include parameters when given."""
        res = self._json_config()
        res["type"] = self.json_type
        # keep 'type' first for readability
        res = {"type": res.pop("type"), **res}
        if params is not None:
            res["params"] = {k: np.asarray(v).tolist()
                             for k, v in self._json_params(params).items()}
        return res

    def _json_config(self):
        return {}

    def _json_params(self, params):
        """Map the internal param pytree to the reference JSON layout."""
        return dict(params)

    def _params_from_json(self, jparams):
        """Inverse of :meth:`_json_params`."""
        return {k: jnp.asarray(np.array(v, dtype=np.float32))
                for k, v in jparams.items()}

    # -- helpers ----------------------------------------------------------

    def param_count(self, params):
        return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))


def from_json(obj):
    """Rebuild ``(layer, params_or_None)`` from a JSON description."""
    cls = _REGISTRY[obj["type"]]
    return cls._from_json(obj)


def activation_name(fun):
    return fun.__name__


def activation_from_name(name):
    return activations.by_name(name)
