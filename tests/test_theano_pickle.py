"""Theano-pickle importer tests: real pretrained model + synthetic stubs for
the layouts (LSTM gate interleave) the bundled pickle doesn't exercise."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sloika_tpu import nn
from sloika_tpu.compat import theano_pickle as tp


class _Shared:
    """Mimic a stubbed Theano shared variable."""
    def __init__(self, value):
        class C:  # container with .storage
            pass
        self.container = C()
        self.container.storage = [np.asarray(value, dtype=np.float32)]


class _Fun:
    def __init__(self, name):
        self.name = name


def _fake_reference_modules(monkeypatch):
    """Install importable stand-ins for the reference's ``sloika.layers``,
    ``sloika.activation`` and Theano's shared-variable classes, so a
    pickle with the reference's globals can be written here."""
    import sys
    import types

    mods = {}
    for name in ("sloika", "sloika.layers", "sloika.activation", "theano",
                 "theano.tensor", "theano.tensor.sharedvar",
                 "theano.compile", "theano.compile.function_module"):
        mods[name] = types.ModuleType(name)
        monkeypatch.setitem(sys.modules, name, mods[name])

    def cls(module, name):
        c = type(name, (), {"__module__": module})
        c.__qualname__ = name
        setattr(mods[module], name, c)
        return c

    layers = {n: cls("sloika.layers", n) for n in
              ("Serial", "Reverse", "Convolution", "Gru", "Softmax")}
    shared = cls("theano.tensor.sharedvar", "TensorSharedVariable")
    container = cls("theano.compile.function_module", "Container")
    funs = {}
    for n in ("tanh", "sigmoid"):
        f = lambda x: x
        f.__module__, f.__name__, f.__qualname__ = "sloika.activation", n, n
        setattr(mods["sloika.activation"], n, f)
        funs[n] = f
    return layers, shared, container, funs


def test_pretrained_pickle_roundtrip(monkeypatch):
    """A pickle written with the reference's globals (Theano shared
    variables, sloika.layers classes, activation functions) for the layer
    graph of the reference's pretrained model (raw_1.00_rGr: tanh
    convolution 128 stride 5, reversed GRU 110, GRU 142, reversed GRU 110,
    softmax 1025) imports to the same graph and the same weights."""
    import pickle
    from sloika_tpu.models import build

    layers, shared_cls, container_cls, funs = \
        _fake_reference_modules(monkeypatch)
    rs = np.random.RandomState(0)

    def shared(*shape):
        v = shared_cls()
        v.container = container_cls()
        v.container.storage = [rs.normal(scale=0.1, size=shape)
                               .astype(np.float32)]
        return v

    def layer(kind, **attrs):
        obj = layers[kind]()
        obj.__dict__.update(attrs)
        return obj

    def gru(I, S):
        return layer("Gru", iW=shared(3 * S, I), sW=shared(2 * S, S),
                     sW2=shared(S, S), b=shared(3 * S), has_bias=True,
                     fun=funs["tanh"], gatefun=funs["sigmoid"])

    graph = layer("Serial", layers=[
        layer("Convolution", W=shared(128, 1, 11), b=shared(128), stride=5,
              has_bias=True, fun=funs["tanh"]),
        layer("Reverse", layer=gru(128, 110)),
        gru(110, 142),
        layer("Reverse", layer=gru(142, 110)),
        layer("Softmax", W=shared(1025, 110), b=shared(1025),
              has_bias=True)])
    blob = pickle.dumps(graph, protocol=2)

    monkeypatch.undo()          # the importer must not need the modules
    lay, params = tp.convert(tp.load_raw(blob))
    ref = build("raw_1.00_rGr", klen=5, sd=0.5, stride=5)
    assert lay.to_json() == ref.to_json()
    assert lay.size == 1025
    np.testing.assert_array_equal(
        np.asarray(params["sublayers"][2]["iW"]),
        graph.layers[2].iW.container.storage[0].reshape(3, 142, 110))
    x = np.random.RandomState(0).normal(size=(50, 2, 1)).astype(np.float32)
    out = np.asarray(lay.apply(params, x))
    assert out.shape == (10, 2, 1025)
    np.testing.assert_allclose(out.sum(axis=2), 1.0, rtol=1e-5)


def test_lstm_interleaved_layout_conversion():
    """The reference Lstm runs with per-unit gate interleaving
    (layers.py:683): flat column 4*u+g is (unit u, gate g).  The importer
    must permute such weights to gate-major so our blockwise step computes
    the same function."""
    rs = np.random.RandomState(4)
    S, I = 8, 3
    # gate-major ground truth
    iW_gm = rs.normal(size=(4, S, I)).astype(np.float32)
    sW_gm = rs.normal(size=(4, S, S)).astype(np.float32)
    b_gm = rs.normal(size=(4, S)).astype(np.float32)
    p = rs.normal(size=(3, S)).astype(np.float32)

    # build the reference's interleaved flat layout: row 4*u+g holds the
    # gate-major row g*S+u
    idx = np.arange(4 * S)
    src = (idx % 4) * S + idx // 4
    iW_flat = iW_gm.reshape(4 * S, I)[src]
    sW_flat = sW_gm.reshape(4 * S, S)[src]
    b_flat = b_gm.reshape(-1)[src]

    class Lstm:  # stub class name drives convert()
        pass

    obj = Lstm()
    obj.iW = _Shared(iW_flat)
    obj.sW = _Shared(sW_flat)
    obj.b = _Shared(b_flat)
    obj.p = _Shared(p)
    obj.fun = _Fun("tanh")
    obj.gatefun = _Fun("sigmoid")

    layer, params = tp.convert(obj)
    assert isinstance(layer, nn.Lstm)
    np.testing.assert_allclose(np.asarray(params["iW"]), iW_gm, atol=1e-7)
    np.testing.assert_allclose(np.asarray(params["sW"]), sW_gm, atol=1e-7)
    np.testing.assert_allclose(np.asarray(params["b"]), b_gm, atol=1e-7)

    # behavioural check against a directly-built gate-major layer
    direct = nn.Lstm(I, S, has_bias=True, has_peep=True)
    dparams = {"iW": jnp.asarray(iW_gm), "sW": jnp.asarray(sW_gm),
               "b": jnp.asarray(b_gm), "p": jnp.asarray(p)}
    x = rs.normal(size=(20, 2, I)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(layer.apply(params, x)),
                               np.asarray(direct.apply(dparams, x)),
                               atol=1e-6)


def test_gru_blockwise_layout_conversion():
    rs = np.random.RandomState(5)
    S, I = 6, 4
    iW = rs.normal(size=(3 * S, I)).astype(np.float32)
    sW = rs.normal(size=(2 * S, S)).astype(np.float32)
    sW2 = rs.normal(size=(S, S)).astype(np.float32)
    b = rs.normal(size=3 * S).astype(np.float32)

    class Gru:
        pass

    obj = Gru()
    obj.iW, obj.sW, obj.sW2, obj.b = (_Shared(iW), _Shared(sW), _Shared(sW2),
                                      _Shared(b))
    obj.fun = _Fun("tanh")
    obj.gatefun = _Fun("sigmoid")
    layer, params = tp.convert(obj)
    assert isinstance(layer, nn.Gru)
    np.testing.assert_allclose(np.asarray(params["iW"]),
                               iW.reshape(3, S, I))
    np.testing.assert_allclose(np.asarray(params["b"]), b.reshape(3, S))


def test_unknown_reference_layer_refused():
    """A reference layer type the importer does not know must be refused
    explicitly, not silently mis-imported."""
    from sloika_tpu.compat import theano_pickle

    # hand-assemble a pickle whose global is an unknown sloika.layers class
    # (no such class exists here, so pickletools-level construction is
    # needed)
    blob = (b"\x80\x02csloika.layers\nFrobnicate\nq\x00)\x81q\x01}q\x02b.")
    obj = theano_pickle.load_raw(blob)
    with pytest.raises(NotImplementedError, match="Frobnicate"):
        theano_pickle.convert(obj)


def _behavioural_check(layer, params, direct_layer, direct_params, insize,
                       rs, atol=1e-6):
    x = rs.normal(size=(20, 2, insize)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(layer.apply(params, x)),
                               np.asarray(direct_layer.apply(direct_params, x)),
                               atol=atol)


def test_scrn_conversion():
    """SCRN pickles carry separate isW/sfW/ifW/ffW plus the non-learned
    decay matrix ssW = alpha*I the importer recovers alpha from
    (layers.py:543-553)."""
    rs = np.random.RandomState(6)
    F, S, I = 5, 3, 4
    mats = {"isW": rs.normal(size=(S, I)), "sfW": rs.normal(size=(F, S)),
            "ifW": rs.normal(size=(F, I)), "ffW": rs.normal(size=(F, F))}

    class Scrn:
        pass

    obj = Scrn()
    for nm, v in mats.items():
        setattr(obj, nm, _Shared(v.astype(np.float32)))
    obj.ssW = _Shared(0.9 * np.eye(S, dtype=np.float32))
    obj.fun = _Fun("sigmoid")
    layer, params = tp.convert(obj)
    assert isinstance(layer, nn.Scrn)
    assert layer.fast_size == F and layer.slow_size == S
    assert layer.alpha == pytest.approx(0.9)
    direct = nn.Scrn(I, F, S, alpha=0.9)
    dparams = {nm: jnp.asarray(v.astype(np.float32))
               for nm, v in mats.items()}
    _behavioural_check(layer, params, direct, dparams, I, rs)


def test_forget_conversion():
    """Forget pickles store block-wise fused (2S, fan) weights
    (layers.py:909-911) and never a gatefun attribute (the reference's
    unassigned-gatefun bug) -> sigmoid default."""
    rs = np.random.RandomState(7)
    S, I = 6, 3
    iW = rs.normal(size=(2 * S, I)).astype(np.float32)
    sW = rs.normal(size=(2 * S, S)).astype(np.float32)
    b = rs.normal(size=2 * S).astype(np.float32)

    class Forget:
        pass

    obj = Forget()
    obj.iW, obj.sW, obj.b = _Shared(iW), _Shared(sW), _Shared(b)
    obj.fun = _Fun("tanh")
    layer, params = tp.convert(obj)
    assert isinstance(layer, nn.Forget) and layer.has_bias
    direct = nn.Forget(I, S, has_bias=True)
    dparams = {"iW": jnp.asarray(iW.reshape(2, S, I)),
               "sW": jnp.asarray(sW.reshape(2, S, S)),
               "b": jnp.asarray(b.reshape(2, S))}
    _behavioural_check(layer, params, direct, dparams, I, rs)


@pytest.mark.parametrize("kind", ["Mut1", "Mut2", "Mut3"])
def test_mut_conversion(kind):
    """MUT pickles carry per-gate matrices under the same names used here
    (layers.py:1057-1066,1156-1166,1259-1270): straight copy."""
    rs = np.random.RandomState(8)
    S, I = 5, 3
    cls = getattr(nn, kind)
    obj = type(kind, (), {})()
    dparams = {}
    for nm in cls._XMATS:
        v = rs.normal(size=(S, I)).astype(np.float32)
        setattr(obj, nm, _Shared(v))
        dparams[nm] = jnp.asarray(v)
    for nm in cls._HMATS:
        v = rs.normal(size=(S, S)).astype(np.float32)
        setattr(obj, nm, _Shared(v))
        dparams[nm] = jnp.asarray(v)
    for nm in ("b_u", "b_z", "b_r", "b_h"):
        v = rs.normal(size=S).astype(np.float32)
        setattr(obj, nm, _Shared(v))
        dparams[nm] = jnp.asarray(v)
    obj.fun = _Fun("tanh")
    obj.gatefun = _Fun("sigmoid")
    layer, params = tp.convert(obj)
    assert isinstance(layer, cls) and layer.has_bias
    direct = cls(I, S, has_bias=True)
    _behavioural_check(layer, params, direct, dparams, I, rs)


def test_genmut_conversion():
    """Genmut pickles store block-wise fused (3S, fan) weights
    (layers.py:1369-1373): direct reshape."""
    rs = np.random.RandomState(9)
    S, I = 4, 3
    xW = rs.normal(size=(3 * S, I)).astype(np.float32)
    sW = rs.normal(size=(3 * S, S)).astype(np.float32)
    sW2 = rs.normal(size=(S, S)).astype(np.float32)
    b = rs.normal(size=3 * S).astype(np.float32)
    b2 = rs.normal(size=S).astype(np.float32)

    class Genmut:
        pass

    obj = Genmut()
    obj.xW, obj.sW, obj.sW2 = _Shared(xW), _Shared(sW), _Shared(sW2)
    obj.b, obj.b2 = _Shared(b), _Shared(b2)
    obj.fun = _Fun("tanh")
    obj.gatefun = _Fun("sigmoid")
    layer, params = tp.convert(obj)
    assert isinstance(layer, nn.Genmut) and layer.has_bias
    direct = nn.Genmut(I, S, has_bias=True)
    dparams = {"xW": jnp.asarray(xW.reshape(3, S, I)),
               "sW": jnp.asarray(sW.reshape(3, S, S)),
               "sW2": jnp.asarray(sW2),
               "b": jnp.asarray(b.reshape(3, S)),
               "b2": jnp.asarray(b2)}
    _behavioural_check(layer, params, direct, dparams, I, rs)
