"""Finite-difference gradient verification for representative cells."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sloika_tpu.nn as nn


CELLS = {
    "gru": lambda: nn.Gru(5, 8, init=nn.truncated_normal(0.4), has_bias=True,
                          impl="xla"),
    "lstm": lambda: nn.Lstm(5, 8, init=nn.truncated_normal(0.4),
                            has_bias=True, has_peep=True),
    # has_peep=True so the peephole leaf is differentiated (without it the
    # zero peepholes are deliberately frozen — see the test at the end)
    "lstm_cifg": lambda: nn.LstmCIFG(5, 8, init=nn.truncated_normal(0.4),
                                     has_bias=True, has_peep=True),
    "genmut": lambda: nn.Genmut(5, 8, init=nn.truncated_normal(0.4),
                                has_bias=True),
    "scrn": lambda: nn.Scrn(5, 6, 4, init=nn.truncated_normal(0.4)),
    "mut2": lambda: nn.Mut2(5, 8, init=nn.truncated_normal(0.4),
                            has_bias=True),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_grad_matches_finite_differences(name):
    layer = CELLS[name]()
    params = layer.init(jax.random.PRNGKey(3))
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.normal(size=(12, 3, 5)).astype(np.float32))
    # random fixed projection so the loss touches every output
    proj = jnp.asarray(rs.normal(size=(layer.size,)).astype(np.float32))

    def loss(p):
        return jnp.sum(jnp.tanh(layer.apply(p, x)) @ proj)

    grads = jax.grad(loss)(params)
    f64 = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float64), t)
    base = float(loss(params))

    # probe a handful of random coordinates per parameter
    flat, treedef = jax.tree_util.tree_flatten(params)
    gflat = jax.tree_util.tree_leaves(grads)
    eps = 1e-2
    for leaf_idx in range(len(flat)):
        leaf = np.asarray(flat[leaf_idx])
        if leaf.size == 0:
            continue
        for _ in range(2):
            coord = tuple(rs.randint(0, s) for s in leaf.shape)
            bumped = leaf.copy()
            bumped[coord] += eps
            flat2 = list(flat)
            flat2[leaf_idx] = jnp.asarray(bumped)
            lp = float(loss(jax.tree_util.tree_unflatten(treedef, flat2)))
            bumped[coord] -= 2 * eps
            flat2[leaf_idx] = jnp.asarray(bumped)
            lm = float(loss(jax.tree_util.tree_unflatten(treedef, flat2)))
            fd = (lp - lm) / (2 * eps)
            an = float(np.asarray(gflat[leaf_idx])[coord])
            assert an == pytest.approx(fd, rel=0.1, abs=5e-3), \
                "leaf {} coord {}: analytic {} vs fd {}".format(
                    leaf_idx, coord, an, fd)


def test_elu_gradient_finite_at_extreme_inputs():
    """elu's unselected expm1 branch must not overflow: a +400 preactivation
    (bundled reads contain -54 MAD signal glitches that the conv frontend
    amplifies) used to give 0 * inf = NaN through the where VJP."""
    from sloika_tpu.activations import elu
    x = jnp.asarray([-400.0, -1.0, 0.0, 1.0, 400.0])
    y, g = elu(x), jax.vmap(jax.grad(elu))(x)
    assert bool(jnp.all(jnp.isfinite(y))) and bool(jnp.all(jnp.isfinite(g)))
    assert np.allclose(np.asarray(y[3:]), [1.0, 400.0])
    assert np.allclose(np.asarray(g), [0.0, np.exp(-1.0), 1.0, 1.0, 1.0],
                       atol=1e-6)


def test_loss_gradient_finite_when_label_posterior_underflows():
    """The xent must backprop through log-softmax (bounded y - onehot), not
    log(softmax(x)) whose 1/post cotangent overflows f32 when the labelled
    posterior underflows (~1e-20); observed as NaN gradients fine-tuning the
    pretrained model on a glitchy bundled chunk."""
    from sloika_tpu import training

    layer = nn.Serial([nn.FeedForward(2, 4, init=nn.truncated_normal(0.5)),
                       nn.Softmax(4, 5, has_bias=True)])
    params = layer.init(jax.random.PRNGKey(0))
    # drive one logit 120 nats above the labelled one: softmax underflows
    # to exactly 0.0 in f32 at the labelled column
    params["sublayers"][1]["b"] = jnp.asarray([120.0, 0.0, -120.0, 0.0, 0.0],
                                              jnp.float32)
    x = jnp.zeros((6, 3, 2), jnp.float32)
    labels = jnp.full((6, 3), 2, jnp.int32)
    weights = jnp.ones((6, 3), jnp.float32)
    loss_fn = training.make_loss_fn(layer, min_prob=1e-30)
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, x, labels, weights)
    assert bool(jnp.isfinite(loss))
    # the true xent is ~240 nats, far below the 1e-30 floor: the floored
    # loss must sit exactly at -log(1e-30)
    assert float(loss) == pytest.approx(-np.log(1e-30), rel=1e-4)
    assert all(bool(jnp.all(jnp.isfinite(g)))
               for g in jax.tree_util.tree_leaves(grads))


def test_lstm_peep_gradient_frozen_without_has_peep():
    """has_peep=False must not leak gradients into the zero peephole
    weights (the optimiser would silently train them)."""
    layer = nn.Lstm(8, 16, init=nn.truncated_normal(0.4), has_bias=True,
                    has_peep=False)
    params = layer.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(0).normal(
        size=(12, 3, 8)).astype(np.float32))
    g = jax.grad(lambda p: jnp.sum(layer.apply(p, x) ** 2))(params)
    assert np.all(np.asarray(g["p"]) == 0.0)
