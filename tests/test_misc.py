"""Tests for the legacy decoder, parallel map, serialisation round trips and
model conversion."""
import subprocess
import sys

import numpy as np
import pytest

from sloika_tpu.ops import olddecode
from sloika_tpu.parallel.imap import imap_mp, try_except_pass


# ---------------------------------------------------------------------------
# olddecode (legacy non-transducer decoder)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kmer_post():
    rs = np.random.RandomState(1)
    return rs.dirichlet(np.full(64, 0.2), size=30)  # 3-mers, no blank


def test_estimate_transitions(kmer_post):
    trans = olddecode.estimate_transitions(kmer_post)
    assert trans.shape == (30, 3)
    np.testing.assert_allclose(trans.sum(1), 1.0, rtol=1e-6)
    assert np.all(trans >= 0)


def test_decode_profile_runs(kmer_post):
    trans = olddecode.estimate_transitions(kmer_post)
    score, path = olddecode.decode_profile(kmer_post,
                                           trans=np.log(1e-10 + trans),
                                           log=False)
    assert len(path) == 30
    assert np.all((path >= 0) & (path < 64))


def test_decode_simple_recovers_planted_path():
    """With a posterior concentrated on a valid step path, simple decoding
    must recover it."""
    rs = np.random.RandomState(2)
    path = [0]
    for _ in range(19):
        path.append((path[-1] * 4 + rs.randint(4)) % 64)  # valid steps
    post = np.full((20, 64), 1e-4)
    post[np.arange(20), path] = 1.0
    post /= post.sum(1, keepdims=True)
    score, got = olddecode.decode_simple(post)
    np.testing.assert_array_equal(got, path)


def test_decode_transition_matches_profile(kmer_post):
    t = np.log(np.array([0.4, 0.5, 0.1]))
    s1, p1 = olddecode.decode_transition(kmer_post, t)
    s2, p2 = olddecode.decode_profile(
        kmer_post, trans=np.tile(t, (30, 1)))
    assert s1 == pytest.approx(s2)
    np.testing.assert_array_equal(p1, p2)


# ---------------------------------------------------------------------------
# parallel map / fault masking
# ---------------------------------------------------------------------------

def _square(x, offset=0):
    return x * x + offset


def _explode(x):
    if x == 3:
        raise ValueError("boom")
    return x


def test_imap_inline():
    assert list(imap_mp(_square, range(5))) == [0, 1, 4, 9, 16]


def test_imap_threaded_ordered():
    out = list(imap_mp(_square, range(10), threads=4,
                       fix_kwargs={"offset": 1}))
    assert out == [x * x + 1 for x in range(10)]


def test_imap_unordered():
    out = sorted(imap_mp(_square, range(10), threads=4, unordered=True))
    assert out == sorted(x * x for x in range(10))


def test_imap_fault_masking(capfd):
    out = list(imap_mp(_explode, range(5), pass_exception=True))
    assert out == [0, 1, 2, None, 4]


def test_try_except_pass_recover():
    calls = []
    wrapped = try_except_pass(_explode, recover=lambda x: calls.append(x))
    assert wrapped(3) is None
    assert calls == [3]
    assert wrapped(2) == 2


# ---------------------------------------------------------------------------
# model conversion CLI
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_model_convert_pkl_to_npz_and_json(tmp_path):
    import os
    env = dict(os.environ)
    env.update({"PYTHONPATH": "/root/repo:" + os.environ.get("PYTHONPATH", ""),
                "JAX_PLATFORMS": "cpu"})
    npz = str(tmp_path / "model.npz")
    res = subprocess.run(
        [sys.executable, "-m", "sloika_tpu.cli.model_convert",
         "/root/reference/models/pretrained.pkl", npz],
        env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-1000:]

    # reload and verify it basecalls like the original import
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sloika_tpu import serialize
    from sloika_tpu.compat import theano_pickle
    l1, p1 = theano_pickle.load_model("/root/reference/models/pretrained.pkl")
    l2, p2, _ = serialize.load_checkpoint(npz)
    x = np.random.RandomState(0).normal(size=(200, 1, 1)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(l1.apply(p1, x)),
                               np.asarray(l2.apply(p2, x)), atol=1e-6)
