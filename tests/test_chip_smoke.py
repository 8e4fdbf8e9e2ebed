"""The parts of chip_smoke.py that need no card (CPU)."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


class _Device:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line([_Device()] * count)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_on_cpu_without_result():
    res = _run(REPO, "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), str(tmp_path))
    res = _run(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_viterbi_path_score_of_the_optimum():
    """The tie check scores a path the way the decoder does: the numpy
    decoder's own path scores its optimum."""
    from sloika_tpu.ops import decode_jax, decode_np
    rs = np.random.RandomState(0)
    post = rs.dirichlet(np.full(65, 0.2), size=40).astype(np.float32)
    best, _ = decode_np.viterbi(post, 3, skip_pen=2.0)
    _, path, moved = decode_jax.viterbi(post[None], 3, skip_pen=2.0)
    got = chip_smoke.viterbi_path_score(np.log(post + 1e-10),
                                        np.asarray(path[0]),
                                        np.asarray(moved[0]), 2.0)
    assert got == pytest.approx(best, rel=1e-5)


def test_remap_path_score_of_the_optimum():
    from sloika_tpu.ops import remap_np
    from sloika_tpu.util import geometric_prior
    rs = np.random.RandomState(1)
    lt = np.log(rs.dirichlet(np.ones(65), size=60)).astype(np.float32)
    seq = rs.randint(1, 65, size=30)
    p0 = geometric_prior(30, 5.0).astype(np.float32)
    p1 = geometric_prior(30, 5.0, rev=True).astype(np.float32)
    best, path = remap_np.map_to_sequence(lt, seq, 2.0, p0, p1)
    got = chip_smoke.remap_path_score(lt, seq, path, 2.0, p0, p1)
    assert got == pytest.approx(best, rel=1e-9)


def test_basecall_reads_fill_eight_windows_each():
    from sloika_tpu import basecall as bc
    reads = chip_smoke.basecall_reads(3, 512, 64, seed=0)
    jobs = bc._window_jobs([len(r["dac"]) for r in reads], 512, 64)
    assert len(jobs) == 24


def test_training_data_shapes():
    data = chip_smoke.training_data(50, 300, seed=0)
    assert data["chunks"].shape == (50, 300, 1)
    assert data["labels"].shape == (50, 60)
    assert data["labels"].max() <= 1024 and (data["labels"] > 0).any()


@pytest.fixture
def gpu_backend():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("compiled Pallas kernels need the GPU; on the CPU the "
                    "kernels run in the interpreter (test_pallas_*.py)")


@pytest.mark.gpu
def test_compiled_kernels_match_references(gpu_backend):
    """The compiled Viterbi and GRU kernels against their plain references
    at a real width (the same checks chip_smoke.py makes at full size)."""
    chip_smoke.check_gru(T=200, B=16, grad_shape=(50, 16, 96))
    import jax.numpy as jnp
    from sloika_tpu.ops import decode_jax
    from sloika_tpu.ops.pallas import viterbi as pv
    rs = np.random.RandomState(0)
    post = jnp.asarray(rs.dirichlet(np.full(1025, 0.05), size=(8, 64))
                       .astype(np.float32))
    got = pv.viterbi(post, 5, skip_pen=3.0)
    ref = decode_jax.viterbi(post, 5, skip_pen=3.0)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gru_parity_check_in_interpreter():
    """chip_smoke's GRU check (float32 and bfloat16, forward and gradient)
    runs and passes with the kernel in the Pallas interpreter."""
    chip_smoke.check_gru(impl="interpret", T=20, B=5, widths=(11, 20),
                         grad_shape=(12, 5, 9))


def test_remap_phase_and_oracle_check_at_small_size():
    """The remap phase (XLA on the CPU) and its check of the Remapper's
    paths against the numpy oracle, on the captured log posteriors."""
    chip_smoke.phase_remap(batch=3, lo=1500, hi=2500, ncheck=2)


def test_remap_check_catches_a_wrong_path(monkeypatch):
    """A Remapper path that is neither the oracle's nor a tie fails the
    check."""
    from sloika_tpu import remap
    layer, params = chip_smoke.build("raw_1.00_rGr", 1)
    reads = chip_smoke.simulate_reads(1, 1500, 2000, seed=6)
    real = remap.Remapper.remap_dac_signals

    def shifted(self, dacs, refs):
        out = real(self, dacs, refs)
        return [(s, t, np.minimum(p + 1, len(q) - 1), q)
                for s, t, p, q in out]
    monkeypatch.setattr(remap.Remapper, "remap_dac_signals", shifted)
    with pytest.raises(RuntimeError, match="not a tie"):
        chip_smoke.check_remap(layer, params, reads)


def test_basecall_phase_and_viterbi_check_at_small_size():
    """The basecall phase (XLA on the CPU) and the Viterbi check against
    the numpy decoder, with the kernel in the Pallas interpreter."""
    caller, reads, out = chip_smoke.phase_basecall(batch=16, chunk=512,
                                                   overlap=64)
    assert len(out) == 2 and all(len(o[1]) > 0 for o in out)
    chip_smoke.check_viterbi(caller, reads, rows=(0, 15), impl="interpret")
