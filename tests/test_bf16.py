"""bfloat16 compute-path test: the MXU fast path must stay numerically close
to float32 (run in a subprocess because the compute dtype is import-time
configuration)."""
import os
import subprocess
import sys

import pytest

SCRIPT = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from sloika_tpu.models import build

layer = build("raw_1.00_rGr", klen=5, sd=0.5, nfeature=1, winlen=11, stride=2)
params = layer.init(jax.random.PRNGKey(0))
x = np.random.RandomState(0).normal(size=(400, 2, 1)).astype(np.float32)
out = np.asarray(layer.apply(params, x))
np.save(os.environ["OUT_FILE"], out)
"""


@pytest.mark.slow
def test_bf16_forward_close_to_f32(tmp_path):
    import numpy as np
    outs = {}
    for dtype in ["float32", "bfloat16"]:
        env = dict(os.environ)
        env["SLOIKA_TPU_COMPUTE_DTYPE"] = dtype
        env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
        env["OUT_FILE"] = str(tmp_path / (dtype + ".npy"))
        res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                             capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-1500:]
        outs[dtype] = np.load(env["OUT_FILE"])
    # posteriors must agree closely despite reduced-precision matmuls
    diff = np.abs(outs["float32"] - outs["bfloat16"]).max()
    assert diff < 0.05, "bf16 posterior deviation too large: {}".format(diff)
    agree = (outs["float32"].argmax(-1) == outs["bfloat16"].argmax(-1)).mean()
    assert agree > 0.95
