"""Global numeric configuration for sloika_tpu.

The reference pins everything to Theano's floatX=float32 (sloika/config.py
in the reference).  float32 stays the parameter/IO dtype for parity with
the reference, and a compute-dtype knob lets matmul-heavy paths run in
bfloat16 on the tensor cores when parity is not required.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

#: dtype used for parameters, inputs and outputs (reference parity dtype)
sloika_dtype = np.float32

#: jnp view of the same dtype
jax_dtype = jnp.float32

#: compute dtype for matmuls inside the hot path.  float32 by default for
#: parity; set SLOIKA_TPU_COMPUTE_DTYPE=bfloat16 for tensor-core throughput.
compute_dtype = jnp.bfloat16 if os.environ.get(
    "SLOIKA_TPU_COMPUTE_DTYPE", "float32") == "bfloat16" else jnp.float32


def set_matmul_precision(precision: str = "highest") -> None:
    """Set the default precision of float32 matmuls.

    On the GPU, 'default' runs float32 matmuls as TF32 on the tensor cores
    (about three decimal digits), 'high' as three bf16 passes, and
    'highest' as IEEE float32.  Parity references ask for 'highest'.
    """
    jax.config.update("jax_default_matmul_precision", precision)
