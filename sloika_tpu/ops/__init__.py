"""Compute ops: convolution helpers, decoders and remap DP.

Three implementation tiers, parity-tested against each other:

* ``decode_np`` / ``remap_np`` / ``olddecode`` — numpy oracles (exact
  reference semantics);
* ``decode_jax`` / ``remap_jax`` / ``remap_banded`` — jittable batched XLA
  implementations;
* ``pallas.viterbi`` — the GPU kernel (Pallas, Triton route).
"""
from sloika_tpu.ops import conv, decode_jax, decode_np, olddecode, remap_jax, remap_np

__all__ = ["conv", "decode_jax", "decode_np", "olddecode", "remap_jax",
           "remap_np"]
