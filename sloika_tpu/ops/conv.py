"""1-D temporal convolution and pooling over time-major tensors.

Functional equivalents of /root/reference/sloika/conv.py:10-135, built on
XLA's native convolution (``lax.conv_general_dilated``) and
``lax.reduce_window`` instead of the reference's NCHW-transpose-into-conv2d
dance.  Inputs are ``(time, batch, features)``; the convolution itself runs
batch-major so XLA runs it as one large matmul.
"""
import jax
import jax.numpy as jnp

PADDING_MODES = frozenset(['same', 'half', 'valid', 'full', 'same_left'])


def calculate_padding(mode, winlen):
    """(start, end) zero-padding for a padding mode and window length.

        'same'       ((winlen-1)//2, winlen//2)   — TF 'SAME'; output length
                     is independent of window length
        'half'       (winlen//2, winlen//2)
        'valid'      (0, 0)
        'full'       (winlen-1, winlen-1)
        'same_left'  (winlen//2, (winlen-1)//2)   — 'same' with the extra 0
                     at the start for even windows
        int          (int, int)
        (int, int)   as given
    """
    assert winlen > 0, "winlen must be positive"
    if isinstance(mode, int):
        return (mode, mode)
    if isinstance(mode, (tuple, list)):
        assert len(mode) == 2 and all(isinstance(m, int) for m in mode), \
            "Padding should be (int, int), got {!r}".format(mode)
        return tuple(mode)
    assert mode in PADDING_MODES, 'Padding mode "{}" not supported'.format(mode)
    if mode == "same":
        return ((winlen - 1) // 2, winlen // 2)
    if mode == "half":
        return (winlen // 2, winlen // 2)
    if mode == "valid":
        return (0, 0)
    if mode == "full":
        return (winlen - 1, winlen - 1)
    return (winlen // 2, (winlen - 1) // 2)


def conv_1d(x, W, stride=1, padding=(0, 0)):
    """Temporal cross-correlation (no filter flip, like the reference).

    :param x: input ``(time, batch, in_features)``
    :param W: filter ``(out_features, in_features, winlen)`` (reference layout)
    :param stride: temporal downsampling rate
    :param padding: (start, end) zero padding of the time axis

    :returns: ``(1 + (time + pad - winlen)//stride, batch, out_features)``
    """
    lhs = jnp.transpose(x, (1, 2, 0))          # (batch, feature, time) = NCW
    out = jax.lax.conv_general_dilated(
        lhs, W,                                # rhs (out, in, winlen) = OIW
        window_strides=(stride,),
        padding=(tuple(padding),),
        dimension_numbers=('NCW', 'OIW', 'NCW'),
        preferred_element_type=jnp.float32,
    )
    return jnp.transpose(out, (2, 0, 1))       # back to (time, batch, feature)


def pool_1d(x, pool_size, stride, padding=(0, 0)):
    """Temporal max-pool with *zero* padding (reference semantics: the input
    is explicitly zero-padded before pooling, conv.py:114-135, so padded
    positions compete as 0.0 rather than -inf).

    :param x: input ``(time, batch, features)``
    :returns: ``(1 + (time + pad - pool_size)//stride, batch, features)``
    """
    ntime = x.shape[0]
    if padding[0] or padding[1]:
        x = jnp.pad(x, ((padding[0], padding[1]), (0, 0), (0, 0)))
    out = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(pool_size, 1, 1),
        window_strides=(stride, 1, 1),
        padding='VALID')
    return out
