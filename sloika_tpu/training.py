"""Transducer training: loss, pjit'd train step and the training loop.

Re-design of the reference's bin/train_network.py:100-330:

* loss graph semantics kept exactly — ``post = min_prob + (1-min_prob) *
  softmax``, weighted cross-entropy with ``drop`` edge trimming, optional L2
  penalty, accuracy from argmax (train_network.py:124-142)
* gradients via ``jax.grad`` (replacing Theano BPTT) and the ADAMski
  optimiser (:mod:`sloika_tpu.optim`)
* data parallelism: one jit'd train step with sharding annotations over a
  ``('data',)`` mesh — params replicated, batch axis sharded; XLA inserts
  the gradient all-reduce
* the reference's random chunk-length curriculum (train_network.py:291-294)
  is kept, *bucketed* to a small set of static lengths so each length
  compiles once (XLA static shapes)
* checkpoints save params + optimiser state (fixing the reference's
  lost-optimiser-state-on-resume flaw, updates.py:71-81)
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from sloika_tpu import optim, serialize
from sloika_tpu.parallel import mesh as meshlib


class ExponentialSmoother(object):
    """Exponentially smoothed metric (train_network.py:100-113)."""

    def __init__(self, factor, val=0.0, weight=1e-30):
        assert 0.0 <= factor <= 1.0
        self.factor = factor
        self.val = val
        self.weight = weight

    @property
    def value(self):
        return self.val / self.weight

    def update(self, val, weight=1.0):
        self.val = self.factor * self.val + (1.0 - self.factor) * val
        self.weight = self.factor * self.weight + (1.0 - self.factor) * weight


def remove_blanks(labels):
    """Propagate the previous label into blanks (non-transducer training,
    train_network.py:116-121); vectorised."""
    out = labels.copy()
    for lbl in out:
        nz = np.arange(len(lbl)) * (lbl != 0)
        np.maximum.accumulate(nz, out=nz)
        lbl[:] = np.where(lbl == 0, lbl[nz], lbl)
    return out


class Logger(object):
    """Unbuffered tee to a log file and stdout (train_network.py:155-173)."""

    def __init__(self, log_file_name=None, quiet=False):
        self.fh = open(log_file_name, 'wb', 0) if log_file_name else None
        self.quiet = quiet

    def write(self, message):
        if not self.quiet:
            sys.stdout.write(message)
            sys.stdout.flush()
        if self.fh is not None:
            self.fh.write(message.encode('utf-8'))


def terminal_softmax_logits(layer):
    """Build an apply-to-logits function when the network ends in a Softmax.

    The naive loss through ``log(softmax(x))`` overflows float32 in the
    backward pass when a glitchy chunk drives the labelled posterior below
    ~1e-20 — the cotangent is ``1/post`` and BPTT amplifies it past f32 max
    (observed: NaN gradients fine-tuning the pretrained model on bundled
    read data with a -54 MAD signal spike).  The fused log-softmax form has
    the bounded ``y - onehot`` logit gradient, so the loss is computed from
    logits whenever the terminal op is a softmax (every reference model
    config); the ``min_prob`` floor is applied exactly in log space.

    :returns: ``f(params, x) -> logits`` or None if the network does not
        end in a Softmax layer.
    """
    from sloika_tpu.nn.combinators import Serial
    from sloika_tpu.nn.layers import Softmax
    if isinstance(layer, Softmax):
        return lambda params, x: layer._preact(params, x)
    if isinstance(layer, Serial):
        inner = terminal_softmax_logits(layer.layers[-1])
        if inner is None:
            return None

        def apply_logits(params, x):
            sub = params["sublayers"]
            for l, p in zip(layer.layers[:-1], sub[:-1]):
                x = l.apply(p, x)
            return inner(sub[-1], x)

        return apply_logits
    return None


def make_loss_fn(layer, min_prob=0.0, l2=0.0, drop=0):
    """Weighted cross-entropy loss + accuracy over time-major batches.

    :returns: loss_fn(params, x, labels, weights) -> (loss, acc) where
        x (T, B, F); labels, weights (T', B) at label resolution
    """
    ldrop = drop
    udrop = None if drop == 0 else -drop
    logits_fn = terminal_softmax_logits(layer)

    def loss_fn(params, x, labels, weights):
        if logits_fn is not None:
            logits = logits_fn(params, x).astype(jnp.float32)
            lpost = jax.nn.log_softmax(logits, axis=2)
            if min_prob > 0.0:
                # log(min_prob + (1 - min_prob) * post), computed stably
                lpost = jnp.logaddexp(np.log(min_prob),
                                      np.log1p(-min_prob) + lpost)
            post = lpost   # argmax of log-post == argmax of post
        else:
            post = min_prob + (1.0 - min_prob) * layer.apply(params, x)
            lpost = jnp.log(post)
        xent = -jnp.take_along_axis(lpost, labels[..., None], axis=2)[..., 0]
        loss = jnp.mean((weights * xent)[ldrop:udrop])
        if l2 > 0.0:
            loss = loss + l2 * optim.param_sqr(params)
        correct = (jnp.argmax(post, axis=2) == labels)[ldrop:udrop]
        # accuracy over positions with nonzero weight: identical to the
        # plain mean for all-ones weights, and exact for zero-weight
        # padding rows (validate's mesh-rounded tail batch)
        valid = (weights > 0)[ldrop:udrop]
        acc = (jnp.sum(correct * valid)
               / jnp.maximum(jnp.sum(valid), 1)).astype(jnp.float32)
        return loss, acc

    return loss_fn


def make_train_step(layer, opt_update, min_prob=0.0, l2=0.0, drop=0,
                    mesh=None):
    """Build the jit'd data-parallel train step.

    :returns: step(params, opt_state, x, labels, weights, lr)
        -> (params, opt_state, loss, acc)
    """
    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=l2, drop=drop)

    def step(params, opt_state, x, labels, weights, lr):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, x, labels, weights)
        params, opt_state = opt_update(grads, opt_state, params, lr)
        return params, opt_state, loss, acc

    if mesh is None:
        return jax.jit(step, donate_argnums=(0, 1))

    rep = meshlib.replicated(mesh)
    xsh = meshlib.batch_sharding(mesh)
    lsh = meshlib.batch2_sharding(mesh)
    return meshlib.under_mesh(jax.jit(
        step,
        in_shardings=(rep, rep, xsh, lsh, lsh, rep),
        out_shardings=(rep, rep, rep, rep),
        donate_argnums=(0, 1)), mesh)


def make_train_multi_step(layer, opt_update, min_prob=0.0, l2=0.0, drop=0,
                          mesh=None):
    """Build a jit'd train step that runs ``nsteps`` optimiser updates in
    ONE device dispatch (``lax.scan`` over stacked batches).

    Each host->device dispatch has a fixed launch cost; fusing K
    fixed-shape steps amortises it K-fold.  Semantics are identical to calling the single step K times
    (same update maths, sequential batches, per-step learning rates) —
    requires all K batches to share one shape, so it applies to
    fixed-chunk-length training (``--chunk_len_range x x``), not the
    variable-length curriculum.

    :returns: step(params, opt_state, xs, labels, weights, lrs)
        -> (params, opt_state, losses (K,), accs (K,)) with leading
        ``nsteps`` axis on xs/labels/weights/lrs
    """
    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=l2, drop=drop)

    def body(carry, batch):
        params, opt_state = carry
        x, labels, weights, lr = batch
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, x, labels, weights)
        params, opt_state = opt_update(grads, opt_state, params, lr)
        return (params, opt_state), (loss, acc)

    def step(params, opt_state, xs, labels, weights, lrs):
        (params, opt_state), (losses, accs) = jax.lax.scan(
            body, (params, opt_state), (xs, labels, weights, lrs))
        return params, opt_state, losses, accs

    if mesh is None:
        return jax.jit(step, donate_argnums=(0, 1))

    rep = meshlib.replicated(mesh)
    xsh = meshlib.batch_sharding(mesh)
    lsh = meshlib.batch2_sharding(mesh)

    def shard2(sharding):
        # stacked batches: same per-batch sharding with a leading steps axis
        spec = sharding.spec
        return jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, *spec))

    return meshlib.under_mesh(jax.jit(
        step,
        in_shardings=(rep, rep, shard2(xsh), shard2(lsh), shard2(lsh), rep),
        out_shardings=(rep, rep, rep, rep),
        donate_argnums=(0, 1)), mesh)


def make_train_multi_step_resident(layer, opt_update, chunk_len, stride,
                                   min_prob=0.0, l2=0.0, drop=0, mesh=None):
    """Fused K-step trainer whose batches are gathered ON DEVICE from the
    resident chunk set.

    Real-data training through a slow host link is input-wire-bound (the
    reference-default group ships ~11 MB of f32 chunks per 10-step
    dispatch); with the dataset resident on the device the host ships only the
    sampler's (K, B) int32 chunk indices and (K,) window starts — a few
    KB.  The device gather (row take + time slice + transpose) touches
    exactly the elements the host sampler copies
    (train_network.py:304-306 semantics), so training is bit-identical to
    the streaming path (tests/test_training.py::test_resident_training_
    matches_streaming).

    :returns: step(params, opt_state, chunks_d (N, T, F), labels_d (N, L)
        int32, label_weights_d (nlabel,), idx (K, B) int32, starts (K,)
        int32, lrs (K,)) -> (params, opt_state, losses, accs)
    """
    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=l2, drop=drop)
    llen = chunk_len // stride

    def body(data, carry, batch):
        chunks_d, labels_d, lwts = data
        params, opt_state = carry
        idx, start, lr = batch
        rows = jnp.take(chunks_d, idx, axis=0)        # (B, Tdata, F)
        x = jax.lax.dynamic_slice_in_dim(rows, start, chunk_len, axis=1)
        x = jnp.transpose(x, (1, 0, 2))               # time-major
        lrows = jnp.take(labels_d, idx, axis=0)       # (B, Ldata)
        labels = jax.lax.dynamic_slice_in_dim(
            lrows, start // stride, llen, axis=1).T   # (L, B)
        weights = jnp.take(lwts, labels)
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, x, labels, weights)
        params, opt_state = opt_update(grads, opt_state, params, lr)
        return (params, opt_state), (loss, acc)

    def step(params, opt_state, chunks_d, labels_d, lwts, idx, starts, lrs):
        (params, opt_state), (losses, accs) = jax.lax.scan(
            lambda c, b: body((chunks_d, labels_d, lwts), c, b),
            (params, opt_state), (idx, starts, lrs))
        return params, opt_state, losses, accs

    if mesh is None:
        return jax.jit(step, donate_argnums=(0, 1))

    rep = meshlib.replicated(mesh)
    P = jax.sharding.PartitionSpec
    idxsh = jax.sharding.NamedSharding(mesh, P(None, "data"))
    return meshlib.under_mesh(jax.jit(
        step,
        in_shardings=(rep, rep, rep, rep, rep, idxsh, rep, rep),
        out_shardings=(rep, rep, rep, rep),
        donate_argnums=(0, 1)), mesh)


def make_eval_step(layer, min_prob=0.0, drop=0, mesh=None):
    """Loss/accuracy evaluation step without updates
    (validate_network.py:46-54)."""
    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=0.0, drop=drop)

    def step(params, x, labels, weights):
        return loss_fn(params, x, labels, weights)

    if mesh is None:
        return jax.jit(step)
    rep = meshlib.replicated(mesh)
    return meshlib.under_mesh(
        jax.jit(step, in_shardings=(rep, meshlib.batch_sharding(mesh),
                                    meshlib.batch2_sharding(mesh),
                                    meshlib.batch2_sharding(mesh)),
                out_shardings=(rep, rep)), mesh)


def apply_bad_mask(all_labels, all_bad):
    """Zero (blank) labels marked bad.  Raw pipelines store the bad mask at
    sample resolution while labels are stride-downsampled; a label is bad if
    any sample in its block is bad."""
    all_labels = all_labels.copy()
    if all_bad.shape != all_labels.shape:
        stride = all_bad.shape[1] // all_labels.shape[1]
        all_bad = (all_bad[:, :all_labels.shape[1] * stride]
                   .reshape(all_bad.shape[0], all_labels.shape[1], stride)
                   .any(axis=2))
    all_labels[all_bad] = 0
    return all_labels


class ChunkSampler(object):
    """Weighted chunk/window sampler with a bucketed chunk-length curriculum.

    Reference behaviour (train_network.py:288-306): per batch, sample a
    random chunk length in [min_chunk, max_chunk] rounded to the stride,
    scale batch size inversely, pick a random window start, and draw chunks
    weighted without replacement.  Lengths are bucketed to ``n_buckets``
    static values so XLA compiles each shape once.
    """

    def __init__(self, data, batch_size, min_chunk, max_chunk, stride,
                 label_weights, seed=None, n_buckets=4, device_multiple=1):
        self.chunks = data["chunks"]
        self.labels = data["labels"]
        self.weights = data["weights"]
        self.batch_size = batch_size
        self.stride = stride
        self.label_weights = label_weights
        self.rs = np.random.RandomState(seed)
        self.max_batch_size = int((self.weights > 0).sum())
        self.device_multiple = device_multiple

        lengths = np.unique(np.linspace(min_chunk, max_chunk, n_buckets)
                            .astype(int) // stride * stride)
        self.bucket_lengths = lengths[lengths >= stride]
        self.max_chunk = max_chunk
        self.data_chunk = self.chunks.shape[1]

    def sample_indices(self):
        """Draw one batch's (chunk indices, window start, chunk length)
        without materialising the arrays — the device-resident trainer
        gathers the batch on device from exactly these indices, so both
        paths consume the SAME random stream and train bit-identically.

        :returns: (idx (B,) int, start int, chunk_len int)
        """
        chunk_len = int(self.rs.choice(self.bucket_lengths))
        batch_size = int(self.batch_size * float(self.max_chunk) / chunk_len)
        batch_size = min(batch_size, self.max_batch_size)
        batch_size = max(self.device_multiple,
                         batch_size // self.device_multiple * self.device_multiple)

        start = self.rs.randint(self.data_chunk - chunk_len + 1)
        start -= start % self.stride

        # sampling is without replacement while the nonzero-weight
        # population allows it; a tiny dataset on a wide mesh (population <
        # device multiple) falls back to with-replacement so the batch can
        # still fill every device shard
        replace = batch_size > self.max_batch_size
        idx = np.sort(self.rs.choice(len(self.chunks), size=batch_size,
                                     replace=replace, p=self.weights))
        return idx, start, chunk_len

    def materialise(self, idx, start, chunk_len):
        """Build the host arrays for a draw from :meth:`sample_indices`."""
        label_lb = start // self.stride
        label_ub = (start + chunk_len) // self.stride
        x = np.ascontiguousarray(
            self.chunks[idx, start:start + chunk_len].transpose((1, 0, 2)))
        labels = np.ascontiguousarray(
            self.labels[idx, label_lb:label_ub].transpose())
        weights = self.label_weights[labels]
        return x, labels, weights

    def sample(self):
        """Draw one time-major training batch.

        :returns: (x (T, B, F), labels (T', B), weights (T', B))
        """
        return self.materialise(*self.sample_indices())


def label_frequency_weights(all_labels, chunk_weights, ilf=False):
    """Per-label weights; inverse label frequency when ``ilf``
    (train_network.py:242-251)."""
    nlabel = int(np.max(all_labels)) + 1
    if not ilf:
        return np.ones(nlabel, dtype='f4')
    label_weights = np.zeros(nlabel, dtype='f4')
    for i, lbls in enumerate(all_labels):
        label_weights += chunk_weights[i] * np.bincount(lbls, minlength=nlabel)
    label_weights = np.reciprocal(label_weights)
    label_weights /= np.mean(label_weights)
    return label_weights


def train(layer, params, data, *, output=None, adam=(1e-3, 0.9, 0.999),
          batch_size=100, chunk_len_range=(0.5, 1.0), drop=20, ilf=False,
          l2=0.0, lrdecay=5000.0, min_prob=1e-30, niteration=50000,
          quiet=False, save_every=5000, seed=None,
          smooth=0.45, transducer=True, bad=True, mesh=None, log=None,
          opt_state=None, n_length_buckets=4, profile_dir=None,
          steps_per_dispatch=1, prefetch=True, data_on_device="auto",
          optimiser="adamski", lr_warmup=0):
    """Train a network on labelled chunks; the reference training loop
    (train_network.py:176-330) as a function.

    :param data: dict from :func:`sloika_tpu.data.hdf5.load_labelled_chunks`
    :param optimiser: ``"adamski"`` (reference default, updates.py:36-89),
        ``"adam"`` (momentum ramp off) or ``"sgd"`` (momentum SGD,
        updates.py:9-33 — steps proportional to gradient magnitude; the
        gentle choice for fine-tuning a converged model, where ADAMski's
        bias-corrected early steps are ~lr-sized for EVERY parameter
        regardless of gradient and walk the model away from its optimum).
        ``adam[1]`` is the momentum when ``optimiser="sgd"``.
    :param lr_warmup: run the first N iterations at lr 0 — parameters
        frozen while the optimiser's gradient statistics (ADAMski mu/nu)
        calibrate on real gradients, so the first moving step is
        curvature-scaled instead of sign-like.  No-op for sgd.
    :param steps_per_dispatch: fuse this many optimiser steps into one
        device dispatch (fixed chunk length only) — amortises the
        per-dispatch launch cost; maths identical to single steps
        (tests/test_training.py::test_multi_step_matches_repeated_single_steps).
        Checkpoints land at the END of the group that crosses a
        ``save_every`` boundary, so unless ``save_every %
        steps_per_dispatch == 0`` a checkpoint can include up to K-1 extra
        iterations relative to the plain loop.
    :param data_on_device: keep the whole chunk set resident on device and
        gather batches on device (the host ships only int32 sampler
        indices per dispatch; bit-identical training).  "auto" engages it
        for fused fixed-length training (steps_per_dispatch > 1) on a
        single process when the dataset fits the resident budget
        (~1.2 GB, env SLOIKA_TPU_RESIDENT_BYTES); True asserts those
        conditions, False streams batches (the prefetch-worker path).
    :returns: (params, opt_state)
    """
    if output:
        os.makedirs(output, exist_ok=True)
    if log is None:
        log = Logger(os.path.join(output, 'model.log') if output else None,
                     quiet)
    rs_seed = seed

    all_chunks = data["chunks"]
    all_labels = data["labels"]
    all_bad = data["bad"]

    stride = int(np.ceil(float(all_chunks.shape[1]) / all_labels.shape[1]))
    log.write('* Stride is {}\n'.format(stride))

    data_chunk = all_chunks.shape[1]
    min_chunk = (2 * drop + 1 if chunk_len_range[0] is None
                 else int(np.around(chunk_len_range[0] * data_chunk)))
    max_chunk = (data_chunk if chunk_len_range[1] is None
                 else int(np.around(chunk_len_range[1] * data_chunk)))
    log.write('* Will use min_chunk, max_chunk = {}, {}\n'.format(
        min_chunk, max_chunk))
    assert data_chunk >= max_chunk >= min_chunk >= 2 * drop + 1, (
        "inconsistent chunk sizes: need data chunk ({}) >= max_chunk ({}) >= "
        "min_chunk ({}) >= 2*drop+1 ({}); reduce --drop or widen "
        "--chunk_len_range".format(data_chunk, max_chunk, min_chunk,
                                   2 * drop + 1))

    if not transducer:
        all_labels = remove_blanks(all_labels)
    if bad:
        all_labels = apply_bad_mask(all_labels, all_bad)

    label_weights = label_frequency_weights(all_labels, data["weights"], ilf)

    n_dev = 1 if mesh is None else mesh.size
    sampler = ChunkSampler({"chunks": all_chunks, "labels": all_labels,
                            "weights": data["weights"]},
                           batch_size, min_chunk, max_chunk, stride,
                           label_weights, seed=rs_seed,
                           n_buckets=n_length_buckets, device_multiple=n_dev)

    if optimiser == "adamski":
        opt_init, opt_update = optim.adamski(decay=(adam[1], adam[2]))
        state_type = optim.OptState
    elif optimiser == "adam":
        opt_init, opt_update = optim.adam(decay=(adam[1], adam[2]))
        state_type = optim.OptState
    elif optimiser == "sgd":
        opt_init, opt_update = optim.sgd(momentum=adam[1])
        state_type = optim.SGDState
    else:
        raise ValueError("unknown optimiser {!r}".format(optimiser))
    if opt_state is not None and not isinstance(opt_state, state_type):
        log.write('* Resumed optimiser state is {} but optimiser is {}; '
                  'starting the optimiser fresh\n'.format(
                      type(opt_state).__name__, optimiser))
        opt_state = None
    if opt_state is None:
        opt_state = opt_init(params)

    warmup = max(0, int(lr_warmup))

    def sched(i):
        """Per-iteration learning rate: optional statistics warmup at lr 0,
        then the reference 1/(1+i/lrdecay) decay (train_network.py:289)."""
        if i < warmup:
            return 0.0
        return adam[0] / (1.0 + (i - warmup) / lrdecay)
    K = max(1, int(steps_per_dispatch))
    if K > 1 and min_chunk != max_chunk:
        log.write('* steps_per_dispatch needs a fixed chunk length '
                  '(--chunk_len_range x x); falling back to 1\n')
        K = 1
    # device-resident data: gather batches on device from the resident
    # chunk set so only sampler indices ride the host link.  The 1.2 GB
    # budget is a default to re-tune for the card's memory (ROADMAP.md)
    budget = int(os.environ.get("SLOIKA_TPU_RESIDENT_BYTES", 1_200_000_000))
    resident_bytes = (all_chunks.nbytes + all_labels.nbytes
                      + label_weights.nbytes)
    resident_ok = (K > 1 and jax.process_count() == 1
                   and resident_bytes <= budget)
    if data_on_device == "auto":
        resident = resident_ok
    elif data_on_device:
        assert resident_ok, (
            "data_on_device=True needs steps_per_dispatch > 1 (fixed chunk "
            "length), a single process, and <= {} resident bytes (have "
            "{})".format(budget, resident_bytes))
        resident = True
    else:
        resident = False

    if resident:
        fixed_len = int(sampler.bucket_lengths[0])
        step = make_train_multi_step_resident(
            layer, opt_update, fixed_len, stride, min_prob=min_prob, l2=l2,
            drop=drop, mesh=mesh)
        rep_sh = None if mesh is None else meshlib.replicated(mesh)
        chunks_d = jax.device_put(
            np.ascontiguousarray(all_chunks, dtype=np.float32), rep_sh)
        labels_d = jax.device_put(
            np.ascontiguousarray(all_labels, dtype=np.int32), rep_sh)
        lwts_d = jax.device_put(label_weights.astype(np.float32), rep_sh)
        log.write('* Chunk set resident on device ({:.1f} MB); dispatches '
                  'ship sampler indices only\n'.format(resident_bytes / 1e6))
    elif K > 1:
        step = make_train_multi_step(layer, opt_update, min_prob=min_prob,
                                     l2=l2, drop=drop, mesh=mesh)
    else:
        step = make_train_step(layer, opt_update, min_prob=min_prob, l2=l2,
                               drop=drop, mesh=mesh)

    score_smoothed = ExponentialSmoother(smooth)
    acc_smoothed = ExponentialSmoother(smooth)

    # multi-process runs: parameters are replicated, so only process 0
    # writes checkpoints (concurrent writers would corrupt the files on a
    # shared filesystem)
    save_ckpt = output and jax.process_index() == 0
    if save_ckpt:
        serialize.save_checkpoint(
            os.path.join(output, 'model_checkpoint_00000.npz'),
            layer, params, opt_state)

    total_ev = 0
    t0 = time.time()
    log.write('* Training\n')

    if mesh is not None:
        xsh = meshlib.batch_sharding(mesh)
        lsh = meshlib.batch2_sharding(mesh)
        P = jax.sharding.PartitionSpec
        xsh_k = jax.sharding.NamedSharding(mesh, P(None, None, "data", None))
        lsh_k = jax.sharding.NamedSharding(mesh, P(None, None, "data"))
    else:
        xsh = lsh = xsh_k = lsh_k = None

    def put(batch):
        """Start async host->device transfer of a sampled batch.  Under a
        multi-process runtime each host contributes its shard of the global
        batch (hosts sample identically via the shared seed), assembled
        with jax.make_array_from_process_local_data."""
        x, labels, weights = batch
        if xsh is not None:
            return (meshlib.put_host_batch(x, xsh),
                    meshlib.put_host_batch(labels, lsh),
                    meshlib.put_host_batch(weights, lsh), labels.size)
        return (jax.device_put(x, xsh), jax.device_put(labels, lsh),
                jax.device_put(weights, lsh), labels.size)

    def put_group():
        """Sample and ship a group of K same-shape batches as one stacked
        dispatch payload (the fused multi-step amortises the per-dispatch
        launch cost)."""
        if resident:
            draws = [sampler.sample_indices() for _ in range(K)]
            idx = np.stack([d[0] for d in draws]).astype(np.int32)
            starts = np.asarray([d[1] for d in draws], np.int32)
            nev = idx.size * (draws[0][2] // stride)
            return ((jax.device_put(idx), jax.device_put(starts)),
                    draws, nev)
        if K == 1:
            return put(sampler.sample())
        bs = [sampler.sample() for _ in range(K)]
        xs = np.stack([b[0] for b in bs])
        labels = np.stack([b[1] for b in bs])
        weights = np.stack([b[2] for b in bs])
        if xsh_k is not None:
            return (meshlib.put_host_batch(xs, xsh_k, batch_axis=2),
                    meshlib.put_host_batch(labels, lsh_k, batch_axis=2),
                    meshlib.put_host_batch(weights, lsh_k, batch_axis=2),
                    labels.size)
        return (jax.device_put(xs), jax.device_put(labels),
                jax.device_put(weights), labels.size)

    if profile_dir:
        # capture an XLA device trace of the steady-state steps
        # (viewable with TensorBoard or xprof)
        jax.profiler.start_trace(profile_dir)
    # a tail shorter than K runs as single steps (second compile) so the
    # fused path never executes extra iterations
    niter_grouped = (niteration // K) * K
    if K > 1 and niter_grouped < niteration:
        tail_step = make_train_step(layer, opt_update, min_prob=min_prob,
                                    l2=l2, drop=drop, mesh=mesh)

    # Prefetch on a worker thread: sampling (host numpy gather + stack) and
    # the host->device transfer of group g+1 overlap group g's device
    # compute (an inline "dispatch next put before stepping" does not
    # overlap where device_put blocks the caller).  One worker keeps the
    # sample order identical to the
    # serial loop (same sampler stream, same batches); ``prefetch=False``
    # restores the serial loop (for A/B timing or memory-tight hosts).
    from concurrent.futures import ThreadPoolExecutor

    class _Inline:
        def submit(self, fn):
            class R:
                def __init__(self):
                    self.v = fn()

                def result(self):
                    return self.v
            return R()

        def shutdown(self, wait=False):
            pass

    prefetch_pool = (ThreadPoolExecutor(max_workers=1) if prefetch
                     else _Inline())
    try:
        next_batch = prefetch_pool.submit(put_group)
        pending = []
        for g in range(0, niteration, K):
            nsteps = min(K, niteration - g)
            got = next_batch.result()
            if resident:
                (idx_d, starts_d), draws, nev = got
            else:
                x, labels, weights, nev = got
            if g + K < niteration:
                next_batch = prefetch_pool.submit(put_group)
            if resident and nsteps == K:
                lr = jnp.asarray([sched(i) for i in range(g, g + K)],
                                 jnp.float32)
                params, opt_state, loss, acc = step(
                    params, opt_state, chunks_d, labels_d, lwts_d,
                    idx_d, starts_d, lr)
            elif resident:
                # tail group: materialise the drawn batches on the host and
                # run single steps (same draws, same maths)
                losses, accs = [], []
                for j in range(nsteps):
                    xb, lb, wb = sampler.materialise(*draws[j])
                    lr = jnp.float32(sched(g + j))
                    params, opt_state, lv, av = tail_step(
                        params, opt_state, xb, lb, wb, lr)
                    losses.append(lv)
                    accs.append(av)
                loss, acc = jnp.stack(losses), jnp.stack(accs)
                nev = nev // K * nsteps
            elif K == 1:
                lr = jnp.float32(sched(g))
                params, opt_state, loss, acc = step(
                    params, opt_state, x, labels, weights, lr)
            elif nsteps == K:
                lr = jnp.asarray([sched(i) for i in range(g, g + K)],
                                 jnp.float32)
                params, opt_state, loss, acc = step(
                    params, opt_state, x, labels, weights, lr)
            else:
                losses, accs = [], []
                for j in range(nsteps):
                    lr = jnp.float32(sched(g + j))
                    params, opt_state, lv, av = tail_step(
                        params, opt_state, x[j], labels[j], weights[j], lr)
                    losses.append(lv)
                    accs.append(av)
                loss, acc = jnp.stack(losses), jnp.stack(accs)
                nev = nev // K * nsteps

            total_ev += nev
            # keep metrics on device; reading them every group would stall
            # the device for one sync round-trip per dispatch.  Flush on
            # the same 50-iteration
            # boundary as the progress log so several groups queue between
            # pulls and the device never starves.
            pending.append((loss, acc))

            i_last = min(g + K, niteration) - 1
            if save_ckpt and (i_last + 1) // save_every > g // save_every:
                serialize.save_checkpoint(
                    os.path.join(output, 'model_checkpoint_{:05d}.npz'.format(
                        (i_last + 1) // save_every)),
                    layer, params, opt_state)
                log.write('C')
            else:
                log.write('.' * nsteps)

            # fire when the 50-iteration counter advances across this dispatch
            # (same boundary test as checkpoints — robust to any K, including
            # K > 50 where a modulo test would skip counter values)
            if (i_last + 1) // 50 > g // 50:
                for lv, av in pending:
                    for v, a in zip(np.atleast_1d(np.asarray(lv)),
                                    np.atleast_1d(np.asarray(av))):
                        score_smoothed.update(float(v))
                        acc_smoothed.update(float(a))
                pending = []
                tn = time.time()
                dt = tn - t0
                log.write(' {:5d} {:5.3f}  {:5.2f}%  {:5.2f}s ({:.2f} kev/s)\n'
                          .format((i_last + 1) // 50, score_smoothed.value,
                                  100.0 * acc_smoothed.value, dt,
                                  total_ev / 1000.0 / dt))
                total_ev = 0
                t0 = tn

    finally:
        # reap the worker on any exit (exceptions included) so
        # failed runs don't leak prefetch threads
        prefetch_pool.shutdown(wait=False)
    if profile_dir:
        jax.profiler.stop_trace()
        log.write('* Wrote profiler trace to {}\n'.format(profile_dir))
    if save_ckpt:
        serialize.save_checkpoint(os.path.join(output, 'model_final.npz'),
                                  layer, params, opt_state)
    return params, opt_state


def validate(layer, params, data, *, batch_size=200, min_prob=1e-30, drop=0,
             transducer=True, bad=True, mesh=None, log=None, quiet=False):
    """Held-out evaluation over all chunks (validate_network.py:57-110).

    :returns: (mean loss, mean accuracy)
    """
    if log is None:
        log = Logger(None, quiet)
    all_chunks = data["chunks"]
    all_labels = data["labels"]
    if not transducer:
        all_labels = remove_blanks(all_labels)
    if bad:
        all_labels = apply_bad_mask(all_labels, data["bad"])

    step = make_eval_step(layer, min_prob=min_prob, drop=drop, mesh=mesh)

    assert len(all_chunks) > 0, "validation set is empty"
    n_dev = 1 if mesh is None else mesh.size
    nchunk = 0
    per_batch = []        # device (loss*bp, acc*b) pairs: ONE pull at the
    t0 = time.time()      # end instead of a ~32 ms sync per batch
    total_ev = 0
    for lo in range(0, len(all_chunks), batch_size):
        # the tail runs as a smaller batch (rounded up to the mesh size
        # with zero-weight padding rows) rather than being silently
        # dropped — a set smaller than batch_size previously "validated"
        # to a meaningless 0.0/0.0
        b = min(batch_size, len(all_chunks) - lo)
        bp = -(-b // n_dev) * n_dev
        x = np.zeros((bp,) + all_chunks.shape[1:], all_chunks.dtype)
        labels = np.zeros((bp,) + all_labels.shape[1:], all_labels.dtype)
        x[:b] = all_chunks[lo:lo + b]
        labels[:b] = all_labels[lo:lo + b]
        w = np.zeros(labels.shape, np.float32)
        w[:b] = 1.0
        loss, acc = step(params,
                         jnp.asarray(np.ascontiguousarray(
                             x.transpose((1, 0, 2)))),
                         jnp.asarray(np.ascontiguousarray(labels.T)),
                         jnp.asarray(np.ascontiguousarray(w.T)))
        # the padded rows deflate the weighted-mean loss by b/bp exactly
        # (their weights are zero), so loss*bp is b times the true per-chunk
        # mean; accuracy is already weight-masked.  Accumulate chunk-weighted
        # so a small tail batch does not carry a full batch's weight.
        per_batch.append((loss * bp, acc * b))
        nchunk += b
        total_ev += b * all_labels.shape[1]
        log.write('.')
    sums = np.asarray(jnp.asarray(per_batch)).sum(axis=0)
    dt = time.time() - t0
    log.write('\n* {:.2f} kev/s\n'.format(total_ev / 1000.0 / max(dt, 1e-9)))
    return float(sums[0]) / nchunk, float(sums[1]) / nchunk
