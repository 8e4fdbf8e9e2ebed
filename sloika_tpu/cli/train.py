"""``sloika-train`` — train a network (reference bin/train_network.py).

Subcommands ``events`` and ``raw`` share the reference's argument surface;
models resolve via the model zoo, a ``.py`` model file, or a ``.npz``
checkpoint to resume (optimiser state included — an improvement over the
reference, which rebuilt Adam state on resume).
"""
import argparse
import os
import shutil
import sys

from sloika_tpu.cmdargs import (AutoBool, FileExists, Maybe, NonNegative,
                                ParseToNamedTuple, Positive, proportion,
                                display_version_and_exit)
from sloika_tpu import __version__


def make_parser():
    parser = argparse.ArgumentParser(
        description='Train a transducer neural network',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--adam', nargs=3, metavar=('rate', 'decay1', 'decay2'),
                        default=(1e-3, 0.9, 0.999),
                        type=(NonNegative(float), NonNegative(float),
                              NonNegative(float)),
                        action=ParseToNamedTuple,
                        help='Parameters for ADAMski optimiser')
    common.add_argument('--bad', default=True, action=AutoBool,
                        help='Force blocks marked as bad to be stays')
    common.add_argument('--batch_size', default=100, metavar='chunks',
                        type=Positive(int),
                        help='Number of chunks to run in parallel')
    common.add_argument('--chunk_len_range', nargs=2, metavar=('min', 'max'),
                        type=Maybe(proportion), default=(0.5, 1.0),
                        help='Sample chunk sizes between min and max '
                             '(fraction of chunk size in input file)')
    common.add_argument('--ilf', default=False, action=AutoBool,
                        help='Weight objective by inverse label frequency')
    common.add_argument('--l2', default=0.0, metavar='penalty',
                        type=NonNegative(float), help='L2 penalty on parameters')
    common.add_argument('--lrdecay', default=5000, metavar='n',
                        type=Positive(float),
                        help='LR for batch i is adam.rate / (1.0 + i / n)')
    common.add_argument('--min_prob', default=1e-30, metavar='p',
                        type=proportion, help='Minimum probability in training')
    common.add_argument('--niteration', metavar='batches', type=Positive(int),
                        default=50000, help='Maximum number of batches')
    common.add_argument('--optimiser', default='adamski',
                        choices=['adamski', 'adam', 'sgd'],
                        help='adamski (reference default), plain adam, or '
                             'momentum SGD (gradient-proportional steps — '
                             'the gentle choice for fine-tuning; --adam '
                             'decay1 is the momentum)')
    common.add_argument('--lr_warmup', default=0, metavar='n',
                        type=NonNegative(int),
                        help='Run the first n iterations at lr 0 so the '
                             'optimiser statistics calibrate before the '
                             'first moving step (fine-tuning)')
    common.add_argument('--overwrite', default=False, action=AutoBool,
                        help='Overwrite output directory')
    common.add_argument('--quiet', default=False, action=AutoBool,
                        help="Don't print progress to stdout")
    common.add_argument('--reweight', metavar='group', default='weights',
                        type=Maybe(str),
                        help="Select chunks according to weights in 'group'")
    common.add_argument('--save_every', metavar='x', type=Positive(int),
                        default=5000, help='Save model every x batches')
    common.add_argument('--steps_per_dispatch', metavar='k',
                        type=Positive(int), default=1,
                        help='Fuse k optimiser steps per device dispatch '
                             '(fixed chunk length only; identical maths, '
                             'amortises the dispatch launch cost)')
    common.add_argument('--data_on_device', default='auto',
                        choices=('auto', 'on', 'off'),
                        help='Keep the whole chunk set resident in device '
                             'memory and gather batches on device (host '
                             'ships sampler indices only; bit-identical '
                             'training).  auto = on when '
                             '--steps_per_dispatch > 1, single process, '
                             'and the set fits the ~1.2 GB resident budget')
    common.add_argument('--sd', default=0.5, metavar='value',
                        type=Positive(float),
                        help='Standard deviation for initialisation')
    common.add_argument('--seed', default=None, metavar='integer',
                        type=Positive(int), help='Random number seed')
    common.add_argument('--smooth', default=0.45, metavar='factor',
                        type=proportion, help='Progress smoothing factor')
    common.add_argument('--transducer', default=True, action=AutoBool,
                        help='Train a transducer model')
    common.add_argument('--ndevice', default=None, type=Positive(int),
                        help='Number of devices for data parallelism '
                             '(default: all)')
    common.add_argument('--profile', default=None, metavar='dir',
                        help='Write a jax.profiler trace of the run to dir')
    common.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    common.add_argument('model',
                        help='Model name, python file, or checkpoint to resume')
    common.add_argument('output', help='Output directory')
    common.add_argument('input', action=FileExists,
                        help='HDF5 file containing chunks')

    sub = parser.add_subparsers(dest='command', required=True)
    pe = sub.add_parser('events', parents=[common], help='Train from events',
                        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    pe.add_argument('--drop', default=20, metavar='events',
                    type=NonNegative(int),
                    help='Drop events at chunk edges from the loss')
    pe.add_argument('--winlen', default=3, type=Positive(int),
                    help='Length of window over data')
    pr = sub.add_parser('raw', parents=[common], help='Train from raw signal',
                        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    pr.add_argument('--drop', default=20, metavar='samples',
                    type=NonNegative(int),
                    help='Drop labels at chunk edges from the loss')
    pr.add_argument('--winlen', default=11, type=Positive(int),
                    help='Length of window over data')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)

    import jax
    import numpy as np
    from sloika_tpu import backend, serialize, training
    backend.init_compile_cache()
    from sloika_tpu.data import hdf5
    from sloika_tpu.models import network_factory
    from sloika_tpu.parallel import mesh as meshlib
    from sloika_tpu.variables import DEFAULT_ALPHABET

    if os.path.exists(args.output) and not args.overwrite:
        sys.stderr.write('Error: Output directory {} exists but --overwrite '
                         'is false\n'.format(args.output))
        return 1
    os.makedirs(args.output, exist_ok=True)

    log = training.Logger(os.path.join(args.output, 'model.log'), args.quiet)
    log.write('* Command line\n' + ' '.join(sys.argv) + '\n')
    log.write('* Loading data from {}\n'.format(args.input))
    data = hdf5.load_labelled_chunks(args.input, reweight=args.reweight)

    stride = int(np.ceil(float(data['chunks'].shape[1])
                         / data['labels'].shape[1]))
    klen = int(data['attrs'].get('kmer', 5))
    alphabet = data['attrs'].get('alphabet', DEFAULT_ALPHABET)
    if isinstance(alphabet, str):
        alphabet = alphabet.encode('utf-8')
    nbase = len(alphabet)

    meshlib.maybe_init_distributed()
    ndev = args.ndevice or len(jax.devices())
    mesh = meshlib.make_mesh(ndev) if ndev > 1 else None
    log.write('* Devices: {} ({} used)\n'.format(len(jax.devices()), ndev))

    opt_state = None
    if args.model.endswith('.npz'):
        log.write('* Resuming from checkpoint {}\n'.format(args.model))
        layer, params, opt_state = serialize.load_checkpoint(args.model)
    else:
        log.write('* Building network {}\n'.format(args.model))
        if os.path.exists(args.model) and args.model.endswith('.py'):
            shutil.copyfile(args.model,
                            os.path.join(args.output, 'model.py'))
        network = network_factory(args.model)
        layer = network(klen=klen, sd=args.sd, nbase=nbase,
                        nfeature=data['chunks'].shape[-1],
                        winlen=args.winlen, stride=stride)
        params = layer.init(jax.random.PRNGKey(args.seed or 0))

    training.train(
        layer, params, data, output=args.output,
        adam=(args.adam.rate, args.adam.decay1, args.adam.decay2),
        batch_size=args.batch_size, chunk_len_range=args.chunk_len_range,
        drop=args.drop, ilf=args.ilf, l2=args.l2, lrdecay=args.lrdecay,
        min_prob=args.min_prob, niteration=args.niteration, quiet=args.quiet,
        save_every=args.save_every, seed=args.seed, smooth=args.smooth,
        transducer=args.transducer, bad=args.bad, mesh=mesh, log=log,
        opt_state=opt_state, profile_dir=args.profile,
        optimiser=args.optimiser, lr_warmup=args.lr_warmup,
        steps_per_dispatch=args.steps_per_dispatch,
        data_on_device={"auto": "auto", "on": True,
                        "off": False}[args.data_on_device])
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
