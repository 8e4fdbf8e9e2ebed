"""``sloika-verify`` — model smoke test (reference bin/verify_network.py):
build a model, jit-compile the forward, and run a handful of random-shaped
batches as a shape fuzz; report parameter count.
"""
import argparse

from sloika_tpu.cmdargs import Positive, display_version_and_exit
from sloika_tpu import __version__


def make_parser():
    parser = argparse.ArgumentParser(
        description='Verify a model file compiles and runs',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--kmer_len', default=5, type=Positive(int))
    parser.add_argument('--nfeature', default=1, type=Positive(int))
    parser.add_argument('--winlen', default=11, type=Positive(int))
    parser.add_argument('--stride', default=1, type=Positive(int))
    parser.add_argument('--sd', default=0.5, type=float)
    parser.add_argument('--nbatch', default=5, type=Positive(int),
                        help='Number of random-shaped batches to run')
    parser.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    parser.add_argument('model', help='Model name or python file')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)

    import jax
    import numpy as np
    from sloika_tpu import backend
    from sloika_tpu.models import network_factory
    backend.init_compile_cache()

    network = network_factory(args.model)
    layer = network(klen=args.kmer_len, sd=args.sd,
                    nfeature=args.nfeature, winlen=args.winlen,
                    stride=args.stride)
    params = layer.init(jax.random.PRNGKey(0))
    nparam = layer.param_count(params)
    print('* Built network: insize {}, size {}, {} parameters'.format(
        layer.insize, layer.size, nparam))

    rs = np.random.RandomState(17)
    for i in range(args.nbatch):
        ntime = int(rs.randint(50, 500)) // args.stride * args.stride
        nbatch = int(rs.randint(1, 17))
        x = rs.normal(size=(ntime, nbatch, args.nfeature)).astype(np.float32)
        out = np.asarray(layer.apply(params, x))
        assert np.all(np.isfinite(out)), 'non-finite output'
        print('  batch {}: in ({}, {}, {}) -> out {}'.format(
            i, ntime, nbatch, args.nfeature, out.shape))
    print('* OK')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
