"""``sloika-basecall`` — basecall reads (reference bin/basecall_network.py).

Subcommands ``events`` and ``raw``.  Reads are loaded host-side (thread
pool), length-bucketed, and decoded in device batches; FASTA goes to stdout.
"""
import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from sloika_tpu.cmdargs import (AutoBool, FileExists, Maybe, NonNegative,
                                Positive, proportion, ByteString,
                                display_version_and_exit)
from sloika_tpu import __version__


def make_parser():
    parser = argparse.ArgumentParser(
        description='Basecall reads with a transducer network',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--alphabet', default=b'ACGT', type=ByteString,
                        help='Alphabet of the model')
    common.add_argument('--bad', default=False, action=AutoBool,
                        help='Model has a bad state')
    common.add_argument('--batch', default=8, metavar='reads',
                        type=Positive(int), help='Reads per device batch')
    common.add_argument('--chunked', default=False, action=AutoBool,
                        help='Chunked overlap-stitch decoding (single '
                             'compiled shape, highest throughput; exact '
                             'full-read decode when disabled)')
    common.add_argument('--chunk_size', default=8192, type=Positive(int),
                        help='Window size for chunked decoding (samples)')
    common.add_argument('--device_collapse', default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Collapse calls to bases on device and transfer '
                             'compacted move records (chunked transducer '
                             'mode; "auto" = on for GPU backends)')
    common.add_argument('--dac', default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Ship raw int16 DAC samples and window + '
                             'normalise on device (transfer-lean input '
                             'path; raw reads, chunked device-collapse '
                             'mode; "auto" = on whenever device collapse '
                             'is active)')
    common.add_argument('--devices', default=1, type=Positive(int),
                        help='Shard device batches over this many chips '
                             '(data-parallel mesh)')
    common.add_argument('--overlap', default=400, type=Positive(int),
                        help='Window overlap for chunked decoding (samples)')
    common.add_argument('--kmer_len', default=5, type=Positive(int),
                        help='Kmer length of model')
    common.add_argument('--limit', default=None, type=Maybe(Positive(int)),
                        help='Limit number of reads processed')
    common.add_argument('--min_prob', default=1e-5, type=proportion,
                        help='Minimum posterior probability')
    common.add_argument('--skip', default=5.0, type=NonNegative(float),
                        help='Skip penalty for transducer decoding')
    common.add_argument('--strand_list', default=None, action=FileExists,
                        help='File containing reads to process')
    common.add_argument('--transducer', default=True, action=AutoBool,
                        help='Model is a transducer')
    common.add_argument('--trans', nargs=3, default=None, type=float,
                        metavar=('stay', 'step', 'skip'),
                        help='Base transition probabilities (non-transducer)')
    common.add_argument('--jobs', default=4, type=Positive(int),
                        help='Host threads for read loading')
    common.add_argument('--output', default=None,
                        help='Output FASTA file (default stdout)')
    common.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    common.add_argument('model', action=FileExists,
                        help='Checkpoint (.npz), model JSON, or reference '
                             'pickle (.pkl)')
    common.add_argument('input_folder', action=FileExists,
                        help='Directory containing fast5 files')

    sub = parser.add_subparsers(dest='command', required=True)
    pe = sub.add_parser('events', parents=[common],
                        help='Basecall from events',
                        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    pe.add_argument('--section', default='template',
                    choices=['template', 'complement'])
    pe.add_argument('--segmentation', default='Segmentation',
                    help='Segmentation analysis name')
    pe.add_argument('--trim', default=(50, 10), nargs=2, type=NonNegative(int),
                    metavar=('beginning', 'end'), help='Events to trim')
    pr = sub.add_parser('raw', parents=[common],
                        help='Basecall from raw signal',
                        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    pr.add_argument('--open_pore_fraction', default=0.3, type=proportion,
                    help='Max fraction of signal to trim as open pore')
    pr.add_argument('--trim', default=(200, 50), nargs=2,
                    type=NonNegative(int), metavar=('beginning', 'end'),
                    help='Samples to trim')
    return parser


def load_model(path):
    """Load (layer, params) from a checkpoint, JSON dump or Theano pickle."""
    from sloika_tpu import serialize
    if path.endswith('.npz'):
        layer, params, _ = serialize.load_checkpoint(path)
        return layer, params
    if path.endswith('.json'):
        layer, params = serialize.load_model_json(path)
        assert params is not None, 'model JSON has no parameters'
        return layer, params
    from sloika_tpu.compat import theano_pickle
    return theano_pickle.load_model(path)


def main(argv=None):
    args = make_parser().parse_args(argv)

    from sloika_tpu import backend, basecall as bc
    backend.init_compile_cache()
    from sloika_tpu.data.fast5 import iterate_fast5
    from sloika_tpu.parallel import mesh as meshlib

    # multi-host: under a coordinator (JAX_COORDINATOR_ADDRESS) each process
    # basecalls a strided share of the reads on its local devices and rank 0
    # writes the merged FASTA (the reference's pool-per-host scaled across
    # hosts, bin/basecall_network.py:100-101)
    meshlib.maybe_init_distributed()

    import jax

    layer, params = load_model(args.model)
    if args.device_collapse == 'auto':
        device_collapse = (backend.platform() == 'gpu' and args.chunked
                           and args.transducer and len(args.alphabet) == 4)
    else:
        device_collapse = args.device_collapse == 'on'
    output = 'bases' if device_collapse else 'states'
    mesh = None
    if args.devices > 1:
        from sloika_tpu.parallel import mesh as meshlib
        mesh = meshlib.make_mesh(args.devices)
    caller = bc.Basecaller(layer, params, args.kmer_len,
                           transducer=args.transducer, bad=args.bad,
                           min_prob=args.min_prob, skip=args.skip,
                           trans=args.trans, alphabet=args.alphabet,
                           batch_size=args.batch, chunked=args.chunked,
                           chunk_size=args.chunk_size, overlap=args.overlap,
                           output=output, mesh=mesh)
    # the Basecaller downgrades chunked/bases modes for models that cannot
    # run the padded batch path (Studentise -> exact per-read); follow its
    # decision so the writer and the dac auto-selection below stay
    # consistent with what basecall_signals actually returns
    output = caller.output
    multihost = jax.process_count() > 1
    capture = None
    if multihost:
        import io
        capture = io.StringIO()
    printer = bc.SeqPrinter(
        args.kmer_len,
        datatype='samples' if args.command == 'raw' else 'events',
        transducer=args.transducer,
        fname=None if multihost else args.output,
        alphabet=args.alphabet, fh=capture)

    files = list(iterate_fast5(args.input_folder, paths=True,
                               limit=args.limit,
                               strand_list=args.strand_list))
    file_indices = list(range(len(files)))
    if multihost:
        from sloika_tpu.parallel import multihost as mh
        sharded = mh.process_shard(files, with_indices=True)
        file_indices = [i for i, _ in sharded]
        files = [f for _, f in sharded]

    if args.dac == 'auto':
        dac = (args.command == 'raw' and output == 'bases')
    else:
        dac = args.dac == 'on'
        assert not dac or (args.command == 'raw' and output == 'bases'), \
            '--dac on requires raw reads and device collapse'

    if args.command == 'raw':
        if dac:
            loader = lambda fn: bc.load_raw_dac(
                fn, trim=tuple(args.trim),
                open_pore_fraction=args.open_pore_fraction)
        else:
            loader = lambda fn: bc.load_raw_signal(
                fn, trim=tuple(args.trim),
                open_pore_fraction=args.open_pore_fraction)
    else:
        loader = lambda fn: bc.load_event_features(
            fn, section=args.section, segmentation=args.segmentation,
            trim=tuple(args.trim))

    t0 = time.time()
    nbases = nevents = nreads = 0
    records = []                    # multihost: (original index, FASTA text)
    # stream in bounded blocks: host memory stays O(block), and the next
    # block's loader futures are submitted BEFORE the current block's device
    # decode, so host I/O genuinely overlaps device work (the pool drains
    # block N+1 while the device chews block N)
    block = max(8 * args.batch, 512)
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        pending = [pool.submit(loader, fn) for fn in files[:block]]
        for lo in range(0, len(files), block):
            current, pending = pending, [
                pool.submit(loader, fn)
                for fn in files[lo + block:lo + 2 * block]]
            loaded = [(i, r) for i, r in zip(file_indices[lo:lo + block],
                                             (f.result() for f in current))
                      if r is not None]
            if not loaded:
                continue
            idxs = [i for i, _ in loaded]
            names = [r[0] for _, r in loaded]
            signals = [r[1] for _, r in loaded]
            if dac:
                results = caller.basecall_dac_reads(
                    [(r[1], r[2]) for _, r in loaded])
            else:
                results = caller.basecall_signals(signals)
            for idx, name, sig, res in zip(idxs, names, signals, results):
                if res is None:
                    continue
                score, call = res
                if output == 'bases':
                    seq_len = printer.write_codes(name, score, call,
                                                  len(sig))
                else:
                    seq_len = printer.write(name, score, call, len(sig))
                if multihost:
                    records.append((idx, capture.getvalue()))
                    capture.seek(0)
                    capture.truncate(0)
                nbases += seq_len
                nevents += len(sig)
                nreads += 1
    dt = time.time() - t0
    printer.close()

    if multihost:
        # counters to every rank (tiny allgather, for the per-rank report);
        # bulk FASTA records to rank 0 only, which writes the merged file
        # in original read order (byte-identical to single-process)
        import json as _json
        from sloika_tpu.parallel import multihost as mh
        stats = mh.allgather_records([[nreads, nbases, nevents]])
        nreads = sum(s[0] for s in stats)
        nbases = sum(s[1] for s in stats)
        nevents = sum(s[2] for s in stats)
        payloads = mh.gather_bytes_to_rank0(
            _json.dumps(records).encode())
        if jax.process_index() == 0:
            allrec = sorted((tuple(r) for p in payloads
                             for r in _json.loads(p.decode())),
                            key=lambda r: r[0])
            out_fh = open(args.output, 'w') if args.output else sys.stdout
            for _, text in allrec:
                out_fh.write(text)
            if args.output:
                out_fh.close()

    sys.stderr.write(
        'Called {} reads in {:.2f}s ({:.1f} bases/s, {:.1f} {}/s)\n'.format(
            nreads, dt, nbases / dt, nevents / dt,
            'samples' if args.command == 'raw' else 'events'))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
