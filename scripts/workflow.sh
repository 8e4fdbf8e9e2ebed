#!/usr/bin/env bash
# Canonical end-to-end workflow (the reference's scripts/workflow.sh:
# chunkify -> train -> validate -> basecall -> evaluate -> remap) on seeded
# simulated reads.  Runs on the CPU by default; DEVICE=gpu uses the card.
#
#     bash scripts/workflow.sh            # READS=<dir of fast5> to use your own
set -euo pipefail

ROOT="$(cd "$(dirname "$0")/.." && pwd)"
WORKDIR=${WORKDIR:-$(mktemp -d "${TMPDIR:-/tmp}/sloika_workflow.XXXX")}
DEVICE=${DEVICE:-cpu}
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
if [ "$DEVICE" = "cpu" ]; then
    export JAX_PLATFORMS=cpu
fi

echo "* Working directory: $WORKDIR"
if [ -z "${READS:-}" ]; then
    READS="$WORKDIR/reads"
    echo "* 0. Simulate 8 reads"
    python -c "from sloika_tpu.data import simulate; \
simulate.simulate_read_set('$READS', 8, genome_len=100000, read_len=3000)"
fi

echo "* 1. Chunk the reads against their in-file mappings"
python -m sloika_tpu.cli.chunkify raw_identity "$READS" "$WORKDIR/chunks.hdf5" \
    --chunk_len 500 --kmer_len 5 --downsample_factor 5 --overwrite

echo "* 2. Train for a few iterations"
python -m sloika_tpu.cli.train raw raw_0.98_rgrgr "$WORKDIR/training" \
    "$WORKDIR/chunks.hdf5" --niteration 3 --batch_size 8 --drop 5 \
    --quiet --overwrite
MODEL="$WORKDIR/training/model_final.npz"

echo "* 3. Validate"
python -m sloika_tpu.cli.validate "$MODEL" "$WORKDIR/chunks.hdf5" --batch_size 8

echo "* 4. Basecall the reads"
python -m sloika_tpu.cli.basecall raw "$MODEL" "$READS" --batch 4 \
    --output "$WORKDIR/calls.fa"

echo "* 5. Extract per-read references and evaluate the calls"
python -m sloika_tpu.cli.extract_reference "$READS" --output "$WORKDIR/refs.fa"
python -m sloika_tpu.cli.align --reference "$WORKDIR/refs.fa" "$WORKDIR/calls.fa"

echo "* 6. Remap the reads against their references"
python -m sloika_tpu.cli.chunkify raw_remap "$READS" "$WORKDIR/remapped.hdf5" \
    "$MODEL" "$WORKDIR/refs.fa" --chunk_len 500 --kmer_len 5 \
    --downsample_factor 5 --overwrite \
    --output_strand_list "$WORKDIR/strands_remap.txt"

test -f "$WORKDIR/remapped.hdf5"
echo "* Workflow complete: $WORKDIR"
