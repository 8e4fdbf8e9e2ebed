"""Minimal h5py-based reader for single-read fast5 files.

The reference leans on the external ``fast5_research`` package
(/root/reference/requirements.txt:5); this module reimplements the API
surface sloika actually uses (get_read/get_section_events/
get_any_mapping_data/get_reference_fasta/filename_short/sample_rate/
iterate_fast5 — e.g. basecall.py:70-72,104-105, chunkify_raw.py:228-232,
extract_reference.py:35-38) directly against the observed file layout:

    Raw/Reads/Read_<n>/Signal                              int16 raw signal
    Analyses/Basecall_1D_<xxx>/BaseCalled_<sec>/Events     basecall events
    Analyses/AlignToRef_<xxx>/CurrentSpaceMapped_<sec>/Events   mapping table
    Analyses/AlignToRef_<xxx>/Summary/current_space_map_<sec>   direction etc.
    Analyses/Alignment_<xxx>/Aligned_<sec>/Fasta           per-read reference
    UniqueGlobalKey/channel_id                             scaling attrs
"""
import glob
import os
import re

import numpy as np


class Fast5(object):
    """Context-manager reader for one fast5 file."""

    def __init__(self, filename, mode="r"):
        import h5py
        self.filename = filename
        self._h5 = h5py.File(filename, mode)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._h5.close()

    # -- identity / metadata ---------------------------------------------

    @property
    def filename_short(self):
        return os.path.splitext(os.path.basename(self.filename))[0]

    @property
    def sample_rate(self):
        return float(self._h5["UniqueGlobalKey/channel_id"].attrs["sampling_rate"])

    @property
    def channel_meta(self):
        return dict(self._h5["UniqueGlobalKey/channel_id"].attrs)

    # -- raw signal ------------------------------------------------------

    def _raw_group(self):
        reads = self._h5["Raw/Reads"]
        name = sorted(reads.keys())[0]
        return reads[name]

    def get_read(self, raw=True, group=False, scale=True):
        """Raw signal of the read (optionally scaled to pA).

        :param group: return the enclosing h5 group instead of the data
        :param scale: apply channel (offset, range/digitisation) scaling.
            Downstream normalisation (median/MAD) is affine-invariant, so
            scaling does not change basecalls; pA is returned for physical
            interpretability.
        """
        grp = self._raw_group()
        if group:
            return grp
        sig = grp["Signal"][:]
        if scale:
            meta = self.channel_meta
            sig = (sig + meta["offset"]) * meta["range"] / meta["digitisation"]
        return sig.astype(np.float32)

    @property
    def raw_start_sample(self):
        return int(self._raw_group().attrs["start_time"])

    # -- analyses --------------------------------------------------------

    def _latest(self, base, contains=None):
        """Latest Analyses/<base>_NNN group name, or None.

        :param contains: relative path that must exist inside the group —
            an empty newer analysis (e.g. read7's AlignToRef_000) must not
            shadow an older complete one
        """
        if "Analyses" not in self._h5:
            return None
        pat = re.compile(re.escape(base) + r"_(\d+)$")
        best, best_n = None, -1
        for name in self._h5["Analyses"]:
            m = pat.match(name)
            if m is None or int(m.group(1)) <= best_n:
                continue
            path = "Analyses/" + name
            if contains is not None and \
                    "{}/{}".format(path, contains) not in self._h5:
                continue
            best, best_n = path, int(m.group(1))
        return best

    def get_section_events(self, section="template", analysis="Segmentation"):
        """Event table for a read section.

        Searches Basecall_1D (albacore layout) then Basecall_2D; events have
        at least mean/stdv/start/length.
        """
        for base in ("Basecall_1D", "Basecall_2D"):
            grp = self._latest(base)
            if grp is None:
                continue
            path = "{}/BaseCalled_{}/Events".format(grp, section)
            if path in self._h5:
                return self._h5[path][:]
        raise ValueError("No events for section {!r} in {}".format(
            section, self.filename))

    def get_basecall_data(self, section="template"):
        return self.get_section_events(section)

    def get_any_mapping_data(self, section="template", return_attrs=True):
        """Mapping table (events aligned to a reference) and its attributes.

        :returns: (mapping_table, attrs) with attrs keys direction,
            ref_start, ref_stop, reference — the fields the chunkify
            pipeline interpolation consumes (chunkify_raw.py:85-120).
        """
        ev_rel = "CurrentSpaceMapped_{}/Events".format(section)
        grp = self._latest("AlignToRef", contains=ev_rel)
        if grp is None:
            raise ValueError("No mapping data in {}".format(self.filename))
        ev = self._h5["{}/{}".format(grp, ev_rel)][:]
        if ev.dtype.names and 'move' not in ev.dtype.names:
            # AlignToRef tables carry seq_pos but no move column; synthesise
            # it like fast5_research does (consumed at chunkify_raw.py:196)
            import numpy.lib.recfunctions as nprf
            move = np.ediff1d(ev['seq_pos'], to_begin=1)
            if len(move) > 1 and np.all(move[1:] <= 0):
                # a decreasing seq_pos layout (genomic '-'-strand table)
                # would silently label every chunk blank downstream
                raise ValueError(
                    "mapping table seq_pos is non-increasing in {} — "
                    "unsupported coordinate layout".format(self.filename))
            ev = nprf.append_fields(ev, 'move', move, usemask=False)
        reference = self.get_reference_fasta(section=section)
        summ = "{}/Summary/current_space_map_{}".format(grp, section)
        a = dict(self._h5[summ].attrs) if summ in self._h5 else {}
        # seq_pos in these tables is READ-LOCAL (it indexes the per-read
        # Aligned fasta), so ref_start/ref_stop are local coordinates too;
        # the file's genome_start/genome_end are genomic and must NOT feed
        # interpolate_pos (read7: seq_pos 8..167 vs genome_start 4031059)
        attrs = {
            "direction": _to_str(a.get("direction", "+")),
            "ref_start": 0,
            "ref_stop": len(reference),
            "genome_start": int(a.get("genome_start", 0)),
            "genome_end": int(a.get("genome_end", 0)),
            "reference": reference,
        }
        if return_attrs:
            return ev, attrs
        return ev

    def get_reference_fasta(self, section="template"):
        """Per-read reference sequence (bytes) from the Alignment analysis."""
        rel = "Aligned_{}/Fasta".format(section)
        grp = self._latest("Alignment", contains=rel)
        if grp is not None:
            fasta = _to_str(self._h5["{}/{}".format(grp, rel)][()])
            seq = "".join(l.strip() for l in fasta.split("\n")[1:])
            return seq.encode("utf-8")
        raise ValueError("No reference fasta in {}".format(self.filename))

    def has_mapping_data(self, section="template"):
        grp = self._latest("AlignToRef")
        return (grp is not None and
                "{}/CurrentSpaceMapped_{}/Events".format(grp, section) in self._h5)

    def has_raw(self):
        return "Raw/Reads" in self._h5 and len(self._h5["Raw/Reads"]) > 0


def _to_str(x):
    return x.decode("utf-8") if isinstance(x, bytes) else str(x)


def iterate_fast5(path, strand_list=None, paths=True, limit=None):
    """Iterate fast5 filenames under a directory.

    :param strand_list: optional TSV file with a 'filename' column restricting
        the set (reference strand-list convention, fileio.py:112-127)
    :param limit: yield at most this many
    """
    if os.path.isfile(path):
        files = [path]
    else:
        files = sorted(glob.glob(os.path.join(path, "*.fast5")))
    if strand_list is not None:
        from sloika_tpu.data import fileio
        tsv = fileio.readtsv(strand_list)
        col = "filename" if "filename" in tsv.dtype.names else tsv.dtype.names[0]
        wanted = {os.path.basename(_to_str(f)) for f in tsv[col]}
        files = [f for f in files if os.path.basename(f) in wanted]
    if limit is not None:
        files = files[:limit]
    for f in files:
        yield f if paths else os.path.basename(f)
