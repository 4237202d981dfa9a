"""Deterministic per-window read collection with coverage-capped downsampling.

Reference: src/lancet/core/read_collector.{h,cpp}. Three passes per sample:
  1. profile passing reads (QC-fail/dup/unmapped/MAPQ<20 filtered), convert
     the base budget (max_sample_cov * window_len) into a read budget via the
     observed mean read length, shuffle qname hashes with a FIXED seed and
     keep the first N — both mates of a pair are symmetrically kept/dropped
  2. deep-copy kept reads
  3. (optional) recapture out-of-region mates of kept discordant/SA reads in
     ascending genomic order

Final reads are sorted with the deterministic 6-key comparator so identical
inputs always produce identical assemblies.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from lancet2_tpu_torch.cbdg.read import Read, sort_key
from lancet2_tpu_torch.core.sample_info import SampleInfo
from lancet2_tpu_torch.hts.bam import BamReader, open_bam
from lancet2_tpu_torch.hts.fasta import Region

DEFAULT_MAX_WINDOW_COVERAGE = 1000.0


@dataclass
class CollectorParams:
    max_sample_cov: float = DEFAULT_MAX_WINDOW_COVERAGE
    extract_pairs: bool = False
    # index-backed streaming readers (BAI) instead of whole-file decode —
    # bounded memory on multi-GB inputs (reference streams via htslib BAI)
    stream_bam: bool = False
    # reference FASTA path: required to decode reference-based CRAM inputs
    ref_path: str | None = None
    # samtools filter expression applied before the profile filters
    # (reference: hts_filter on the extractor, extractor.cpp:57-63)
    filter_expr: str | None = None


def _passes_profile_filters(rec) -> bool:
    return not (rec.is_qcfail or rec.is_duplicate or rec.is_unmapped or rec.mapq < 20)


class ReadCollector:
    def __init__(self, params: CollectorParams, samples: list[SampleInfo],
                 reader_pool: dict | None = None):
        self.params = params
        self.samples = samples
        # reader_pool: share decoded BAM/CRAM readers across collectors
        # (e.g. the batch executor's prep workers) — whole-file decode and
        # the active-region event index then happen once per file, not once
        # per worker. Missing entries are opened and published to the pool.
        self.readers: dict[str, BamReader] = {}
        for s in samples:
            if reader_pool is not None and s.path in reader_pool:
                self.readers[s.path] = reader_pool[s.path]
                continue
            reader = open_bam(s.path, stream=params.stream_bam, ref=params.ref_path)
            self.readers[s.path] = reader
            if reader_pool is not None:
                # eager index build before publication: shared readers must
                # be fully initialized before prep threads fetch from them
                if getattr(reader, "_by_contig", False) is None:
                    reader._build_index()
                reader_pool[s.path] = reader
        self.read_filter = None
        if params.filter_expr:
            from lancet2_tpu_torch.hts.filter_expr import compile_filter

            self.read_filter = compile_filter(params.filter_expr)

    @property
    def is_case_ctrl_mode(self) -> bool:
        from lancet2_tpu_torch.cbdg.read import LABEL_CASE, LABEL_CTRL

        tags = {s.tag for s in self.samples}
        return LABEL_CASE in tags and LABEL_CTRL in tags

    def collect(self, chrom: str, start1: int, end1: int) -> list[Read]:
        window_len = end1 - start1 + 1
        max_sample_bases = self.params.max_sample_cov * window_len
        out: list[Read] = []
        for sinfo in self.samples:
            reader = self.readers[sinfo.path]

            # columnar fast path: filters, qname hashes, downsampling, and
            # Read construction run vectorized over the record pools — no
            # BamRecord materialization (result-identical to the record
            # path below, parity-tested). The filter-expression path needs
            # materialized records, so it keeps the record path.
            if (getattr(reader, "_cols", None) is not None
                    and self.read_filter is None):
                fast = self._collect_columnar(
                    reader, sinfo, chrom, start1, end1, max_sample_bases)
                if fast is not None:
                    reads_s, sampled_bases, kept_idx = fast
                    out.extend(reads_s)
                    if self.params.extract_pairs:
                        sampled_bases += self._recapture_mates_columnar(
                            reader, sinfo, kept_idx, start1, end1, out)
                    sinfo.num_sampled_bases = sampled_bases
                    continue

            records = [r for r in reader.fetch(chrom, start1, end1) if _passes_profile_filters(r)]
            if self.read_filter is not None:
                records = [r for r in records if self.read_filter(r)]

            # Pass 1: profile + deterministic downsample
            from lancet2_tpu_torch.base.hashing import hash_str64

            num_pass = len(records)
            num_bases = sum(r.length for r in records)
            qhashes = np.array([hash_str64(r.qname) for r in records], dtype=np.uint64)
            bases_per_read = num_bases / max(num_pass, 1)
            max_reads = int(np.ceil(max_sample_bases / max(bases_per_read, 1e-9)))
            sampled_count = min(num_pass, max_reads)

            if sampled_count < num_pass:
                # fixed-seed shuffle of the per-read qname-hash list; the keep
                # set is the first `sampled_count` entries — both mates of a
                # pair are symmetrically kept or dropped (hash-level decision)
                order = np.random.default_rng(0).permutation(num_pass)
                keep = set(int(q) for q in qhashes[order][:sampled_count])
                records = [r for r, qh in zip(records, qhashes) if int(qh) in keep]
            sinfo.num_sampled_reads = sampled_count

            # Pass 2: deep copy kept reads
            sampled_bases = 0
            for rec in records:
                read = Read.from_bam(rec, sinfo.sample_name, sinfo.tag, sinfo.sample_index)
                sampled_bases += read.length
                out.append(read)

            # Pass 3: ordered mate recapture (discordant or SA-tagged pairs).
            # Mirrors the reference's RecaptureMates (read_collector.cpp:
            # 237-271): pending mates are visited in ASCENDING genomic order
            # (sequential BAM access), each mate-region scan opportunistically
            # captures EVERY still-pending mate it encounters (first record
            # per qname wins), and already-captured entries skip their scan.
            if self.params.extract_pairs:
                pending: dict[str, tuple[int, int]] = {}
                for rec in records:
                    if not rec.is_mate_mapped or rec.next_ref_id < 0:
                        continue
                    if rec.is_proper_pair and "SA" not in rec.tags:
                        continue
                    if rec.next_ref_id == rec.ref_id and (
                        start1 - 1 <= rec.next_pos0 < end1
                    ):
                        continue  # mate already inside the scanned window
                    pending[rec.qname] = (rec.next_ref_id, rec.next_pos0)
                for qname, (rid, pos0) in sorted(
                    pending.items(), key=lambda kv: (kv[1], kv[0])
                ):
                    if qname not in pending:
                        continue  # captured by an earlier overlapping scan
                    mate_chrom = reader.ref_name(rid)
                    for rec in reader.fetch(mate_chrom, pos0 + 1, pos0 + 1):
                        hit = pending.pop(rec.qname, None)
                        if hit is None:
                            continue
                        read = Read.from_bam(rec, sinfo.sample_name, sinfo.tag,
                                             sinfo.sample_index)
                        sampled_bases += read.length
                        out.append(read)

            sinfo.num_sampled_bases = sampled_bases

        out.sort(key=sort_key)
        return out

    def _collect_columnar(self, reader, sinfo, chrom, start1, end1,
                          max_sample_bases):
        """Vectorized passes 1+2 over the columnar pools. Returns
        (reads, sampled_bases, kept_idx) or None when native hashing is
        unavailable (caller falls back to the record path)."""
        from lancet2_tpu_torch.cbdg.read import reads_from_columnar
        from lancet2_tpu_torch.hts import native

        cols = reader._cols
        idxs = reader.fetch_handles(chrom, start1, end1)
        flags = cols["flag"][idxs]
        mapqs = cols["mapq"][idxs]
        # not qcfail(0x200)/dup(0x400)/unmapped(0x4), MAPQ >= 20
        keep = ((flags & (0x200 | 0x400 | 0x4)) == 0) & (mapqs >= 20)
        idxs = idxs[keep]

        num_pass = len(idxs)
        lens = cols["l_seq"][idxs].astype(np.int64)
        num_bases = int(lens.sum())
        qhashes = native.hash_batch(
            cols["qname_pool"], cols["qname_off"][idxs],
            cols["qname_len"][idxs],
        )
        if qhashes is None:
            return None
        bases_per_read = num_bases / max(num_pass, 1)
        max_reads = int(np.ceil(max_sample_bases / max(bases_per_read, 1e-9)))
        sampled_count = min(num_pass, max_reads)
        if sampled_count < num_pass:
            order = np.random.default_rng(0).permutation(num_pass)
            keepset = set(int(q) for q in qhashes[order][:sampled_count])
            m = np.fromiter(
                (int(q) in keepset for q in qhashes), bool, count=num_pass
            )
            idxs = idxs[m]
            qhashes = qhashes[m]
        sinfo.num_sampled_reads = sampled_count

        reads = reads_from_columnar(
            reader, idxs, qhashes, sinfo.sample_name, sinfo.tag,
            sinfo.sample_index,
        )
        sampled_bases = int(cols["l_seq"][idxs].sum())
        return reads, sampled_bases, idxs

    def _recapture_mates_columnar(self, reader, sinfo, kept_idx, start1, end1,
                                  out) -> int:
        """Pass 3 for the columnar path: the pending-mate candidate set is
        prefiltered vectorized (mate mapped, outside the scanned window);
        only those few records materialize for the proper-pair/SA check.
        Same visit order and capture semantics as the record path."""
        cols = reader._cols
        flags = cols["flag"][kept_idx]
        next_rid = cols["next_ref_id"][kept_idx]
        next_pos = cols["next_pos"][kept_idx]
        rid = cols["ref_id"][kept_idx]
        mate_mapped = (flags & 0x8) == 0
        inside = (next_rid == rid) & (next_pos >= start1 - 1) & (next_pos < end1)
        cand = np.flatnonzero(mate_mapped & (next_rid >= 0) & ~inside)

        pending: dict[str, tuple[int, int]] = {}
        for j in cand:
            rec = reader._record_at(int(kept_idx[j]))
            if rec.is_proper_pair and "SA" not in rec.tags:
                continue
            pending[rec.qname] = (rec.next_ref_id, rec.next_pos0)

        sampled_bases = 0
        for qname, (mrid, pos0) in sorted(
            pending.items(), key=lambda kv: (kv[1], kv[0])
        ):
            if qname not in pending:
                continue
            mate_chrom = reader.ref_name(mrid)
            for rec in reader.fetch(mate_chrom, pos0 + 1, pos0 + 1):
                hit = pending.pop(rec.qname, None)
                if hit is None:
                    continue
                read = Read.from_bam(rec, sinfo.sample_name, sinfo.tag,
                                     sinfo.sample_index)
                sampled_bases += read.length
                out.append(read)
        return sampled_bases
