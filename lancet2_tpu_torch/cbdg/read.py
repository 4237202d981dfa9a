"""Assembly read model: deep-copied read with sample/role metadata + filters.

Reference: src/lancet/cbdg/read.h — MAPQ>=20 gates graph participation
(PassesAlnFilters); soft-clip fraction >= 6% of read length flags the read
for the SCA feature (computed from the original whole-genome alignment CIGAR).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from lancet2_tpu_torch.base.dna import encode
from lancet2_tpu_torch.base.hashing import hash_str64
from lancet2_tpu_torch.hts.bam import BamRecord
from lancet2_tpu_torch.hts.cigar import S as CIGAR_S

# Role tags (bitmask values mirror reference cbdg::Label).
LABEL_REFERENCE = 1
LABEL_CTRL = 2
LABEL_CASE = 4

MIN_READ_MAPQ = 20
SOFT_CLIP_FRAC_THRESHOLD = 0.06


@dataclass(slots=True)
class Read:
    qname: str
    seq: str
    qual: np.ndarray  # uint8
    sample_name: str
    sample_index: int
    tag: int  # LABEL_CTRL or LABEL_CASE
    chrom_index: int
    start0: int
    mapq: int
    sam_flag: int
    insert_size: int
    is_soft_clipped: bool
    passes_aln_filters: bool
    codes: np.ndarray = field(default=None, repr=False)  # lazy uint8 encoding
    qname_hash: int = field(default=0)

    @classmethod
    def from_bam(cls, rec: BamRecord, sample_name: str, tag: int, sample_index: int) -> "Read":
        total_clip = sum(l for op, l in rec.cigar if op == CIGAR_S)
        clip_frac = total_clip / rec.length if rec.length > 0 else 0.0
        return cls(
            # bytes, matching reads_from_columnar: sort_key must never
            # compare str against bytes when readers mix access modes
            qname=rec.qname.encode("ascii", "replace"),
            seq=rec.seq,
            qual=np.asarray(rec.qual, dtype=np.uint8),
            sample_name=sample_name,
            sample_index=sample_index,
            tag=tag,
            chrom_index=rec.ref_id,
            start0=rec.pos0,
            mapq=rec.mapq,
            sam_flag=rec.flag,
            insert_size=rec.tlen,
            is_soft_clipped=clip_frac >= SOFT_CLIP_FRAC_THRESHOLD,
            passes_aln_filters=rec.mapq >= MIN_READ_MAPQ,
            codes=encode(rec.seq),
            qname_hash=hash_str64(rec.qname),
        )

    @property
    def length(self) -> int:
        return len(self.codes) if self.seq is None else len(self.seq)

    @property
    def is_reverse(self) -> bool:
        return bool(self.sam_flag & 0x10)

    @property
    def is_proper_pair(self) -> bool:
        return bool(self.sam_flag & 0x2)


def reads_from_columnar(reader, idxs: np.ndarray, qhashes: np.ndarray,
                        sample_name: str, tag: int, sample_index: int) -> list[Read]:
    """Batch Read construction straight from a columnar BamReader: codes and
    quals are zero-copy pool views (consumers are read-only), soft-clip
    totals come from the cached cigar cumsum, and the seq string is skipped
    entirely (nothing downstream reads it). Field-for-field equal to
    from_bam(_record_at(i)) except `seq` (None here) — parity-tested."""
    cols = reader._cols
    codes_pool = reader.codes_pool()
    sc_csum = reader.softclip_csum()
    qual_pool = cols["qual_pool"]
    qname_pool = cols["qname_pool"]

    pos = cols["pos"][idxs]
    mapqs = cols["mapq"][idxs]
    flags = cols["flag"][idxs]
    tlens = cols["tlen"][idxs]
    ref_ids = cols["ref_id"][idxs]
    l_seq = cols["l_seq"][idxs].astype(np.int64)
    so = cols["seq_off"][idxs]
    qo = cols["qname_off"][idxs]
    ql = cols["qname_len"][idxs].astype(np.int64)
    co = cols["cigar_off"][idxs]
    ce = co + cols["n_cigar"][idxs]
    sc_total = sc_csum[ce] - sc_csum[co]
    with np.errstate(divide="ignore", invalid="ignore"):
        clip_frac = np.where(l_seq > 0, sc_total / np.maximum(l_seq, 1), 0.0)
    is_clipped = clip_frac >= SOFT_CLIP_FRAC_THRESHOLD
    passes = mapqs >= MIN_READ_MAPQ

    # .tolist() converts every scalar in C; qnames stay BYTES (the only
    # consumer is the deterministic 6-key sort, and bytes order == ascii
    # str order == the reference's std::string compare)
    rows = zip(so.tolist(), qo.tolist(), ql.tolist(), l_seq.tolist(),
               ref_ids.tolist(), pos.tolist(), mapqs.tolist(),
               flags.tolist(), tlens.tolist(), is_clipped.tolist(),
               passes.tolist(), qhashes.tolist())
    return [
        Read(
            qname=qname_pool[q : q + qn].tobytes(),
            seq=None,
            qual=qual_pool[s : s + l],
            sample_name=sample_name,
            sample_index=sample_index,
            tag=tag,
            chrom_index=rid,
            start0=p,
            mapq=mq,
            sam_flag=fl,
            insert_size=tl,
            is_soft_clipped=clip,
            passes_aln_filters=ok,
            codes=codes_pool[s : s + l],
            qname_hash=qh,
        )
        for s, q, qn, l, rid, p, mq, fl, tl, clip, ok, qh in rows
    ]


def sort_key(read: Read):
    """Deterministic 6-key read ordering (reference: core/read_collector.cpp:42-53)."""
    return (
        0 if read.passes_aln_filters else 1,
        read.tag,
        read.sample_name,
        read.qname,
        read.chrom_index,
        read.start0,
    )
