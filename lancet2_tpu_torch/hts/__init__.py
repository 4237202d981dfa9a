from lancet2_tpu_torch.hts.fasta import Reference, Region, parse_region_spec, write_fasta
from lancet2_tpu_torch.hts.bam import BamReader, BamWriter, BamRecord
from lancet2_tpu_torch.hts.bgzf import BgzfWriter

__all__ = [
    "Reference",
    "Region",
    "parse_region_spec",
    "write_fasta",
    "BamReader",
    "BamWriter",
    "BamRecord",
    "BgzfWriter",
]
