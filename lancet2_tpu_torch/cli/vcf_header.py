"""VCF header assembly (reference: src/lancet/cli/vcf_header_builder.cpp)."""

from __future__ import annotations

import datetime

from lancet2_tpu_torch import __version__
from lancet2_tpu_torch.hts.fasta import Reference

_INFO_LINES_CASE_CTRL = [
    '##INFO=<ID=SHARED,Number=0,Type=Flag,Description="Variant has ALT support in both case and control samples">',
    '##INFO=<ID=CTRL,Number=0,Type=Flag,Description="Variant has ALT support only in control samples">',
    '##INFO=<ID=CASE,Number=0,Type=Flag,Description="Variant has ALT support only in case samples">',
    '##INFO=<ID=NONE,Number=0,Type=Flag,Description="Variant has no ALT support">',
]

_INFO_LINES = [
    '##INFO=<ID=UNKNOWN,Number=0,Type=Flag,Description="Allele state could not be classified (control-only mode)">',
    '##INFO=<ID=MULTIALLELIC,Number=0,Type=Flag,Description="Site has more than one ALT allele">',
    '##INFO=<ID=TYPE,Number=A,Type=String,Description="Variant type: SNV, INS, DEL, MNP or CPX">',
    '##INFO=<ID=LENGTH,Number=A,Type=Integer,Description="Variant length in base pairs">',
    '##INFO=<ID=GRAPH_CX,Number=3,Type=Float,Description="Graph complexity: GraphEntanglementIndex,TipToPathCovRatio,MaxSingleDirDegree">',
    '##INFO=<ID=SEQ_CX,Number=11,Type=Float,Description="Sequence complexity: ContextHRun,ContextEntropy,ContextFlankLQ,ContextHaplotypeLQ,DeltaHRun,DeltaEntropy,DeltaFlankLQ,TrAffinity,TrPurity,TrPeriod,IsStutterIndel">',
]

_FORMAT_LINES = [
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype derived from minimum PL">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
    '##FORMAT=<ID=ADF,Number=R,Type=Integer,Description="Forward strand allele depths">',
    '##FORMAT=<ID=ADR,Number=R,Type=Integer,Description="Reverse strand allele depths">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Total read depth">',
    '##FORMAT=<ID=RMQ,Number=R,Type=Float,Description="RMS mapping quality per allele">',
    '##FORMAT=<ID=NPBQ,Number=R,Type=Float,Description="Normalized posterior base quality per allele">',
    '##FORMAT=<ID=SB,Number=1,Type=Float,Description="Strand bias log odds ratio (Haldane corrected)">',
    '##FORMAT=<ID=SCA,Number=1,Type=Float,Description="Soft clip asymmetry (ALT - REF soft-clip fraction)">',
    '##FORMAT=<ID=FLD,Number=1,Type=Float,Description="Fragment length delta (mean ALT isize - mean REF isize)">',
    '##FORMAT=<ID=RPCD,Number=1,Type=Float,Description="Read position Cohen D (folded position effect size)">',
    '##FORMAT=<ID=BQCD,Number=1,Type=Float,Description="Base quality Cohen D effect size">',
    '##FORMAT=<ID=MQCD,Number=1,Type=Float,Description="Mapping quality Cohen D effect size">',
    '##FORMAT=<ID=ASMD,Number=1,Type=Float,Description="Allele specific mismatch delta (mean ALT NM - mean REF NM - variant length)">',
    '##FORMAT=<ID=SDFC,Number=1,Type=Float,Description="Site depth fold change vs per-sample window mean coverage">',
    '##FORMAT=<ID=PRAD,Number=1,Type=Float,Description="Polar radius log10(1 + sqrt(AD_ref^2 + AD_alt^2))">',
    '##FORMAT=<ID=PANG,Number=1,Type=Float,Description="Polar angle atan2(AD_alt, AD_ref) in radians">',
    '##FORMAT=<ID=CMLOD,Number=A,Type=Float,Description="Continuous mixture LOD per ALT allele (quality weighted)">',
    '##FORMAT=<ID=FSSE,Number=1,Type=Float,Description="Fragment start Shannon entropy of ALT reads">',
    '##FORMAT=<ID=AHDD,Number=1,Type=Float,Description="ALT haplotype discordance delta">',
    '##FORMAT=<ID=HSE,Number=1,Type=Float,Description="Haplotype segregation entropy of ALT reads">',
    '##FORMAT=<ID=PDCV,Number=1,Type=Float,Description="Path depth coefficient of variation">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods (Dirichlet-Multinomial)">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality (second lowest PL, capped at 99)">',
]


def build_vcf_header(
    ref: Reference, sample_names: list[str], command_line: str, case_ctrl_mode: bool
) -> str:
    lines = ["##fileformat=VCFv4.5"]
    lines.append(f"##fileDate={datetime.date.today().strftime('%Y%m%d')}")
    lines.append(f"##source=lancet2_tpu_v{__version__}")
    lines.append(f"##commandLine=\"{command_line}\"")
    lines.append(f"##reference={ref.path}")
    for info in ref.list_chroms():
        lines.append(f"##contig=<ID={info.name},length={info.length}>")
    if case_ctrl_mode:
        lines.extend(_INFO_LINES_CASE_CTRL)
    lines.extend(_INFO_LINES)
    lines.extend(_FORMAT_LINES)
    cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT"]
    cols.extend(sample_names)
    lines.append("\t".join(cols))
    return "\n".join(lines) + "\n"
