"""Sample metadata and deterministic sample-index assignment.

Reference: src/lancet/core/sample_info.h, input_spec_parser.cpp,
sample_header_reader.cpp — samples are sorted by (role, SM tag) to produce
deterministic 0-based indices; per-sample sampled read/base counters feed
the SDFC feature and coverage gates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lancet2_tpu_torch.cbdg.read import LABEL_CASE, LABEL_CTRL
from lancet2_tpu_torch.hts.bam import parse_sample_name, read_bam_header


@dataclass
class SampleInfo:
    path: str
    sample_name: str
    tag: int  # LABEL_CTRL or LABEL_CASE
    sample_index: int = -1
    num_sampled_reads: int = 0
    num_sampled_bases: int = 0

    def mean_sampled_cov(self, region_len: int) -> float:
        return self.num_sampled_bases / region_len if region_len > 0 else 0.0


def parse_sample_spec(spec: str) -> tuple[str, int]:
    """'<path>:<role>' with role in {case,tumor,control,normal}; default control."""
    if ":" in spec:
        path, _, role = spec.rpartition(":")
        role_l = role.strip().lower()
        if role_l in ("case", "tumor"):
            return path, LABEL_CASE
        if role_l in ("control", "normal", "ctrl"):
            return path, LABEL_CTRL
    return spec, LABEL_CTRL


def make_sample_list(
    normal_paths: list[str], tumor_paths: list[str], sample_specs: list[str]
) -> list[SampleInfo]:
    """Read SM tags, sort by (role, SM), assign deterministic indices."""
    infos: list[SampleInfo] = []
    entries = [(p, LABEL_CTRL) for p in normal_paths]
    entries += [(p, LABEL_CASE) for p in tumor_paths]
    entries += [parse_sample_spec(s) for s in sample_specs]
    for path, tag in entries:
        # header-only read: inflates just the leading BGZF blocks
        header_text, _refs = read_bam_header(path)
        name = parse_sample_name(header_text) or path
        infos.append(SampleInfo(path=path, sample_name=name, tag=tag))
    infos.sort(key=lambda s: (s.tag, s.sample_name))
    for idx, info in enumerate(infos):
        info.sample_index = idx
    return infos


def cross_sample_mean_coverage(samples: list[SampleInfo], window_length: int) -> float:
    """Total sampled coverage across samples over the window."""
    if not samples or window_length <= 0:
        return 0.0
    total = sum(s.num_sampled_bases for s in samples)
    return total / window_length
