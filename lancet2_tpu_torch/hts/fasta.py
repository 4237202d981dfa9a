"""Indexed FASTA access and genomic region model.

Mirrors the reference's `hts::Reference` / `Reference::Region`
(reference: src/lancet/hts/reference.{h,cpp}): chromosome listing in FASTA
order, 1-based inclusive regions with lazily loaded sequence, and samtools
region-spec parsing including the `{chrom}:start-end` brace syntax for
contig names that contain ':'.

Reads/writes standard `.fai` indexes so fixtures interoperate with samtools.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

from lancet2_tpu_torch.hts.uri import hts_open


@dataclass(frozen=True)
class ChromInfo:
    name: str
    length: int
    offset: int  # byte offset of first base in FASTA
    line_bases: int
    line_width: int  # line_bases + newline byte(s)
    index: int  # 0-based position in FASTA order


class Reference:
    """Random access over an indexed FASTA file."""

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            write_fai(path)
        self._chroms: list[ChromInfo] = []
        self._by_name: dict[str, ChromInfo] = {}
        with hts_open(fai, "r") as fh:
            for idx, line in enumerate(fh):
                name, length, offset, line_bases, line_width = line.rstrip("\n").split("\t")[:5]
                info = ChromInfo(name, int(length), int(offset), int(line_bases), int(line_width), idx)
                self._chroms.append(info)
                self._by_name[name] = info
        self._fh = hts_open(path, "rb")
        self._fh_pid = os.getpid()
        self._lock = threading.Lock()

    def _file(self):
        """Fork-safe handle: a forked child shares the parent's seek offset
        (same OS open-file description), so each process reopens its own."""
        if os.getpid() != self._fh_pid:
            self._fh = hts_open(self.path, "rb")
            self._fh_pid = os.getpid()
            self._lock = threading.Lock()
        return self._fh

    def list_chroms(self) -> list[ChromInfo]:
        return list(self._chroms)

    def find_chrom(self, name: str) -> ChromInfo:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"chromosome {name!r} not in reference {self.path}") from None

    def fetch(self, chrom: str, start1: int, end1: int) -> str:
        """Fetch [start1, end1] 1-based inclusive, clamped to contig bounds."""
        info = self.find_chrom(chrom)
        start1 = max(1, start1)
        end1 = min(info.length, end1)
        if end1 < start1:
            return ""
        start0, end0 = start1 - 1, end1  # half-open 0-based
        first = info.offset + (start0 // info.line_bases) * info.line_width + start0 % info.line_bases
        last = info.offset + ((end0 - 1) // info.line_bases) * info.line_width + (end0 - 1) % info.line_bases
        fh = self._file()
        # one seek offset per handle: the threads executor's workers share
        # this reader, and a seek of one between another's seek and read
        # would hand it the wrong bases (the JAX package's copy has no lock)
        with self._lock:
            fh.seek(first)
            raw = fh.read(last - first + 1)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii").upper()

    def make_region(self, chrom: str, start1: int, end1: int) -> "Region":
        info = self.find_chrom(chrom)
        return Region(chrom, max(1, start1), min(info.length, end1), info.index, self)

    def parse_region(self, spec: str) -> "Region":
        chrom, start1, end1 = parse_region_spec(spec)
        info = self.find_chrom(chrom)
        if end1 is None:
            end1 = info.length
        if start1 is None:
            start1 = 1
        return self.make_region(chrom, start1, end1)

    def close(self) -> None:
        self._fh.close()


@dataclass
class Region:
    """1-based inclusive genomic span with lazily loaded reference sequence."""

    chrom: str
    start1: int
    end1: int
    chrom_index: int
    _ref: Reference | None = None
    _seq: str | None = field(default=None, repr=False)

    @property
    def length(self) -> int:
        return self.end1 - self.start1 + 1

    def seq(self) -> str:
        if self._seq is None:
            if self._ref is None:
                raise RuntimeError("region has no backing reference")
            self._seq = self._ref.fetch(self.chrom, self.start1, self.end1)
        return self._seq

    def to_samtools(self) -> str:
        if ":" in self.chrom:
            return f"{{{self.chrom}}}:{self.start1}-{self.end1}"
        return f"{self.chrom}:{self.start1}-{self.end1}"


def parse_region_spec(spec: str) -> tuple[str, int | None, int | None]:
    """Parse 'chrom', 'chrom:start-end', or '{chrom:with:colons}:start-end'."""
    spec = spec.strip()
    if spec.startswith("{"):
        close = spec.index("}")
        chrom = spec[1:close]
        rest = spec[close + 1 :]
        if rest.startswith(":"):
            rest = rest[1:]
        else:
            rest = ""
    elif ":" in spec:
        chrom, rest = spec.rsplit(":", 1)
        # If the suffix does not look like a span, the whole spec is a name.
        if not rest or not rest[0].isdigit():
            return spec, None, None
    else:
        return spec, None, None

    if not rest:
        return chrom, None, None
    if "-" in rest:
        s, e = rest.split("-", 1)
        return chrom, int(s.replace(",", "")), int(e.replace(",", "")) if e else None
    return chrom, int(rest.replace(",", "")), None


def write_fai(fasta_path: str) -> None:
    """Generate a samtools-compatible .fai index for a FASTA file."""
    entries = []
    with open(fasta_path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        line_bases = None
        line_width = None
        pos = 0
        for raw in fh:
            line_len = len(raw)
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, line_bases or 0, line_width or 0))
                name = line[1:].split()[0].decode("ascii")
                length = 0
                line_bases = None
                line_width = None
                offset = pos + line_len
            elif line:
                if line_bases is None:
                    line_bases = len(line)
                    line_width = line_len
                length += len(line)
            pos += line_len
        if name is not None:
            entries.append((name, length, offset, line_bases or 0, line_width or 0))
    with open(fasta_path + ".fai", "w") as out:
        for name, length, offset, lb, lw in entries:
            out.write(f"{name}\t{length}\t{offset}\t{lb}\t{lw}\n")


def write_fasta(path: str, chroms: dict[str, str], line_bases: int = 60) -> None:
    """Write a FASTA file (+ .fai) from a {name: sequence} mapping."""
    with open(path, "w") as fh:
        for name, seq in chroms.items():
            fh.write(f">{name}\n")
            for off in range(0, len(seq), line_bases):
                fh.write(seq[off : off + line_bases] + "\n")
    write_fai(path)
