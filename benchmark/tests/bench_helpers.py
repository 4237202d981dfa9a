"""Shared helpers of the benchmark's tests: put the harness on sys.path,
and parse the BAMs the generator writes with the standard library."""

import gzip
import os
import struct
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

_SEQ = "=ACMGRSVTWYHKDBN"


def read_bam(path: str) -> list[dict]:
    """Records of a BAM as dicts (pos0, flag, cigar, seq, md, nm)."""
    data = gzip.open(path).read()
    assert data[:4] == b"BAM\x01"
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    recs = []
    while off < len(data):
        (size, _ref, pos, l_name, _mq, _bin, n_cig, flag, l_seq, _nr, _np,
         _tl) = struct.unpack_from("<iiiBBHHHiiii", data, off)
        p = off + 36 + l_name
        cig = [(c & 15, c >> 4) for c in struct.unpack_from(f"<{n_cig}I", data, p)]
        p += 4 * n_cig
        packed = data[p:p + (l_seq + 1) // 2]
        seq = "".join(_SEQ[b >> 4] + _SEQ[b & 15] for b in packed)[:l_seq]
        p += (l_seq + 1) // 2 + l_seq
        aux = data[p:off + 4 + size]
        nm = struct.unpack_from("<i", aux, aux.index(b"NMi") + 3)[0]
        m = aux.index(b"MDZ") + 3
        md = aux[m:aux.index(b"\x00", m)].decode()
        recs.append({"pos0": pos, "flag": flag, "cigar": cig, "seq": seq,
                     "md": md, "nm": nm})
        off += 4 + size
    return recs


def base_at(rec: dict, pos0: int) -> str | None:
    """The read's base aligned to contig position pos0 along its CIGAR, or
    None where it does not cover it or deletes it."""
    q, t = 0, rec["pos0"]
    for op, n in rec["cigar"]:
        if op == 0:
            if t <= pos0 < t + n:
                return rec["seq"][q + pos0 - t]
            q, t = q + n, t + n
        elif op == 1:
            q += n
        else:
            if t <= pos0 < t + n:
                return None
            t += n
    return None
