"""rANS 4x8 codec (CRAM compression method 4) — orders 0 and 1.

Implements the CRAM specification's rANS codec (4 interleaved range-ANS
states, 8-bit renormalization, 12-bit frequency precision) following
htslib's rANS_static stream layout:

  block payload = order byte | u32le compressed size of the remainder |
                  u32le raw size | frequency table | rANS payload

Order-0: one 256-symbol model; state j handles output positions i % 4 == j.
Order-1: 256 context models keyed on the previous byte; the output is split
into 4 quarters (state j owns positions [j*isz4, (j+1)*isz4), each quarter
starting from context 0); per output step the decoder advances all 4 states
in j order, so renormalization bytes interleave per position. The tail
(raw_size % 4) is decoded by state 3 continuing past its quarter.

Pure Python (fixture-scale IO; the hot BAM path uses native/bam_decoder).
Spec behavior source: CRAM 3.0 specification §rANS codec (the reference
delegates all CRAM IO to htslib 1.23.1 — SURVEY.md §2 L2).
"""

from __future__ import annotations

import struct

RANS_LOW = 1 << 23
TOTFREQ = 4096  # 12-bit precision


# ---------------------------------------------------------------- helpers

def _normalize_freqs(counts: list[int], total: int = TOTFREQ) -> list[int]:
    """Scale symbol counts to sum exactly `total`, every used symbol >= 1."""
    n = sum(counts)
    freqs = [0] * 256
    if n == 0:
        return freqs
    used = [s for s in range(256) if counts[s]]
    acc = 0
    for s in used:
        f = max(1, (counts[s] * total) // n)
        freqs[s] = f
        acc += f
    top = max(used, key=lambda s: freqs[s])
    freqs[top] += total - acc
    if freqs[top] <= 0:  # pathological skew: rebalance greedily
        need = 1 - freqs[top]
        freqs[top] = 1
        for s in used:
            if s == top:
                continue
            take = min(freqs[s] - 1, need)
            freqs[s] -= take
            need -= take
            if need == 0:
                break
    return freqs


def _write_freq(out: bytearray, f: int) -> None:
    if f < 128:
        out.append(f)
    else:
        out.append(0x80 | (f >> 8))
        out.append(f & 0xFF)


def _read_freq(buf: bytes, p: int) -> tuple[int, int]:
    b = buf[p]
    if b >= 128:
        return ((b & 0x7F) << 8) | buf[p + 1], p + 2
    return b, p + 1


def _emit_rle_symbol(out: bytearray, idx: int, syms: list[int], rle: int) -> int:
    """Emit the symbol byte (and run-length byte when a +1 run starts);
    returns the remaining run counter."""
    if rle:
        return rle - 1
    s = syms[idx]
    out.append(s)
    if idx > 0 and s == syms[idx - 1] + 1:
        run = 0
        while idx + run + 1 < len(syms) and syms[idx + run + 1] == s + run + 1:
            run += 1
        out.append(run)
        return run
    return 0


def _write_freq_table(out: bytearray, freqs: list[int]) -> None:
    """Inner (per-context) symbol/frequency table with +1-run RLE."""
    syms = [s for s in range(256) if freqs[s]]
    rle = 0
    for idx in range(len(syms)):
        rle = _emit_rle_symbol(out, idx, syms, rle)
        _write_freq(out, freqs[syms[idx]])
    out.append(0)


def _read_freq_table(buf: bytes, p: int) -> tuple[list[int], int]:
    """Mirror of htslib's do/while table parse: freq for symbol j, then the
    next symbol byte (consumed unless inside a run); terminate on j == 0."""
    freqs = [0] * 256
    s = buf[p]
    p += 1
    rle = 0
    while True:
        f, p = _read_freq(buf, p)
        freqs[s] = f
        last = s
        if rle:
            rle -= 1
            s += 1
        else:
            s = buf[p]
            p += 1
            if s == last + 1:
                rle = buf[p]
                p += 1
        if s == 0 and not rle:
            break
    return freqs, p


def _cum_table(freqs: list[int]) -> list[int]:
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    return cum


def _slot_table(freqs: list[int], cum: list[int]) -> bytearray:
    sl = bytearray(TOTFREQ)
    for s in range(256):
        if freqs[s]:
            sl[cum[s]: cum[s + 1]] = bytes([s]) * freqs[s]
    return sl


class _Enc:
    """One rANS state encoding back-to-front into a shared byte list."""

    __slots__ = ("x", "out")

    def __init__(self, out: bytearray):
        self.x = RANS_LOW
        self.out = out

    def put(self, f: int, c: int) -> None:
        x = self.x
        x_max = ((RANS_LOW >> 12) << 8) * f
        while x >= x_max:
            self.out.append(x & 0xFF)
            x >>= 8
        self.x = ((x // f) << 12) + (x % f) + c


# ---------------------------------------------------------------- order 0

def compress_o0(data: bytes) -> bytes:
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freqs = _normalize_freqs(counts)
    cum = _cum_table(freqs)

    table = bytearray()
    _write_freq_table(table, freqs)

    payload = bytearray()
    encs = [_Enc(payload) for _ in range(4)]
    for i in range(len(data) - 1, -1, -1):
        s = data[i]
        encs[i & 3].put(freqs[s], cum[s])
    head = b"".join(struct.pack("<I", encs[j].x) for j in range(4))
    body = bytes(table) + head + bytes(payload[::-1])
    return struct.pack("<BII", 0, len(body), len(data)) + body


def uncompress_o0(body: bytes, raw_size: int) -> bytes:
    freqs, p = _read_freq_table(body, 0)
    cum = _cum_table(freqs)
    slots = _slot_table(freqs, cum)

    states = list(struct.unpack_from("<4I", body, p))
    p += 16
    out = bytearray(raw_size)
    n = len(body)
    for i in range(raw_size):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = slots[slot]
        out[i] = s
        x = freqs[s] * (x >> 12) + slot - cum[s]
        while x < RANS_LOW and p < n:
            x = (x << 8) | body[p]
            p += 1
        states[j] = x
    return bytes(out)


# ---------------------------------------------------------------- order 1

def _o1_stats(data: bytes):
    n = len(data)
    isz4 = n >> 2
    counts = [None] * 256

    def bump(c, s):
        row = counts[c]
        if row is None:
            row = counts[c] = [0] * 256
        row[s] += 1

    for j in range(4):
        beg = j * isz4
        end = n if j == 3 else (j + 1) * isz4
        ctx = 0
        for i in range(beg, end):
            bump(ctx, data[i])
            ctx = data[i]
    return counts, isz4


def compress_o1(data: bytes) -> bytes:
    n = len(data)
    if n < 4:
        return compress_o0(data)
    counts, isz4 = _o1_stats(data)
    freqs = [None] * 256
    cums = [None] * 256
    for c in range(256):
        if counts[c] is not None:
            freqs[c] = _normalize_freqs(counts[c])
            cums[c] = _cum_table(freqs[c])

    table = bytearray()
    ctxs = [c for c in range(256) if freqs[c] is not None]
    rle = 0
    for idx in range(len(ctxs)):
        rle = _emit_rle_symbol(table, idx, ctxs, rle)
        _write_freq_table(table, freqs[ctxs[idx]])
    table.append(0)

    payload = bytearray()
    encs = [_Enc(payload) for _ in range(4)]

    def ctx_of(pos: int, qbeg: int) -> int:
        return data[pos - 1] if pos > qbeg else 0

    # encode in exact reverse of the decoder's byte-consumption order:
    # tail (state 3) first, then positions isz4-1..0 with states 3..0
    for pos in range(n - 1, 4 * isz4 - 1, -1):
        s = data[pos]
        c = data[pos - 1]  # tail always has a predecessor (n >= 4)
        encs[3].put(freqs[c][s], cums[c][s])
    for i in range(isz4 - 1, -1, -1):
        for j in (3, 2, 1, 0):
            pos = j * isz4 + i
            s = data[pos]
            c = ctx_of(pos, j * isz4)
            encs[j].put(freqs[c][s], cums[c][s])
    head = b"".join(struct.pack("<I", encs[j].x) for j in range(4))
    body = bytes(table) + head + bytes(payload[::-1])
    return struct.pack("<BII", 1, len(body), n) + body


def uncompress_o1(body: bytes, raw_size: int) -> bytes:
    p = 0
    freqs = [None] * 256
    cums = [None] * 256
    slots = [None] * 256
    c = body[p]
    p += 1
    rle = 0
    while True:
        fr, p = _read_freq_table(body, p)
        freqs[c] = fr
        cums[c] = _cum_table(fr)
        slots[c] = _slot_table(fr, cums[c])
        last = c
        if rle:
            rle -= 1
            c += 1
        else:
            c = body[p]
            p += 1
            if c == last + 1:
                rle = body[p]
                p += 1
        if c == 0 and not rle:
            break

    states = list(struct.unpack_from("<4I", body, p))
    p += 16
    n = len(body)
    out = bytearray(raw_size)
    isz4 = raw_size >> 2
    ctx = [0, 0, 0, 0]

    def step(j: int, pos: int, p: int) -> int:
        x = states[j]
        slot = x & (TOTFREQ - 1)
        cc = ctx[j]
        s = slots[cc][slot]
        out[pos] = s
        x = freqs[cc][s] * (x >> 12) + slot - cums[cc][s]
        while x < RANS_LOW and p < n:
            x = (x << 8) | body[p]
            p += 1
        states[j] = x
        ctx[j] = s
        return p

    for i in range(isz4):
        for j in range(4):
            p = step(j, j * isz4 + i, p)
    for pos in range(4 * isz4, raw_size):  # tail rides state 3's context
        p = step(3, pos, p)
    return bytes(out)


# ---------------------------------------------------------------- dispatch

def compress(data: bytes, order: int = 0) -> bytes:
    if order == 1 and len(data) >= 4:
        return compress_o1(data)
    return compress_o0(data)


def uncompress(blob: bytes) -> bytes:
    order, comp_size, raw_size = struct.unpack_from("<BII", blob, 0)
    body = blob[9: 9 + comp_size]
    if raw_size == 0:
        return b""
    if order == 0:
        return uncompress_o0(body, raw_size)
    if order == 1:
        return uncompress_o1(body, raw_size)
    raise ValueError(f"rans4x8: unknown order {order}")
