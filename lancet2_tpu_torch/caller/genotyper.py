"""The genotyper's device half on one torch device.

`TorchGenotyper` subclasses `lancet2_tpu.caller.genotyper.Genotyper` and
overrides the indexed two-pass protocol (`begin_evidence_indexed` /
`finish_evidence_indexed`, reference `:786-1067`):

  pass 1  the span kernel (K1) over every (read x hap x region-chunk) pair;
  gate    score >= min_score_frac * read length, t_end > t_start, and the
          span overlaps an active region;
  crop    each survivor's target band is cut to its pass-1 span; regions
          shift WITHOUT clamping, so starts can be negative (ref `:964-975`);
  pass 2  the evidence kernel (K2) over the survivors, one launch class per
          highest active region slot R in {1, 2, 4}.

Launches are asynchronous: `begin` returns with pass 1 in flight and
`finish` is where the host waits. The kernel is exact at every deletion
distance, so there is no taint and no host rerun. The pair builders and
`assemble_evidence_packed` are inherited unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu.caller.genotyper import (
    _PAIR_CHUNK,
    _TARGET_BUCKETS,
    Genotyper,
    _bucket,
)
from lancet2_tpu_torch.ops.evidence_cuda import (
    evidence_pairs_finalize,
    span_pairs_finalize,
)
from lancet2_tpu_torch.ops.evidence_dp import R_MAX, REGION_FILL, SPAN_KEYS
from lancet2_tpu_torch.ops.evidence_fused import (
    DevicePools,
    evidence_indexed_submit,
    span_indexed_submit,
)
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS

PASS2_R = (1, 2, 4)  # evidence launch classes: highest active slot + 1


class TorchGenotyper(Genotyper):
    def __init__(self, device: torch.device, min_score_frac: float = 0.25):
        super().__init__(backend="evidence", min_score_frac=min_score_frac)
        self.device = torch.device(device)
        self.kp = READ_TO_HAP_PARAMS.to(self.device)
        # pairs seen / pairs sent to pass 2, summed over this genotyper's life
        self.pass2_stats = {"total": 0, "pass2": 0}

    def run_evidence_pairs(self, *args, **kwargs):
        raise NotImplementedError("the port runs the indexed protocol only "
                                  "(run_evidence_indexed)")

    run_evidence_arrays = run_evidence_pairs

    def begin_evidence_indexed(self, pools: dict, pairs: dict,
                               pair_chunk: int | None = None):
        """Upload the pools and launch pass 1 over every pair; returns the
        state `finish_evidence_indexed` completes."""
        chunk = pair_chunk if pair_chunk is not None else _PAIR_CHUNK
        if self.device.type == "cpu":
            # the plain version holds tens of [chunk, Lt] planes per row:
            # cap the chunk as the reference caps its host engine (:623-626)
            chunk = min(chunk, 2048)
        read_ix = np.asarray(pairs["read_ix"], np.int64)
        hap_ix = np.asarray(pairs["hap_ix"], np.int64)
        band_start = np.asarray(pairs["band_start"], np.int64)
        tlens = np.asarray(pairs["tlens"], np.int64)
        n = len(read_ix)
        lt = int(pairs.get("lt_bucket") or _bucket(
            int(np.max(tlens, initial=1)), _TARGET_BUCKETS))
        dev = DevicePools(pools["reads_q"], pools["reads_qu"],
                          pools["read_lens"], pools["haps"], self.device)
        pend = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            iout = span_indexed_submit(dev, read_ix[lo:hi], hap_ix[lo:hi],
                                       band_start[lo:hi], tlens[lo:hi], lt,
                                       self.kp)
            pend.append((iout, lo, hi))
        return dict(dev=dev, pend=pend, n=n, chunk=chunk, read_ix=read_ix,
                    hap_ix=hap_ix, band_start=band_start,
                    regions=np.asarray(pairs["regions"], np.int32))

    def finish_evidence_indexed(self, st: dict) -> dict:
        dev, n, chunk = st["dev"], st["n"], st["chunk"]
        read_ix, hap_ix = st["read_ix"], st["hap_ix"]
        band_start, regions = st["band_start"], st["regions"]

        outs = {k: np.zeros(n, np.int64) for k in SPAN_KEYS}
        for iout, lo, hi in st["pend"]:
            span = span_pairs_finalize(iout)
            for k in outs:
                outs[k][lo:hi] = span[k]
        for k, fill in REGION_FILL.items():
            dt = np.float64 if isinstance(fill, float) else np.int64
            outs[k] = np.full((n, R_MAX), fill, dt)
        score, t_start, t_end = outs["score"], outs["t_start"], outs["t_end"]

        active = regions[:, :, 1] > regions[:, :, 0]
        overlap = ((regions[:, :, 1] > t_start[:, None])
                   & (regions[:, :, 0] < t_end[:, None]) & active).any(axis=1)
        min_scores = (self.min_score_frac
                      * dev.read_lens_host[read_ix].astype(np.int64)
                      ).astype(np.int64)
        needed = np.flatnonzero((score >= min_scores) & (t_end > t_start)
                                & overlap)
        self.pass2_stats["total"] += n
        self.pass2_stats["pass2"] += int(needed.size)
        if not needed.size:
            return outs

        # launch class: the highest active slot, not the count (band
        # clipping can empty a leading slot)
        act = active[needed]
        r_need = np.where(act[:, 2:].any(axis=1), 4,
                          np.where(act[:, 1], 2, 1))
        c_off = t_start[needed]
        c_len = t_end[needed] - c_off
        pend = []
        for R in PASS2_R:
            sel = np.flatnonzero(r_need == R)
            for lo in range(0, sel.size, chunk):
                k = sel[lo:lo + chunk]
                idx = needed[k]
                reg = regions[idx] - c_off[k, None, None].astype(np.int32)
                iout, fout = evidence_indexed_submit(
                    dev, read_ix[idx], hap_ix[idx], band_start[idx] + c_off[k],
                    c_len[k], reg, int(c_len[k].max()), R, self.kp)
                pend.append((iout, fout, idx, c_off[k], R))
        for iout, fout, idx, off, R in pend:
            sub = evidence_pairs_finalize(iout, fout, R)
            # t_start/t_end come back in crop coordinates
            sub["t_start"] = sub["t_start"] + off
            sub["t_end"] = sub["t_end"] + off
            for k in outs:
                outs[k][idx] = sub[k]
        return outs
