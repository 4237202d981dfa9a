"""Read -> haplotype allele assignment: the genotyper of the port.

The JAX package's `caller/genotyper.py` with its engines swapped for the
port's and the TPU-only measures left out (descent taint and host rerun,
pinned device shapes). Three backends, as in the JAX package:

  numpy     the CIGAR-walk baseline: `align_batch_numpy` + traceback;
  jax       the same walk over the bucketed dirs engine
            (ops/affine_dp_torch.py, the port of ops/affine_dp_jax.py) on
            the genotyper's torch device; the name is the JAX package's,
            kept so that command lines carry over;
  evidence  the traceback-free evidence DP, per window in tuple form
            (`build_evidence_pairs` -> `run_evidence_pairs` ->
            `assemble_evidence`), or across windows through the indexed
            protocol of `TorchGenotyper`.

`run_evidence_pairs` runs the plain version (ops/evidence_dp.py) in one pass
on the CPU. On a CUDA device it runs the two-pass protocol through the
kernel wrappers (ops/evidence_cuda.py), as `TorchGenotyper` does for the
batch executor:

  pass 1  the span kernel (K1) over every (read x hap x region-chunk) pair;
  gate    score >= min_score_frac * read length, t_end > t_start, and the
          span overlaps an active region (`pass2_survivors`, shared by
          both routes);
  pass 2  the evidence kernel (K2) over the survivors, one launch class per
          highest active region slot R in {1, 2, 4} (`launch_class`).

The tuple form runs pass 2 on the survivors' full targets, so its outputs
equal the one-pass CPU run on every field `assemble_evidence` reads. The
indexed form crops each survivor's band to its pass-1 span first; regions
shift WITHOUT clamping, so starts can be negative. Launches are
asynchronous: `begin_evidence_indexed` returns with pass 1 in flight and
`finish_evidence_indexed` is where the host waits. The kernel is exact at
every deletion distance, so there is no taint and no host rerun.

torch and the device ops are imported where an engine runs, as the JAX
package imports its engines, and the pair layout comes from the torch-free
ops/evidence_layout.py: the CLI and phase A (the prep coordinator and its
fork workers) load no torch.

Divergence from the reference caller (kept from the JAX package): minimap2
returns "no hit" for unalignable reads; the DP always produces a best-effort
alignment, so a minimum score gate (score >= read_len/4 by default) stands in
for mapability filtering.
"""

from __future__ import annotations

import numpy as np

from lancet2_tpu_torch.base.dna import encode
from lancet2_tpu_torch.caller.scoring import (
    ReadAlleleAssignment,
    compute_edit_distance_cigar,
    score_read_at_variant,
)
from lancet2_tpu_torch.caller.support import STRAND_FWD, STRAND_REV, ReadEvidence, VariantSupport
from lancet2_tpu_torch.caller.variant import RawVariant
from lancet2_tpu_torch.cbdg.read import Read
from lancet2_tpu_torch.core.prep_worker import ReadCols
from lancet2_tpu_torch.ops.affine_dp import READ_TO_HAP, align_batch_numpy, traceback_batch
from lancet2_tpu_torch.ops.evidence_layout import R_MAX, REGION_FILL, SPAN_KEYS

REF_HAP_IDX = 0
_PAIR_CHUNK = 512

_TARGET_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 4096, 8192)
_QUERY_BUCKETS = (160, 320, 640, 1280)

PASS2_R = (1, 2, 4)  # evidence launch classes: highest active slot + 1
# pairs per kernel launch of the tuple form on a CUDA device (the CPU runs
# _PAIR_CHUNK, as the JAX package's host engine)
_DEVICE_PAIR_CHUNK = 8192

# With a mesh attached, a dispatch is sharded only when it fills at least
# this many rows per mesh entry; the rest run on the first entry and are
# counted here (the multi-device dry run asserts plain_span_with_mesh == 0).
SPMD_MIN_ROWS_PER_DEVICE = 128
MESH_FALLBACK_STATS = {"plain_span_with_mesh": 0, "plain_ev_with_mesh": 0}


def pass2_survivors(score, t_start, t_end, regions, min_scores):
    """The two-pass gate: pairs whose pass-1 span passes the mapability gate
    (score >= min_score, t_end > t_start) and overlaps an active region.
    Returns (their indices, their active-slot mask [m, R_MAX])."""
    active = regions[:, :, 1] > regions[:, :, 0]
    overlap = ((regions[:, :, 1] > t_start[:, None])
               & (regions[:, :, 0] < t_end[:, None]) & active).any(axis=1)
    needed = np.flatnonzero((score >= min_scores) & (t_end > t_start)
                            & overlap)
    return needed, active[needed]


def launch_class(active):
    """Pass-2 launch class R in PASS2_R per pair: the highest active slot,
    not the count (band clipping can empty a leading slot)."""
    return np.where(active[:, 2:].any(axis=1), 4,
                    np.where(active[:, 1], 2, 1))


def _bucket(n: int, buckets=(64, 128, 256, 512, 1024, 2048, 4096, 8192)) -> int:
    """Round a length up to a fixed bucket (the padded shapes of a pair
    chunk)."""
    for b in buckets:
        if n <= b:
            return b
    return n


def _pad(seqs: list[np.ndarray], width: int | None = None):
    max_len = max((len(s) for s in seqs), default=1)
    width = width if width is not None else max_len
    out = np.full((len(seqs), width), 5, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int64)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


class Genotyper:
    """backend: 'numpy' (CIGAR traceback per pair), 'jax' (the same walk
    over the bucketed dirs engine on `device`) or 'evidence' (the
    traceback-free evidence DP on `device`: per window through `genotype`,
    or across windows through `TorchGenotyper`).

    `device` names a torch device ("cuda", "cuda:0", "cpu"); it is resolved
    only when an engine runs, so that phase A, which builds pairs and never
    touches the device, imports no torch. `devices`, a list of devices, has
    the tuple-form evidence path take them in turn, one launch chunk each,
    as the JAX package's Genotyper(devices=) does."""

    def __init__(self, backend: str = "numpy", min_score_frac: float = 0.25,
                 device="cuda", devices: list | None = None):
        self.backend = backend
        self.min_score_frac = min_score_frac
        self.device = device
        self.devices = devices
        # pairs seen / pairs sent to pass 2, summed over this genotyper's life
        self.pass2_stats = {"total": 0, "pass2": 0}

    # ------------------------------------------------------------------
    # evidence-DP backend per window, in tuple form:
    #   build_evidence_pairs -> run_evidence_pairs -> assemble_evidence
    # ------------------------------------------------------------------
    def build_evidence_pairs(self, hap_codes, reads, variants,
                             anchor_pos1: int | None = None,
                             band_margin: int | None = None,
                             max_regions: int | None = None):
        """Phase 1: enumerate (read, hap, region-chunk) pairs for one window.

        With band_margin set (and anchor_pos1 giving the haplotypes' genomic
        start), each pair's target is the haplotype BAND around the read's
        mapped diagonal — read_len + 2*margin columns instead of the full
        haplotype. Exact whenever the optimal path stays inside the band;
        reads whose true alignment lies outside their band score low and hit
        the mapability gate, mirroring minimap2's no-hit behavior
        (reference: caller/genotyper.cpp:376-411 seeds per-haplotype indexes
        for the same economy). Regions and t_start/t_end stay in band
        coordinates — all downstream comparisons are relative.

        Region chunks hold at most R_MAX variants on every device: the CUDA
        kernel takes R up to R_MAX, so the TPU's groups of two are not
        needed.
        """
        if max_regions is None:
            max_regions = R_MAX
        max_regions = min(max_regions, R_MAX)

        n_haps = len(hap_codes)
        # per-hap region chunks: (chunk_regions [R_MAX, 2], chunk_vis [R_MAX])
        hap_chunks: list[list[tuple[np.ndarray, list[int]]]] = []
        for h in range(n_haps):
            carried = []
            for vi, variant in enumerate(variants):
                bounds = self._extract_hap_bounds(variant, h)
                if bounds is not None:
                    carried.append((vi, bounds[0], bounds[1], bounds[2]))
            chunks = []
            for off in range(0, max(len(carried), 1), max_regions):
                group = carried[off : off + max_regions]
                regions = np.zeros((R_MAX, 2), np.int32)
                vis = []
                for r, (vi, vs, vlen, allele) in enumerate(group):
                    regions[r] = (vs, vs + vlen)
                    vis.append((vi, allele))
                chunks.append((regions, vis))
            hap_chunks.append(chunks)

        # build the pair list: (read, hap, chunk). All band gathers and
        # region shifts are one vectorized op per (hap, chunk) over every
        # read at once; the per-pair loop only appends precomputed row
        # views, so values and pair order are those of the scalar form.
        use_band = band_margin is not None and anchor_pos1 is not None
        pair_q, pair_qu, pair_t, pair_meta = [], [], [], []
        if not use_band:
            for r, read in enumerate(reads):
                for h in range(n_haps):
                    hap = hap_codes[h]
                    for ci, (regions, vis) in enumerate(hap_chunks[h]):
                        pair_t.append(hap)
                        pair_meta.append((r, h, regions, vis))
                        pair_q.append(read.codes)
                        pair_qu.append(read.qual)
            return pair_q, pair_qu, pair_t, pair_meta

        n_reads = len(reads)
        ro = np.fromiter(
            (rd.start0 + 1 - anchor_pos1 for rd in reads), np.int64, n_reads
        )
        bandw = np.fromiter((rd.length for rd in reads), np.int64, n_reads)
        bandw += 2 * band_margin

        # per hap: banded row + per-chunk shifted regions for each read whose
        # band is narrower than the haplotype (others use the full hap)
        per_hap: list[tuple[dict, list]] = []
        for h in range(n_haps):
            hap = hap_codes[h]
            lh = len(hap)
            sel = bandw < lh
            band_rows: dict[int, np.ndarray] = {}
            chunk_bregs: list[dict[int, np.ndarray]] = []
            if sel.any():
                idx_sel = np.nonzero(sel)[0]
                bs = np.clip(ro[idx_sel] - band_margin, 0, lh - bandw[idx_sel])
                bw_sel = bandw[idx_sel]
                for bw in np.unique(bw_sel):
                    grp = bw_sel == bw
                    g_idx = idx_sel[grp]
                    gathered = hap[
                        bs[grp][:, None] + np.arange(int(bw))[None, :]
                    ]
                    for gi, r in enumerate(g_idx):
                        band_rows[int(r)] = gathered[gi]
                for regions, _vis in hap_chunks[h]:
                    active = regions[:, 1] > regions[:, 0]
                    breg = np.clip(
                        regions[None, :, :] - bs[:, None, None],
                        0,
                        bw_sel[:, None, None],
                    ).astype(np.int32)
                    breg[:, ~active, :] = 0
                    chunk_bregs.append(
                        {int(r): breg[si] for si, r in enumerate(idx_sel)}
                    )
            else:
                chunk_bregs = [{} for _ in hap_chunks[h]]
            per_hap.append((band_rows, chunk_bregs))

        for r, read in enumerate(reads):
            codes, qual = read.codes, read.qual
            for h in range(n_haps):
                hap = hap_codes[h]
                band_rows, chunk_bregs = per_hap[h]
                row = band_rows.get(r)
                for ci, (regions, vis) in enumerate(hap_chunks[h]):
                    if row is not None:
                        pair_t.append(row)
                        pair_meta.append((r, h, chunk_bregs[ci][r], vis))
                    else:
                        pair_t.append(hap)
                        pair_meta.append((r, h, regions, vis))
                    pair_q.append(codes)
                    pair_qu.append(qual)
        return pair_q, pair_qu, pair_t, pair_meta

    @staticmethod
    def _chunk_inputs(pair_q, pair_qu, pair_t, pair_meta, lo, hi):
        """Pad one pair chunk [lo, hi) to bucketed lengths. The pair count is
        not padded: the JAX package pads it to reuse XLA executables, and
        neither the plain version nor the kernel needs that."""
        bq = _bucket(max(len(s) for s in pair_q[lo:hi]), _QUERY_BUCKETS)
        bt = _bucket(max(len(s) for s in pair_t[lo:hi]), _TARGET_BUCKETS)
        qs, qlens = _pad(pair_q[lo:hi], bq)
        qus, _ = _pad(pair_qu[lo:hi], bq)
        ts, tlens = _pad(pair_t[lo:hi], bt)
        regions = np.zeros((hi - lo, R_MAX, 2), np.int32)
        for b in range(hi - lo):
            regions[b] = pair_meta[lo + b][2]
        return qs, qus, qlens, ts, tlens, regions

    def run_evidence_pairs(self, pair_q, pair_qu, pair_t, pair_meta):
        """Phase 2: the evidence DP over the pair list, in chunks. One pass
        of the plain version on the CPU; the two-pass kernel protocol on a
        CUDA device (`_run_evidence_pairs_two_pass`); any other device
        raises."""
        import torch

        dev = torch.device(self.device)
        if self.devices:
            return self._run_evidence_pairs_two_pass(
                pair_q, pair_qu, pair_t, pair_meta,
                [torch.device(d) for d in self.devices])
        if dev.type == "cuda":
            return self._run_evidence_pairs_two_pass(
                pair_q, pair_qu, pair_t, pair_meta, [dev])
        if dev.type != "cpu":
            raise ValueError(f"no evidence DP for device {dev}")
        from lancet2_tpu_torch.ops.evidence_dp import evidence_dp

        outs = {}
        for lo in range(0, len(pair_q), _PAIR_CHUNK):
            hi = min(lo + _PAIR_CHUNK, len(pair_q))
            out = evidence_dp(*self._chunk_inputs(
                pair_q, pair_qu, pair_t, pair_meta, lo, hi))
            for key, arr in out.items():
                outs.setdefault(key, []).append(arr)
        return {k: np.concatenate(v) for k, v in outs.items()}

    def _run_evidence_pairs_two_pass(self, pair_q, pair_qu, pair_t,
                                     pair_meta, dev):
        """Two-pass dispatch on `dev`, a device or a list of devices whose
        entries the launch chunks take in turn, through the kernel wrappers:
        the kernels on a CUDA device, their plain versions on CPU tensors
        (how the tests hold this protocol on the CPU). Pass 1: K1 (score, t_end,
        t_start, NM) over EVERY pair, all chunks launched before any is read
        back. Pass 2: K2 over the survivors of `pass2_survivors` only, on
        their full targets, by launch class. Excluded pairs' region outputs
        are never read by assemble_evidence (their gate/overlap checks fail
        identically), and a survivor's every output comes from K2, so the
        result equals the one-pass CPU run on every field assembly reads.

        Launches go to the current stream of the calling thread, which is
        the device's default stream for every worker of the threads
        executor: the wrappers free per-launch scratch while the kernel
        runs, which is safe only in one stream's order."""
        import torch

        from lancet2_tpu_torch.ops.evidence_cuda import (
            evidence_pairs_finalize,
            evidence_pairs_submit,
            span_pairs_finalize,
            span_pairs_submit,
        )
        from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS

        devs = dev if isinstance(dev, (list, tuple)) else [dev]

        def launch(lists, R, ci):
            dev = devs[ci % len(devs)]
            kp = READ_TO_HAP_PARAMS.to(dev)

            def put(a, dt):
                return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

            qs, qus, qlens, ts, tlens, regions = self._chunk_inputs(
                *lists, 0, len(lists[0]))
            q, ql = put(qs, np.uint8), put(qlens, np.int32)
            t, tl = put(ts, np.uint8), put(tlens, np.int32)
            if R == 0:
                return span_pairs_submit(q, ql, t, tl, kp)
            return evidence_pairs_submit(q, put(qus, np.uint8), ql, t, tl,
                                         put(regions, np.int32), R, kp)

        n = len(pair_q)
        lists = (pair_q, pair_qu, pair_t, pair_meta)
        chunk = _DEVICE_PAIR_CHUNK
        pend = []
        for ci, lo in enumerate(range(0, n, chunk)):
            hi = min(lo + chunk, n)
            pend.append((launch([x[lo:hi] for x in lists], 0, ci), lo, hi))
        outs = {k: np.zeros(n, np.int64) for k in SPAN_KEYS}
        for iout, lo, hi in pend:
            span = span_pairs_finalize(iout)
            for k in outs:
                outs[k][lo:hi] = span[k]
        for k, fill in REGION_FILL.items():
            dt = np.float64 if isinstance(fill, float) else np.int64
            outs[k] = np.full((n, R_MAX), fill, dt)

        regions = np.stack([m[2] for m in pair_meta]).astype(np.int32)
        q_lens = np.fromiter((len(q) for q in pair_q), np.int64, n)
        min_scores = (self.min_score_frac * q_lens).astype(np.int64)
        needed, active = pass2_survivors(outs["score"], outs["t_start"],
                                         outs["t_end"], regions, min_scores)
        self.pass2_stats["total"] += n
        self.pass2_stats["pass2"] += int(needed.size)
        r_need = launch_class(active)
        pend = []
        for R in PASS2_R:
            sel = needed[r_need == R]
            for lo in range(0, sel.size, chunk):
                idx = sel[lo:lo + chunk]
                pend.append((launch([[x[i] for i in idx] for x in lists], R,
                                    len(pend)), idx, R))
        for (iout, fout), idx, R in pend:
            sub = evidence_pairs_finalize(iout, fout, R)
            for k in outs:
                outs[k][idx] = sub[k]
        return outs

    def build_pair_indices(self, hap_lens, reads, variants,
                           anchor_pos1: int, band_margin: int,
                           max_regions: int):
        """Evidence pairs of ONE component as indices: no per-pair sequence
        copies — pairs are (read_ix, hap_local, band_start, t_len, shifted
        regions), fully vectorized. Pair order is read-major then (hap,
        chunk), as in the JAX package's expanded builder (bit-identity
        depends on it: best-per-(read, variant) tie-breaks iterate pairs in
        order)."""
        if band_margin is None:
            band_margin = 1 << 30  # no banding: every pair gets the full hap
        n_haps = len(hap_lens)
        n_reads = len(reads)
        # per-hap region chunks of at most max_regions carried variants
        hap_chunks: list[list[tuple[np.ndarray, list]]] = []
        for h in range(n_haps):
            carried = []
            for vi, variant in enumerate(variants):
                bounds = self._extract_hap_bounds(variant, h)
                if bounds is not None:
                    carried.append((vi, bounds[0], bounds[1], bounds[2]))
            chunks = []
            for off in range(0, max(len(carried), 1), max_regions):
                group = carried[off : off + max_regions]
                regions = np.zeros((R_MAX, 2), np.int32)
                vis = []
                for r, (vi, vs, vlen, allele) in enumerate(group):
                    regions[r] = (vs, vs + vlen)
                    vis.append((vi, allele))
                chunks.append((regions, vis))
            hap_chunks.append(chunks)

        cols = [(h, ci) for h in range(n_haps)
                for ci in range(len(hap_chunks[h]))]
        C = len(cols)
        if n_reads == 0 or C == 0:
            z = np.zeros(0, np.int32)
            return dict(read_ix=z, hap_local=z, band_start=z, tlens=z,
                        regions=np.zeros((0, R_MAX, 2), np.int32),
                        meta_vis=z, vis_table=[])

        ro = np.fromiter(
            (rd.start0 + 1 - anchor_pos1 for rd in reads), np.int64, n_reads
        )
        rlen = np.fromiter((rd.length for rd in reads), np.int64, n_reads)
        bandw = rlen + 2 * band_margin
        hl = np.asarray(hap_lens, np.int64)

        # per (read, hap) band start + target length [n_reads, n_haps]
        banded = bandw[:, None] < hl[None, :]
        bs = np.clip(
            ro[:, None] - band_margin, 0,
            np.maximum(hl[None, :] - bandw[:, None], 0),
        )
        bs = np.where(banded, bs, 0).astype(np.int64)
        tl = np.where(banded, bandw[:, None], hl[None, :]).astype(np.int64)

        col_h = np.fromiter((h for h, _ci in cols), np.int64, C)
        read_ix = np.repeat(np.arange(n_reads, dtype=np.int32), C)
        hap_local = np.tile(col_h.astype(np.int32), n_reads)
        band_start = bs[:, col_h].ravel().astype(np.int32)
        tlens = tl[:, col_h].ravel().astype(np.int32)

        # shifted regions per (col, read) -> (read-major, col) pair order
        vis_table: list = []
        meta_vis_col = np.empty(C, np.int32)
        regs_by_col = np.empty((C, n_reads, R_MAX, 2), np.int32)
        for j, (h, ci) in enumerate(cols):
            regions, vis = hap_chunks[h][ci]
            meta_vis_col[j] = len(vis_table)
            vis_table.append(vis)
            shifted = np.clip(
                regions[None, :, :] - bs[:, h, None, None],
                0, tl[:, h, None, None],
            ).astype(np.int32)
            inact = regions[:, 1] <= regions[:, 0]
            shifted[:, inact, :] = 0
            regs_by_col[j] = np.where(
                banded[:, h, None, None], shifted, regions[None, :, :]
            )
        regions_all = regs_by_col.transpose(1, 0, 2, 3).reshape(
            n_reads * C, R_MAX, 2
        )
        meta_vis = np.tile(meta_vis_col, n_reads)

        # EXACT pair pruning: a pair whose every region slot band-clipped
        # to empty can never contribute evidence (assembly reads a pair
        # only through active-slot overlap), so it never needs to ship or
        # align. Kept regardless: each read's FIRST REF-hap pair — the
        # per-read NM-baseline source (assemble_evidence* takes the first
        # REF pair in order). Identical results, ~35% fewer pairs on the
        # chr-scale bench (reference aligns every read to every haplotype
        # — caller/genotyper.cpp:376-411 — but only because minimap2
        # can't know which alignments feed evidence; the band geometry
        # here proves it upfront).
        keep = (regions_all[:, :, 1] > regions_all[:, :, 0]).any(axis=1)
        keep = keep.reshape(n_reads, C)
        keep[:, 0] = True  # (h=0, ci=0): the REF baseline pair
        keep = keep.ravel()
        return dict(read_ix=read_ix[keep], hap_local=hap_local[keep],
                    band_start=band_start[keep], tlens=tlens[keep],
                    regions=regions_all[keep], meta_vis=meta_vis[keep],
                    vis_table=vis_table)

    def assemble_evidence_packed(self, reads, variants, comp, outs):
        """Phase 3 over a PackedComponent (core/prep_worker.py): the gate /
        overlap / field math runs vectorized over all pairs; Python touches
        only the surviving candidates (measured ~16% of pairs). Result- and
        ORDER-identical to assemble_evidence on the tuple form: candidates
        iterate in (pair, slot) order — the same nesting as the scalar
        loops — so best-per-(read,variant) tie-breaks match exactly, and
        evidence rows append per read in read order."""
        n = comp.pair_stop - comp.pair_start
        result: dict[int, dict[str, VariantSupport]] = {}
        if n == 0:
            return result
        meta_r, meta_h, meta_vis = comp.meta_r, comp.meta_h, comp.meta_vis
        regions = comp.regions
        score = np.asarray(outs["score"])
        t_start = np.asarray(outs["t_start"])
        t_end = np.asarray(outs["t_end"])
        nm = np.asarray(outs["nm"])

        n_reads = len(reads)
        if hasattr(reads, "length"):  # ReadCols (columnar payload)
            read_len = reads.length
        else:
            read_len = np.fromiter(
                (r.length for r in reads), np.int64, n_reads
            )
        min_score = (self.min_score_frac * read_len).astype(np.int64)
        pm = (score >= min_score[meta_r]) & (t_end > t_start)

        # per-read NM baseline from the first REF-haplotype pair
        baseline = read_len.copy()
        sel = np.flatnonzero(meta_h == REF_HAP_IDX)
        if sel.size:
            ur, ui = np.unique(meta_r[sel], return_index=True)
            ridx = sel[ui]
            ok = pm[ridx]
            baseline[ur[ok]] = nm[ridx[ok]]

        active = regions[:, :, 1] > regions[:, :, 0]
        ov = ((regions[:, :, 1] > t_start[:, None])
              & (regions[:, :, 0] < t_end[:, None]) & active)
        pi, si = np.nonzero(ov & pm[:, None])
        if pi.size == 0:
            return result

        aligned = np.asarray(outs["aligned"])[pi, si]
        matches = np.asarray(outs["matches"])[pi, si]
        identity = np.where(aligned > 0, matches / np.maximum(aligned, 1), 0.0)
        raw = np.asarray(outs["raw"])[pi, si]
        pbq = np.asarray(outs["pbq"])[pi, si]
        min_bq = np.asarray(outs["min_bq"])[pi, si]
        qv = np.maximum(np.asarray(outs["qv"])[pi, si], 0)
        # int(float(score) - raw): trunc-toward-zero, matching the scalar int()
        gscore = np.trunc(score[pi].astype(np.float64) - raw).astype(np.int64)
        combined = gscore.astype(np.float64) + pbq * identity
        rl = read_len[meta_r[pi]]
        rel = np.where(rl > 0, qv / np.maximum(rl, 1), 0.5)
        folded = np.minimum(rel, 1.0 - rel)
        bq = np.where(min_bq == 255, 0, min_bq)
        own_nm = nm[pi]
        hap_of = meta_h[pi]
        read_of = meta_r[pi]

        # best-per-(read, variant): candidates already in (pair, slot)
        # order == the scalar loops' nesting; dict updates keep insertion
        # position, preserving the per-read variant iteration order
        winners: dict[int, dict[int, tuple]] = {}
        vis_table = comp.vis_table
        for c in range(pi.size):
            vt = vis_table[meta_vis[pi[c]]]
            s = si[c]
            if s >= len(vt):
                continue  # inactive slot (regions row padded) — not a vis
            vi, allele = vt[s]
            per_read = winners.setdefault(int(read_of[c]), {})
            prev = per_read.get(vi)
            if prev is None or combined[c] > prev[0]:
                per_read[vi] = (combined[c], c, allele)

        columnar = hasattr(reads, "flags")
        for r in sorted(winners):
            if columnar:
                fl = int(reads.flags[r])
                strand = STRAND_REV if fl & ReadCols.F_REVERSE else STRAND_FWD
                sample_name = reads.sample_names[reads.sample_idx[r]]
                insert_size = int(reads.insert_size[r])
                start0 = int(reads.start0[r])
                qname_hash = int(reads.qname_hash[r])
                mapq = int(reads.mapq[r])
                is_clip = bool(fl & ReadCols.F_SOFT_CLIPPED)
                is_pp = bool(fl & ReadCols.F_PROPER_PAIR)
            else:
                read = reads[r]
                strand = STRAND_REV if read.is_reverse else STRAND_FWD
                sample_name = read.sample_name
                insert_size = read.insert_size
                start0 = read.start0
                qname_hash = read.qname_hash
                mapq = read.mapq
                is_clip, is_pp = read.is_soft_clipped, read.is_proper_pair
            for vi, (comb, c, allele) in winners[r].items():
                supports = result.setdefault(vi, {})
                support = supports.setdefault(sample_name, VariantSupport())
                support.add_evidence(
                    ReadEvidence(
                        insert_size=insert_size,
                        alignment_start=start0,
                        aln_score=float(comb),
                        folded_read_pos=float(folded[c]),
                        rname_hash=qname_hash & 0xFFFFFFFF,
                        ref_nm=int(baseline[r]),
                        own_hap_nm=int(own_nm[c]),
                        assigned_haplotype_id=int(hap_of[c]),
                        allele=int(allele),
                        strand=strand,
                        base_qual=int(bq[c]),
                        map_qual=mapq,
                        is_soft_clipped=is_clip,
                        is_proper_pair=is_pp,
                    )
                )
        return result

    def assemble_evidence(self, reads, variants, pair_meta, outs):
        """Phase 3: per-read allele assignment + VariantSupport assembly."""
        # per-read assembly (mirrors the CIGAR-walk backend's logic)
        result: dict[int, dict[str, VariantSupport]] = {}
        idx_of: dict[tuple[int, int, int], int] = {}
        for idx, (r, h, _reg, _vis) in enumerate(pair_meta):
            idx_of.setdefault((r, h), idx)  # first chunk holds the aln stats

        pair_index = 0
        per_read_pairs: dict[int, list[int]] = {}
        for idx, (r, h, _reg, _vis) in enumerate(pair_meta):
            per_read_pairs.setdefault(r, []).append(idx)

        for r, read in enumerate(reads):
            min_score = int(self.min_score_frac * read.length)
            read_pairs = per_read_pairs.get(r, [])
            # ref-hap NM baseline
            ref_idx = idx_of.get((r, REF_HAP_IDX))
            if (ref_idx is not None and outs["score"][ref_idx] >= min_score
                    and outs["t_end"][ref_idx] > outs["t_start"][ref_idx]):
                baseline_ref_nm = int(outs["nm"][ref_idx])
            else:
                baseline_ref_nm = read.length

            assignments: dict[int, ReadAlleleAssignment] = {}
            for idx in read_pairs:
                _r, h, regions, vis = pair_meta[idx]
                score = int(outs["score"][idx])
                t_start = int(outs["t_start"][idx])
                t_end = int(outs["t_end"][idx])
                if score < min_score or t_end <= t_start:
                    continue
                for slot, (vi, allele_idx) in enumerate(vis):
                    vs, ve = int(regions[slot, 0]), int(regions[slot, 1])
                    if not (ve > t_start and vs < t_end):
                        continue
                    aligned = int(outs["aligned"][idx, slot])
                    matches = float(outs["matches"][idx, slot])
                    identity = matches / aligned if aligned > 0 else 0.0
                    raw = float(outs["raw"][idx, slot])
                    pbq = float(outs["pbq"][idx, slot])
                    min_bq = int(outs["min_bq"][idx, slot])
                    qv = max(0, int(outs["qv"][idx, slot]))
                    scored = ReadAlleleAssignment()
                    scored.allele = allele_idx
                    scored.global_score = int(float(score) - raw)
                    scored.local_score = pbq
                    scored.local_identity = identity
                    scored.base_qual_at_var = 0 if min_bq == 255 else min_bq
                    scored.assigned_haplotype_id = h
                    scored.own_hap_nm = int(outs["nm"][idx])
                    scored.ref_nm = baseline_ref_nm
                    rel = qv / read.length if read.length > 0 else 0.5
                    scored.folded_read_pos = min(rel, 1.0 - rel)
                    prev = assignments.get(vi)
                    if prev is None or scored.combined_score > prev.combined_score:
                        assignments[vi] = scored

            strand = STRAND_REV if read.is_reverse else STRAND_FWD
            for vi, scored in assignments.items():
                supports = result.setdefault(vi, {})
                support = supports.setdefault(read.sample_name, VariantSupport())
                support.add_evidence(
                    ReadEvidence(
                        insert_size=read.insert_size,
                        alignment_start=read.start0,
                        aln_score=scored.combined_score,
                        folded_read_pos=scored.folded_read_pos,
                        rname_hash=read.qname_hash & 0xFFFFFFFF,
                        ref_nm=scored.ref_nm,
                        own_hap_nm=scored.own_hap_nm,
                        assigned_haplotype_id=scored.assigned_haplotype_id,
                        allele=scored.allele,
                        strand=strand,
                        base_qual=scored.base_qual_at_var,
                        map_qual=read.mapq,
                        is_soft_clipped=read.is_soft_clipped,
                        is_proper_pair=read.is_proper_pair,
                    )
                )
        return result

    def _genotype_evidence(self, hap_codes, hap_seqs, reads, variants, quals_list):
        pair_q, pair_qu, pair_t, pair_meta = self.build_evidence_pairs(
            hap_codes, reads, variants
        )
        outs = self.run_evidence_pairs(pair_q, pair_qu, pair_t, pair_meta)
        return self.assemble_evidence(reads, variants, pair_meta, outs)

    def _align_all(self, hap_codes: list[np.ndarray], reads: list[Read],
                   variants: list[RawVariant] | None = None):
        """Batched alignment of every (read, hap) pair; returns nested dict
        alns[read_idx][hap_idx] = {score, t_start, t_end, cigar, hap_idx}
        for pairs that need CIGARs (None entries are gated/non-candidates)."""
        n_reads, n_haps = len(reads), len(hap_codes)
        pair_q = []
        pair_t = []
        for read in reads:
            for h in range(n_haps):
                pair_q.append(read.codes)
                pair_t.append(hap_codes[h])

        # min-score gate applied after alignment; all pairs get CIGARs
        pair_of = {i: i for i in range(len(pair_q))}
        results: list[dict] = []
        for lo in range(0, len(pair_q), _PAIR_CHUNK):
            hi = min(lo + _PAIR_CHUNK, len(pair_q))
            if self.backend == "jax":
                # the JAX package buckets every dimension so its jitted
                # executable is reused across windows (pair count, read
                # length, haplotype length); the same buckets here
                from lancet2_tpu_torch.ops.affine_dp_torch import (
                    align_dirs_torch,
                )

                n_pairs = hi - lo
                bq = _bucket(max(len(s) for s in pair_q[lo:hi]), _QUERY_BUCKETS)
                bt = _bucket(max(len(s) for s in pair_t[lo:hi]), _TARGET_BUCKETS)
                bb = _bucket(n_pairs, (64, 128, 256, 512))
                qs, qlens = _pad(pair_q[lo:hi] + [pair_q[lo]] * (bb - n_pairs), bq)
                ts, tlens = _pad(pair_t[lo:hi] + [pair_t[lo]] * (bb - n_pairs), bt)
                score, t_end, dirs = align_dirs_torch(
                    qs, qlens, ts, tlens, READ_TO_HAP, device=self.device)
                out = {"score": score[:n_pairs], "t_end": t_end[:n_pairs],
                       "dirs": dirs[:n_pairs]}
                qlens = qlens[:n_pairs]
            else:
                qs, qlens = _pad(pair_q[lo:hi])
                ts, tlens = _pad(pair_t[lo:hi])
                out = align_batch_numpy(qs, qlens, ts, tlens, READ_TO_HAP)
            cigars = traceback_batch(
                np.asarray(out["dirs"]), qlens, np.asarray(out["t_end"], dtype=np.int64), READ_TO_HAP
            )
            for b in range(hi - lo):
                cigar = cigars[b]
                t_span = sum(l for op, l in cigar if op in (0, 2))
                t_end = int(out["t_end"][b])
                results.append(
                    {
                        "score": int(out["score"][b]),
                        "t_end": t_end,
                        "t_start": t_end - t_span,
                        "cigar": cigar,
                    }
                )

        alns = []
        for r in range(n_reads):
            per_hap = []
            for h in range(n_haps):
                idx = r * n_haps + h
                res = dict(results[pair_of[idx]])
                res["hap_idx"] = h
                # apply the min-score mapability gate here so downstream
                # sees None for unalignable pairs
                min_score = int(self.min_score_frac * reads[r].length)
                if res["score"] < min_score:
                    per_hap.append(None)
                else:
                    per_hap.append(res)
            alns.append(per_hap)
        return alns

    @staticmethod
    def _extract_hap_bounds(variant: RawVariant, hap_idx: int):
        """(var_start, var_len, allele_idx) of this variant on haplotype hap_idx,
        or None when the haplotype doesn't carry it."""
        if hap_idx == REF_HAP_IDX:
            return variant.local_ref_start0, len(variant.ref_allele), 0
        for alt_pos, alt in enumerate(variant.alts):
            start = alt.local_hap_starts.get(hap_idx)
            if start is not None:
                return start, len(alt.sequence), alt_pos + 1
        return None

    def genotype(
        self, hap_seqs: list[str], reads: list[Read], variants: list[RawVariant]
    ) -> dict[int, dict[str, VariantSupport]]:
        """Returns {variant_index: {sample_name: VariantSupport}}."""
        if not variants or not reads:
            return {}
        hap_codes = [encode(h) for h in hap_seqs]
        if self.backend == "evidence":
            return self._genotype_evidence(
                hap_codes, hap_seqs, reads, variants, [r.qual for r in reads]
            )
        alns = self._align_all(hap_codes, reads, variants)

        result: dict[int, dict[str, VariantSupport]] = {}
        for read, per_hap in zip(reads, alns):
            valid = [a for a in per_hap
                     if a is not None and a["t_end"] > a["t_start"]]
            if not valid:
                continue

            # O(1)-per-read NM baseline against the REF haplotype
            ref_aln = per_hap[REF_HAP_IDX]
            if ref_aln is not None and ref_aln in valid:
                ref_slice = hap_codes[REF_HAP_IDX][ref_aln["t_start"] : ref_aln["t_end"]]
                baseline_ref_nm = compute_edit_distance_cigar(
                    ref_aln["cigar"], read.codes, ref_slice
                )
            else:
                baseline_ref_nm = read.length

            assignments: dict[int, ReadAlleleAssignment] = {}
            for aln in valid:
                hap_idx = aln["hap_idx"]
                for vi, variant in enumerate(variants):
                    bounds = self._extract_hap_bounds(variant, hap_idx)
                    if bounds is None:
                        continue
                    var_start, var_len, allele_idx = bounds
                    if not (var_start + var_len > aln["t_start"] and var_start < aln["t_end"]):
                        continue
                    scored = score_read_at_variant(
                        aln, hap_codes[hap_idx], read.codes, read.qual,
                        read.length, var_start, var_len, allele_idx,
                    )
                    scored.ref_nm = baseline_ref_nm
                    prev = assignments.get(vi)
                    if prev is None or scored.combined_score > prev.combined_score:
                        assignments[vi] = scored

            strand = STRAND_REV if read.is_reverse else STRAND_FWD
            for vi, scored in assignments.items():
                supports = result.setdefault(vi, {})
                support = supports.setdefault(read.sample_name, VariantSupport())
                support.add_evidence(
                    ReadEvidence(
                        insert_size=read.insert_size,
                        alignment_start=read.start0,
                        aln_score=scored.combined_score,
                        folded_read_pos=scored.folded_read_pos,
                        rname_hash=read.qname_hash & 0xFFFFFFFF,
                        ref_nm=scored.ref_nm,
                        own_hap_nm=scored.own_hap_nm,
                        assigned_haplotype_id=scored.assigned_haplotype_id,
                        allele=scored.allele,
                        strand=strand,
                        base_qual=scored.base_qual_at_var,
                        map_qual=read.mapq,
                        is_soft_clipped=read.is_soft_clipped,
                        is_proper_pair=read.is_proper_pair,
                    )
                )
        return result


class TorchGenotyper(Genotyper):
    """The batch executor's device half: the indexed two-pass protocol on
    one torch device, or with `mesh` (parallel/mesh.py) sharded over the
    mesh's entries (parallel/evidence_spmd.py) whenever a dispatch fills at
    least SPMD_MIN_ROWS_PER_DEVICE rows per entry; smaller ones run on the
    first entry and count in MESH_FALLBACK_STATS."""

    def __init__(self, device, min_score_frac: float = 0.25, mesh=None):
        import torch

        from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS

        super().__init__(backend="evidence", min_score_frac=min_score_frac,
                         device=torch.device(device))
        self.kp = READ_TO_HAP_PARAMS.to(self.device)
        self.mesh = mesh

    def _use_mesh(self, n: int, fallback_key: str) -> bool:
        if self.mesh is None:
            return False
        if n >= self.mesh.size * SPMD_MIN_ROWS_PER_DEVICE:
            return True
        MESH_FALLBACK_STATS[fallback_key] += 1
        return False

    def run_evidence_indexed(self, pools: dict, pairs: dict,
                             pair_chunk: int | None = None):
        """pools: reads_q/reads_qu [NR, Lq] u8, read_lens [NR] i32,
                  haps [NH, LH] u8
        pairs: read_ix/hap_ix/band_start/tlens [n] i32,
               regions [n, R_MAX, 2] i32 (band coordinates)."""
        return self.finish_evidence_indexed(
            self.begin_evidence_indexed(pools, pairs, pair_chunk)
        )

    def begin_evidence_indexed(self, pools: dict, pairs: dict,
                               pair_chunk: int | None = None):
        """Upload the pools and launch pass 1 over every pair; returns the
        state `finish_evidence_indexed` completes."""
        from lancet2_tpu_torch.ops.evidence_fused import (
            DevicePools,
            span_indexed_submit,
        )

        chunk = pair_chunk if pair_chunk is not None else _PAIR_CHUNK
        if self.device.type == "cpu":
            # the plain version holds tens of [chunk, Lt] planes per row:
            # cap the chunk as the JAX package caps its host engine
            chunk = min(chunk, 2048)
        read_ix = np.asarray(pairs["read_ix"], np.int64)
        hap_ix = np.asarray(pairs["hap_ix"], np.int64)
        band_start = np.asarray(pairs["band_start"], np.int64)
        tlens = np.asarray(pairs["tlens"], np.int64)
        n = len(read_ix)
        lt = int(pairs.get("lt_bucket") or _bucket(
            int(np.max(tlens, initial=1)), _TARGET_BUCKETS))
        pool_args = (pools["reads_q"], pools["reads_qu"], pools["read_lens"],
                     pools["haps"])
        st = dict(n=n, chunk=chunk, read_ix=read_ix, hap_ix=hap_ix,
                  band_start=band_start,
                  regions=np.asarray(pairs["regions"], np.int32))
        if self.mesh is not None:
            from lancet2_tpu_torch.parallel.evidence_spmd import (
                replicate_pools,
                span_indexed_sharded_submit,
            )

            st["pools"] = replicate_pools(self.mesh, *pool_args)
            st["dev"] = st["pools"][0]
            if self._use_mesh(n, "plain_span_with_mesh"):
                st["sharded"] = span_indexed_sharded_submit(
                    self.mesh, st["pools"], read_ix, hap_ix, band_start,
                    tlens, lt, self.kp, self._max_rows(chunk))
                return st
        else:
            st["dev"] = DevicePools(*pool_args, self.device)
        pend = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            iout = span_indexed_submit(st["dev"], read_ix[lo:hi],
                                       hap_ix[lo:hi], band_start[lo:hi],
                                       tlens[lo:hi], lt, self.kp)
            pend.append((iout, lo, hi))
        st["pend"] = pend
        return st

    def _max_rows(self, chunk: int) -> int | None:
        """Rows per launch of a sharded dispatch: one launch per entry on a
        CUDA device; chunks on the CPU, where the plain version's planes
        grow with the launch."""
        return chunk if self.device.type == "cpu" else None

    def finish_evidence_indexed(self, st: dict) -> dict:
        from lancet2_tpu_torch.ops.evidence_cuda import (
            evidence_pairs_finalize,
            span_pairs_finalize,
        )
        from lancet2_tpu_torch.ops.evidence_fused import evidence_indexed_submit

        dev, n, chunk = st["dev"], st["n"], st["chunk"]
        read_ix, hap_ix = st["read_ix"], st["hap_ix"]
        band_start, regions = st["band_start"], st["regions"]

        outs = {k: np.zeros(n, np.int64) for k in SPAN_KEYS}
        if "sharded" in st:
            from lancet2_tpu_torch.parallel.evidence_spmd import (
                span_sharded_finalize,
            )

            span = span_sharded_finalize(st["sharded"])
            for k in outs:
                outs[k][:] = span[k]
        for iout, lo, hi in st.get("pend", ()):
            span = span_pairs_finalize(iout)
            for k in outs:
                outs[k][lo:hi] = span[k]
        for k, fill in REGION_FILL.items():
            dt = np.float64 if isinstance(fill, float) else np.int64
            outs[k] = np.full((n, R_MAX), fill, dt)
        score, t_start, t_end = outs["score"], outs["t_start"], outs["t_end"]

        min_scores = (self.min_score_frac
                      * dev.read_lens_host[read_ix].astype(np.int64)
                      ).astype(np.int64)
        needed, active = pass2_survivors(score, t_start, t_end, regions,
                                         min_scores)
        self.pass2_stats["total"] += n
        self.pass2_stats["pass2"] += int(needed.size)
        if not needed.size:
            return outs

        r_need = launch_class(active)
        c_off = t_start[needed]
        c_len = t_end[needed] - c_off
        pend = []
        for R in PASS2_R:
            sel = np.flatnonzero(r_need == R)
            if sel.size and self._use_mesh(sel.size, "plain_ev_with_mesh"):
                from lancet2_tpu_torch.parallel.evidence_spmd import (
                    evidence_indexed_sharded,
                )

                idx = needed[sel]
                reg = regions[idx] - c_off[sel, None, None].astype(np.int32)
                sub = evidence_indexed_sharded(
                    self.mesh, st["pools"], read_ix[idx], hap_ix[idx],
                    band_start[idx] + c_off[sel], c_len[sel], reg,
                    int(c_len[sel].max()), R, self.kp, self._max_rows(chunk))
                pend.append((sub, idx, c_off[sel]))
                continue
            for lo in range(0, sel.size, chunk):
                k = sel[lo:lo + chunk]
                idx = needed[k]
                reg = regions[idx] - c_off[k, None, None].astype(np.int32)
                iout, fout = evidence_indexed_submit(
                    dev, read_ix[idx], hap_ix[idx], band_start[idx] + c_off[k],
                    c_len[k], reg, int(c_len[k].max()), R, self.kp)
                pend.append(((iout, fout, R), idx, c_off[k]))
        for sub, idx, off in pend:
            if isinstance(sub, tuple):
                sub = evidence_pairs_finalize(*sub)
            # t_start/t_end come back in crop coordinates
            sub["t_start"] = sub["t_start"] + off
            sub["t_end"] = sub["t_end"] + off
            for k in outs:
                outs[k][idx] = sub[k]
        return outs
