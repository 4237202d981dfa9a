// Traceback-free evidence DP for one (read, haplotype) pair.
//
// The arithmetic of the kernel in evidence_dp.cu, kept in a header of plain
// C++ so that it reads top to bottom as the recurrence it is: `cell<R>` is
// one cell update, which the kernel calls in anti-diagonal order and the
// host reference `dp_pair_host<R>` row by row. The contract is
// lancet2_tpu_torch/ops/evidence_dp.py (the plain PyTorch version), which in
// turn is lancet2_tpu/ops/evidence_dp.py line by line: every output equal bit
// for bit, float32 op order included. tests/test_torch_evidence_cell.py
// compiles this header with g++ and holds the host reference to it.
//
// Recurrence (fitting single-affine DP of read q against target band t;
// match/mismatch/open/extend from READ_TO_HAP, N scores 0, free target ends):
//   diag(i,j) = H(i-1,j-1) + s(q[i-1], t[j-1])
//   V(i,j)    = max(H(i-1,j) - (go+ge), V(i-1,j) - ge)     extension wins ties
//   Ht(i,j)   = max(diag, V)                               diag wins ties
//   F(i,j)    = max_{k<j} Ht(i,k) - go - ge*(j-k)          earliest k wins
//   H(i,j)    = max(Ht, F)                                 Ht wins ties
// with Ht(i,0) = H(i,0) = -(go+ge*i) for i >= 1 and H(0,j) = 0. Every cell
// carries a bank of companions that follow its argmax path: start column,
// NM, and per region slot r < R the query position at the region start (qv),
// aligned columns, min base quality, raw substitution total, confidence-
// weighted score (pbq) and matches.
//
// Deletions: each row carries the best source k and the source cell's
// Ht bank in registers, so the companions of a deletion run come from the
// exact source column at any distance (the TPU kernel approximated this with
// a capped shift descent and a taint bit; here there is neither). The run's
// contribution is added in closed form at the cell: nm += j-k, aligned +=
// overlap with the region, pbq += float(overlap)*ge (once), min_bq takes the
// run's flank quals when the run starts before the region end, qv = i when
// the region start lies in the run.

#pragma once

#include <stdint.h>
#include <stddef.h>

#include <vector>

#ifdef __CUDACC__
#define L2T_HD __host__ __device__ __forceinline__
#else
#define L2T_HD inline
#endif

namespace l2t {

constexpr int kNegInf = -(1 << 29);  // lancet2_tpu.ops.affine_dp.NEG_INF
constexpr int kBigBq = 255;
constexpr int kRMax = 4;             // region slots per pair in `regions`

// Products and sums round separately, as the two torch ops of the plain
// version do (no fused multiply-add).
L2T_HD float fmul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

L2T_HD float fadd_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

L2T_HD int imin(int a, int b) { return a < b ? a : b; }
L2T_HD int imax(int a, int b) { return a > b ? a : b; }

template <int R>
struct Bank {
  static constexpr int RA = R > 0 ? R : 1;
  int start, nm;
  int qv[RA], al[RA], mb[RA];
  float raw[RA], pbq[RA], mt[RA];
};

// Words of one cell (value and bank) as the kernel stores it: value +
// start + nm + 6 per region slot.
template <int R>
L2T_HD constexpr int cell_fields() { return 3 + 6 * R; }

struct Scoring {
  int match, mismatch, go, ge;
};

// Region slots [0, R) of one pair: [vs, ve) in target columns; ve <= vs is
// inactive; in0 marks a region that holds column 0.
template <int R>
struct Regions {
  static constexpr int RA = R > 0 ? R : 1;
  int vs[RA], ve[RA];
  bool act[RA], in0[RA];
};

template <int R>
L2T_HD Regions<R> load_regions(const int* regions, int b) {
  Regions<R> g;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    g.vs[r] = regions[((size_t)b * kRMax + r) * 2];
    g.ve[r] = regions[((size_t)b * kRMax + r) * 2 + 1];
    g.act[r] = g.ve[r] > g.vs[r];
    g.in0[r] = g.act[r] && g.vs[r] <= 0 && g.ve[r] > 0;
  }
  return g;
}

// Companions of column 0 at row i: a pure query-prefix insertion path
// (minq: the least base quality of rows 1..i).
template <int R>
L2T_HD Bank<R> col0_bank(int i, int minq, const Regions<R>& g, int ge) {
  Bank<R> k;
  k.start = 0;
  k.nm = i;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k.qv[r] = -1;
    k.al[r] = g.in0[r] ? i : 0;
    k.mb[r] = g.in0[r] ? minq : kBigBq;
    k.raw[r] = 0.0f;
    k.pbq[r] = g.in0[r] ? fmul_rn((float)ge, (float)i) : 0.0f;
    k.mt[r] = 0.0f;
  }
  return k;
}

// Companions of row 0 at column j (H = 0, V = -inf): a free target prefix.
template <int R>
L2T_HD Bank<R> row0_bank(int j) {
  Bank<R> k;
  k.start = j;
  k.nm = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k.qv[r] = -1;
    k.al[r] = 0;
    k.mb[r] = kBigBq;
    k.raw[r] = 0.0f;
    k.pbq[r] = 0.0f;
    k.mt[r] = 0.0f;
  }
  return k;
}

// Region columns in [0, m): |[0, m) & [vs, ve)|.
L2T_HD int pref(bool act, int vs, int ve, int m) {
  return act ? imax(0, imin(m, ve) - imax(vs, 0)) : 0;
}

// Constants of query row i (1-based): its base, and for R > 0 its quality,
// that quality's confidence and the deletion flank min(qual[i-1], qual[i]).
struct RowConst {
  int i, qi, qq, flank;
  float qc;
};

// The deletion state of a row, carried left to right: the best source
// value (Ht(i, k) + ge * (k + 1)), its column k and the source's Ht bank.
template <int R>
struct DelState {
  int best, src;
  Bank<R> b;
};

// The deletion state at column 0 of row i (minq as in col0_bank).
template <int R>
L2T_HD DelState<R> del_start(int i, int minq, const Regions<R>& g,
                             const Scoring& sc) {
  DelState<R> d;
  d.best = -(sc.go + sc.ge * i) + sc.ge;
  d.src = 0;
  d.b = col0_bank<R>(i, minq, g, sc.ge);
  return d;
}

// One cell (i, j), j >= 1, with t[j-1] = tj: from H(i-1, j-1) (dH, dB),
// H(i-1, j) (hP, hPB) and V(i-1, j) (vP, vPB) it computes H(i, j) (hn, hB)
// and V(i, j) (vv, vB), and moves the row's deletion state past column j.
// Every cell order that supplies these inputs gives the same bits: the
// host reference visits rows, the kernel anti-diagonals.
template <int R>
L2T_HD void cell(const Scoring& sc, const RowConst& rc, const Regions<R>& g,
                 int j, int tj, int dH, const Bank<R>& dB, int hP,
                 const Bank<R>& hPB, int vP, const Bank<R>& vPB,
                 DelState<R>& del, int& hn, Bank<R>& hB, int& vv,
                 Bank<R>& vB) {
  const int go = sc.go, ge = sc.ge, i = rc.i, tcol = j - 1;

  // diagonal
  const bool eq = rc.qi == tj;
  const int sub = (rc.qi >= 4 || tj >= 4) ? 0 : (eq ? sc.match : -sc.mismatch);
  const int diag = dH + sub;
  Bank<R> di = dB;
  di.nm += eq ? 0 : 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (g.act[r] && tcol >= g.vs[r] && tcol < g.ve[r]) {
      const float subf = (float)sub;
      di.al[r] += 1;
      di.mb[r] = imin(di.mb[r], rc.qq);
      di.raw[r] = fadd_rn(di.raw[r], subf);
      di.pbq[r] = fadd_rn(di.pbq[r], fmul_rn(subf, rc.qc));
      if (eq) di.mt[r] = fadd_rn(di.mt[r], 1.0f);
    }
    if (g.act[r] && tcol == g.vs[r] && di.qv[r] < 0) di.qv[r] = i - 1;
  }

  // vertical (insertion)
  const int vopen = hP - (go + ge);
  const int vext = vP - ge;
  const bool use_ext = vext >= vopen;
  vv = use_ext ? vext : vopen;
  vB = use_ext ? vPB : hPB;
  vB.nm += 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (g.act[r] && j >= g.vs[r] && j < g.ve[r]) {
      vB.al[r] += 1;
      vB.mb[r] = imin(vB.mb[r], rc.qq);
      vB.pbq[r] = fadd_rn(vB.pbq[r], (float)ge);
    }
  }

  const bool use_diag = diag >= vv;
  const int ht = use_diag ? diag : vv;
  const int fv = del.best - (go + ge) - ge * (j - 1) - ge;

  if (ht >= fv) {
    hn = ht;
    hB = use_diag ? di : vB;
  } else {
    // deletion run over target columns [src, j)
    const int src = del.src;
    hn = fv;
    hB = del.b;
    hB.nm += j - src;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool a = g.act[r];
      const int overlap = pref(a, g.vs[r], g.ve[r], j)
                          - pref(a, g.vs[r], g.ve[r], src);
      hB.al[r] += overlap;
      hB.pbq[r] = fadd_rn(hB.pbq[r], fmul_rn((float)overlap, (float)ge));
      if (a && src < g.ve[r]) hB.mb[r] = imin(hB.mb[r], rc.flank);
      if (a && g.vs[r] >= src && g.vs[r] < j && hB.qv[r] < 0) hB.qv[r] = i;
    }
  }

  // Ht(i, j) becomes a deletion source for columns > j; strictly greater
  // keeps the earliest source on ties
  const int cand = ht + ge * (j + 1);
  if (cand > del.best) {
    del.best = cand;
    del.src = j;
    del.b = use_diag ? di : vB;
  }
}

// Writes one pair's outputs: iout [B, 4 + 3R] = score, t_end, t_start, nm,
// qv[R], aligned[R], min_bq[R]; fout [B, 3R] = raw[R], pbq[R], matches[R].
template <int R>
L2T_HD void write_pair(int b, int score, int t_end, const Bank<R>& ob,
                       int* iout, float* fout) {
  int* io = iout + (size_t)b * (4 + 3 * R);
  io[0] = score;
  io[1] = t_end;
  io[2] = ob.start;
  io[3] = ob.nm;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    io[4 + r] = ob.qv[r];
    io[4 + R + r] = ob.al[r];
    io[4 + 2 * R + r] = ob.mb[r];
    float* fo = fout + (size_t)b * (3 * R);
    fo[r] = ob.raw[r];
    fo[R + r] = ob.pbq[r];
    fo[2 * R + r] = ob.mt[r];
  }
}

// The rows a pair computes: `final` is taken at row q_len, and a q_len
// outside [1, Lq] never reaches it and leaves row 0.
L2T_HD int pair_rows(int ql, int Lq) { return (ql >= 1 && ql <= Lq) ? ql : 0; }

// Outputs of a pair with no DP cell. No valid column (ncols 0): score
// NEG_INF, t_end 0 and the column-0 bank of row nrows. No query row
// (nrows 0): row 0, whose first maximum is H = 0 at column 1.
template <int R>
L2T_HD void write_cellless_pair(int b, const uint8_t* qu, int Lq, int nrows,
                                int ncols, const Regions<R>& g, int ge,
                                int* iout, float* fout) {
  if (ncols == 0) {
    int minq = kBigBq;
    if (R > 0)
      for (int i = 0; i < nrows; ++i)
        minq = imin(minq, (int)qu[(size_t)b * Lq + i]);
    write_pair<R>(b, kNegInf, 0, col0_bank<R>(nrows, minq, g, ge), iout,
                  fout);
  } else {
    write_pair<R>(b, 0, 1, row0_bank<R>(1), iout, fout);
  }
}

// Host reference: pair b, row by row through cell<R>. Inputs: q, qu
// [B, Lq] u8; q_lens [B]; t [B, Lt] u8; t_lens [B]; regions [B, kRMax, 2]
// (start, end; slots >= R are not read; qu and regions unread at R = 0);
// conf [256]. Outputs as write_pair.
template <int R>
void dp_pair_host(int b, const uint8_t* q, const uint8_t* qu,
                  const int* q_lens, const uint8_t* t, const int* t_lens,
                  const int* regions, const float* conf, int Lq, int Lt,
                  const Scoring& sc, int* iout, float* fout) {
  const int ql = q_lens[b];
  const int nrows = pair_rows(ql, Lq);
  const int ncols = imax(0, imin(t_lens[b], Lt));
  Regions<R> g{};
  if (R > 0) g = load_regions<R>(regions, b);
  if (nrows == 0 || ncols == 0) {
    write_cellless_pair<R>(b, qu, Lq, nrows, ncols, g, sc.ge, iout, fout);
    return;
  }
  const uint8_t* qb = q + (size_t)b * Lq;
  const uint8_t* qub = R > 0 ? qu + (size_t)b * Lq : nullptr;
  const uint8_t* tb = t + (size_t)b * Lt;

  // the previous row's H and V at columns 1..ncols; starts as row 0
  std::vector<int> H(ncols, 0), V(ncols, kNegInf);
  std::vector<Bank<R>> HB(ncols), VB(ncols);
  for (int j = 1; j <= ncols; ++j) HB[j - 1] = VB[j - 1] = row0_bank<R>(j);

  int minq_prev = kBigBq;  // least quality of rows < i
  for (int i = 1; i <= nrows; ++i) {
    RowConst rc{i, qb[i - 1], 0, 0, 0.0f};
    int minq = kBigBq;
    if (R > 0) {
      rc.qq = qub[i - 1];
      rc.qc = conf[rc.qq];
      rc.flank = imin(rc.qq, i < ql ? (int)qub[i] : kBigBq);
      minq = imin(minq_prev, rc.qq);
    }
    int dH = (i == 1) ? 0 : -(sc.go + sc.ge * (i - 1));
    Bank<R> dB = col0_bank<R>(i - 1, minq_prev, g, sc.ge);
    DelState<R> del = del_start<R>(i, minq, g, sc);
    for (int j = 1; j <= ncols; ++j) {
      const int hP = H[j - 1], vP = V[j - 1];
      const Bank<R> hPB = HB[j - 1], vPB = VB[j - 1];
      cell<R>(sc, rc, g, j, tb[j - 1], dH, dB, hP, hPB, vP, vPB, del,
              H[j - 1], HB[j - 1], V[j - 1], VB[j - 1]);
      dH = hP;
      dB = hPB;
    }
    minq_prev = minq;
  }

  // first maximum of H over columns 1..ncols of row nrows
  int t_end = 1;
  for (int j = 2; j <= ncols; ++j)
    if (H[j - 1] > H[t_end - 1]) t_end = j;
  write_pair<R>(b, H[t_end - 1], t_end, HB[t_end - 1], iout, fout);
}

}  // namespace l2t
