// Traceback-free evidence DP for one (read, haplotype) pair.
//
// The arithmetic of the kernel in evidence_dp.cu, kept in a header of plain
// C++ so that it reads top to bottom as the recurrence it is. The contract is
// lancet2_tpu_torch/ops/evidence_dp.py (the plain PyTorch version), which in
// turn is lancet2_tpu/ops/evidence_dp.py line by line: every output equal bit
// for bit, float32 op order included.
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
// Deletions: the row sweep carries the best source k and the source cell's
// Ht bank in registers, so the companions of a deletion run come from the
// exact source column at any distance (the TPU kernel approximated this with
// a capped shift descent and a taint bit; here there is neither). The run's
// contribution is added in closed form at the cell: nm += j-k, aligned +=
// overlap with the region, pbq += float(overlap)*ge (once), min_bq takes the
// run's flank quals when the run starts before the region end, qv = i when
// the region start lies in the run.

#pragma once

#include <stdint.h>
#include <string.h>

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

L2T_HD int f2i(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int v;
  memcpy(&v, &x, sizeof v);
  return v;
#endif
}

L2T_HD float i2f(int x) {
#ifdef __CUDA_ARCH__
  return __int_as_float(x);
#else
  float v;
  memcpy(&v, &x, sizeof v);
  return v;
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

// Words per cell in the scratch: value + start + nm + 6 per region slot.
template <int R>
constexpr int cell_fields() { return 3 + 6 * R; }

// Scratch layout: [field][column][pair], so that neighbouring threads (pairs)
// touch neighbouring words. `P` points at field 0 of this pair's column 1;
// `fs` is the distance between fields, `c` the offset of the column.
template <int R>
L2T_HD void load_cell(const int* P, size_t fs, size_t c, int& val, Bank<R>& k) {
  val = P[c];
  k.start = P[fs + c];
  k.nm = P[2 * fs + c];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k.qv[r] = P[(3 + r) * fs + c];
    k.al[r] = P[(3 + R + r) * fs + c];
    k.mb[r] = P[(3 + 2 * R + r) * fs + c];
    k.raw[r] = i2f(P[(3 + 3 * R + r) * fs + c]);
    k.pbq[r] = i2f(P[(3 + 4 * R + r) * fs + c]);
    k.mt[r] = i2f(P[(3 + 5 * R + r) * fs + c]);
  }
}

template <int R>
L2T_HD void store_cell(int* P, size_t fs, size_t c, int val, const Bank<R>& k) {
  P[c] = val;
  P[fs + c] = k.start;
  P[2 * fs + c] = k.nm;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    P[(3 + r) * fs + c] = k.qv[r];
    P[(3 + R + r) * fs + c] = k.al[r];
    P[(3 + 2 * R + r) * fs + c] = k.mb[r];
    P[(3 + 3 * R + r) * fs + c] = f2i(k.raw[r]);
    P[(3 + 4 * R + r) * fs + c] = f2i(k.pbq[r]);
    P[(3 + 5 * R + r) * fs + c] = f2i(k.mt[r]);
  }
}

// Companions of column 0 at row i: a pure query-prefix insertion path.
template <int R>
L2T_HD Bank<R> col0_bank(int i, int minq, const bool* in0, int ge) {
  Bank<R> k;
  k.start = 0;
  k.nm = i;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k.qv[r] = -1;
    k.al[r] = in0[r] ? i : 0;
    k.mb[r] = in0[r] ? minq : kBigBq;
    k.raw[r] = 0.0f;
    k.pbq[r] = in0[r] ? fmul_rn((float)ge, (float)i) : 0.0f;
    k.mt[r] = 0.0f;
  }
  return k;
}

// Region columns in [0, m): |[0, m) & [vs, ve)|.
L2T_HD int pref(bool act, int vs, int ve, int m) {
  return act ? imax(0, imin(m, ve) - imax(vs, 0)) : 0;
}

// One pair b. Inputs: q, qu [B, Lq] u8; q_lens [B]; t [B, Lt] u8; t_lens [B];
// regions [B, kRMax, 2] (start, end; end <= start = inactive; slots >= R are
// not read); conf [256]. Scratch: 2 * cell_fields<R>() * Lt * B ints.
// Outputs: iout [B, 4 + 3R] = score, t_end, t_start, nm, qv[R], aligned[R],
// min_bq[R]; fout [B, 3R] = raw[R], pbq[R], matches[R].
template <int R>
L2T_HD void dp_pair(int b, const uint8_t* q, const uint8_t* qu,
                    const int* q_lens, const uint8_t* t, const int* t_lens,
                    const int* regions, const float* conf, int B, int Lq,
                    int Lt, int match, int mismatch, int go, int ge, int* S,
                    int* iout, float* fout) {
  constexpr int RA = Bank<R>::RA;
  const uint8_t* qb = q + (size_t)b * Lq;
  const uint8_t* tb = t + (size_t)b * Lt;
  const int ql = q_lens[b];
  // `final` is taken at row q_len; a q_len outside [1, Lq] never reaches it
  // and leaves row 0
  const int nrows = (ql >= 1 && ql <= Lq) ? ql : 0;
  const int ncols = imax(0, imin(t_lens[b], Lt));

  int vs[RA], ve[RA];
  bool act[RA], in0[RA];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    vs[r] = regions[((size_t)b * kRMax + r) * 2];
    ve[r] = regions[((size_t)b * kRMax + r) * 2 + 1];
    act[r] = ve[r] > vs[r];
    in0[r] = act[r] && vs[r] <= 0 && ve[r] > 0;
  }

  const size_t fs = (size_t)Lt * B;
  int* SH = S + b;                          // H cells
  int* SV = SH + cell_fields<R>() * fs;     // V cells

  // ---- row 0: H = 0, V = -inf, start = j --------------------------------
  {
    Bank<R> k = col0_bank<R>(0, kBigBq, in0, ge);
    for (int j = 1; j <= ncols; ++j) {
      const size_t c = (size_t)(j - 1) * B;
      k.start = j;
      store_cell<R>(SH, fs, c, 0, k);
      store_cell<R>(SV, fs, c, kNegInf, k);
    }
  }

  int minq_prev = kBigBq;  // min of quals of rows < i
  for (int i = 1; i <= nrows; ++i) {
    const int qi = qb[i - 1];
    int qq = 0, flank = 0, minq = kBigBq;
    float qc = 0.0f;
    if constexpr (R > 0) {
      const uint8_t* qub = qu + (size_t)b * Lq;
      qq = qub[i - 1];
      qc = conf[qq];
      flank = imin(qq, i < ql ? (int)qub[i] : kBigBq);
      minq = imin(minq_prev, qq);
    }
    // diagonal source for column 1: column 0 of row i-1
    int dH = (i == 1) ? 0 : -(go + ge * (i - 1));
    Bank<R> dB = col0_bank<R>(i - 1, minq_prev, in0, ge);
    // deletion source: starts at column 0 of row i
    int best = -(go + ge * i) + ge;
    int src = 0;
    Bank<R> sB = col0_bank<R>(i, minq, in0, ge);

    for (int j = 1; j <= ncols; ++j) {
      const size_t c = (size_t)(j - 1) * B;
      int hP, vP;
      Bank<R> hPB, vPB;
      load_cell<R>(SH, fs, c, hP, hPB);
      load_cell<R>(SV, fs, c, vP, vPB);
      const int tj = tb[j - 1];
      const int tcol = j - 1;

      // diagonal
      const bool eq = qi == tj;
      const int sub = (qi >= 4 || tj >= 4) ? 0 : (eq ? match : -mismatch);
      const int diag = dH + sub;
      Bank<R> di = dB;
      di.nm += eq ? 0 : 1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (act[r] && tcol >= vs[r] && tcol < ve[r]) {
          const float subf = (float)sub;
          di.al[r] += 1;
          di.mb[r] = imin(di.mb[r], qq);
          di.raw[r] = fadd_rn(di.raw[r], subf);
          di.pbq[r] = fadd_rn(di.pbq[r], fmul_rn(subf, qc));
          if (eq) di.mt[r] = fadd_rn(di.mt[r], 1.0f);
        }
        if (act[r] && tcol == vs[r] && di.qv[r] < 0) di.qv[r] = i - 1;
      }

      // vertical (insertion)
      const int vopen = hP - (go + ge);
      const int vext = vP - ge;
      const bool use_ext = vext >= vopen;
      const int vv = use_ext ? vext : vopen;
      Bank<R> vi = use_ext ? vPB : hPB;
      vi.nm += 1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (act[r] && j >= vs[r] && j < ve[r]) {
          vi.al[r] += 1;
          vi.mb[r] = imin(vi.mb[r], qq);
          vi.pbq[r] = fadd_rn(vi.pbq[r], (float)ge);
        }
      }

      const bool use_diag = diag >= vv;
      const int ht = use_diag ? diag : vv;
      const int fv = best - (go + ge) - ge * (j - 1) - ge;

      int hn;
      Bank<R> hB;
      if (ht >= fv) {
        hn = ht;
        hB = use_diag ? di : vi;
      } else {
        // deletion run over target columns [src, j)
        hn = fv;
        hB = sB;
        hB.nm += j - src;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int overlap = pref(act[r], vs[r], ve[r], j)
                              - pref(act[r], vs[r], ve[r], src);
          hB.al[r] += overlap;
          hB.pbq[r] = fadd_rn(hB.pbq[r], fmul_rn((float)overlap, (float)ge));
          if (act[r] && src < ve[r]) hB.mb[r] = imin(hB.mb[r], flank);
          if (act[r] && vs[r] >= src && vs[r] < j && hB.qv[r] < 0) hB.qv[r] = i;
        }
      }

      store_cell<R>(SH, fs, c, hn, hB);
      store_cell<R>(SV, fs, c, vv, vi);

      dH = hP;
      dB = hPB;
      // Ht(i, j) becomes a deletion source for columns > j; strictly
      // greater keeps the earliest source on ties
      const int cand = ht + ge * (j + 1);
      if (cand > best) {
        best = cand;
        src = j;
        sB = use_diag ? di : vi;
      }
    }
    if constexpr (R > 0) minq_prev = minq;
  }

  // ---- extraction: first max of H over columns 1..t_len of the last row --
  int score, t_end;
  Bank<R> ob;
  if (ncols == 0) {
    score = kNegInf;
    t_end = 0;
    ob = col0_bank<R>(nrows, minq_prev, in0, ge);
  } else {
    score = SH[0];
    t_end = 1;
    for (int j = 2; j <= ncols; ++j) {
      const int h = SH[(size_t)(j - 1) * B];
      if (h > score) {
        score = h;
        t_end = j;
      }
    }
    int val;
    load_cell<R>(SH, fs, (size_t)(t_end - 1) * B, val, ob);
  }

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

}  // namespace l2t
