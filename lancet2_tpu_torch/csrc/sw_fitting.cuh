// Score-only fitting DP (K3) for one (read, haplotype) pair.
//
// The arithmetic of the kernel in sw_fitting.cu, kept in a header of plain
// C++ so that the host compiler can check it against the plain PyTorch
// version (lancet2_tpu_torch/ops/sw_dp.py), which is its contract: score and
// t_end equal for every pair.
//
// Recurrence (fitting single-affine DP of read q against target t; N and
// padding score 0, free target ends):
//   diag(i,j) = H(i-1,j-1) + s(q[i-1], t[j-1])
//   V(i,j)    = max(H(i-1,j) - (go+ge), V(i-1,j) - ge)
//   Ht(i,j)   = max(diag, V)
//   F(i,j)    = max(F(i,j-1) - ge, Ht(i,j-1) - (go+ge))
//   H(i,j)    = max(Ht, F)
// with Ht(i,0) = H(i,0) = -(go+ge*i) for i >= 1, H(0,j) = 0, V(0,j) = -inf.
// The sequential F is the plain version's cummax form,
//   F(i,j) = max_{k<=j}(Ht(i,k-1) + ge*k) - (go+ge) - ge*(j-1) - ge,
// unrolled one column at a time; both are exact in int32.
// The score is the maximum of row q_len over columns 1..min(t_len, Lt), and
// t_end the first column holding it. Columns past t_len never feed a valid
// one, so they are not computed. As the Pallas kernel did: with q_len outside
// [1, Lq] the final row is row 0 (score 0, t_end 1), and with no valid column
// the score is -inf and t_end 1.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define L2T_SW_HD __host__ __device__ __forceinline__
#else
#define L2T_SW_HD inline
#endif

namespace l2t_sw {

constexpr int32_t kNegInf = -(1 << 29);  // lancet2_tpu.ops.affine_dp.NEG_INF

struct Params {
  int match, mismatch, go, ge;
};

L2T_SW_HD int32_t max32(int32_t a, int32_t b) { return a > b ? a : b; }

// One query row i over columns 0..tl-1 (0-based column j is DP column j+1).
// The previous row's H and V are read from, and this row's written to,
// H[j * stride] and V[j * stride]. With kLast, the row's maximum and its
// first column are tracked.
template <bool kLast>
L2T_SW_HD void row(int qi, int i, const uint8_t* t, int tl, Params p,
                   int32_t* H, int32_t* V, long stride, int32_t* best,
                   int* best_j) {
  const int32_t goe = p.go + p.ge;
  int32_t h_diag = i == 1 ? 0 : -(p.go + p.ge * (i - 1));  // H(i-1, j-1)
  int32_t ht_left = -(p.go + p.ge * i);                     // Ht(i, j-1)
  int32_t f = kNegInf;                                      // F(i, j-1)
  const bool q_is_n = qi >= 4;
  for (int j = 0; j < tl; ++j) {
    const int tj = t[j];
    const int32_t s = (q_is_n || tj >= 4) ? 0
                      : (qi == tj ? p.match : -p.mismatch);
    const int32_t hp = H[j * stride];
    const int32_t vp = V[j * stride];
    const int32_t v = max32(hp - goe, vp - p.ge);
    const int32_t ht = max32(h_diag + s, v);
    f = max32(f - p.ge, ht_left - goe);
    const int32_t h = max32(ht, f);
    H[j * stride] = h;
    V[j * stride] = v;
    h_diag = hp;
    ht_left = ht;
    if (kLast && h > *best) {
      *best = h;
      *best_j = j;
    }
  }
}

// q: the pair's Lq query codes; t: its Lt target codes.
L2T_SW_HD void fitting_pair(const uint8_t* q, int q_len, int Lq,
                            const uint8_t* t, int t_len, int Lt, Params p,
                            int32_t* H, int32_t* V, long stride,
                            int32_t* score, int32_t* t_end) {
  const int tl = t_len < Lt ? t_len : Lt;
  *t_end = 1;
  if (tl <= 0) {
    *score = kNegInf;
    return;
  }
  if (q_len < 1 || q_len > Lq) {
    *score = 0;
    return;
  }
  for (int j = 0; j < tl; ++j) {
    H[j * stride] = 0;
    V[j * stride] = kNegInf;
  }
  int32_t best = kNegInf;
  int best_j = 0;
  for (int i = 1; i < q_len; ++i)
    row<false>(q[i - 1], i, t, tl, p, H, V, stride, &best, &best_j);
  row<true>(q[q_len - 1], q_len, t, tl, p, H, V, stride, &best, &best_j);
  *score = best;
  *t_end = best_j + 1;
}

}  // namespace l2t_sw
