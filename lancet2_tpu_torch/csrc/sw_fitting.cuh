// Score-only fitting DP (K3): the per-lane step of the CUDA kernel in
// sw_fitting.cu, and a host function that runs the kernel's schedule, 32
// lanes in lockstep, in plain C++. The host function is what the CPU test
// (tests/test_torch_sw_cell.py) holds against the plain PyTorch version
// (lancet2_tpu_torch/ops/sw_dp.py), the contract: score and t_end equal for
// every pair.
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
// one, so they need not be right. As the Pallas kernel did: with no valid
// column the score is -inf and t_end 1, else with q_len outside [1, Lq] the
// final row is row 0 (score 0, t_end 1).
//
// The schedule. A warp takes a pair; lane l holds RPL consecutive query rows
// (a stripe of 32 * RPL rows per warp) and at step s computes its RPL cells
// of column j = s - l + 1, top to bottom (`lane_step`). The cell above its
// first row is lane l-1's last row at column j, computed one step earlier;
// everything else a cell needs (the diagonal, Ht and F of the column before)
// stays in the lane. Stripes are aligned to the bottom: row q_len is always
// the last row of lane 31 of the last stripe, so one lane tracks the first
// maximum and no lane looks for the row. The rows above row 1 in the first
// stripe are "dead": with an N query base and column 0 at 0 they reproduce
// row 0 (H 0, V -(go+ge), which feeds row 1 exactly as V = -inf does), so
// they need no case of their own. Lane 31 of a stripe that is not the last
// writes its row to a boundary row (H and V per column); lane 0 of the next
// stripe reads it as the cell above.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define L2T_SW_HD __host__ __device__ __forceinline__
#define L2T_SW_UNROLL _Pragma("unroll")
#else
#define L2T_SW_HD inline
#define L2T_SW_UNROLL
#endif

namespace l2t_sw {

constexpr int32_t kNegInf = -(1 << 29);  // ops/affine_dp.py NEG_INF
constexpr int kLanes = 32;
constexpr int kMaxRpl = 8;  // rows per lane: 1..kMaxRpl are instantiated

struct Params {
  int match, mismatch, go, ge;
};

L2T_SW_HD int32_t max32(int32_t a, int32_t b) { return a > b ? a : b; }
L2T_SW_HD int32_t min32(int32_t a, int32_t b) { return a < b ? a : b; }

// max(a + b, c): one VIADDMNMX on sm_90a (ptxas fuses it unasked)
L2T_SW_HD int32_t addmax(int32_t a, int32_t b, int32_t c) {
  return max32(a + b, c);
}

// The substitution scores are held as signed bytes.
L2T_SW_HD bool scores_fit(const Params& p) {
  return p.match >= -128 && p.match <= 127 && p.mismatch >= -127 &&
         p.mismatch <= 128;
}

// The scores of one query base against target codes 0..3, a signed byte
// each (byte 4, in the zero word beside it, serves codes >= 4). A query N
// or padding (code >= 4) scores 0 everywhere.
L2T_SW_HD uint32_t query_table(int qc, const Params& p) {
  uint32_t tab = 0;
  if (qc < 4) {
    for (int c = 0; c < 4; ++c) {
      const int s = c == qc ? p.match : -p.mismatch;
      tab |= (uint32_t)(uint8_t)(int8_t)s << (8 * c);
    }
  }
  return tab;
}

// prmt.b32 selector of target code tc: byte min(tc, 4), sign-extended.
L2T_SW_HD uint32_t target_selector(int tc) {
  const uint32_t c = (uint32_t)min32(tc, 4);
  return c * 0x1111u + 0x8880u;
}

// s(q, t) from the query's table and the target's selector.
L2T_SW_HD int32_t score(uint32_t tab, uint32_t sel) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(tab), "r"(0u), "r"(sel));
  return (int32_t)r;
#else
  // prmt.b32's default mode: nibble n of sel picks byte (sel_n & 7) of
  // {0, tab}, or with bit 3 set that byte's sign bit in all 8 bits
  const uint64_t src = tab;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) {
    const uint32_t k = (sel >> (4 * n)) & 0xf;
    uint32_t byte = (uint32_t)(src >> (8 * (k & 7))) & 0xff;
    if (k & 8) byte = (byte & 0x80) ? 0xff : 0;
    r |= byte << (8 * n);
  }
  return (int32_t)r;
#endif
}

// H(r, 0) = Ht(r, 0); rows r <= 0 stand for row 0.
L2T_SW_HD int32_t col0(int r, const Params& p) {
  return r >= 1 ? -(p.go + p.ge * r) : 0;
}

// A lane's state between steps: per row, its score table and H, Ht and F at
// the column last computed; and H of the row above at that column.
template <int RPL>
struct Lane {
  uint32_t tab[RPL];
  int32_t h[RPL], ht[RPL], f[RPL];
  int32_t dg;
};

// The lane's rows row0 .. row0 + RPL - 1 before column 1. q: the pair's
// query codes; rows <= 0 take an N.
template <int RPL>
L2T_SW_HD void lane_init(Lane<RPL>& L, const uint8_t* q, int row0,
                         const Params& p) {
  L2T_SW_UNROLL
  for (int m = 0; m < RPL; ++m) {
    const int r = row0 + m;
    L.tab[m] = query_table(r >= 1 ? (int)q[r - 1] : 4, p);
    L.h[m] = L.ht[m] = col0(r, p);
    L.f[m] = kNegInf;
  }
  L.dg = col0(row0 - 1, p);
}

// One lane's RPL cells of its next column, top to bottom. In: h and v of
// the row above the lane's first row at this column, and the column's
// target selector. Out, in h and v: the lane's last row at this column.
template <int RPL>
L2T_SW_HD void lane_step(Lane<RPL>& L, uint32_t sel, int32_t goe, int32_t ge,
                         int32_t& h, int32_t& v) {
  int32_t dg = L.dg;
  L.dg = h;
  L2T_SW_UNROLL
  for (int m = 0; m < RPL; ++m) {
    v = addmax(h, -goe, v - ge);
    const int32_t ht = addmax(dg, score(L.tab[m], sel), v);
    L.f[m] = addmax(L.ht[m], -goe, L.f[m] - ge);
    dg = L.h[m];
    h = max32(ht, L.f[m]);
    L.h[m] = h;
    L.ht[m] = ht;
  }
}

// Rows per lane and stripes for queries of up to Lq rows: the fewest
// stripes of at most kMaxRpl rows per lane, then the fewest rows per lane.
struct Plan {
  int rpl, stripes;
};

L2T_SW_HD Plan plan(int Lq) {
  const int per = kLanes * kMaxRpl;
  const int stripes = Lq > per ? (Lq + per - 1) / per : 1;
  const int rows = kLanes * stripes;
  const int rpl = Lq > rows ? (Lq + rows - 1) / rows : 1;
  return {rpl, stripes};
}

// A pair that needs no DP cell: its score and t_end, and true.
L2T_SW_HD bool cellless(int q_len, int Lq, int ncols, int32_t* score,
                        int32_t* t_end) {
  *t_end = 1;
  if (ncols <= 0) {
    *score = kNegInf;
    return true;
  }
  if (q_len < 1 || q_len > Lq) {
    *score = 0;
    return true;
  }
  return false;
}

// The first step of a stripe whose lane 0 holds rows rowbase + 1 .. : the
// lanes above the first that holds a row >= 1 hold only row-0 stand-ins,
// which hand down row 0 before they compute anything.
template <int RPL>
L2T_SW_HD int first_step(int rowbase) {
  return rowbase < 0 ? -rowbase / RPL : 0;
}

// The kernel's schedule on the host: 32 lanes in lockstep, one step after
// another, each lane reading the cell above from what its neighbour handed
// down at the step before (the kernel's __shfl_up_sync). Stripes meet
// through the boundary rows G, two rows of Lt (H, V) pairs used in turn,
// as in the kernel. Steps s < 31 run only the lanes with a column in
// 1..ncols; later steps run every lane (lane 31 always has one), with the
// target column clamped to ncols for the lanes past it (the kernel's
// shuffled target bases give those lanes an N instead: their cells lie past
// ncols and feed no valid one either way).
template <int RPL>
inline void fitting_pair_lockstep(const uint8_t* q, int q_len, int Lq,
                                  const uint8_t* t, int t_len, int Lt,
                                  const Params& p, int32_t* G,
                                  int32_t* score_out, int32_t* t_end_out) {
  const int ncols = min32(t_len, Lt);
  if (cellless(q_len, Lq, ncols, score_out, t_end_out)) return;
  const int32_t goe = p.go + p.ge;
  const int rows = kLanes * RPL;
  const int nst = (q_len + rows - 1) / rows;
  const int base = q_len - nst * rows;
  int32_t best = kNegInf, best_j = 1;
  Lane<RPL> lanes[kLanes];
  int32_t hv[kLanes], vv[kLanes], hin[kLanes], vin[kLanes];
  for (int k = 0; k < nst; ++k) {
    const int rowbase = base + k * rows;
    const bool first = k == 0, last = k == nst - 1;
    const int32_t* gin = G + 2 * Lt * ((k + 1) & 1);
    int32_t* gout = G + 2 * Lt * (k & 1);
    for (int l = 0; l < kLanes; ++l) {
      lane_init<RPL>(lanes[l], q, rowbase + l * RPL + 1, p);
      hv[l] = 0;
      vv[l] = kNegInf;
    }
    const int end = ncols + kLanes - 1;
    for (int s = first ? first_step<RPL>(rowbase) : 0; s < end; ++s) {
      const bool guarded = s < kLanes - 1;
      for (int l = 0; l < kLanes; ++l) {  // the shuffle
        hin[l] = l > 0 ? hv[l - 1] : first ? 0 : s < ncols ? gin[2 * s] : 0;
        vin[l] = l > 0 ? vv[l - 1]
                       : first ? kNegInf
                       : s < ncols ? gin[2 * s + 1] : kNegInf;
      }
      for (int l = 0; l < kLanes; ++l) {
        const int j = s - l + 1;
        if (guarded && (j < 1 || j > ncols)) continue;
        const int tc = t[min32(j, ncols) - 1];
        int32_t h = hin[l], v = vin[l];
        lane_step<RPL>(lanes[l], target_selector(tc), goe, p.ge, h, v);
        hv[l] = h;
        vv[l] = v;
      }
      if (!guarded) {  // lane 31 is at column s - 30, in 1..ncols
        const int j = s - (kLanes - 1) + 1;
        const int32_t h = hv[kLanes - 1];
        if (last) {
          if (h > best) {
            best = h;
            best_j = j;
          }
        } else {
          gout[2 * (j - 1)] = h;
          gout[2 * (j - 1) + 1] = vv[kLanes - 1];
        }
      }
    }
  }
  *score_out = best;
  *t_end_out = best_j;
}

}  // namespace l2t_sw
