// K1 (span, R = 0) and K2 (evidence, R in {1, 2, 4}) for Hopper.
//
// Replaces the Pallas kernel generator lancet2_tpu/ops/evidence_pallas.py
// `_make_kernel` (launched by `_run_span`, pallas_call at :514, and by `_run`,
// pallas_call at :546). The arithmetic, one cell update `l2t::cell<R>`, is in
// evidence_dp.cuh; this file holds the schedule, the launch and the plain C
// entry points that lancet2_tpu_torch/ops/evidence_cuda.py binds with ctypes.
//
// Design: a warp per pair, a lane per query row. The warp takes the pair's
// rows 32 at a time (a stripe) and sweeps the stripe's anti-diagonals: at
// step s lane l computes row 32k + l + 1 at column s - l + 1. H(i, j) needs
// H and V at (i-1, j), which lane l-1 computed one step earlier and hands
// down with __shfl_up_sync; H(i-1, j-1), which the lane received one step
// before that and keeps; and the row's deletion state (best source, its
// column and bank), which moves left to right and never leaves the lane. So
// the row state lives in registers and every cell computes the same
// expression from the same inputs as the row-by-row host reference.
//
// Stripes meet at a boundary row. Lane 31 puts its cells (value and
// companions, of H and V) into a 32-column ring in shared memory, and the
// warp writes each full chunk to a per-warp boundary row in device memory,
// coalesced, [field][column]. Lane 0 of the next stripe reads that row
// through a second, double-buffered ring that cp.async fills one chunk
// ahead. The rings are sized by R and not by Lt, so every Lt up to MAX_LEN
// takes the same path, and device traffic is 2 * (3 + 6R) words per cell of
// every 32nd row. Target bases reach lane 0 through a register that holds
// the next 32 columns, and pass down the lanes with the cell above.
// Extraction needs no pass over a row: the lane that owns row q_len keeps
// the first strict maximum of H and stores the cell's bank in shared memory
// only when the maximum improves.
//
// Launch: blocks of kWarps warps, as many as fit on the card at once; the
// warps take pairs from a counter in device memory, so a block's boundary
// rows are reused pair after pair and the scratch is resident warps x
// 2 * (3 + 6R) x Lt words, whatever B is.
//
// What bounds it on the H100: instruction issue and latency, not bytes.
// Each step of a warp issues one shuffle per word of the cell above (H and
// V, 2 * (3 + 6R) words) and two for the target base, on top of the cell's
// selects, and each step waits on the one before through the shuffle;
// occupancy is what hides that chain. ptxas (sm_90a, --fmad=false): R = 0
// 56 registers, R = 1 128, R = 2 168, R = 4 254, no spills at any R; at
// kWarps = 4 that leaves 36, 16, 12 and 8 resident warps (pairs in flight)
// per SM, registers being the limit (R = 4 also fills 166 KB of shared
// memory). Measured on NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase
// 3): K1 takes 2.0 ms for 8192 pairs at Lq 160, Lt 384, 5.8x its operations
// bound; R = 4 takes 10.5 ms at Lt 256. The one-thread-per-pair schedule it
// replaces took 46.1 and 113 ms.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

#include "evidence_dp.cuh"

namespace {

constexpr int kWarps = 4;  // pairs in flight per block
constexpr unsigned kFull = 0xffffffffu;

using l2t::Bank;

// Shared words per warp: the double-buffered input ring and the output
// ring (2 * cell_fields fields of 32 columns each), and the extraction slot.
template <int R>
__host__ __device__ constexpr int warp_words() {
  return 3 * 2 * l2t::cell_fields<R>() * 32 + l2t::cell_fields<R>();
}

template <int R>
__host__ __device__ constexpr size_t block_smem() {
  return (size_t)kWarps * warp_words<R>() * sizeof(int);
}

// A cell laid out field after field, `fs` words apart: field f of the cell
// at P is P[f * fs].
template <int R>
__device__ __forceinline__ void load_cell(const int* P, int fs, int& val,
                                          Bank<R>& k) {
  val = P[0];
  k.start = P[fs];
  k.nm = P[2 * fs];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k.qv[r] = P[(3 + r) * fs];
    k.al[r] = P[(3 + R + r) * fs];
    k.mb[r] = P[(3 + 2 * R + r) * fs];
    k.raw[r] = __int_as_float(P[(3 + 3 * R + r) * fs]);
    k.pbq[r] = __int_as_float(P[(3 + 4 * R + r) * fs]);
    k.mt[r] = __int_as_float(P[(3 + 5 * R + r) * fs]);
  }
}

template <int R>
__device__ __forceinline__ void store_cell(int* P, int fs, int val,
                                           const Bank<R>& k) {
  P[0] = val;
  P[fs] = k.start;
  P[2 * fs] = k.nm;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    P[(3 + r) * fs] = k.qv[r];
    P[(3 + R + r) * fs] = k.al[r];
    P[(3 + 2 * R + r) * fs] = k.mb[r];
    P[(3 + 3 * R + r) * fs] = __float_as_int(k.raw[r]);
    P[(3 + 4 * R + r) * fs] = __float_as_int(k.pbq[r]);
    P[(3 + 5 * R + r) * fs] = __float_as_int(k.mt[r]);
  }
}

template <int R>
__device__ __forceinline__ void shfl_up_bank(Bank<R>& k) {
  k.start = __shfl_up_sync(kFull, k.start, 1);
  k.nm = __shfl_up_sync(kFull, k.nm, 1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k.qv[r] = __shfl_up_sync(kFull, k.qv[r], 1);
    k.al[r] = __shfl_up_sync(kFull, k.al[r], 1);
    k.mb[r] = __shfl_up_sync(kFull, k.mb[r], 1);
    k.raw[r] = __shfl_up_sync(kFull, k.raw[r], 1);
    k.pbq[r] = __shfl_up_sync(kFull, k.pbq[r], 1);
    k.mt[r] = __shfl_up_sync(kFull, k.mt[r], 1);
  }
}

// Starts the copy of boundary-row columns [32m, 32m + 32) (0-based) into
// ring buffer m & 1: lane c copies column 32m + c of every field.
template <int R>
__device__ __forceinline__ void fetch_chunk(int* in_ring, const int* G, int Lt,
                                            int ncols, int m, int lane) {
  constexpr int F2 = 2 * l2t::cell_fields<R>();
  const int col = 32 * m + lane;
  if (col < ncols) {
    int* dst = in_ring + (m & 1) * F2 * 32 + lane;
#pragma unroll
    for (int f = 0; f < F2; ++f)
      __pipeline_memcpy_async(dst + f * 32, G + (size_t)f * Lt + col,
                              sizeof(int));
  }
  __pipeline_commit();
}

// One pair, by one warp. `ws` is the warp's shared words, `G` its boundary
// row [2 * cell_fields][Lt].
template <int R>
__device__ void dp_pair_warp(int b, const uint8_t* q, const uint8_t* qu,
                             const int* q_lens, const uint8_t* t,
                             const int* t_lens, const int* regions,
                             const float* conf, int Lq, int Lt,
                             const l2t::Scoring& sc, int* ws, int* G,
                             int* iout, float* fout) {
  constexpr int F = l2t::cell_fields<R>();
  const int lane = threadIdx.x & 31;
  const int ql = q_lens[b];
  const int nrows = l2t::pair_rows(ql, Lq);
  const int ncols = l2t::imax(0, l2t::imin(t_lens[b], Lt));
  l2t::Regions<R> g{};
  if (R > 0) g = l2t::load_regions<R>(regions, b);
  if (nrows == 0 || ncols == 0) {
    if (lane == 0)
      l2t::write_cellless_pair<R>(b, qu, Lq, nrows, ncols, g, sc.ge, iout,
                                  fout);
    return;
  }
  int* in_ring = ws;                    // [2][2F][32]
  int* out_ring = ws + 2 * 2 * F * 32;  // [2F][32]
  int* slot = out_ring + 2 * F * 32;    // [F]: the best cell of row q_len
  const uint8_t* qb = q + (size_t)b * Lq;
  const uint8_t* qub = R > 0 ? qu + (size_t)b * Lq : nullptr;
  const uint8_t* tb = t + (size_t)b * Lt;

  int minq_above = l2t::kBigBq;  // least quality of the rows above the stripe
  int score = INT_MIN, t_end = 0;
  const int nstripes = (nrows + 31) / 32;
  for (int k = 0; k < nstripes; ++k) {
    const int i = 32 * k + lane + 1;
    const bool live = i <= nrows;
    const int rows_here = l2t::imin(32, nrows - 32 * k);
    const bool feed = k + 1 < nstripes;  // lane 31's row seeds stripe k + 1

    l2t::RowConst rc{i, live ? (int)qb[i - 1] : 0, 0, 0, 0.0f};
    int minq = l2t::kBigBq, minq_prev = l2t::kBigBq;
    if constexpr (R > 0) {
      if (live) {
        rc.qq = qub[i - 1];
        rc.qc = conf[rc.qq];
        rc.flank = l2t::imin(rc.qq, i < ql ? (int)qub[i] : l2t::kBigBq);
        minq = rc.qq;
      }
      // least quality of rows 1..i: a min-scan over the lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, minq, d);
        if (lane >= d) minq = l2t::imin(minq, o);
      }
      minq = l2t::imin(minq, minq_above);
      minq_prev = __shfl_up_sync(kFull, minq, 1);
      if (lane == 0) minq_prev = minq_above;
      minq_above = __shfl_sync(kFull, minq, 31);
    }

    // H(i-1, j-1) for column 1 is column 0 of row i-1
    int dH = (i == 1) ? 0 : -(sc.go + sc.ge * (i - 1));
    Bank<R> dB = l2t::col0_bank<R>(i - 1, minq_prev, g, sc.ge);
    l2t::DelState<R> del = l2t::del_start<R>(i, minq, g, sc);
    // the lane's last cell, handed down at the next step
    int hv = 0, vv = l2t::kNegInf;
    Bank<R> hB = dB, vB = dB;
    int tj = 0;
    int tcur = 0, tnext = lane < ncols ? tb[lane] : 0;
    if (k > 0) {
      __syncwarp();  // lane 0 is done with the previous stripe's ring
      fetch_chunk<R>(in_ring, G, Lt, ncols, 0, lane);
    }

    const int nsteps = ncols + rows_here - 1;
    for (int s = 0; s < nsteps; ++s) {
      if ((s & 31) == 0) {
        tcur = tnext;
        tnext = s + 32 + lane < ncols ? tb[s + 32 + lane] : 0;
        if (k > 0) {
          __syncwarp();  // lane 0 is done with the buffer refilled next
          fetch_chunk<R>(in_ring, G, Lt, ncols, (s >> 5) + 1, lane);
          __pipeline_wait_prior(1);
          __syncwarp();
        }
      }
      // t[j-1]: lane 0 takes column s from the chunk, the others the base
      // lane l-1 used one step earlier
      const int t0 = __shfl_sync(kFull, tcur, s & 31);
      tj = __shfl_up_sync(kFull, tj, 1);
      if (lane == 0) tj = t0;
      // H and V at (i-1, j): lane l-1's last cell, or row 32k for lane 0
      int hP = __shfl_up_sync(kFull, hv, 1);
      int vP = __shfl_up_sync(kFull, vv, 1);
      Bank<R> hPB = hB, vPB = vB;
      shfl_up_bank<R>(hPB);
      shfl_up_bank<R>(vPB);
      const int j = s - lane + 1;
      if (lane == 0) {
        if (k == 0) {
          hP = 0;
          vP = l2t::kNegInf;
          hPB = vPB = l2t::row0_bank<R>(j);
        } else {
          const int* c = in_ring + ((s >> 5) & 1) * 2 * F * 32 + (s & 31);
          load_cell<R>(c, 32, hP, hPB);
          load_cell<R>(c + F * 32, 32, vP, vPB);
        }
      }
      if (live && j >= 1 && j <= ncols) {
        l2t::cell<R>(sc, rc, g, j, tj, dH, dB, hP, hPB, vP, vPB, del, hv, hB,
                     vv, vB);
        dH = hP;
        dB = hPB;
        if (i == nrows && hv > score) {  // first maximum of row q_len
          score = hv;
          t_end = j;
          store_cell<R>(slot, 1, hv, hB);
        }
        if (feed && lane == 31) {
          int* c = out_ring + ((j - 1) & 31);
          store_cell<R>(c, 32, hv, hB);
          store_cell<R>(c + F * 32, 32, vv, vB);
        }
      }
      // lane 31 finished a chunk of row 32k + 32: write it to the boundary
      // row, a field per instruction, a column per lane
      const int jw = s - 30;
      if (feed && jw >= 1 && ((jw & 31) == 0 || jw == ncols)) {
        __syncwarp();
        const int col = ((jw - 1) & ~31) + lane;
        if (col < jw) {
#pragma unroll
          for (int f = 0; f < 2 * F; ++f)
            G[(size_t)f * Lt + col] = out_ring[f * 32 + lane];
        }
        __syncwarp();
      }
    }
  }
  if (lane == ((nrows - 1) & 31)) {
    int val;
    Bank<R> ob;
    load_cell<R>(slot, 1, val, ob);
    l2t::write_pair<R>(b, score, t_end, ob, iout, fout);
  }
  __syncwarp();  // the next pair reuses the rings and the slot
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
evidence_dp_kernel(const uint8_t* q, const uint8_t* qu, const int* q_lens,
                   const uint8_t* t, const int* t_lens, const int* regions,
                   const float* conf, int B, int Lq, int Lt, l2t::Scoring sc,
                   int* scratch, int* next_pair, int* iout, float* fout) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  int* ws = smem + warp * warp_words<R>();
  int* G = scratch + (size_t)(blockIdx.x * kWarps + warp) * 2 *
                         l2t::cell_fields<R>() * Lt;
  for (;;) {
    int b = 0;
    if ((threadIdx.x & 31) == 0) b = atomicAdd(next_pair, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= B) return;
    dp_pair_warp<R>(b, q, qu, q_lens, t, t_lens, regions, conf, Lq, Lt, sc,
                    ws, G, iout, fout);
  }
}

// Warps of one launch over B pairs: as many as fit on the card at once (at
// most one per pair), a multiple of kWarps. Each needs a boundary row of
// 2 * cell_fields<R>() * Lt ints of scratch.
template <int R>
int slots(int B, int* out) {
  const size_t smem = block_smem<R>();
  cudaError_t e = cudaFuncSetAttribute(
      evidence_dp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, evidence_dp_kernel<R>, kWarps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = l2t::imin(per_sm * sms, (B + kWarps - 1) / kWarps);
  *out = l2t::imax(1, blocks) * kWarps;
  return 0;
}

template <int R>
int launch(const void* q, const void* qu, const void* q_lens, const void* t,
           const void* t_lens, const void* regions, const void* conf, int B,
           int Lq, int Lt, int match, int mismatch, int go, int ge,
           int n_slots, void* scratch, void* next_pair, void* iout,
           void* fout, void* stream) {
  if (B <= 0 || n_slots < kWarps || n_slots % kWarps != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem<R>();
  cudaError_t e = cudaFuncSetAttribute(
      evidence_dp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  evidence_dp_kernel<R><<<n_slots / kWarps, kWarps * 32, smem,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const uint8_t*)qu, (const int*)q_lens,
      (const uint8_t*)t, (const int*)t_lens, (const int*)regions,
      (const float*)conf, B, Lq, Lt, l2t::Scoring{match, mismatch, go, ge},
      (int*)scratch, (int*)next_pair, (int*)iout, (float*)fout);
  return (int)cudaGetLastError();
}

}  // namespace

#define L2T_ENTRY(R)                                                          \
  extern "C" int l2t_evidence_dp_slots_r##R(int B, int* out) {                \
    return slots<R>(B, out);                                                  \
  }                                                                           \
  extern "C" int l2t_evidence_dp_r##R(                                        \
      const void* q, const void* qu, const void* q_lens, const void* t,       \
      const void* t_lens, const void* regions, const void* conf, int B,       \
      int Lq, int Lt, int match, int mismatch, int go, int ge, int n_slots,   \
      void* scratch, void* next_pair, void* iout, void* fout, void* stream) { \
    return launch<R>(q, qu, q_lens, t, t_lens, regions, conf, B, Lq, Lt,     \
                     match, mismatch, go, ge, n_slots, scratch, next_pair,   \
                     iout, fout, stream);                                     \
  }

L2T_ENTRY(0)
L2T_ENTRY(1)
L2T_ENTRY(2)
L2T_ENTRY(4)
