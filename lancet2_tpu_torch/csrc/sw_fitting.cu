// K3, the score-only fitting DP, for Hopper.
//
// Replaces the Pallas kernel lancet2_tpu/ops/sw_pallas.py `_make_kernel`
// (launched by `fitting_scores_device`, pallas_call at :184), which the JAX
// window step reaches through `_dp_scores_pallas`. It computes what the
// Pallas kernel computed, without its shape contract: any B, Lq and Lt, no
// 256-pair tiles, no Lq % 8 or Lt % 128 padding, int32 state only. The cell
// update and the schedule's host twin are in sw_fitting.cuh; this file holds
// the warp's sweep, the launch and the plain C entry points that
// lancet2_tpu_torch/ops/sw_cuda.py binds with ctypes.
//
// What bounds it on the H100: operations. A cell is 10 int32 operations
// (score, diagonal, V 3, Ht 1, F 3, H 1); sm_90a issues 64 int32 lanes per
// SM and clock on 132 SMs, and its three-input VIADDMNMX does an add and a
// max at once, so the floor is 5 issue slots per cell; the inputs and
// outputs are under 3 MB, under 0.01 ms of HBM. So the design keeps every
// word of DP state out of memory and feeds the int32 lanes from enough
// warps to hide each step's dependency chain.
//
// Design: a warp per pair, RPL query rows per lane (sw_fitting.cuh, "The
// schedule"). Lane l owns rows 32 * RPL * k + l * RPL + 1 .. + RPL of stripe
// k and at step s computes its RPL cells of column s - l + 1; the cell above
// its first row comes from lane l-1 with two __shfl_up_sync, the diagonal,
// Ht and F of each row stay in registers. A cell is one prmt (the score,
// from a per-row byte table selected by the target base), and the adds and
// maxes of the recurrence, which ptxas fuses into three VIADDMNMX and one
// VIMNMX. Target bases reach lane 0 from a register that holds the next 32
// columns, one per lane, and pass down the lanes by shuffle beside the cell
// above. RPL is a template parameter picked per launch from Lq (`plan`):
// ceil(Lq / 32) up to 8, so the window step's Lq 128 runs RPL 4 and
// bench.py's Lq 152 RPL 5, each in one stripe; longer queries take stripes
// of up to 256 rows, which meet at a per-pair boundary row of (H, V) in
// device memory, two rows used in turn: lane 31 writes a column each step,
// and the next stripe's lanes load 32 columns at a time, a chunk ahead, and
// hand lane 0 its column by __shfl_sync. Only launches with such queries
// need scratch. Stripes are aligned to the bottom, so lane 31 of the last
// stripe owns row q_len and keeps its first maximum. Blocks of kWarps
// warps, one warp per pair.
//
// Measured on NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_sw_tune.py rpl,
// CUDA events, mean of 20 launches): 0.153 ms for 8192 pairs at Lq 128,
// Lt 256 (RPL 4) and 0.175 ms for 2048 pairs at Lq 152, Lt 1024 (RPL 5),
// about 1.9x the 0.080 and 0.095 ms of the operations floor above; the
// one-thread-per-pair kernel it replaces took 2.9-3.0 and 28.3 ms. Why RPL
// = ceil(Lq / 32): one stripe with the fewest dead rows was fastest at both
// shapes; each further row per lane cost 0.02 ms, and fewer rows per lane,
// with two or more stripes, 0.206-0.413 ms. ptxas (sm_90a,
// --fmad=false): RPL 4 55 registers, RPL 5 56, no spills, 36 resident
// warps per SM at kWarps 4; the multi-stripe instantiations take 51-96
// registers, RPL 6 spilling 8 bytes.

#include <cuda_runtime.h>

#include "sw_fitting.cuh"

namespace {

constexpr int kWarps = 4;  // pairs per block
constexpr unsigned kFull = 0xffffffffu;

using l2t_sw::kNegInf;

// Column 32 * m + lane of a boundary row, or row 0's cell past ncols.
__device__ __forceinline__ int2 boundary_chunk(const int2* G, int ncols,
                                               int m, int lane) {
  const int col = 32 * m + lane;
  return col < ncols ? G[col] : make_int2(0, kNegInf);
}

__device__ __forceinline__ int target_at(const uint8_t* tb, int ncols,
                                         int col) {
  return col >= 0 && col < ncols ? (int)tb[col] : 4;
}

// One stripe of one pair: the warp's lanes hold rows rowbase + 1 .. +
// 32 * RPL. Gin is the boundary row above (unused in the first stripe),
// Gout the one below (unused in the last); lane 31 of the last stripe
// leaves the first maximum of row q_len in best and best_j.
template <int RPL, bool kFirst, bool kLast>
__device__ __forceinline__ void stripe(const uint8_t* __restrict__ qb,
                                       const uint8_t* __restrict__ tb,
                                       int ncols, int rowbase, int lane,
                                       const l2t_sw::Params& p,
                                       const int2* Gin, int2* Gout,
                                       int32_t& best, int32_t& best_j) {
  const int32_t goe = p.go + p.ge, ge = p.ge;
  l2t_sw::Lane<RPL> L;
  l2t_sw::lane_init<RPL>(L, qb, rowbase + lane * RPL + 1, p);
  int32_t hv = 0, vv = kNegInf;  // the lane's last row, handed down
  const int s0 = kFirst ? l2t_sw::first_step<RPL>(rowbase) : 0;
  const int end = ncols + 31;
  int2 gcur = make_int2(0, kNegInf), gnext = gcur;
  if (!kFirst) {
    gcur = boundary_chunk(Gin, ncols, 0, lane);
    gnext = boundary_chunk(Gin, ncols, 1, lane);
  }
  // target bases: lane 0 takes column s from tcur (columns of this chunk
  // of 32, one per lane), the others the base lane - 1 had a step before
  int tcur = target_at(tb, ncols, lane), tnext = target_at(tb, ncols, 32 + lane);
  int tj = target_at(tb, ncols, s0 - 1 - lane);  // the lane's last base

  auto step = [&](int s, auto guarded) {
    constexpr bool kGuarded = decltype(guarded)::value;
    const int j = s - lane + 1;
    int32_t h = __shfl_up_sync(kFull, hv, 1);
    int32_t v = __shfl_up_sync(kFull, vv, 1);
    if (kFirst) {
      if (lane == 0) {
        h = 0;
        v = kNegInf;
      }
    } else {
      const int32_t gh = __shfl_sync(kFull, gcur.x, s & 31);
      const int32_t gv = __shfl_sync(kFull, gcur.y, s & 31);
      if (lane == 0) {
        h = gh;
        v = gv;
      }
    }
    const bool live = !kGuarded || (j >= 1 && j <= ncols);
    const int t0 = __shfl_sync(kFull, tcur, s & 31);
    tj = __shfl_up_sync(kFull, tj, 1);
    if (lane == 0) tj = t0;
    if (live) {
      l2t_sw::lane_step<RPL>(L, l2t_sw::target_selector(tj), goe, ge, h, v);
      hv = h;
      vv = v;
    }
    if (!kGuarded) {  // lane 31 is at column s - 30, in 1..ncols
      if (kLast) {
        if (hv > best) {
          best = hv;
          best_j = j;
        }
      } else if (lane == 31) {
        Gout[j - 1] = make_int2(hv, vv);
      }
    }
  };

  int s = s0;
  for (; s < 31; ++s) step(s, std::true_type{});
  while (s < end) {
    if ((s & 31) == 0) {  // the next chunk of 32 columns, one ahead
      if (!kFirst) {
        gcur = gnext;
        gnext = boundary_chunk(Gin, ncols, (s >> 5) + 1, lane);
      }
      tcur = tnext;
      tnext = target_at(tb, ncols, s + 32 + lane);
    }
    const int stop = l2t_sw::min32(end, (s | 31) + 1);
#pragma unroll 4
    for (; s < stop; ++s) step(s, std::false_type{});
  }
}

// One warp per pair. kMulti: queries may need more than one stripe, and
// scratch holds two boundary rows of Lt (H, V) per pair.
template <int RPL, bool kMulti>
__global__ void __launch_bounds__(kWarps * 32)
sw_fitting_kernel(const uint8_t* __restrict__ q,
                  const int32_t* __restrict__ q_lens,
                  const uint8_t* __restrict__ t,
                  const int32_t* __restrict__ t_lens, int B, int Lq, int Lt,
                  l2t_sw::Params p, int2* scratch, int32_t* score,
                  int32_t* t_end) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int ql = q_lens[b];
  const int ncols = l2t_sw::min32(t_lens[b], Lt);
  int32_t sc, te;
  if (l2t_sw::cellless(ql, Lq, ncols, &sc, &te)) {
    if (lane == 0) {
      score[b] = sc;
      t_end[b] = te;
    }
    return;
  }
  const uint8_t* qb = q + (size_t)b * Lq;
  const uint8_t* tb = t + (size_t)b * Lt;
  constexpr int kRows = 32 * RPL;
  int32_t best = kNegInf, best_j = 1;
  if (!kMulti) {
    stripe<RPL, true, true>(qb, tb, ncols, ql - kRows, lane, p, nullptr,
                            nullptr, best, best_j);
  } else {
    const int nst = (ql + kRows - 1) / kRows;
    const int base = ql - nst * kRows;
    int2* G = scratch + (size_t)b * 2 * Lt;
    if (nst == 1) {
      stripe<RPL, true, true>(qb, tb, ncols, base, lane, p, nullptr, nullptr,
                              best, best_j);
    } else {
      stripe<RPL, true, false>(qb, tb, ncols, base, lane, p, nullptr, G,
                               best, best_j);
      for (int k = 1; k < nst - 1; ++k) {
        __syncwarp();  // stripe k-1's row is written, stripe k-2's read
        stripe<RPL, false, false>(qb, tb, ncols, base + k * kRows, lane, p,
                                  G + ((k + 1) & 1) * Lt, G + (k & 1) * Lt,
                                  best, best_j);
      }
      __syncwarp();
      const int k = nst - 1;
      stripe<RPL, false, true>(qb, tb, ncols, base + k * kRows, lane, p,
                               G + ((k + 1) & 1) * Lt, nullptr, best, best_j);
    }
  }
  if (lane == 31) {
    score[b] = best;
    t_end[b] = best_j;
  }
}

template <int RPL, bool kMulti>
int launch_kernel(const void* q, const void* q_lens, const void* t,
                  const void* t_lens, int B, int Lq, int Lt,
                  const l2t_sw::Params& p, void* scratch, void* score,
                  void* t_end, void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  sw_fitting_kernel<RPL, kMulti><<<blocks, kWarps * 32, 0,
                                   (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const int32_t*)q_lens, (const uint8_t*)t,
      (const int32_t*)t_lens, B, Lq, Lt, p, (int2*)scratch, (int32_t*)score,
      (int32_t*)t_end);
  return (int)cudaGetLastError();
}

template <int RPL>
int launch_rpl(const void* q, const void* q_lens, const void* t,
               const void* t_lens, int B, int Lq, int Lt,
               const l2t_sw::Params& p, void* scratch, void* score,
               void* t_end, void* stream) {
  if (Lq > 32 * RPL) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return launch_kernel<RPL, true>(q, q_lens, t, t_lens, B, Lq, Lt, p,
                                    scratch, score, t_end, stream);
  }
  return launch_kernel<RPL, false>(q, q_lens, t, t_lens, B, Lq, Lt, p,
                                   scratch, score, t_end, stream);
}

template <int RPL, bool kMulti>
int warps_per_sm(int* out) {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sw_fitting_kernel<RPL, kMulti>, kWarps * 32, 0);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * kWarps;
  return 0;
}

}  // namespace

// Rows per lane of a launch at Lq (0 for an Lq the kernel cannot take).
extern "C" int l2t_sw_fitting_rpl_for(int Lq) {
  return Lq >= 0 ? l2t_sw::plan(Lq).rpl : 0;
}

// Bytes of scratch a launch needs: two boundary rows per pair when queries
// of Lq rows take more than one stripe, else 0.
extern "C" long long l2t_sw_fitting_scratch_bytes(int B, int Lq, int Lt) {
  if (Lq <= 32 * l2t_sw::plan(Lq).rpl || B <= 0 || Lt <= 0) return 0;
  return (long long)B * 2 * Lt * (long long)sizeof(int2);
}

// Resident warps (pairs in flight) per SM of the kernel at rpl, single- or
// multi-stripe. Returns a CUDA error code.
extern "C" int l2t_sw_fitting_warps_per_sm(int rpl, int multi, int* out) {
#define L2T_CASE(R) \
  case R:           \
    return multi ? warps_per_sm<R, true>(out) : warps_per_sm<R, false>(out);
  switch (rpl) {
    L2T_CASE(1)
    L2T_CASE(2)
    L2T_CASE(3)
    L2T_CASE(4)
    L2T_CASE(5)
    L2T_CASE(6)
    L2T_CASE(7)
    L2T_CASE(8)
  }
#undef L2T_CASE
  return (int)cudaErrorInvalidValue;
}

// The launch at the plan's rows per lane for Lq. scratch:
// l2t_sw_fitting_scratch_bytes(B, Lq, Lt) bytes, or null when that is 0.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take (scores outside a signed byte).
extern "C" int l2t_sw_fitting(const void* q, const void* q_lens,
                              const void* t, const void* t_lens, int B,
                              int Lq, int Lt, int match, int mismatch, int go,
                              int ge, void* scratch, void* score, void* t_end,
                              void* stream) {
  const l2t_sw::Params p{match, mismatch, go, ge};
  if (B <= 0 || Lq < 0 || Lt < 0 || !l2t_sw::scores_fit(p))
    return (int)cudaErrorInvalidValue;
#define L2T_CASE(R)                                                       \
  case R:                                                                 \
    return launch_rpl<R>(q, q_lens, t, t_lens, B, Lq, Lt, p, scratch,     \
                         score, t_end, stream);
  switch (l2t_sw::plan(Lq).rpl) {
    L2T_CASE(1)
    L2T_CASE(2)
    L2T_CASE(3)
    L2T_CASE(4)
    L2T_CASE(5)
    L2T_CASE(6)
    L2T_CASE(7)
    L2T_CASE(8)
  }
#undef L2T_CASE
  return (int)cudaErrorInvalidValue;
}
