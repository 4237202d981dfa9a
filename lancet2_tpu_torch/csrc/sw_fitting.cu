// K3, the score-only fitting DP, for Hopper.
//
// Replaces the Pallas kernel lancet2_tpu/ops/sw_pallas.py `_make_kernel`
// (launched by `fitting_scores_device`, pallas_call at :184), which the JAX
// window step reaches through `_dp_scores_pallas`. The arithmetic is in
// sw_fitting.cuh; this file holds the launch and the plain C entry point
// that lancet2_tpu_torch/ops/sw_cuda.py binds with ctypes. It computes what
// the Pallas kernel computed, without its shape contract: any B, Lq and Lt,
// no 256-pair tiles, no Lq % 8 or Lt % 128 padding, int32 state only.
//
// Design: one thread per pair. The outer loop runs over the pair's own
// q_len query rows, the inner loop over its valid target columns; the
// horizontal gap F is carried in a register along the column sweep. The
// previous row's H and V (8 B per column) live in a global scratch laid out
// [column][pair], so a warp's 32 loads or stores of one column hit one
// contiguous 128-byte line. At the main path's shapes (8192 pairs x 256
// columns, 2048 x 1024) the scratch is 16.8 MB and stays in the 50 MB L2.
//
// What bounds it on the H100: the bound is operations, about 10 int32 ops
// per cell against 64 int32 lanes per SM (132 SMs), so 8192 pairs at Lq 128
// and Lt 256 need at least 0.16 ms at 1.98 GHz; the inputs are 3 MB. This
// design is latency-bound instead: one thread per pair gives a launch of
// 8192 pairs 256 warps, two per SM, and each cell waits on an L2 round trip
// for its H and V. Pairs per launch, or a warp per pair sweeping
// anti-diagonals with the row state in registers, are work for later.

#include <cuda_runtime.h>

#include "sw_fitting.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per block spreads a launch over SMs

__global__ void __launch_bounds__(kThreads)
sw_fitting_kernel(const uint8_t* q, const int32_t* q_lens, const uint8_t* t,
                  const int32_t* t_lens, int B, int Lq, int Lt,
                  l2t_sw::Params p, int32_t* scratch, int32_t* score,
                  int32_t* t_end) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t* H = scratch + b;
  int32_t* V = scratch + (long)Lt * B + b;
  l2t_sw::fitting_pair(q + (long)b * Lq, q_lens[b], Lq, t + (long)b * Lt,
                       t_lens[b], Lt, p, H, V, B, score + b, t_end + b);
}

}  // namespace

// scratch: 2 * Lt * B int32. Returns cudaGetLastError() of the launch.
extern "C" int l2t_sw_fitting(const void* q, const void* q_lens,
                              const void* t, const void* t_lens, int B,
                              int Lq, int Lt, int match, int mismatch, int go,
                              int ge, void* scratch, void* score, void* t_end,
                              void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const l2t_sw::Params p{match, mismatch, go, ge};
  const int blocks = (B + kThreads - 1) / kThreads;
  sw_fitting_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const int32_t*)q_lens, (const uint8_t*)t,
      (const int32_t*)t_lens, B, Lq, Lt, p, (int32_t*)scratch,
      (int32_t*)score, (int32_t*)t_end);
  return (int)cudaGetLastError();
}
