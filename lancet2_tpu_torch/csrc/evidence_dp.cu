// K1 (span, R = 0) and K2 (evidence, R in {1, 2, 4}) for Hopper.
//
// Replaces the Pallas kernel generator lancet2_tpu/ops/evidence_pallas.py
// `_make_kernel` (launched by `_run_span`, pallas_call at :514, and by `_run`,
// pallas_call at :546). The arithmetic is in evidence_dp.cuh; this file
// holds the launch and the plain C entry points that
// lancet2_tpu_torch/ops/evidence_cuda.py binds with ctypes.
//
// Design: one thread per pair. The outer loop runs over query rows, the
// inner loop over target columns 1..t_len; cells past t_len never reach an
// extracted output, so they are not computed. The previous row's H and V
// cells (value plus companions) live in a global scratch laid out
// [field][column][pair], so a warp's 32 loads or stores of one field hit one
// contiguous 128-byte line. The deletion state is carried in registers along
// the column sweep as the best source column and its bank, which makes every
// deletion distance exact: no descent cap, no taint, no host rerun.
//
// What bounds it on the H100: at the launch size the genotyper uses, latency
// more than bytes. Each cell reads and writes 2 * (3 + 6R) words of scratch
// (48 B for the span kernel, 432 B for R = 4), a scratch larger than L2 at
// B = 8192 and Lt = 384. But one thread per pair gives a launch of 8192
// pairs only 128 blocks of 64 threads, about two warps per SM. Measured on
// NVIDIA H100 80GB HBM3 at 700 W: the span kernel takes 46.1 ms for 8192
// pairs (Lq 160, Lt 384) in a launch of 8192, and 12.0 ms per 8192 pairs in
// a launch of 65536. R = 4 needs 255 registers and spills. The design keeps
// the arithmetic simple and exact first; larger launches, and row tiles held
// in shared memory or registers, are work for later.

#include <cuda_runtime.h>

#include "evidence_dp.cuh"

namespace {

constexpr int kThreads = 64;  // small blocks spread a chunk over more SMs

template <int R>
__global__ void __launch_bounds__(kThreads)
evidence_dp_kernel(const uint8_t* q, const uint8_t* qu, const int* q_lens,
                   const uint8_t* t, const int* t_lens, const int* regions,
                   const float* conf, int B, int Lq, int Lt, int match,
                   int mismatch, int go, int ge, int* scratch, int* iout,
                   float* fout) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  l2t::dp_pair<R>(b, q, qu, q_lens, t, t_lens, regions, conf, B, Lq, Lt,
                  match, mismatch, go, ge, scratch, iout, fout);
}

template <int R>
int launch(const void* q, const void* qu, const void* q_lens, const void* t,
           const void* t_lens, const void* regions, const void* conf, int B,
           int Lq, int Lt, int match, int mismatch, int go, int ge,
           void* scratch, void* iout, void* fout, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  evidence_dp_kernel<R><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const uint8_t*)qu, (const int*)q_lens,
      (const uint8_t*)t, (const int*)t_lens, (const int*)regions,
      (const float*)conf, B, Lq, Lt, match, mismatch, go, ge, (int*)scratch,
      (int*)iout, (float*)fout);
  return (int)cudaGetLastError();
}

}  // namespace

#define L2T_ENTRY(R)                                                          \
  extern "C" int l2t_evidence_dp_r##R(                                        \
      const void* q, const void* qu, const void* q_lens, const void* t,       \
      const void* t_lens, const void* regions, const void* conf, int B,       \
      int Lq, int Lt, int match, int mismatch, int go, int ge, void* scratch, \
      void* iout, void* fout, void* stream) {                                 \
    return launch<R>(q, qu, q_lens, t, t_lens, regions, conf, B, Lq, Lt,     \
                     match, mismatch, go, ge, scratch, iout, fout, stream);   \
  }

L2T_ENTRY(0)
L2T_ENTRY(1)
L2T_ENTRY(2)
L2T_ENTRY(4)
