// Block-max pruned BM25 sweep, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_blockmax_kernel` / `blockmax_scores_pallas`
// (src/repro/kernels/bm25_blockmax/kernel.py:24,42).  Same function:
//
//   impacts   [T, NB, BS] f32   dense block-impact layout
//   block_max [T, NB]     f32   per-(term, block) maxima
//   theta     [1]         f32   top-k threshold, read on the device
//   out       [NB, BS]    f32   out[j, i] = sum_t impacts[t, j, i] if
//                               UB_j = sum_t block_max[t, j] >= theta,
//                               else -inf
//
// Bound: memory.  Each input byte is read at most once and the work is one
// add per byte read, so the least time is
//   bytes = 4 * (T*NB + T*BS*NB_kept + NB*BS)
// over the card's memory rate, where NB_kept counts the blocks whose UB
// reaches theta.
//
// Design: a single pass with a predicate that skips loads.  One thread
// block per doc block j (grid = NB), min(BS, 1024) threads, looping over i
// when BS > 1024.  Every thread sums UB_j serially over t = 0..T-1 (the
// block_max reads of a warp hit one address and broadcast).  A block below
// theta writes -inf and returns without loading its impact tile, so a
// pruned block costs 4*T bytes of reads, not 4*T*BS.  A kept block's thread
// i sums impacts[(t*NB + j)*BS + i] serially over t; neighbouring threads
// read neighbouring addresses, so each term plane is one coalesced row.
//
// Rounding: UB, the scores, the host-side theta pre-pass and the plain
// version all add in term order starting from 0.0f, with no reassociation
// (no fast-math; adds only, so no contraction into FMA).  Rounding is
// monotone, so no document's score can exceed its block's UB, and a block
// holding the k-th best document is never pruned.  theta comes from the
// device, so the pre-pass never waits on the host.

#include <cuda_runtime.h>
#include <math_constants.h>

__global__ void bm25_blockmax_kernel(const float* __restrict__ impacts,
                                     const float* __restrict__ block_max,
                                     const float* __restrict__ theta,
                                     float* __restrict__ out,
                                     int T, int NB, int BS) {
  const long long j = blockIdx.x;
  float ub = 0.0f;
  for (int t = 0; t < T; ++t) ub += block_max[(long long)t * NB + j];
  float* o = out + j * BS;
  // only strictly-below blocks may be skipped: a block at ub == theta may
  // hold a document scoring exactly the k-th best
  if (!(ub >= *theta)) {
    for (int i = threadIdx.x; i < BS; i += blockDim.x) o[i] = -CUDART_INF_F;
    return;
  }
  const long long plane = (long long)NB * BS;
  const float* src = impacts + j * BS;
  for (int i = threadIdx.x; i < BS; i += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += src[t * plane + i];
    o[i] = s;
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Does not synchronise and allocates nothing: the caller owns every buffer.
extern "C" int bm25_blockmax_launch(const void* impacts, const void* block_max,
                                    const void* theta, void* out, int T,
                                    int NB, int BS, void* stream) {
  if (NB <= 0 || BS <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const int threads = BS < 1024 ? BS : 1024;
  bm25_blockmax_kernel<<<NB, threads, 0, (cudaStream_t)stream>>>(
      (const float*)impacts, (const float*)block_max, (const float*)theta,
      (float*)out, T, NB, BS);
  return (int)cudaGetLastError();
}
