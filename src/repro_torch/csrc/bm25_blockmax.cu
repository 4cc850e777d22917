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
// Design: a warp a doc block, kWarps warps a block, one doc block a warp
// (grid = ceil(NB / kWarps)).  Lane i holds VEC consecutive documents
// (VEC = 4: one 16-byte load of each term plane, 32 * 4 = BS = 128 in one
// pass; VEC = 1 when the pointers are off 16 bytes or BS % 4 != 0; BS
// wider than 32 * VEC takes passes).  Lane t loads block_max[t, j] and
// the warp sums UB_j by shuffles in term order (theta loads beside it).
// If UB_j >= theta, the warp issues the loads of all T planes before the
// first add (T is a template parameter for 1..16; kChunk planes at a time
// for T > 16), adds them in term order and stores.  A pruned block stores
// -inf and loads no impact tile.  Impact loads are marked evict-first
// (read once).  A grid sized to the card, each warp walking doc blocks
// with the next block's maxima loaded under this block's loads, measured
// 1-2 % slower on an H100 than this (PERF.md).  wgmma and TMA do not
// apply: no products, and a tile is one 512-byte row a plane.
//
// Rounding: UB, the scores, the host-side theta pre-pass and the plain
// version all add in term order starting from 0.0f, with no reassociation
// (no fast-math; adds only, so no contraction into FMA).  Rounding is
// monotone, so no document's score can exceed its block's UB, and a block
// holding the k-th best document is never pruned.  theta comes from the
// device, so the pre-pass never waits on the host.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTerms = 16;          // T templated up to here
constexpr int kChunk = 8;              // planes in flight for T > kMaxTerms
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Docs;

template <>
struct Docs<4> {
  using V = float4;
  static __device__ __forceinline__ V zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ V fill(float x) {
    return make_float4(x, x, x, x);
  }
  static __device__ __forceinline__ V load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(V& s, const V& x) {
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  static __device__ __forceinline__ void store(float* p, const V& s) {
    *reinterpret_cast<float4*>(p) = s;
  }
};

template <>
struct Docs<1> {
  using V = float;
  static __device__ __forceinline__ V zero() { return 0.f; }
  static __device__ __forceinline__ V fill(float x) { return x; }
  static __device__ __forceinline__ V load(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void add(V& s, const V& x) { s += x; }
  static __device__ __forceinline__ void store(float* p, const V& s) {
    *p = s;
  }
};

// UB_j = sum_t block_max[t, j] in term order from 0.0f: lane u loads plane
// t0 + u, and the sum takes them by shuffles.  Every lane gets the sum.
__device__ __forceinline__ float upper_bound(const float* __restrict__ bm,
                                             long long nb, long long j,
                                             int t, int lane) {
  float ub = 0.f;
  for (int t0 = 0; t0 < t; t0 += 32) {
    const float v =
        t0 + lane < t ? __ldg(bm + (long long)(t0 + lane) * nb + j) : 0.f;
    const int n = min(32, t - t0);
    for (int u = 0; u < n; ++u) ub += __shfl_sync(kFull, v, u);
  }
  return ub;
}

// TC > 0: T == TC, known here.  TC == 0: T at run time, kChunk planes at a
// time (T > kMaxTerms, and T == 0).
template <int TC, int VEC>
__global__ void __launch_bounds__(kThreads)
    bm25_blockmax_kernel(const float* __restrict__ impacts,
                         const float* __restrict__ block_max,
                         const float* __restrict__ theta,
                         float* __restrict__ out, int t_run, int nb,
                         int bs) {
  using D = Docs<VEC>;
  constexpr int kIn = TC > 0 ? TC : kChunk;   // planes before the first add
  const int t = TC > 0 ? TC : t_run;
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= nb) return;                  // the whole warp leaves together
  const float th = __ldg(theta);
  const float ub = upper_bound(block_max, nb, j, t, lane);
  float* o = out + j * bs;
  // only strictly-below blocks may be skipped: a block at ub == theta may
  // hold a document scoring exactly the k-th best
  if (!(ub >= th)) {
    for (int e = lane * VEC; e < bs; e += 32 * VEC)
      D::store(o + e, D::fill(-CUDART_INF_F));
    return;
  }
  const long long plane = (long long)nb * bs;
  const float* src = impacts + j * bs;
  for (int e = lane * VEC; e - lane * VEC < bs; e += 32 * VEC) {
    const bool in = e < bs;
    typename D::V s = D::zero();
    for (int t0 = 0; t0 < t; t0 += kIn) {
      typename D::V x[kIn];
#pragma unroll
      for (int u = 0; u < kIn; ++u) {
        x[u] = D::zero();
        if (in && (TC > 0 || t0 + u < t))
          x[u] = D::load(src + (t0 + u) * plane + e);
      }
#pragma unroll
      for (int u = 0; u < kIn; ++u)
        if (TC > 0 || t0 + u < t) D::add(s, x[u]);
    }
    if (in) D::store(o + e, s);
  }
}

template <int TC>
cudaError_t launch_t(const float* impacts, const float* block_max,
                     const float* theta, float* out, int t, int nb, int bs,
                     int vec, int grid, cudaStream_t s) {
  if (vec)
    bm25_blockmax_kernel<TC, 4>
        <<<grid, kThreads, 0, s>>>(impacts, block_max, theta, out, t, nb, bs);
  else
    bm25_blockmax_kernel<TC, 1>
        <<<grid, kThreads, 0, s>>>(impacts, block_max, theta, out, t, nb, bs);
  return cudaGetLastError();
}

template <int TC>
cudaError_t dispatch(const float* impacts, const float* block_max,
                     const float* theta, float* out, int t, int nb, int bs,
                     int vec, int grid, cudaStream_t s) {
  if (t == TC)
    return launch_t<TC>(impacts, block_max, theta, out, t, nb, bs, vec, grid,
                        s);
  if constexpr (TC < kMaxTerms)
    return dispatch<TC + 1>(impacts, block_max, theta, out, t, nb, bs, vec,
                            grid, s);
  return launch_t<0>(impacts, block_max, theta, out, t, nb, bs, vec, grid, s);
}

}  // namespace

// The kernel's warps a block, so the wrapper's launch plan can be checked
// against the library.
extern "C" int bm25_blockmax_warps() { return kWarps; }

// Launches on `stream` over `grid` blocks and returns cudaGetLastError()
// (0 = launched).  vec selects 16-byte loads and stores: impacts and out
// 16-byte aligned and BS % 4 == 0.  Does not synchronise and allocates
// nothing: the caller owns every buffer.
extern "C" int bm25_blockmax_launch(const void* impacts, const void* block_max,
                                    const void* theta, void* out, int T,
                                    int NB, int BS, int vec, int grid,
                                    void* stream) {
  if (NB <= 0 || BS <= 0 || T < 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)grid * kWarps < NB)     // a doc block would go unwritten
    return (int)cudaErrorInvalidConfiguration;
  if (vec && (BS % 4 != 0 || (reinterpret_cast<size_t>(impacts) |
                               reinterpret_cast<size_t>(out)) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch<1>((const float*)impacts, (const float*)block_max,
                          (const float*)theta, (float*)out, T, NB, BS, vec,
                          grid, (cudaStream_t)stream);
}
