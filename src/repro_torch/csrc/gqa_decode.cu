// Flash-decoding GQA attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` / `gqa_decode_pallas`
// (src/repro/kernels/gqa_decode/kernel.py:25,62).  Same function, one query
// token per sequence against its KV cache:
//
//   q       [B, Hkv, G, D]  float32 or bfloat16, contiguous
//   k, v    [B, S, Hkv, D]  same type, contiguous (one layer of the
//                           [L, B, S, Hkv, D] cache is such a slice)
//   length  [B] int32       valid prefix of each sequence
//   out     [B, Hkv, G, D]  q's type
//
//   scale = 1/sqrt(D) in float32; scores = (q . k) * scale in float32
//   (bfloat16 widened); positions at or past min(length[b], S) do not
//   count and are never read; length 0 gives zeros, as the Pallas kernel's
//   acc / max(l, 1e-30) over tiles it skipped.  The plain version is
//   kernels/gqa_decode/ref.py.
//
// Bound: memory.  The least traffic is the valid K and V rows read once,
// plus q and out: bytes = 2 * sum_b min(length_b, S) * Hkv * D * elt
// + 2 * B * Hkv * G * D * elt.  Operations are 4 * sum_b min(length_b, S)
// * Hkv * G * D, G <= 8 flops a byte: far under the card's rate.  At one
// layer of Qwen2.5-14B with 4 sequences at 32k (bf16, [4, 32768, 8, 128],
// G = 5) that is 0.537 GB, 0.160 ms at 3.35 TB/s (H100 SXM data sheet).
//
// Design.  The TPU grid (B, Hkv, KV tiles) walks the tile axis in order on
// one core and carries the online softmax (m, l, acc) in VMEM scratch.  A
// CUDA grid has no order, and one block per (b, h) would launch 32 blocks
// at the 32k shape on 132 SMs.  So this is split-KV flash decoding, two
// kernels:
//   partial  grid (B*Hkv, n_split).  A block loads the G query rows of its
//            (b, h) once into registers and walks its split's positions
//            [lo, min(hi, length, S)).  TPR = pow2 >= D/8 threads share
//            one K/V row, 8 elements each (one 16-byte load per row for
//            bfloat16), so a block holds 128/TPR row groups, each with its
//            own online softmax per query row in float32 over U rows per
//            step (their loads issued together).  The row groups merge in
//            shared memory and the block writes one partial (m, l,
//            acc[G, D]) in float32.  A split wholly past length writes
//            m = -1e30, l = 0 and loads nothing: the `pl.when(base <
//            length)` skip.
//   combine  grid (B*Hkv*G), a thread per element of D.  m* = max m_i,
//            l = sum l_i e^(m_i - m*), out = sum acc_i e^(m_i - m*) /
//            max(l, 1e-30), over the splits with l_i > 0, cast to q's
//            type.
// The wrapper picks n_split from B*Hkv and S alone (never from length), so
// the card gets a few blocks per SM.  G <= 8 query rows give no tile for a
// tensor-core product: the dots are float32 FMAs, wgmma and TMA do not
// apply.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Rows each row group keeps in flight per step (U).  2 was the fastest
// bfloat16 setting at both the 32k and the 500k shape with 8 blocks an SM
// (`python -m repro_torch.launch.decode_sweep`, which builds the others;
// PERF.md): 128 registers at G = 5 against 168 at U = 4.
#ifndef GQA_ROWS_IN_FLIGHT
#define GQA_ROWS_IN_FLIGHT 2
#endif

constexpr int kThreads = 128;
constexpr int kVec = 8;            // elements of D per thread
constexpr int kMaxD = 32 * kVec;   // the combine's block: one thread a d
constexpr float kNegInf = -1e30f;

// Eight elements of a row in registers, loaded with 16-byte vector loads.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void widen(float (&f)[kVec]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { a = make_uint4(0u, 0u, 0u, 0u); }
  // bfloat16 is the high half of a float32: widening is a shift (exact).
  __device__ __forceinline__ void widen(float (&f)[kVec]) const {
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gqa_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ length,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int s, int hkv, int d,
                   int tpr, int n_split, int chunk, float scale) {
  constexpr int U = GQA_ROWS_IN_FLIGHT;
  __shared__ float sm_m[kThreads][G];
  __shared__ float sm_l[kThreads][G];
  __shared__ float sm_acc[kThreads * kVec * G];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / hkv, h = bh - b * hkv;
  const long long part = (long long)bh * n_split + split;
  const int len = min(max(length[b], 0), s);
  const int lo = split * chunk;
  const int hi = min(lo + chunk, len);
  if (lo >= hi) {
    if (threadIdx.x < G) {
      m_part[part * G + threadIdx.x] = kNegInf;
      l_part[part * G + threadIdx.x] = 0.f;
    }
    return;
  }

  const int tid = threadIdx.x;
  const int row = tid / tpr, lane = tid - row * tpr;
  const int rows = kThreads / tpr;
  const int e0 = lane * kVec;
  const bool active = e0 < d;  // D/8 need not be a power of two

  float qf[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Vec8<T> x;
    if (active) {
      x.load(q + ((long long)bh * G + g) * d + e0);
    } else {
      x.zero();
    }
    x.widen(qf[g]);
  }
  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  const long long pos_stride = (long long)hkv * d;
  const long long base_off = ((long long)b * s * hkv + h) * d + e0;
  const T* kb = k + base_off;
  const T* vb = v + base_off;

  // The trip count is the same for every thread of the block, so the
  // shuffles below always run with the whole warp.
  for (int base = lo; base < hi; base += rows * U) {
    Vec8<T> kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + row + u * rows;
      ok[u] = p < hi;
      if (ok[u] && active) {
        kr[u].load(kb + p * pos_stride);
        vr[u].load(vb + p * pos_stride);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[kVec];
      kr[u].widen(kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qf[g][e], kf[e], dot);
        sc[u][g] = dot;
      }
    }
    for (int off = tpr >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
        }
      }
    }
    float vf[U][kVec];
#pragma unroll
    for (int u = 0; u < U; ++u) vr[u].widen(vf[u]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][g] *= scale;
        if (ok[u]) mx = fmaxf(mx, sc[u][g]);
      }
      const float alpha = __expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? __expf(sc[u][g] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // Merge the row groups: rescale each to the block's max, then sum.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) sm_m[row][g] = m[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mstar = sm_m[0][g];
    for (int r = 1; r < rows; ++r) mstar = fmaxf(mstar, sm_m[r][g]);
    const float w = __expf(m[g] - mstar);
    if (lane == 0) sm_l[row][g] = l[g] * w;
    if (active) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sm_acc[(row * G + g) * d + e0 + e] = acc[g][e] * w;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * d; i += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += sm_acc[r * G * d + i];
    acc_part[part * G * d + i] = sum;
  }
  if (tid < G) {
    float mstar = sm_m[0][tid], lsum = 0.f;
    for (int r = 1; r < rows; ++r) mstar = fmaxf(mstar, sm_m[r][tid]);
    for (int r = 0; r < rows; ++r) lsum += sm_l[r][tid];
    m_part[part * G + tid] = mstar;
    l_part[part * G + tid] = lsum;
  }
}

// One block per query row (b, h, g), one thread per element of D.
template <typename T>
__global__ void __launch_bounds__(kMaxD)
gqa_combine_kernel(const float* __restrict__ m_part,
                   const float* __restrict__ l_part,
                   const float* __restrict__ acc_part, T* __restrict__ out,
                   int n_split, int g, int d) {
  const int row = blockIdx.x, t = threadIdx.x;
  const int bh = row / g, gi = row - bh * g;
  if (t >= d) return;
  const long long part0 = (long long)bh * n_split;
  float mstar = kNegInf;
  for (int j = 0; j < n_split; ++j) {
    if (l_part[(part0 + j) * g + gi] > 0.f) {
      mstar = fmaxf(mstar, m_part[(part0 + j) * g + gi]);
    }
  }
  float lsum = 0.f, o = 0.f;
#pragma unroll 8
  for (int j = 0; j < n_split; ++j) {
    const long long p = (part0 + j) * g + gi;
    const float lj = l_part[p];
    if (lj > 0.f) {  // a split past length wrote no acc
      const float w = __expf(m_part[p] - mstar);
      lsum = fmaf(lj, w, lsum);
      o = fmaf(acc_part[p * d + t], w, o);
    }
  }
  store(out + (long long)row * d + t, o / fmaxf(lsum, 1e-30f));
}

template <typename T, int G>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* length, void* out, float* part, int b, int s,
                int hkv, int d, int n_split, int chunk, float scale,
                cudaStream_t stream) {
  int tpr = 1;
  while (tpr * kVec < d) tpr <<= 1;
  const long long n_part = (long long)b * hkv * n_split * G;
  float* m_part = part;
  float* l_part = part + n_part;
  float* acc_part = part + 2 * n_part;
  gqa_partial_kernel<T, G><<<dim3(b * hkv, n_split), kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length, m_part,
      l_part, acc_part, s, hkv, d, tpr, n_split, chunk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gqa_combine_kernel<T><<<b * hkv * G, (d + 31) / 32 * 32, 0, stream>>>(
      m_part, l_part, acc_part, (T*)out, n_split, G, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int g, const void* q, const void* k, const void* v,
                     const void* length, void* out, float* part, int b,
                     int s, int hkv, int d, int n_split, int chunk,
                     float scale, cudaStream_t stream) {
#define GQA_CASE(G_)                                                       \
  case G_:                                                                 \
    return run<T, G_>(q, k, v, length, out, part, b, s, hkv, d, n_split,   \
                      chunk, scale, stream);
  switch (g) {
    GQA_CASE(1) GQA_CASE(2) GQA_CASE(3) GQA_CASE(4)
    GQA_CASE(5) GQA_CASE(6) GQA_CASE(7) GQA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef GQA_CASE
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 =
// launched).  Does not synchronise and allocates nothing: `part` is the
// caller's float32 scratch of B*Hkv*n_split*G*(D + 2) entries.
extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const void* length, void* out, void* part,
                                 int b, int s, int hkv, int g, int d,
                                 int n_split, int chunk, float scale,
                                 int bf16, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || d <= 0 || d % kVec != 0 ||
      d > kMaxD || n_split <= 0 || chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = (cudaStream_t)stream;
  const auto p = (float*)part;
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(g, q, k, v, length, out, p, b, s, hkv,
                                     d, n_split, chunk, scale, st)
           : dispatch<float>(g, q, k, v, length, out, p, b, s, hkv, d,
                             n_split, chunk, scale, st);
  return (int)err;
}
