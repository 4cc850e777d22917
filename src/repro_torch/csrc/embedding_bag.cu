// EmbeddingBag (padded bags), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bag_kernel` / `embedding_bag_pallas`
// (src/repro/kernels/embedding_bag/kernel.py:23,38).  Same function:
//
//   table    [V, D]  float32 or bfloat16, contiguous
//   indices  [B, L]  int32, padded (padding carries weight 0)
//   weights  [B, L]  float32
//   out      [B, D]  table's type:
//                    out[b] = sum_i weights[b, i] * table[indices[b, i]]
//
// accumulated in float32 in bag order, acc = acc + w * row, and cast to the
// table's type once at the end (the Pallas body's fori_loop).  Each add and
// each product is written __fadd_rn / __fmul_rn, so nvcc contracts nothing
// into an FMA and the result equals the plain version (kernels/
// embedding_bag/ref.py, embedding_bag_padded_ref) bit for bit in float32;
// a bag of one with weight 1 is table[id] exactly.  Row ids follow
// jnp.take's rule: an id in [-V, 0) wraps to id + V, an id outside [-V, V)
// reads a row of NaN (0 * NaN is NaN, so padding never hides it).  Rows are
// addressed with 64-bit offsets: DLRM-RM2's 26 stacked tables viewed as
// [26 M, 64] are 6.66 GB.
//
// Bound: memory.  The least traffic is every distinct row the batch names,
// read once, plus ids, weights and the output: bytes = rows * D * elt +
// 8 * B * L + B * D * elt.  Two flops an item and element is far under
// the card's rate.  At two-tower's serve_bulk history bag ([262,144, 8]
// over 1 M x 256 float32) with uniform ids, 2.1 M ids name about 0.88 M
// distinct rows: about 1.18 GB, 0.35 ms at 3.35 TB/s (H100 SXM data
// sheet).  Zipf ids repeat rows more, and the repeats come from the 50 MB
// L2.
//
// Design.  The TPU grid runs one program per bag and fetches one row per
// loop step, with the bag's ids scalar-prefetched into SMEM.  Here one
// warp owns a bag and its lanes lie across D: VEC consecutive elements a
// lane (one 16-byte load when D is a multiple of 16 bytes' worth and the
// table is 16-byte aligned, else scalar loads), CH vectors a lane, passes
// of CH * 32 * VEC elements for wider rows.  A block holds kWarps bags, so
// D = 64 still launches B / 8 blocks.  The warp reads 32 of its bag's ids
// and weights at once, one a lane, and broadcasts them with shuffles (the
// scalar prefetch); it issues the loads of U rows before it adds any of
// them, so each warp keeps U rows in flight, and adds them in bag order.
// No shared memory, no atomics, no order between blocks.  wgmma and TMA do
// not apply (no products; rows are gathered, not tiled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // bags per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsInFlight = 4;       // U
constexpr unsigned kFull = 0xffffffffu;

// VEC elements of a row: the raw load, its widening to float, the store.
template <typename T, int VEC>
struct Io;

template <>
struct Io<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* x) {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Io<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* x) {
    x[0] = r;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *p = x[0];
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* x) {
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    uint4 r;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& r, float* x) {
    x[0] = __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    *p = __float2bfloat16_rn(x[0]);
  }
};

template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const T* __restrict__ table,
                         const int* __restrict__ indices,
                         const float* __restrict__ weights,
                         T* __restrict__ out, long long v, long long n_bags,
                         int l, int d) {
  using IO = Io<T, VEC>;
  constexpr int kSpan = CH * 32 * VEC;
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;           // the whole warp leaves together
  const int* bag_ids = indices + bag * l;
  const float* bag_w = weights + bag * l;
  const float nan = __int_as_float(0x7fc00000);

  for (int base = 0; base < d; base += kSpan) {
    float acc[CH][VEC];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.0f;
    }
    for (int i0 = 0; i0 < l; i0 += 32) {
      const int n = min(32, l - i0);
      int my_id = 0;
      float my_w = 0.0f;
      if (lane < n) {
        my_id = __ldg(bag_ids + i0 + lane);
        my_w = __ldg(bag_w + i0 + lane);
      }
      for (int j = 0; j < n; j += kRowsInFlight) {
        typename IO::Raw raw[kRowsInFlight][CH];
        bool valid[kRowsInFlight];
        float w[kRowsInFlight];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const int id = __shfl_sync(kFull, my_id, (j + u) & 31);
          w[u] = __shfl_sync(kFull, my_w, (j + u) & 31);
          valid[u] = id >= -v && id < v;
          const long long r = id < 0 ? (long long)id + v : (long long)id;
          const T* row = table + r * d + base;
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const int e = (c * 32 + lane) * VEC;
            raw[u][c] = typename IO::Raw{};
            if (j + u < n && valid[u] && base + e < d)
              raw[u][c] = IO::load(row + e);
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          if (j + u < n) {
#pragma unroll
            for (int c = 0; c < CH; ++c) {
              float x[VEC];
              IO::widen(raw[u][c], x);
#pragma unroll
              for (int k = 0; k < VEC; ++k) {
                const float xv = valid[u] ? x[k] : nan;
                acc[c][k] = __fadd_rn(acc[c][k], __fmul_rn(w[u], xv));
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int e = base + (c * 32 + lane) * VEC;
      if (e < d) IO::store(out + bag * d + e, acc[c]);
    }
  }
}

template <typename T, int VEC>
void launch(const void* table, const void* indices, const void* weights,
            void* out, long long v, long long n_bags, int l, int d,
            cudaStream_t s) {
  const long long blocks = (n_bags + kWarps - 1) / kWarps;
  const int span = 32 * VEC;
  const auto t = (const T*)table;
  const auto ids = (const int*)indices;
  const auto w = (const float*)weights;
  const auto o = (T*)out;
  if (d <= span) {
    embedding_bag_kernel<T, VEC, 1>
        <<<(unsigned)blocks, kThreads, 0, s>>>(t, ids, w, o, v, n_bags, l, d);
  } else if (d <= 2 * span) {
    embedding_bag_kernel<T, VEC, 2>
        <<<(unsigned)blocks, kThreads, 0, s>>>(t, ids, w, o, v, n_bags, l, d);
  } else {
    embedding_bag_kernel<T, VEC, 4>
        <<<(unsigned)blocks, kThreads, 0, s>>>(t, ids, w, o, v, n_bags, l, d);
  }
}

}  // namespace

// out [n_bags, d] = the bags of indices/weights [n_bags, l] over table
// [v, d].  bf16 selects a bfloat16 table and output (else float32); vec
// selects 16-byte loads, which need a 16-byte-aligned table and rows a
// multiple of 16 bytes long.  Returns the CUDA error of the launch.
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, void* out,
                                    long long v, long long n_bags, int l,
                                    int d, int bf16, int vec, void* stream) {
  if (n_bags <= 0 || l < 0 || d <= 0 || v < 0)
    return (int)cudaErrorInvalidValue;
  if ((n_bags + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const auto s = (cudaStream_t)stream;
  if (bf16) {
    if (vec) {
      launch<__nv_bfloat16, 8>(table, indices, weights, out, v, n_bags, l, d,
                               s);
    } else {
      launch<__nv_bfloat16, 1>(table, indices, weights, out, v, n_bags, l, d,
                               s);
    }
  } else if (vec) {
    launch<float, 4>(table, indices, weights, out, v, n_bags, l, d, s);
  } else {
    launch<float, 1>(table, indices, weights, out, v, n_bags, l, d, s);
  }
  return (int)cudaGetLastError();
}
