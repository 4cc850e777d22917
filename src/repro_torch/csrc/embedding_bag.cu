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
// loop step, with the bag's ids scalar-prefetched into SMEM.  Here rows
// are read as VEC-element vectors (one 16-byte load each when D is a
// multiple of 16 bytes' worth and the table is 16-byte aligned, else
// scalar loads), and the launch plan (kernel.py `plan`) picks one of two
// kernels by the row's width:
//  - the grouped kernel, for a row of at most 16 vectors (DLRM's 64
//    float32): a warp takes a run of consecutive bags, and its lanes split
//    into groups of LANES lanes (a power of two, a vector a lane), one bag
//    a group: 2 groups at D = 64 float32, 4 at bfloat16 D = 64, 8 at
//    D = 16.  The warp walks its run in steps: in a step a group takes
//    BPG bags (the most, a power of two, whose L items fit its kRows
//    rows in flight; else one bag, kRows items a step) and issues the
//    loads of all their rows before it adds any, so at L = 1 kRows
//    bags' rows are in flight in each group, where a warp a bag would
//    hold one row and leave half its lanes idle.  The next step's ids
//    and weights are loaded while this step's rows are in flight; the
//    lanes of a group read one id from one address (a broadcast), the
//    groups' bags are consecutive, so a step's output rows are one
//    contiguous store;
//  - the warp kernel, for a wider row (the history bag's 256 float32): a
//    warp a bag, lanes across D, CH vectors a lane, passes of CH * 32 *
//    VEC elements for wider rows; the warp reads 32 of its bag's ids and
//    weights at once and broadcasts them with shuffles, and issues the
//    loads of kWarpRows rows before it adds any.  Two rows (2 KB at
//    D = 256) a warp, at 32 registers and so 64 warps a SM, measured on an
//    H100 (PERF.md) as fast as 4 where the rows come from DRAM and 9 %
//    faster at Zipf ids, whose rows mostly hit in cache (fewer rows, more
//    warps); one row was 6 % faster still there but 0.1 % slower from
//    DRAM.  The grouped kernel, 27 % slower at Zipf ids, issues a
//    broadcast load for every id.
// Both add each bag's items in bag order.  No shared memory, no atomics,
// no order between warps.  wgmma and TMA do not apply (no products; rows
// are gathered, not tiled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps a block
// Rows in flight: a group of a warp's lanes (the grouped kernel), a warp
// (the warp kernel); kernel.py's ROWS and WARP_ROWS name them.
constexpr int kRows = 4;
constexpr int kWarpRows = 2;
constexpr int kThreads = 32 * kWarps;

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

template <typename T, int VEC, int BPG>
__global__ void __launch_bounds__(kThreads, 2)
    embedding_bag_kernel(const T* __restrict__ table,
                         const int* __restrict__ indices,
                         const float* __restrict__ weights,
                         T* __restrict__ out, long long v, long long n_bags,
                         int l, int d, int lanes_log2,
                         long long bags_per_warp) {
  using IO = Io<T, VEC>;
  constexpr int kItems = kRows > BPG ? kRows / BPG : 1;  // items a bag
  const int lane = threadIdx.x & 31;
  const int groups = 32 >> lanes_log2;
  const int group = lane >> lanes_log2;
  // the lane's vector of a row: one, as the row fits the group's lanes
  const int e = (lane & ((1 << lanes_log2) - 1)) * VEC;
  const long long warp =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long run0 = warp * bags_per_warp;
  if (run0 >= n_bags) return;          // the whole warp leaves together
  const long long run1 = min(run0 + bags_per_warp, n_bags);
  const long long batch = (long long)groups * BPG;   // bags a step
  const float nan = __int_as_float(0x7fc00000);

  // a step at (b0, i0): group g's slot (b, i) is item i0 + i of bag
  // b0 + b * groups + g; its id and weight, loaded a step ahead by every
  // lane of the group from one address (a broadcast)
  int id_next[BPG][kItems];
  float w_next[BPG][kItems];
  auto fetch = [&](long long b0, int i0) {
#pragma unroll
    for (int b = 0; b < BPG; ++b) {
      const long long bag = b0 + b * groups + group;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        id_next[b][i] = 0;
        w_next[b][i] = 0.f;
        if (bag < run1 && i0 + i < l) {
          id_next[b][i] = __ldg(indices + bag * l + i0 + i);
          w_next[b][i] = __ldg(weights + bag * l + i0 + i);
        }
      }
    }
  };

  float acc[BPG][VEC];
#pragma unroll
  for (int b = 0; b < BPG; ++b)
#pragma unroll
    for (int x = 0; x < VEC; ++x) acc[b][x] = 0.f;
  long long b0 = run0;
  int i0 = 0;
  fetch(b0, i0);
  while (b0 < run1) {
    float w[BPG][kItems];
    bool valid[BPG][kItems];
    typename IO::Raw raw[BPG][kItems];
#pragma unroll
    for (int b = 0; b < BPG; ++b) {
      const bool bag_in = b0 + b * groups + group < run1;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int id = id_next[b][i];
        w[b][i] = w_next[b][i];
        valid[b][i] = id >= -v && id < v;
        const long long r = id < 0 ? (long long)id + v : (long long)id;
        raw[b][i] = typename IO::Raw{};
        if (bag_in && i0 + i < l && valid[b][i] && e < d)
          raw[b][i] = IO::load(table + r * d + e);
      }
    }
    // the next step: the rest of these bags, else the next batch
    const bool last = i0 + kItems >= l;
    const long long nb0 = last ? b0 + batch : b0;
    const int ni0 = last ? 0 : i0 + kItems;
    if (nb0 < run1) fetch(nb0, ni0);   // while this step's rows fly
#pragma unroll
    for (int b = 0; b < BPG; ++b) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (i0 + i < l) {
          float x[VEC];
          IO::widen(raw[b][i], x);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float xv = valid[b][i] ? x[k] : nan;
            acc[b][k] = __fadd_rn(acc[b][k], __fmul_rn(w[b][i], xv));
          }
        }
      }
    }
    if (last) {                        // the batch's bags are complete
#pragma unroll
      for (int b = 0; b < BPG; ++b) {
        const long long bag = b0 + b * groups + group;
        if (bag < run1 && e < d) IO::store(out + bag * d + e, acc[b]);
#pragma unroll
        for (int x = 0; x < VEC; ++x) acc[b][x] = 0.f;
      }
    }
    b0 = nb0;
    i0 = ni0;
  }
}

// A warp a bag, for rows that fill a warp (32 lanes of CH vectors): the
// warp reads 32 of its bag's ids and weights at once, one a lane, and
// broadcasts them with shuffles; it issues the loads of kWarpRows rows
// before it adds any.
template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_warp_kernel(const T* __restrict__ table,
                              const int* __restrict__ indices,
                              const float* __restrict__ weights,
                              T* __restrict__ out, long long v,
                              long long n_bags, int l, int d) {
  using IO = Io<T, VEC>;
  constexpr int kSpan = CH * 32 * VEC;
  constexpr int U = kWarpRows;
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
      for (int j = 0; j < n; j += U) {
        typename IO::Raw raw[U][CH];
        bool valid[U];
        float w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int id = __shfl_sync(0xffffffffu, my_id, (j + u) & 31);
          w[u] = __shfl_sync(0xffffffffu, my_w, (j + u) & 31);
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
        for (int u = 0; u < U; ++u) {
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
cudaError_t by_shape(const T* table, const int* indices, const float* weights,
                     T* out, long long v, long long n_bags, int l, int d,
                     int lanes_log2, int ch, int bpg, long long bags_per_warp,
                     int grid, cudaStream_t s) {
  if (lanes_log2 == 5) {               // a warp a bag
    if (bags_per_warp != 1) return cudaErrorInvalidValue;
    if (ch == 1)
      embedding_bag_warp_kernel<T, VEC, 1><<<grid, kThreads, 0, s>>>(
          table, indices, weights, out, v, n_bags, l, d);
    else if (ch == 2)
      embedding_bag_warp_kernel<T, VEC, 2><<<grid, kThreads, 0, s>>>(
          table, indices, weights, out, v, n_bags, l, d);
    else
      return cudaErrorInvalidValue;
    return cudaGetLastError();
  }
  if (ch != 1) return cudaErrorInvalidValue;
#define EB_CASE(BPG_)                                                     \
  if (bpg == BPG_) {                                                      \
    embedding_bag_kernel<T, VEC, BPG_><<<grid, kThreads, 0, s>>>(         \
        table, indices, weights, out, v, n_bags, l, d, lanes_log2,        \
        bags_per_warp);                                                   \
    return cudaGetLastError();                                            \
  }
  EB_CASE(1)
  EB_CASE(2)
  EB_CASE(4)
#undef EB_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// The kernels' warps a block and rows in flight, so the wrapper's launch
// plan can be checked against the library.
extern "C" int embedding_bag_warps() { return kWarps; }
extern "C" int embedding_bag_rows() { return kRows; }
extern "C" int embedding_bag_warp_rows() { return kWarpRows; }

// out [n_bags, d] = the bags of indices/weights [n_bags, l] over table
// [v, d], with the launch plan of kernel.py's `plan`: bf16 selects a
// bfloat16 table and output (else float32); vec selects 16-byte loads,
// which need a 16-byte-aligned table and rows a multiple of 16 bytes
// long; 2^lanes_log2 lanes a bag, ch vectors a lane, bpg bags a group a
// step, bags_per_warp consecutive bags a warp, grid blocks of 8 warps.
// Returns the CUDA error of the launch.
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, void* out,
                                    long long v, long long n_bags, int l,
                                    int d, int bf16, int vec, int lanes_log2,
                                    int ch, int bpg, long long bags_per_warp,
                                    int grid, void* stream) {
  if (n_bags <= 0 || l < 0 || d <= 0 || v < 0 || grid <= 0 ||
      bags_per_warp <= 0 || lanes_log2 < 0 || lanes_log2 > 5)
    return (int)cudaErrorInvalidValue;
  if ((long long)grid * kWarps * bags_per_warp < n_bags)
    return (int)cudaErrorInvalidConfiguration;
  const auto ids = (const int*)indices;
  const auto w = (const float*)weights;
  const auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    const auto t = (const __nv_bfloat16*)table;
    const auto o = (__nv_bfloat16*)out;
    err = vec ? by_shape<__nv_bfloat16, 8>(t, ids, w, o, v, n_bags, l, d,
                                           lanes_log2, ch, bpg,
                                           bags_per_warp, grid, s)
              : by_shape<__nv_bfloat16, 1>(t, ids, w, o, v, n_bags, l, d,
                                           lanes_log2, ch, bpg,
                                           bags_per_warp, grid, s);
  } else {
    const auto t = (const float*)table;
    const auto o = (float*)out;
    err = vec ? by_shape<float, 4>(t, ids, w, o, v, n_bags, l, d, lanes_log2,
                                   ch, bpg, bags_per_warp, grid, s)
              : by_shape<float, 1>(t, ids, w, o, v, n_bags, l, d, lanes_log2,
                                   ch, bpg, bags_per_warp, grid, s);
  }
  return (int)err;
}
