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
// * Hkv * G * D, G <= 16 flops a byte: far under the card's rate.  At one
// layer of Qwen2.5-14B with 4 sequences at 32k (bf16, [4, 32768, 8, 128],
// G = 5) that is 0.537 GB, 0.160 ms at 3.35 TB/s (H100 SXM data sheet).
//
// Design.  The TPU grid (B, Hkv, KV tiles) walks the tile axis in order on
// one core and carries the online softmax (m, l, acc) in VMEM scratch.  A
// CUDA grid has no order, and one block per (b, h) would launch 32 blocks
// at the 32k shape on 132 SMs.  So this is split-KV flash decoding: a
// partial kernel on grid (B*Hkv, n_split) writes one (m, l, acc[G, D]) in
// float32 per split, and a combine kernel merges the splits.  The wrapper
// picks n_split from the shapes alone (never from length, so a CUDA graph
// can capture the launch), and picks the partial kernel by dtype and D:
//
// mma path, bfloat16 with D <= 128 a multiple of 8 (every LM config of
//   the repository).
//   A block of TILE/16 warps walks its split in tiles of TILE positions.
//   K and V tiles go through a ring of STAGES stages in shared memory:
//   before the block computes tile t, every thread issues `cp.async` of
//   16 bytes for its share of tile t + STAGES - 1 and then
//   `cp.async.mbarrier.arrive.noinc` on the stage's mbarrier, which
//   completes once every thread's copies have landed.  (One
//   `cp.async.bulk` per 256-byte row instead, rows of one head lying
//   Hkv*D*2 bytes apart, made 128 requests a tile, and the copy engine's
//   request rate held that route to about half the byte rate; PERF.md.
//   A TMA tensor map would copy whole tiles, rows past length
//   included.)  Each row lands at a padded stride
//   (DP + 8 elements), so ldmatrix reads 8 rows from 8 distinct bank
//   groups.  Rows at or past the split's end or min(length, S) are never
//   copied; the ring is zeroed once, so the padding columns (D < DP) and
//   rows never copied read 0.
//   Each warp owns 16 positions of a tile.  Scores go through
//   mma.sync m16n8k16 (bf16 in, float32 out): A is q padded with zeros to
//   16 rows and DP = D rounded up to 16 columns, held in registers; B is
//   the K tile by ldmatrix.  P.V takes P_hi = bf16(p) and P_lo =
//   bf16(p - P_hi), B the V tile by ldmatrix.trans; P keeps about 16 bits
//   that way, and a single bf16 P fails the deployment tolerance at every
//   G.  The kernel has two instances, by the rows of the m16 tile that
//   hold query rows (ROWS):
//   - ROWS = 8, G <= 8: rows 8-15 of q's A are zero, so the P.V product
//     puts them to use: its A holds P_hi in rows 0-7 and P_lo in rows
//     8-15, one mma a V fragment, and the float32 accumulator's rows g and
//     g + 8 are added at the end.
//   - ROWS = 16, G >= 9: q fills rows 8..15 too, so each thread keeps the
//     online softmax of two rows (grp and grp + 8), and P.V takes two
//     mmas a V fragment, P_hi of all 16 rows and then P_lo, into the same
//     float32 accumulator.  Above G = 16 the grid's z axis walks row
//     tiles of 16 (one launch; each tile's block reads its split's K and
//     V, so K and V are read ceil(G / 16) times, mostly from L2 where the
//     tiles of one split run together); the wrapper counts the row tiles
//     in the blocks a wave holds when it cuts the splits.
//   Online softmax per warp in float32 (l summed from the float32 p, the
//   rescale skipped when no row's max grew, where it would multiply by
//   1); the warps merge in shared memory.
//   wgmma is not used: its 64-row tile would hold 8 useful rows, and the
//   kernel is memory-bound with mma.sync's products off the FMA pipe.
//
// fma path, float32 (tensor cores would mean TF32, outside the float32
//   tolerance), bfloat16 with D > 128, and any D that is not a multiple
//   of 8 (rows then not 16-byte aligned: each thread loads its 8
//   elements one by one, masked at D; nothing is padded or copied).  A
//   thread holds NV = 1, 2 or 4 vectors of 8 elements of a row, so D goes
//   to 256, 512 or 1024 (kFmaMaxD; the wrapper refuses wider D on the
//   card).  A block loads the G query rows of its (b, h) once into
//   registers and walks its split's positions.  TPR = pow2 >= D/(8 NV)
//   threads share one K/V row, 8 NV elements each (a 16-byte load per
//   vector for bfloat16), so a block holds 128/TPR row groups, each with
//   its own online softmax per query row in float32 over U rows per step
//   (their loads issued together; U = 2 at NV = 1, else 1).  The row
//   groups merge in shared memory.  An instance takes at most 8 query
//   rows at NV = 1: its static shared memory is about 5 KB a row (48 KB is
//   the static limit) and q and the accumulator take 16 NV registers a
//   row a thread.  So the rows go as launches of at most 8, 4 or 1 rows
//   (NV = 1, 2, 4), one after another on the stream, each reading its
//   (b, h)'s K and V once.  This
//   path serves float32 and D > 128, not the bf16 serving path, so the
//   second read of K and V costs nothing that is served.
//
// Both write m = -1e30, l = 0 and load nothing for a split wholly past
// length: the `pl.when(base < length)` skip.  combine, grid (B*Hkv*G), a
// thread per element of D: m* = max m_i, l = sum l_i e^(m_i - m*),
// out = sum acc_i e^(m_i - m*) / max(l, 1e-30), over the splits with
// l_i > 0, cast to q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The mma kernel's positions per tile (16 per warp) and ring stages, swept
// by `python -m repro_torch.launch.decode_sweep` (PERF.md).
#ifndef GQA_TILE
#define GQA_TILE 128
#endif
#ifndef GQA_STAGES
#define GQA_STAGES 2
#endif

// Rows each row group of the fma kernel keeps in flight per step (U).  2
// was the fastest bfloat16 setting of that kernel at both the 32k and the
// 500k shape with 8 blocks an SM (PERF.md).
constexpr int kRowsInFlight = 2;
constexpr int kThreads = 128;
constexpr int kVec = 8;            // elements of D per thread
constexpr int kMaxD = 32 * kVec;   // the combine's widest block; fma D at NV 1
constexpr float kNegInf = -1e30f;
constexpr float kMinusInf = -__builtin_huge_valf();
constexpr int kTile = GQA_TILE;
constexpr int kStages = GQA_STAGES;
constexpr int kMmaWarps = kTile / 16;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaMaxD = 128;
constexpr int kFmaMaxG = 8;        // query rows of one fma instance, D <= 256
constexpr int kFmaMaxD = 4 * kMaxD;  // the fma kernel's widest D
constexpr int kMaxDevices = 64;
static_assert(kTile % 16 == 0 && kTile >= 32 && kTile <= 512,
              "GQA_TILE: a multiple of 16 positions, 32 to 512");
static_assert(kStages >= 2, "GQA_STAGES: at least 2");

// Dynamic shared memory of the mma kernel: STAGES stages of a K and a V
// tile, TILE rows of DP + 8 bfloat16 each (kernel.mma_smem_bytes mirrors
// this).
constexpr int mma_smem_bytes(int dp) {
  return kStages * 2 * kTile * (dp + 8) * 2;
}

// ------------------------------------------------------------------ //
// fma path
// ------------------------------------------------------------------ //
// Eight elements of a row in registers, loaded with 16-byte vector loads
// (`load`), or element by element where D is not a multiple of 8 and
// rows are not 16-byte aligned (`load_tail`, n of the 8 in range).
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void load_tail(const float* p, int n) {
    float f[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = e < n ? __ldg(p + e) : 0.f;
    a = make_float4(f[0], f[1], f[2], f[3]);
    b = make_float4(f[4], f[5], f[6], f[7]);
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
  __device__ __forceinline__ void load_tail(const __nv_bfloat16* p, int n) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    unsigned w[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) w[e] = e < n ? __ldg(h + e) : 0u;
    a = make_uint4(w[0] | w[1] << 16, w[2] | w[3] << 16, w[4] | w[5] << 16,
                   w[6] | w[7] << 16);
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

// The 8 elements of a row at p, of which n (<= 8, maybe fewer or none)
// lie in the row; whole vectors where rows are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_row8(Vec8<T>& x, const T* p, int n,
                                          bool vec) {
  if (n <= 0) {
    x.zero();
  } else if (vec && n >= kVec) {
    x.load(p);
  } else {
    x.load_tail(p, n);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Query rows g0 .. g0 + G - 1 of the g_all rows a KV head has.  A thread
// holds NV vectors of 8 elements of a row: vector c covers elements
// 8 (c tpr + lane) .. + 7, so D <= 256 NV (kFmaMaxD at NV = 4).
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads, 1)
gqa_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ length,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int s, int hkv, int d,
                   int tpr, int n_split, int chunk, float scale, int g_all,
                   int g0) {
  constexpr int U = NV == 1 ? kRowsInFlight : 1;
  __shared__ float sm_m[kThreads][G];
  __shared__ float sm_l[kThreads][G];
  __shared__ float sm_acc[kThreads * kVec * NV * G];

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / hkv, h = bh - b * hkv;
  const long long part = (long long)bh * n_split + split;
  const int len = min(max(length[b], 0), s);
  const int lo = split * chunk;
  const int hi = min(lo + chunk, len);
  const long long prow = part * g_all + g0;  // this launch's first row
  if (lo >= hi) {
    if (threadIdx.x < G) {
      m_part[prow + threadIdx.x] = kNegInf;
      l_part[prow + threadIdx.x] = 0.f;
    }
    return;
  }

  const int tid = threadIdx.x;
  const int row = tid / tpr, lane = tid - row * tpr;
  const int rows = kThreads / tpr;
  const bool vec = d % kVec == 0;  // rows 16-byte aligned
  int e0[NV];                      // D/8 need not be a power of two
#pragma unroll
  for (int c = 0; c < NV; ++c) e0[c] = (c * tpr + lane) * kVec;

  float qf[G][NV][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      Vec8<T> x;
      load_row8(x, q + ((long long)bh * g_all + g0 + g) * d + e0[c],
                d - e0[c], vec);
      x.widen(qf[g][c]);
    }
  }
  float m[G], l[G], acc[G][NV][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][c][e] = 0.f;
    }
  }

  const long long pos_stride = (long long)hkv * d;
  const long long base_off = ((long long)b * s * hkv + h) * d;
  const T* kb = k + base_off;
  const T* vb = v + base_off;

  // The trip count is the same for every thread of the block, so the
  // shuffles below always run with the whole warp.
  for (int base = lo; base < hi; base += rows * U) {
    Vec8<T> kr[U][NV], vr[U][NV];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + row + u * rows;
      ok[u] = p < hi;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int n = ok[u] ? d - e0[c] : 0;
        load_row8(kr[u][c], kb + p * pos_stride + e0[c], n, vec);
        load_row8(vr[u][c], vb + p * pos_stride + e0[c], n, vec);
      }
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) sc[u][g] = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float kf[kVec];
        kr[u][c].widen(kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = sc[u][g];
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot = fmaf(qf[g][c][e], kf[e], dot);
          sc[u][g] = dot;
        }
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
      for (int c = 0; c < NV; ++c) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][c][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? __expf(sc[u][g] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float vf[kVec];
          vr[u][c].widen(vf);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[g][c][e] = fmaf(p, vf[e], acc[g][c][e]);
          }
        }
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
#pragma unroll
    for (int c = 0; c < NV; ++c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (e0[c] + e < d) sm_acc[(row * G + g) * d + e0[c] + e] = acc[g][c][e] * w;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * d; i += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += sm_acc[r * G * d + i];
    acc_part[prow * d + i] = sum;
  }
  if (tid < G) {
    float mstar = sm_m[0][tid], lsum = 0.f;
    for (int r = 1; r < rows; ++r) mstar = fmaxf(mstar, sm_m[r][tid]);
    for (int r = 0; r < rows; ++r) lsum += sm_l[r][tid];
    m_part[prow + tid] = mstar;
    l_part[prow + tid] = lsum;
  }
}

// ------------------------------------------------------------------ //
// mma path: PTX wrappers
// ------------------------------------------------------------------ //
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 16 bytes from global to shared memory, by this thread; L2 fetches the
// 256 bytes around them (a row at D = 128).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::
                   "r"(dst),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every cp.async of this thread has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A[16 x 16] B[16 x 8], bfloat16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats rounded to bfloat16 (nearest even), x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(y), "f"(x));
  return r;
}

// The low and the high bfloat16 of a pair, widened (exact).
__device__ __forceinline__ float lo_f32(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// ------------------------------------------------------------------ //
// mma path: the partial kernel
// ------------------------------------------------------------------ //
// Fragment layouts of m16n8k16 (grp = lane / 4, tig = lane % 4): A regs
// a0 (row grp, cols 2 tig..+1), a1 (row grp + 8, same cols), a2 (row grp,
// cols 8 + 2 tig..+1), a3 (row grp + 8, those cols); B regs b0 (k = 2
// tig..+1, n = grp), b1 (k = 8 + 2 tig..+1); C c0, c1 (row grp, cols 2
// tig..+1), c2, c3 (row grp + 8).
//
// ROWS: the rows of the m16 tile that hold query rows, 8 (G <= 8) or 16
// (G >= 9); QR = ROWS / 8 rows a thread: grp and, at 16, grp + 8.  Above
// 16 query rows the grid's z axis walks tiles of 16 rows: block z takes
// rows g0 = 16 z .. g0 + g - 1 (g <= 16) of the g_all a KV head has, and
// reads its split's K and V itself.
template <int NK, int ROWS>
__global__ void __launch_bounds__(kMmaThreads, 1)
gqa_mma_partial_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ length,
                       float* __restrict__ m_part, float* __restrict__ l_part,
                       float* __restrict__ acc_part, int s, int hkv,
                       int g_all, int d, int n_split, int chunk,
                       float scale) {
  static_assert(ROWS == 8 || ROWS == 16, "ROWS: 8 or 16 query rows");
  constexpr int QR = ROWS / 8;
  constexpr int DP = 16 * NK;      // D padded to the mma's k16
  constexpr int RS = DP + 8;       // row stride in shared memory, elements
  constexpr int STAGE = kTile * RS;  // elements of one K or V tile
  // the warps' merge buffer reuses the ring
  static_assert(kMmaWarps * ROWS * DP * 4 <= kStages * 2 * STAGE * 2,
                "the merge buffer must fit in the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ float sm_m[kMmaWarps][ROWS], sm_l[kMmaWarps][ROWS];
  __nv_bfloat16* const sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const sv = sk + kStages * STAGE;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / hkv, h = bh - b * hkv;
  const long long part = (long long)bh * n_split + split;
  const int g0 = blockIdx.z * ROWS;
  const int g = min(ROWS, g_all - g0);
  const long long prow = part * g_all + g0;  // this block's first row
  const int len = min(max(length[b], 0), s);
  const int lo = split * chunk;
  const int hi = min(lo + chunk, len);
  const int tid = threadIdx.x;
  if (lo >= hi) {
    if (tid < g) {
      m_part[prow + tid] = kNegInf;
      l_part[prow + tid] = 0.f;
    }
    return;
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  // Zero the ring once: padding columns and rows never copied read 0.
  {
    uint4* p = reinterpret_cast<uint4*>(smem_raw);
    constexpr int n = kStages * 2 * STAGE * 2 / 16;
    for (int i = tid; i < n; i += kMmaThreads) p[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(smem_addr(&full[st]), kMmaThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long pos_stride = (long long)hkv * d;
  const long long head = ((long long)b * s * hkv + h) * d;
  const __nv_bfloat16* const kb = k + head;
  const __nv_bfloat16* const vb = v + head;
  // Every thread copies its share of tile t's 16-byte pieces, then
  // arrives on the stage's barrier once they have landed.
  auto issue = [&](int t) {
    constexpr int PIECES = DP / 8;  // 16-byte pieces of a padded row
    const int base = lo + t * kTile;
    const int rows = min(kTile, hi - base);
    const int st = t % kStages;
    for (int c = tid; c < rows * PIECES; c += kMmaThreads) {
      const int r = c / PIECES, e = (c - r * PIECES) * 8;
      if (e < d) {
        const long long off = (long long)(base + r) * pos_stride + e;
        cp_async16(smem_addr(sk + st * STAGE + r * RS + e), kb + off);
        cp_async16(smem_addr(sv + st * STAGE + r * RS + e), vb + off);
      }
    }
    cp_async_arrive(smem_addr(&full[st]));
  };
  for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) issue(t);

  // q as A fragments: qa[kk][half * QR + r] holds row grp + 8 r, columns
  // kk * 16 + half * 8 + 2 tig..+1 (0 at rows >= G or columns >= D); at
  // ROWS = 8 rows 8-15 are zero and not held.
  uint32_t qa[NK][2 * QR];
  {
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const int row = grp + 8 * r;
      const __nv_bfloat16* qrow = q + ((long long)bh * g_all + g0 + row) * d;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = kk * 16 + half * 8 + 2 * tig;
          qa[kk][half * QR + r] =
              (row < g && col < d)
                  ? *reinterpret_cast<const uint32_t*>(qrow + col)
                  : 0u;
        }
      }
    }
  }

  // o[j]: columns 8 j + 2 tig..+1.  ROWS = 8: P_hi.V of row grp in c0, c1
  // and P_lo.V in c2, c3; ROWS = 16: (P_hi + P_lo).V of row grp in c0, c1
  // and of row grp + 8 in c2, c3.  m and l of row grp + 8 r (l is this
  // thread's share of the sum).
  float o[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[QR], l_run[QR];
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }

  // ldmatrix row addresses of this lane: matrix lane / 8, row lane % 8.
  const int mi = lane >> 3, mr = lane & 7;
  const int k_row = warp * 16 + mr + ((mi >> 1) << 3), k_col = (mi & 1) << 3;
  const int v_row = warp * 16 + mr + ((mi & 1) << 3), v_col = (mi >> 1) << 3;

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // every warp is done with tile t - 1's stage
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    const int st = t % kStages;
    mbar_wait(smem_addr(&full[st]), (t / kStages) & 1);
    const int p0 = lo + t * kTile + warp * 16;  // this warp's positions
    if (p0 >= hi) continue;

    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const uint32_t kt = smem_addr(sk + st * STAGE + k_row * RS + k_col);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t bk[4];
      ldsm_x4(kt + kk * 32, bk);
      if constexpr (ROWS == 8) {
        mma_bf16(sc[0], qa[kk][0], 0u, qa[kk][1], 0u, bk[0], bk[1]);
        mma_bf16(sc[1], qa[kk][0], 0u, qa[kk][1], 0u, bk[2], bk[3]);
      } else {
        mma_bf16(sc[0], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[0],
                 bk[1]);
        mma_bf16(sc[1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[2],
                 bk[3]);
      }
    }
    // x[r][i]: position p0 + 8 (i / 2) + 2 tig + i % 2 of row grp + 8 r.
    float x[QR][4], mx[QR];
    bool grew = false;
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      x[r][0] = sc[0][2 * r];
      x[r][1] = sc[0][2 * r + 1];
      x[r][2] = sc[1][2 * r];
      x[r][3] = sc[1][2 * r + 1];
      mx[r] = m_run[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = p0 + ((i >> 1) << 3) + 2 * tig + (i & 1);
        x[r][i] = pos < hi ? x[r][i] * scale : kMinusInf;
        mx[r] = fmaxf(mx[r], x[r][i]);
      }
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      grew = grew || mx[r] > m_run[r];
    }
    if (__any_sync(0xffffffffu, grew)) {
      float alpha[QR];
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        alpha[r] = __expf(m_run[r] - mx[r]);
        l_run[r] *= alpha[r];
      }
      // c0, c1 hold row grp; c2, c3 row grp + 8 at ROWS = 16, and row
      // grp's P_lo part at ROWS = 8
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[(e >> 1) * (QR - 1)];
      }
    }
    float p[QR][4];
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      m_run[r] = mx[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[r][i] = __expf(x[r][i] - mx[r]);
      l_run[r] += (p[r][0] + p[r][1]) + (p[r][2] + p[r][3]);
    }
    const uint32_t vt = smem_addr(sv + st * STAGE + v_row * RS + v_col);
    if constexpr (ROWS == 8) {
      // P_hi = bf16(p) in rows 0-7 and P_lo = bf16(p - P_hi) in rows 8-15,
      // two to a register.
      const uint32_t a0 = pack_bf16(p[0][0], p[0][1]);
      const uint32_t a2 = pack_bf16(p[0][2], p[0][3]);
      const uint32_t a1 = pack_bf16(p[0][0] - lo_f32(a0),
                                    p[0][1] - hi_f32(a0));
      const uint32_t a3 = pack_bf16(p[0][2] - lo_f32(a2),
                                    p[0][3] - hi_f32(a2));
#pragma unroll
      for (int dp = 0; dp < NK; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(vt + dp * 32, bv);
        mma_bf16(o[2 * dp], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    } else {
      // P_hi of rows grp and grp + 8 (h0, h2 and h1, h3), then P_lo.
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float p0v = p[r][2 * half], p1v = p[r][2 * half + 1];
          const uint32_t hv = pack_bf16(p0v, p1v);
          ph[2 * half + r] = hv;
          pl[2 * half + r] = pack_bf16(p0v - lo_f32(hv), p1v - hi_f32(hv));
        }
      }
#pragma unroll
      for (int dp = 0; dp < NK; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(vt + dp * 32, bv);
        mma_bf16(o[2 * dp], ph[0], ph[1], ph[2], ph[3], bv[0], bv[1]);
        mma_bf16(o[2 * dp], pl[0], pl[1], pl[2], pl[3], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ph[0], ph[1], ph[2], ph[3], bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], pl[0], pl[1], pl[2], pl[3], bv[2], bv[3]);
      }
    }
  }

  // Merge the warps: rescale each to the block's max, then sum.
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      sm_m[warp][grp + 8 * r] = m_run[r];
      sm_l[warp][grp + 8 * r] = l_run[r];
    }
  }
  __syncthreads();  // also: no warp reads the ring any more
  float wgt[QR];
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    float mstar = sm_m[0][grp + 8 * r];
#pragma unroll
    for (int w = 1; w < kMmaWarps; ++w) {
      mstar = fmaxf(mstar, sm_m[w][grp + 8 * r]);
    }
    wgt[r] = __expf(m_run[r] - mstar);
  }
  float* const so = reinterpret_cast<float*>(smem_raw);  // [warps][ROWS][DP]
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
    float* row = so + (warp * ROWS + grp) * DP + 8 * j + 2 * tig;
    if constexpr (ROWS == 8) {
      row[0] = (o[j][0] + o[j][2]) * wgt[0];
      row[1] = (o[j][1] + o[j][3]) * wgt[0];
    } else {
      row[0] = o[j][0] * wgt[0];
      row[1] = o[j][1] * wgt[0];
      row[8 * DP] = o[j][2] * wgt[1];
      row[8 * DP + 1] = o[j][3] * wgt[1];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * d; i += kMmaThreads) {
    const int gi = i / d, e = i - gi * d;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) sum += so[(w * ROWS + gi) * DP + e];
    acc_part[prow * d + i] = sum;
  }
  if (tid < g) {
    float ms = sm_m[0][tid], lsum = 0.f;
#pragma unroll
    for (int w = 1; w < kMmaWarps; ++w) ms = fmaxf(ms, sm_m[w][tid]);
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      lsum += sm_l[w][tid] * __expf(sm_m[w][tid] - ms);
    }
    m_part[prow + tid] = ms;
    l_part[prow + tid] = lsum;
  }
}

// One block per query row (b, h, g), one thread per element of D (and
// per element blockDim.x further on, above 256).
template <typename T>
__global__ void __launch_bounds__(kMaxD)
gqa_combine_kernel(const float* __restrict__ m_part,
                   const float* __restrict__ l_part,
                   const float* __restrict__ acc_part, T* __restrict__ out,
                   int n_split, int g, int d) {
  const int row = blockIdx.x;
  const int bh = row / g, gi = row - bh * g;
  const long long part0 = (long long)bh * n_split;
  // Loads are not conditional, so up to 16 splits' are in flight; a split
  // past length wrote no acc, and its entry is never used.
  float mstar = kNegInf;
#pragma unroll 16
  for (int j = 0; j < n_split; ++j) {
    const long long p = (part0 + j) * g + gi;
    const float lj = l_part[p], mj = m_part[p];
    if (lj > 0.f) mstar = fmaxf(mstar, mj);
  }
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    float lsum = 0.f, o = 0.f;
#pragma unroll 16
    for (int j = 0; j < n_split; ++j) {
      const long long p = (part0 + j) * g + gi;
      const float lj = l_part[p], mj = m_part[p], a = acc_part[p * d + t];
      if (lj > 0.f) {
        const float w = __expf(mj - mstar);
        lsum = fmaf(lj, w, lsum);
        o = fmaf(a, w, o);
      }
    }
    store(out + (long long)row * d + t, o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G, int NV>
cudaError_t run_fma(const void* q, const void* k, const void* v,
                    const void* length, float* m_part, float* l_part,
                    float* acc_part, int b, int s, int hkv, int d,
                    int n_split, int chunk, float scale, int g_all, int g0,
                    cudaStream_t stream) {
  int tpr = 1;
  while (tpr * kVec * NV < d) tpr <<= 1;
  gqa_partial_kernel<T, G, NV>
      <<<dim3(b * hkv, n_split), kThreads, 0, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)length, m_part,
          l_part, acc_part, s, hkv, d, tpr, n_split, chunk, scale, g_all,
          g0);
  return cudaGetLastError();
}

// Vectors of 8 a thread holds of a row, by D: 1 up to 256, 2 up to 512,
// 4 up to kFmaMaxD.
int fma_vectors(int d) { return d <= kMaxD ? 1 : d <= 2 * kMaxD ? 2 : 4; }

// Query rows an fma instance takes at NV vectors a thread: its static
// shared memory (sm_acc, kThreads * 8 * NV * G floats) and its registers
// (q and the accumulator, 16 NV G a thread) stay those of 8 rows at NV = 1.
int fma_rows(int nv) { return nv == 1 ? kFmaMaxG : nv == 2 ? 4 : 1; }

// Rows g0 .. g0 + g - 1 (g <= fma_rows) of the g_all a KV head has.
template <typename T>
cudaError_t dispatch_fma(int g, const void* q, const void* k, const void* v,
                         const void* length, float* m_part, float* l_part,
                         float* acc_part, int b, int s, int hkv, int d,
                         int n_split, int chunk, float scale, int g_all,
                         int g0, cudaStream_t stream) {
#define GQA_CASE(G_, NV_)                                                   \
  if (g == G_ && nv == NV_)                                                 \
    return run_fma<T, G_, NV_>(q, k, v, length, m_part, l_part, acc_part, b, \
                               s, hkv, d, n_split, chunk, scale, g_all, g0, \
                               stream);
  const int nv = fma_vectors(d);
  GQA_CASE(1, 1) GQA_CASE(2, 1) GQA_CASE(3, 1) GQA_CASE(4, 1)
  GQA_CASE(5, 1) GQA_CASE(6, 1) GQA_CASE(7, 1) GQA_CASE(8, 1)
  GQA_CASE(1, 2) GQA_CASE(2, 2) GQA_CASE(3, 2) GQA_CASE(4, 2)
  GQA_CASE(1, 4)
  return cudaErrorInvalidValue;
#undef GQA_CASE
}

// Every query row: groups of fma_rows rows, one launch each (see the
// design note at the top).
template <typename T>
cudaError_t run_fma_groups(int g, const void* q, const void* k,
                           const void* v, const void* length, float* m_part,
                           float* l_part, float* acc_part, int b, int s,
                           int hkv, int d, int n_split, int chunk,
                           float scale, cudaStream_t stream) {
  const int rows = fma_rows(fma_vectors(d));
  for (int g0 = 0; g0 < g; g0 += rows) {
    const cudaError_t err = dispatch_fma<T>(
        g - g0 < rows ? g - g0 : rows, q, k, v, length, m_part, l_part,
        acc_part, b, s, hkv, d, n_split, chunk, scale, g, g0, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int NK, int ROWS>
cudaError_t run_mma(const void* q, const void* k, const void* v,
                    const void* length, float* m_part, float* l_part,
                    float* acc_part, int b, int s, int hkv, int g, int d,
                    int n_split, int chunk, float scale,
                    cudaStream_t stream) {
  const int smem = mma_smem_bytes(16 * NK);
  // Above 48 KB only after this attribute, set once per device.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(gqa_mma_partial_kernel<NK, ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int row_tiles = (g + ROWS - 1) / ROWS;
  gqa_mma_partial_kernel<NK, ROWS>
      <<<dim3(b * hkv, n_split, row_tiles), kMmaThreads, smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const int*)length, m_part, l_part,
          acc_part, s, hkv, g, d, n_split, chunk, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* length, float* m_part, float* l_part,
                         float* acc_part, int b, int s, int hkv, int g,
                         int d, int n_split, int chunk, float scale,
                         cudaStream_t stream) {
#define GQA_CASE(NK_)                                                      \
  case NK_:                                                                \
    return g <= 8 ? run_mma<NK_, 8>(q, k, v, length, m_part, l_part,       \
                                    acc_part, b, s, hkv, g, d, n_split,    \
                                    chunk, scale, stream)                  \
                  : run_mma<NK_, 16>(q, k, v, length, m_part, l_part,      \
                                     acc_part, b, s, hkv, g, d, n_split,   \
                                     chunk, scale, stream);
  switch ((d + 15) / 16) {
    GQA_CASE(1) GQA_CASE(2) GQA_CASE(3) GQA_CASE(4)
    GQA_CASE(5) GQA_CASE(6) GQA_CASE(7) GQA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef GQA_CASE
}

}  // namespace

// The mma kernel's positions per tile, as built.
extern "C" int gqa_decode_tile() { return kTile; }

// Launches the partial kernel of `path` (1 = mma: bfloat16, D <= 128 a
// multiple of 8, chunk a multiple of the tile, ceil(G / 16) row tiles on
// the grid above G = 16; 0 = fma, D <= kFmaMaxD, launches of fma_rows
// rows) and the combine on `stream`, for any G >= 1 query rows a KV head,
// and returns cudaGetLastError() (0 = launched).  Does not synchronise and
// allocates nothing: `part` is the caller's float32 scratch of
// B*Hkv*n_split*G*(D + 2) entries.
extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const void* length, void* out, void* part,
                                 int b, int s, int hkv, int g, int d,
                                 int n_split, int chunk, float scale,
                                 int bf16, int mma, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || d <= 0 || d > kFmaMaxD || g < 1 ||
      n_split <= 0 || chunk <= 0 ||
      (mma && (!bf16 || d % kVec != 0 || d > kMmaMaxD ||
               chunk % kTile != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = (cudaStream_t)stream;
  const long long n_part = (long long)b * hkv * n_split * g;
  float* const m_part = (float*)part;
  float* const l_part = m_part + n_part;
  float* const acc_part = m_part + 2 * n_part;
  cudaError_t err;
  if (mma) {
    err = dispatch_mma(q, k, v, length, m_part, l_part, acc_part, b, s, hkv,
                       g, d, n_split, chunk, scale, st);
  } else if (bf16) {
    err = run_fma_groups<__nv_bfloat16>(g, q, k, v, length, m_part, l_part,
                                        acc_part, b, s, hkv, d, n_split,
                                        chunk, scale, st);
  } else {
    err = run_fma_groups<float>(g, q, k, v, length, m_part, l_part,
                                acc_part, b, s, hkv, d, n_split, chunk,
                                scale, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int threads = d < kMaxD ? (d + 31) / 32 * 32 : kMaxD;
  if (bf16) {
    gqa_combine_kernel<__nv_bfloat16><<<b * hkv * g, threads, 0, st>>>(
        m_part, l_part, acc_part, (__nv_bfloat16*)out, n_split, g, d);
  } else {
    gqa_combine_kernel<float><<<b * hkv * g, threads, 0, st>>>(
        m_part, l_part, acc_part, (float*)out, n_split, g, d);
  }
  return (int)cudaGetLastError();
}
