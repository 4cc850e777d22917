// EmbeddingBag's backward with respect to the table, hand-written for Hopper
// (sm_90a): a sorted, deterministic segmented reduction.
//
// The forward (embedding_bag.cu) replaces the TPU kernel `_bag_kernel` /
// `embedding_bag_pallas` (src/repro/kernels/embedding_bag/kernel.py:23,38).
// The JAX package has no backward kernel: its models never call the Pallas
// kernel, and jax.grad scatters through jnp.take.  The port's forward is a
// hand-written kernel, so its gradient is one too:
//
//   grad_out  [B, D]  float32 or bfloat16 (the forward's output type)
//   indices   [B, L]  int32
//   weights   [B, L]  float32
//   grad      [V, D]  float32, zeroed by the caller:
//                     grad[indices[b, i]] += weights[b, i] * grad_out[b]
//
// Row ids follow the forward's jnp.take rule: an id in [-V, 0) wraps to
// id + V; an id outside [-V, V) read a NaN row, whose gradient jnp.take's
// fill mode drops, and so does this kernel, whatever the weight.  The
// reference adds every other term w * g, 0 * g too, which is NaN where g
// is inf or NaN.  A term 0 * g of finite g is +-0 and leaves a float32 sum
// that starts at +0 as it was, so an item of weight 0 joins its row only
// where its bag's grad_out row holds a non-finite element (the row is read
// for that check only for bags that hold an item of weight 0).  Each
// product is __fmul_rn(w, g) in float32 and each add __fadd_rn, never
// contracted to an FMA; a bfloat16 table's gradient is accumulated here in
// float32 and cast once by the wrapper.
//
// Sum order, fixed by the inputs alone.  The kept items are sorted by row,
// stably, so a row's items stay in item order.  A row's run of items is cut
// into pieces of at most kPiece items; a piece is added in item order from
// +0 by one group of lanes.  A run of at most kPiece items is one piece,
// stored into its row: it equals the item-order plain version
// (kernels/embedding_bag/ref.py embedding_bag_backward_ref) bit for bit.  A
// longer run's first piece is stored into its row and each later piece
// into a row of scratch; a second pass adds them to the row in piece
// order.  kernels/embedding_bag/ref.py embedding_bag_backward_sorted_ref
// adds the same terms in the same order, and the kernel equals it bit for
// bit; against the item order a longer row differs by at most
// n * 2^-23 * sum|terms|.  No float atomics: each element of a named row is
// written by one thread, and each scratch element once.
//
// Bound: memory.  The least traffic reads grad_out, ids and weights once
// and reads and writes each distinct row named once: bytes = B * D * elt +
// 8 * B * L + 2 * rows * D * 4.  One product and one add an item and
// element is far under the card's rate.  The zero fill of the [V, D]
// gradient is the caller's (a dense gradient, as autograd hands it on).
//
// Design: one host call launches, on the caller's stream,
//   keys          a warp walks 32 items at a time and writes each item's row,
//                 or kDropped; a warp checks a bag's grad_out row once for
//                 the zero-weight items it holds (16-byte loads, __any_sync);
//   sort_hist,    an LSD radix sort of (row, item) over the bits of V - 1,
//   sort_scan,    kRadixBits a pass: each block of the sort's grid takes one
//   sort_scatter  contiguous chunk of the items, counts its digits
//                 (warp-aggregated shared-memory counts), one block scans
//                 the counts digit-major, and each block ranks its chunk
//                 stably (warps in item order, __match_any_sync within a
//                 warp) and scatters.  The first pass reads the keys kernel's
//                 output and ranks only kept items: it compacts the dropped
//                 ones out, and its scan writes the number kept;
//   runs_count,   each block finds the run heads in its chunk of the sorted
//   runs_write    rows and each run's length (a galloping search for its
//                 end); the second kernel places each run, long run (more
//                 than kPiece items) and scratch row by the counts of the
//                 blocks before it and a block scan;
//   reduce        a group of lanes a piece: the first pieces of every run,
//                 then the later pieces of the long runs, one scratch row
//                 each (a binary search finds the run);
//   combine       a warp a vector of a long run's row: the row (the first
//                 piece) plus its scratch rows in piece order, 32 loaded at
//                 once by the lanes and added in lane order by shuffles;
//                 the grid's x takes the row's vectors 8 at a time.
// A group holds a row's 16-byte vectors (16 lanes at D = 64 float32, a warp
// with two vectors a lane at D = 256), as in the forward.  Every count
// (kept items, runs, long runs, scratch rows) stays on the card: the grids
// are sized from the bound B * L and read the counts there; nothing syncs
// with the host.  Integer counters in shared memory are the only atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPiece = 32;             // items a piece (C)
constexpr int kRadixBits = 8;          // bits a sort pass
constexpr int kRadix = 1 << kRadixBits;
constexpr int kRanks = 8;              // items a lane ranks a tile
constexpr int kTile = kThreads * kRanks;
constexpr int kVpl = 2;                // vectors a lane a pass over D
constexpr int kUnroll = 4;             // items (partials) loaded at once
constexpr unsigned kDropped = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kRadix, "one thread a digit");

// the device counts, words of `totals`
enum { kKept = 0, kRuns = 1, kLong = 2, kRest = 3, kTotals = 4 };

template <typename T, int VEC>
struct Load;

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void get(const float* p, float* x) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
};

template <>
struct Load<float, 1> {
  static __device__ __forceinline__ void get(const float* p, float* x) {
    x[0] = __ldg(p);
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void get(const __nv_bfloat16* p,
                                             float* x) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void get(const __nv_bfloat16* p,
                                             float* x) {
    x[0] = __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
};

// VEC floats of the gradient or the scratch (VEC a multiple of 4 on rows
// 16-byte aligned, else 1); plain loads: the reduce kernel wrote them
template <int VEC>
__device__ __forceinline__ void load_f(const float* p, float* x) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < VEC; c += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + c);
      x[c] = r.x;
      x[c + 1] = r.y;
      x[c + 2] = r.z;
      x[c + 3] = r.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) x[c] = p[c];
  }
}

template <int VEC>
__device__ __forceinline__ void store_f(float* p, const float* x) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < VEC; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) p[c] = x[c];
  }
}

// [lo, hi): block b's chunk of n < 2^31 items, the same in every kernel of
// a pass (32-bit division: a 64-bit one is a call, whose saved registers
// spill)
__device__ __forceinline__ void chunk_of(long long n, long long& lo,
                                         long long& hi) {
  const unsigned m = (unsigned)n;
  const unsigned chunk = m / gridDim.x + (m % gridDim.x != 0);
  lo = min(n, (long long)blockIdx.x * chunk);
  hi = min(n, lo + chunk);
}

// ------------------------------------------------------------------ keys
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_keys(const T* __restrict__ grad_out,
                                const int* __restrict__ indices,
                                const float* __restrict__ weights,
                                unsigned* __restrict__ keys, long long v,
                                long long n, int l, int d) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  const int vectors = d / VEC;         // VEC > 1 only where VEC divides D
  for (long long base = warp * 32; base < n; base += n_warps * 32) {
    const long long i = base + lane;
    const bool in = i < n;
    const long long id = in ? __ldg(indices + i) : 0;
    const float w = in ? __ldg(weights + i) : 1.f;
    const bool ok = in && id >= -v && id < v;
    const unsigned bag = (unsigned)i / (unsigned)l;   // i < 2^31 + 32
    bool keep = ok && w != 0.f;
    // the zero-weight items in range: their bag's row decides
    unsigned need = __ballot_sync(kFull, ok && w == 0.f);
    while (need) {
      const unsigned b = __shfl_sync(kFull, bag, __ffs(need) - 1);
      const T* g = grad_out + (long long)b * d;
      bool bad = false;
      for (int j = lane; j < vectors; j += 32) {
        float x[VEC];
        Load<T, VEC>::get(g + j * VEC, x);
#pragma unroll
        for (int k = 0; k < VEC; ++k) bad |= !isfinite(x[k]);
      }
      bad = __any_sync(kFull, bad);
      const unsigned same =
          __ballot_sync(kFull, ((need >> lane) & 1u) && bag == b);
      if ((same >> lane) & 1u) keep = bad;
      need &= ~same;
    }
    if (in) keys[i] = keep ? (unsigned)(id < 0 ? id + v : id) : kDropped;
  }
}

// ------------------------------------------------------------------ sort
// counts[b][digit]: block b's kept items of each digit
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_sort_hist(const unsigned* __restrict__ keys,
                                     const int* __restrict__ totals,
                                     long long n_first, int shift,
                                     unsigned* __restrict__ counts) {
  __shared__ unsigned h[kRadix];
  const int lane = threadIdx.x & 31;
  const long long n = n_first >= 0 ? n_first : totals[kKept];
  long long lo, hi;
  chunk_of(n, lo, hi);
  h[threadIdx.x] = 0;
  __syncthreads();
  for (long long i0 = lo; i0 < hi; i0 += kThreads) {
    const long long i = i0 + threadIdx.x;
    const unsigned key = i < hi ? keys[i] : kDropped;
    const bool ok = key != kDropped;
    const unsigned digit = (key >> shift) & (kRadix - 1);
    const unsigned active = __ballot_sync(kFull, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(active, digit);
      if (lane == __ffs(peers) - 1) atomicAdd(h + digit, __popc(peers));
    }
  }
  __syncthreads();
  counts[(long long)blockIdx.x * kRadix + threadIdx.x] = h[threadIdx.x];
}

// one block: counts[b][d] becomes the count of digit d in blocks before b,
// base[d] the count of digits below d; the first pass's total is the
// number kept
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_sort_scan(unsigned* __restrict__ counts,
                                     unsigned* __restrict__ base, int grid,
                                     int* __restrict__ totals, int first) {
  __shared__ unsigned s[kRadix];
  const int d = threadIdx.x;
  unsigned run = 0;
#pragma unroll 8
  for (int b = 0; b < grid; ++b) {
    const unsigned c = counts[(long long)b * kRadix + d];
    counts[(long long)b * kRadix + d] = run;
    run += c;
  }
  s[d] = run;
  __syncthreads();
  for (int k = 1; k < kRadix; k <<= 1) {      // inclusive scan over digits
    const unsigned x = d >= k ? s[d - k] : 0;
    __syncthreads();
    s[d] += x;
    __syncthreads();
  }
  base[d] = s[d] - run;
  if (first && d == kRadix - 1) totals[kKept] = (int)s[d];
}

// the stable scatter of one pass; the first reads the keys kernel's rows
// (vals_in unused: an item's value is its index) and drops kDropped
template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_sort_scatter(
        const unsigned* __restrict__ keys_in, const int* __restrict__ vals_in,
        unsigned* __restrict__ keys_out, int* __restrict__ vals_out,
        const unsigned* __restrict__ counts,
        const unsigned* __restrict__ base_in, const int* __restrict__ totals,
        long long n_first, int shift) {
  __shared__ unsigned hist[kWarps][kRadix];
  __shared__ unsigned base[kRadix];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = FIRST ? n_first : totals[kKept];
  long long lo, hi;
  chunk_of(n, lo, hi);
  base[threadIdx.x] = base_in[threadIdx.x] +
                      counts[(long long)blockIdx.x * kRadix + threadIdx.x];
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  for (long long t0 = lo; t0 < hi; t0 += kTile) {
    for (int k = threadIdx.x; k < kWarps * kRadix; k += kThreads)
      (&hist[0][0])[k] = 0;
    __syncthreads();
    // warp w ranks items t0 + w * kRanks * 32 + [0, kRanks * 32), in order
    unsigned key[kRanks], rank[kRanks];
    int val[kRanks];
#pragma unroll
    for (int it = 0; it < kRanks; ++it) {
      const long long i = t0 + (warp * kRanks + it) * 32 + lane;
      key[it] = i < hi ? keys_in[i] : kDropped;
      val[it] = FIRST ? (int)i : (i < hi ? vals_in[i] : 0);
    }
#pragma unroll
    for (int it = 0; it < kRanks; ++it) {
      const bool ok = key[it] != kDropped;
      const unsigned digit = (key[it] >> shift) & (kRadix - 1);
      const unsigned active = __ballot_sync(kFull, ok);
      unsigned peers = 0;
      rank[it] = 0;
      if (ok) {
        peers = __match_any_sync(active, digit);
        rank[it] = hist[warp][digit] + __popc(peers & below);
      }
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) hist[warp][digit] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    {  // digit d: the warps' offsets in warp order, after the tiles before
      const int d = threadIdx.x;
      unsigned s = base[d];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned c = hist[w][d];
        hist[w][d] = s;
        s += c;
      }
      base[d] = s;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kRanks; ++it) {
      if (key[it] == kDropped) continue;
      const unsigned pos =
          hist[warp][(key[it] >> shift) & (kRadix - 1)] + rank[it];
      keys_out[pos] = key[it];
      vals_out[pos] = val[it];
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ runs
// the length of the run of sorted rows that starts at i (s[i - 1] != s[i])
__device__ long long run_length(const unsigned* __restrict__ s, long long i,
                                long long n) {
  const unsigned row = s[i];
  long long lo = i, hi = n, step = 1;
  while (true) {                       // gallop: s[lo] == row
    const long long p = i + step;
    if (p >= n) break;
    if (s[p] != row) {
      hi = p;
      break;
    }
    lo = p;
    step <<= 1;
  }
  while (hi - lo > 1) {                // s[lo] == row, s[hi] != row or n
    const long long mid = lo + (hi - lo) / 2;
    if (s[mid] == row)
      lo = mid;
    else
      hi = mid;
  }
  return hi - i;
}

struct Run3 {
  int runs, longs, rest;   // runs, runs of more than kPiece, scratch rows
};

__device__ __forceinline__ Run3 add3(Run3 a, Run3 b) {
  return {a.runs + b.runs, a.longs + b.longs, a.rest + b.rest};
}

__device__ __forceinline__ Run3 run_at(const unsigned* __restrict__ s,
                                       long long i, long long hi, long long n,
                                       long long& len) {
  len = 0;
  if (i >= hi || (i > 0 && s[i - 1] == s[i])) return {0, 0, 0};
  len = run_length(s, i, n);
  const int pieces = (int)((len + kPiece - 1) / kPiece);
  return {1, pieces > 1, pieces - 1};
}

// exclusive scan of x over the block; *total gets the block's sum
__device__ Run3 block_scan(Run3 x, Run3* total) {
  __shared__ Run3 warps[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Run3 inc = x;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const Run3 y = {__shfl_up_sync(kFull, inc.runs, k),
                    __shfl_up_sync(kFull, inc.longs, k),
                    __shfl_up_sync(kFull, inc.rest, k)};
    if (lane >= k) inc = add3(inc, y);
  }
  if (lane == 31) warps[warp] = inc;
  __syncthreads();
  Run3 before = {0, 0, 0}, all = {0, 0, 0};
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = add3(before, warps[w]);
    all = add3(all, warps[w]);
  }
  __syncthreads();                     // warps[] is reused by the next call
  *total = all;
  return {before.runs + inc.runs - x.runs, before.longs + inc.longs - x.longs,
          before.rest + inc.rest - x.rest};
}

__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_runs_count(const unsigned* __restrict__ s,
                                      const int* __restrict__ totals,
                                      int* __restrict__ run_counts) {
  const long long n = totals[kKept];
  long long lo, hi, len;
  chunk_of(n, lo, hi);
  Run3 mine = {0, 0, 0};
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    mine = add3(mine, run_at(s, i, hi, n, len));
  Run3 sum;
  block_scan(mine, &sum);
  if (threadIdx.x == 0) {
    run_counts[3 * blockIdx.x] = sum.runs;
    run_counts[3 * blockIdx.x + 1] = sum.longs;
    run_counts[3 * blockIdx.x + 2] = sum.rest;
  }
}

__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_runs_write(
        const unsigned* __restrict__ s, int* __restrict__ totals,
        const int* __restrict__ run_counts, int* __restrict__ run_start,
        int* __restrict__ run_len, int* __restrict__ long_start,
        int* __restrict__ long_len, int* __restrict__ long_first) {
  const long long n = totals[kKept];
  long long lo, hi, len;
  chunk_of(n, lo, hi);
  // the blocks before this one, and all of them
  Run3 before = {0, 0, 0}, all = {0, 0, 0};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    const Run3 c = {run_counts[3 * b], run_counts[3 * b + 1],
                    run_counts[3 * b + 2]};
    if (b < (int)blockIdx.x) before = add3(before, c);
    all = add3(all, c);
  }
  Run3 carry, sum;
  block_scan(before, &carry);
  block_scan(all, &sum);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    totals[kRuns] = sum.runs;
    totals[kLong] = sum.longs;
    totals[kRest] = sum.rest;
  }
  for (long long i0 = lo; i0 < hi; i0 += kThreads) {
    const long long i = i0 + threadIdx.x;
    const Run3 mine = run_at(s, i, hi, n, len);
    Run3 tile;
    const Run3 at = add3(carry, block_scan(mine, &tile));
    if (mine.runs) {
      run_start[at.runs] = (int)i;
      run_len[at.runs] = (int)len;
      if (mine.longs) {
        long_start[at.longs] = (int)i;
        long_len[at.longs] = (int)len;
        long_first[at.longs] = at.rest;
      }
    }
    carry = add3(carry, tile);
  }
}

// ---------------------------------------------------------------- reduce
// a group of 2^lanes_log2 lanes a piece: the first piece of run t (t <
// runs) into its row, or scratch row q = t - runs, a later piece of a long
// run; items added in order from +0
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_reduce(
        const T* __restrict__ grad_out, const float* __restrict__ weights,
        const unsigned* __restrict__ s, const int* __restrict__ items,
        const int* __restrict__ totals, const int* __restrict__ run_start,
        const int* __restrict__ run_len, const int* __restrict__ long_start,
        const int* __restrict__ long_len, const int* __restrict__ long_first,
        float* __restrict__ grad, float* __restrict__ scratch, int l, int d,
        int lanes_log2) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int groups = 32 >> lanes_log2;
  const int group = lane >> lanes_log2;
  const int sub = lane & (lanes - 1);
  const int vectors = d / VEC;
  const long long runs = totals[kRuns];
  const int n_long = totals[kLong];
  const long long pieces = runs + totals[kRest];
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long t = warp * groups + group; t < pieces;
       t += n_warps * groups) {
    long long start;
    int len;
    float* dst;
    if (t < runs) {
      start = run_start[t];
      len = min(run_len[t], kPiece);
      dst = grad + (long long)s[start] * d;
    } else {
      const int q = (int)(t - runs);
      int a = 0, b = n_long;             // the last k with long_first[k] <= q
      while (b - a > 1) {
        const int m = (a + b) >> 1;
        if (long_first[m] <= q)
          a = m;
        else
          b = m;
      }
      const int j = q - long_first[a] + 1;
      start = long_start[a] + (long long)j * kPiece;
      len = min(kPiece, long_len[a] - j * kPiece);
      dst = scratch + (long long)q * d;
    }
    for (int j0 = 0; j0 < vectors; j0 += lanes * kVpl) {
      float acc[kVpl][VEC];
#pragma unroll
      for (int u = 0; u < kVpl; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
      for (int k0 = 0; k0 < len; k0 += kUnroll) {
        int item[kUnroll];
        float w[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          item[k] = k0 + k < len ? __ldg(items + start + k0 + k) : -1;
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          w[k] = item[k] >= 0 ? __ldg(weights + item[k]) : 0.f;
        float x[kUnroll][kVpl][VEC];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
#pragma unroll
          for (int u = 0; u < kVpl; ++u) {
            const int j = j0 + u * lanes + sub;
            if (item[k] >= 0 && j < vectors)
              Load<T, VEC>::get(grad_out + (long long)(item[k] / l) * d +
                                    j * VEC,
                                x[k][u]);
            else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) x[k][u][e] = 0.f;
            }
          }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (item[k] < 0) break;
#pragma unroll
          for (int u = 0; u < kVpl; ++u)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[u][e] = __fadd_rn(acc[u][e], __fmul_rn(w[k], x[k][u][e]));
        }
      }
#pragma unroll
      for (int u = 0; u < kVpl; ++u) {
        const int j = j0 + u * lanes + sub;
        if (j < vectors) store_f<VEC>(dst + j * VEC, acc[u]);
      }
    }
  }
}

// a warp a vector j of a long run's row (blockIdx.x and the warp give j;
// blockIdx.y walks the long runs, so a row's blocks are consecutive and
// spread over the SMs): the row holds the first piece; add the later
// pieces' scratch rows in piece order.  The lanes load 32 pieces at
// once, kUnroll rounds in flight, and every lane adds them in lane order
// through shuffles, so the order is the pieces' and a hot row's thousands
// of partials are loaded by a warp a vector
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_combine(
        const unsigned* __restrict__ s, const int* __restrict__ totals,
        const int* __restrict__ long_start, const int* __restrict__ long_len,
        const int* __restrict__ long_first, float* __restrict__ grad,
        const float* __restrict__ scratch, int d) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= d / VEC) return;                       // the whole warp
  const int n_long = totals[kLong];
  for (int k = blockIdx.y; k < n_long; k += gridDim.y) {
    float* row = grad + (long long)s[long_start[k]] * d + j * VEC;
    const float* part = scratch + (long long)long_first[k] * d + j * VEC;
    const int later = (long_len[k] + kPiece - 1) / kPiece - 1;
    float acc[VEC];
    load_f<VEC>(row, acc);
    for (int p0 = 0; p0 < later; p0 += 32 * kUnroll) {
      float x[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * 32 + lane;
        if (p < later) {
          load_f<VEC>(part + (long long)p * d, x[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int n = min(32, later - p0 - u * 32);   // the same in the warp
        for (int i = 0; i < n; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], __shfl_sync(kFull, x[u][e], i));
      }
    }
    if (lane == 0) store_f<VEC>(row, acc);
  }
}

// ---------------------------------------------------------------- launch
// the workspace, in 4-byte words, each part on 256 bytes
struct Layout {
  long long keys_a, vals_a, keys_b, vals_b, counts, base, totals, run_counts,
      run_start, run_len, long_start, long_len, long_first, scratch, words;
};

long long up64(long long w) { return (w + 63) / 64 * 64; }

Layout layout(long long n, int sort_grid, int d) {
  Layout o;
  long long at = 0;
  auto take = [&](long long words) {
    const long long p = at;
    at += up64(words);
    return p;
  };
  const long long longs = n / (kPiece + 1) + 1;
  o.keys_a = take(n);
  o.vals_a = take(n);
  o.keys_b = take(n);
  o.vals_b = take(n);
  o.counts = take((long long)sort_grid * kRadix);
  o.base = take(kRadix);
  o.totals = take(kTotals);
  o.run_counts = take(3LL * sort_grid);
  o.run_start = take(n);
  o.run_len = take(n);
  o.long_start = take(longs);
  o.long_len = take(longs);
  o.long_first = take(longs);
  o.scratch = take((n + kPiece - 1) / kPiece * d);
  o.words = at;
  return o;
}

template <typename T, int VEC>
cudaError_t run(const void* grad_out_, const int* ids, const float* w,
                float* grad, int* ws, const Layout& o, long long v,
                long long n, int l, int d, int lanes_log2, int keys_grid,
                int sort_grid, int passes, int reduce_grid, int combine_grid,
                cudaStream_t st) {
  const T* grad_out = (const T*)grad_out_;
  auto* keys_a = (unsigned*)(ws + o.keys_a);
  auto* keys_b = (unsigned*)(ws + o.keys_b);
  int* vals_a = ws + o.vals_a;
  int* vals_b = ws + o.vals_b;
  auto* counts = (unsigned*)(ws + o.counts);
  auto* base = (unsigned*)(ws + o.base);
  int* totals = ws + o.totals;
  cudaError_t err;
#define CHECK_LAUNCH()                                \
  if ((err = cudaGetLastError()) != cudaSuccess) return err
  embedding_bag_backward_keys<T, VEC><<<keys_grid, kThreads, 0, st>>>(
      grad_out, ids, w, keys_a, v, n, l, d);
  CHECK_LAUNCH();
  unsigned *k_in = keys_a, *k_out = keys_b;
  int *v_in = vals_a, *v_out = vals_b;
  for (int p = 0; p < passes; ++p) {
    const long long n_first = p == 0 ? n : -1;
    const int shift = p * kRadixBits;
    embedding_bag_backward_sort_hist<<<sort_grid, kThreads, 0, st>>>(
        k_in, totals, n_first, shift, counts);
    CHECK_LAUNCH();
    embedding_bag_backward_sort_scan<<<1, kThreads, 0, st>>>(
        counts, base, sort_grid, totals, p == 0);
    CHECK_LAUNCH();
    if (p == 0)
      embedding_bag_backward_sort_scatter<true>
          <<<sort_grid, kThreads, 0, st>>>(k_in, v_in, k_out, v_out, counts,
                                           base, totals, n_first, shift);
    else
      embedding_bag_backward_sort_scatter<false>
          <<<sort_grid, kThreads, 0, st>>>(k_in, v_in, k_out, v_out, counts,
                                           base, totals, n_first, shift);
    CHECK_LAUNCH();
    unsigned* kt = k_in;
    k_in = k_out;
    k_out = kt;
    int* vt = v_in;
    v_in = v_out;
    v_out = vt;
  }
  // the sorted rows and items are in k_in, v_in
  int* run_counts = ws + o.run_counts;
  int* run_start = ws + o.run_start;
  int* run_len = ws + o.run_len;
  int* long_start = ws + o.long_start;
  int* long_len = ws + o.long_len;
  int* long_first = ws + o.long_first;
  auto* scratch = (float*)(ws + o.scratch);
  embedding_bag_backward_runs_count<<<sort_grid, kThreads, 0, st>>>(
      k_in, totals, run_counts);
  CHECK_LAUNCH();
  embedding_bag_backward_runs_write<<<sort_grid, kThreads, 0, st>>>(
      k_in, totals, run_counts, run_start, run_len, long_start, long_len,
      long_first);
  CHECK_LAUNCH();
  embedding_bag_backward_reduce<T, VEC><<<reduce_grid, kThreads, 0, st>>>(
      grad_out, w, k_in, v_in, totals, run_start, run_len, long_start,
      long_len, long_first, grad, scratch, l, d, lanes_log2);
  CHECK_LAUNCH();
  const dim3 combine_blocks((d / VEC + kWarps - 1) / kWarps, combine_grid);
  embedding_bag_backward_combine<VEC><<<combine_blocks, kThreads, 0, st>>>(
      k_in, totals, long_start, long_len, long_first, grad, scratch, d);
  CHECK_LAUNCH();
#undef CHECK_LAUNCH
  return cudaSuccess;
}

}  // namespace

extern "C" int embedding_bag_backward_warps() { return kWarps; }
extern "C" int embedding_bag_backward_piece() { return kPiece; }
extern "C" int embedding_bag_backward_radix_bits() { return kRadixBits; }

// the workspace the launch needs, in 4-byte words
extern "C" long long embedding_bag_backward_workspace_words(long long n,
                                                            int sort_grid,
                                                            int d) {
  return layout(n, sort_grid, d).words;
}

// grad [v, d] (float32, zeroed) += the bags' weighted grad_out rows, with
// the launch plan of kernel.py's `backward_plan`: bf16 selects a bfloat16
// grad_out (else float32); vec selects 16-byte loads, which need grad_out
// 16-byte aligned and rows a multiple of 16 bytes long; 2^lanes_log2
// lanes a piece; `passes` sort passes of kRadixBits over the
// rows' bits; the grids of the keys kernel, of the sort's and the runs'
// kernels, of the reduction and of the combine (its y; its x is the row's
// vectors over kWarps).  `workspace` holds `workspace_words` 4-byte
// words, 256-byte aligned.  Every kernel goes on
// `stream`, in order; nothing syncs.  Returns the first CUDA error.
extern "C" int embedding_bag_backward_launch(
    const void* grad_out, const void* indices, const void* weights,
    void* grad, void* workspace, long long workspace_words, long long v,
    long long n_bags, int l, int d, int bf16, int vec, int lanes_log2,
    int keys_grid, int sort_grid, int passes, int reduce_grid,
    int combine_grid, void* stream) {
  const long long n = n_bags * (long long)l;
  if (n_bags <= 0 || l <= 0 || d <= 0 || v <= 0 || v > (long long)kDropped ||
      n >= (1LL << 31) || keys_grid <= 0 || sort_grid <= 0 ||
      reduce_grid <= 0 || combine_grid <= 0 || lanes_log2 < 0 ||
      lanes_log2 > 5 || passes < 1 ||
      passes > (32 + kRadixBits - 1) / kRadixBits)
    return (int)cudaErrorInvalidValue;
  if (vec && d % (bf16 ? 8 : 4) != 0) return (int)cudaErrorInvalidValue;
  if (((unsigned long long)workspace) % 256 != 0)
    return (int)cudaErrorInvalidValue;
  const Layout o = layout(n, sort_grid, d);
  if (workspace_words < o.words) return (int)cudaErrorInvalidValue;
  const auto ids = (const int*)indices;
  const auto wt = (const float*)weights;
  const auto out = (float*)grad;
  const auto ws = (int*)workspace;
  const auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16)
    err = vec ? run<__nv_bfloat16, 8>(grad_out, ids, wt, out, ws, o, v, n, l,
                                      d, lanes_log2, keys_grid, sort_grid,
                                      passes, reduce_grid, combine_grid, s)
              : run<__nv_bfloat16, 1>(grad_out, ids, wt, out, ws, o, v, n, l,
                                      d, lanes_log2, keys_grid, sort_grid,
                                      passes, reduce_grid, combine_grid, s);
  else
    err = vec ? run<float, 4>(grad_out, ids, wt, out, ws, o, v, n, l, d,
                              lanes_log2, keys_grid, sort_grid, passes,
                              reduce_grid, combine_grid, s)
              : run<float, 1>(grad_out, ids, wt, out, ws, o, v, n, l, d,
                              lanes_log2, keys_grid, sort_grid, passes,
                              reduce_grid, combine_grid, s);
  return (int)err;
}
