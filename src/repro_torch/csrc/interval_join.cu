// Containment join over GC-lists, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_join_kernel` / `interval_join_pallas`
// (src/repro/kernels/interval_join/kernel.py:21,57).  Same function:
//
//   a_s, a_e  [NA] int32   list A (starts, ends), PAD = INT_MAX invalid
//   b_s, b_e  [NB] int32   list B
//   out       [NA] int32   contained_in: out[i] = 1 iff some B[j] has
//                              b_s <= a_s && a_e <= b_e
//                          containing:   out[i] = 1 iff some B[j] has
//                              a_s <= b_s && b_e <= a_e
//                          PAD entries on either side never match.
//
// Contract: B is a GC-list — its valid starts strictly increase, so do its
// valid ends, and its PAD entries form the tail.  Then the first B whose
// end is >= a_e is the only candidate container of A[i] (every later one
// starts later, every earlier one ends too soon), and the first B whose
// start is >= a_s the only candidate A[i] can contain.  One lower-bound
// probe per element of B's probe keys (b_e for contained_in, b_s for
// containing) gives the dense definition exactly; the plain version
// (kernels/interval_join/ref.py) is the same probe with torch.searchsorted.
// A may be in any order, with PAD entries anywhere.
//
// Bound: memory.  The least traffic is each list read once and the mask
// written once, bytes = 4 * (2*NA + 2*NB + NA), over the card's memory
// rate (3.35 TB/s on an H100 SXM; chip_smoke.py's join_bound).
//
// What held the first design back: a thread an element, each binary-
// searching all of B in device memory, ceil(log2 NB) = 22 dependent loads
// at NB = 2.65 M, most of them L2 round trips in a chain.  It was bound by
// latency, not bytes (18 % of the bound on sorted lists, H100 SXM).
//
// Design: two kernels, one launch from the host.
// join_tiles_kernel takes a tile of kTile = 2048 elements of A a block,
// kPer = 8 consecutive a thread (16-byte loads of A and stores of the mask
// where all three are 16-byte aligned, 4-byte otherwise), 8 blocks a SM:
// 1. Window.  The tile's probe keys other than PAD give kmin and kmax (a
//    block reduction).  Every element's candidate lies in B[lo .. hi], lo
//    and hi the lower bounds of kmin and kmax; the window is B[lo ..
//    min(hi, NB-1)].  lo and hi are found together by a block-wide 256-ary
//    search, one probe a thread a bound a level, until each is known to
//    within kSlack entries.  The first level probes the same keys in every
//    block and is loaded with the tile, so at NB = 2.65 M the chain is A,
//    one more level (L2-resident: the tiles of one first-level bucket share
//    its probes), then the copy below, where a thread's own search was 22
//    loads.
// 2. Stage.  If the window can still fit the budget, B's probe keys and
//    other ends over the two bounds' ranges, and the tile's other ends of
//    A, are copied to shared memory by cp.async in 16-byte pieces (4-byte
//    pieces where unaligned); every warp then finds the exact bounds there
//    by two ballots.
// 3. Search.  A window of at most `budget` entries is searched in shared
//    memory, branch-free: each thread finds the candidates of its least
//    and greatest key (two searches in lockstep over the window), then
//    those of its elements between the two (on a sorted A a few entries
//    apart, so a step or two each): about a third of the shared loads of
//    a whole-window search for every element, which took a fifth of the
//    kernel's time at J1 on an H100 SXM.  The mask is written once.
// 4. A wider window (A in no order, or a sparse A over a dense B): in a
//    grid of more than kInlineGrid tiles the tile is listed, and its other
//    ends of A are never read here.  The last block to finish tail-launches
//    join_wide_kernel over the listed tiles only — the first design's
//    kernel, a thread an element, with no shared memory, so that the L1
//    keeps B's top levels as it did there.  With no wide tile nothing is
//    launched.  (The same search in the first kernel, 8 a thread in
//    lockstep, ran 1.2-1.3× the first design at J1 in no order on an H100
//    SXM: its shared memory came out of that L1.)  A grid of at most
//    kInlineGrid tiles, a block or so a SM, searches its wide tiles itself
//    in device memory between the same two bounds, where a tail launch's
//    latency would be most of the call.
// A list of one tile takes the first design's kernel alone (`direct`,
// join_direct_kernel): a launch-bound call that a window does not shorten.
// Nothing is shared between blocks but the list, its counter and the
// optional tile counters (`counts`).  wgmma and TMA do not apply (no
// products; the windows are a few KB, at unaligned offsets).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = INT_MAX;
constexpr int kThreads = 256;            // a block; one probe a thread a level
constexpr int kWarps = kThreads / 32;
constexpr int kSlack = 64;               // candidates a bound may keep: two a lane
constexpr int kPer = 8;                  // elements of A a thread
constexpr int kTile = kThreads * kPer;   // elements of A a block
constexpr int kInlineGrid = 132;         // grids up to a block a SM search
                                         // their wide tiles themselves

// Shared-memory entries of one staged array for a window budget: the two
// bounds' ranges add up to kSlack each, and 16-byte pieces up to 3 at
// either end.
__host__ __device__ constexpr int capacity(int budget) {
  return budget + 2 * kSlack + 8;
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

// Thread t of a block owns the tile's elements kN*t .. kN*t + kN - 1,
// consecutive so that on a sorted A their candidates lie close together.
// They move in pieces of 4: one 16-byte access with kVec = 4, four 4-byte
// accesses otherwise (a warp's pieces then share their sectors in the L1).
// PAD stands past the tile's n elements.  A is read once: streaming loads
// and stores keep B in the L2.
template <int kN, int kVec>
__device__ __forceinline__ void load_tile(const int* __restrict__ src, int n,
                                          int t, int (&x)[kN]) {
#pragma unroll
  for (int v = 0; v < kN / 4; ++v) {
    const int o = kN * t + 4 * v;
    if (kVec == 4 && o + 3 < n) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(src + o));
      x[4 * v] = q.x;
      x[4 * v + 1] = q.y;
      x[4 * v + 2] = q.z;
      x[4 * v + 3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[4 * v + c] = o + c < n ? __ldcs(src + o + c) : kPad;
      }
    }
  }
}

// A thread's kN consecutive elements of a tile in shared memory, 16 bytes
// at a time (src is 16-byte aligned).
template <int kN>
__device__ __forceinline__ void read_own(const int* src, int t,
                                         int (&x)[kN]) {
#pragma unroll
  for (int v = 0; v < kN / 4; ++v) {
    const int4 q = reinterpret_cast<const int4*>(src + kN * t)[v];
    x[4 * v] = q.x;
    x[4 * v + 1] = q.y;
    x[4 * v + 2] = q.z;
    x[4 * v + 3] = q.w;
  }
}

// The same elements copied to dst at their tile offsets by cp.async.
template <int kN, int kVec>
__device__ __forceinline__ void copy_tile(int* dst, const int* __restrict__ src,
                                          int n, int t) {
#pragma unroll
  for (int v = 0; v < kN / 4; ++v) {
    const int o = kN * t + 4 * v;
    if (kVec == 4 && o + 3 < n) {
      cp_async16(dst + o, src + o);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (o + c < n) cp_async4(dst + o + c, src + o + c);
      }
    }
  }
}

template <int kN, int kVec>
__device__ __forceinline__ void store_tile(int* __restrict__ dst, int n,
                                           int t, unsigned hits) {
#pragma unroll
  for (int v = 0; v < kN / 4; ++v) {
    const int o = kN * t + 4 * v;
    const unsigned h = hits >> (4 * v);
    if (kVec == 4 && o + 3 < n) {
      __stcs(reinterpret_cast<int4*>(dst + o),
             make_int4(h & 1, h >> 1 & 1, h >> 2 & 1, h >> 3 & 1));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (o + c < n) __stcs(dst + o + c, int(h >> c & 1));
      }
    }
  }
}

template <bool kGlobal>
__device__ __forceinline__ int read(const int* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// r[j] = the first index in [0, len) whose key is >= x[j], or len; len >= 1.
// Branch-free, the kN searches in lockstep: each takes ceil(log2 len) + 1
// steps, kN independent loads a step (of shared memory, or of device
// memory with kGlobal).
template <int kN, bool kGlobal>
__device__ __forceinline__ void lower_bounds(const int* key, int len,
                                             const int (&x)[kN],
                                             int (&r)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) r[j] = 0;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      r[j] = read<kGlobal>(key + r[j] + half) < x[j] ? r[j] + half : r[j];
    }
    len -= half;
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) r[j] += read<kGlobal>(key + r[j]) < x[j];
}

// The hits of a thread's kN consecutive elements (keys x, other ends y_of
// their tile offsets, `valid` bits) against a window of B: its probe keys
// `key` and other ends `other`, `len` >= 1 entries from B[first], which
// holds every valid element's candidate.  In shared memory the thread
// finds the candidates of its least and greatest key (two searches over
// the window), then those of its elements between the two — on a sorted A
// a few entries apart; in device memory (a wide tile, its elements in any
// order) it searches the whole window for each, so that the chain of
// dependent loads stays one search long.  4 elements at a time.
template <bool kContainedIn, int kN, bool kGlobal>
__device__ __forceinline__ unsigned window_hits(
    const int* key, const int* other, int first, int len, int nb,
    const int (&x)[kN], const int* y_of, unsigned valid, int own_min,
    int own_max) {
  int ends[2] = {0, len};
  if constexpr (!kGlobal) {
    const int own[2] = {own_min, own_max};
    lower_bounds<2, false>(key, len, own, ends);
  }
  const int span = ends[1] - ends[0];
  unsigned hits = 0;
#pragma unroll
  for (int v = 0; v < kN / 4; ++v) {
    const int xs[4] = {x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]};
    int r[4] = {0, 0, 0, 0}, y[4];
    if (span > 0) lower_bounds<4, kGlobal>(key + ends[0], span, xs, r);
    if constexpr (kGlobal) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[c] = valid >> (4 * v + c) & 1 ? __ldg(y_of + 4 * v + c) : kPad;
      }
    } else {
      read_own<4>(y_of + 4 * v, 0, y);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ends[0] + r[c], j = 4 * v + c;
      if ((valid >> j & 1) && first + i < nb) {
        bool ok;
        if constexpr (kContainedIn) {   // b_s <= a_s (and b_e >= a_e)
          const int bs = read<kGlobal>(other + i);
          ok = y[c] != kPad && bs != kPad && bs <= y[c];
        } else {                        // b_e <= a_e (and b_s >= a_s)
          ok = read<kGlobal>(key + i) != kPad && read<kGlobal>(other + i) <= y[c];
        }
        hits |= unsigned(ok) << j;
      }
    }
  }
  return hits;
}

// First index in [lo, hi) whose key is >= x, or hi (the first design's
// search, kept for the wide tiles).
__device__ __forceinline__ int lower_bound(const int* __restrict__ key,
                                           int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(key + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One level of the 256-ary search: the answer lies in [lo, hi], thread t
// probed lo + (t + 1) * step - 1, and the c lowest probes were below x.
__device__ __forceinline__ void narrow(int c, int step, int& lo, int& hi) {
  const long long next = lo + (long long)c * step;
  hi = (int)min((long long)hi, next + step - 1);
  lo = (int)next;
}

__device__ __forceinline__ int probe_step(int lo, int hi) {
  return hi > lo ? (hi - lo - 1) / kThreads + 1 : 0;
}

__device__ __forceinline__ bool probe_below(const int* __restrict__ key,
                                            int lo, int hi, int step, int t,
                                            int x) {
  const long long q = lo + (long long)(t + 1) * step - 1;
  return step > 0 && q < hi && __ldg(key + q) < x;
}

// Entries below x among key[lo, hi), hi - lo <= kSlack, staged at win[g - a0].
__device__ __forceinline__ int count_below(const int* win, int a0, int lo,
                                           int hi, int x, int lane) {
  const int g0 = lo + lane, g1 = lo + 32 + lane;
  const unsigned m0 = __ballot_sync(~0u, g0 < hi && win[g0 - a0] < x);
  const unsigned m1 = __ballot_sync(~0u, g1 < hi && win[g1 - a0] < x);
  return __popc(m0) + __popc(m1);
}

// The first design's search for element i of A: the first B whose probe
// key is >= its own, in all of B in device memory, and the check.
template <bool kContainedIn>
__device__ __forceinline__ int first_design_hit(const int* __restrict__ a_s,
                                                const int* __restrict__ a_e,
                                                const int* __restrict__ b_s,
                                                const int* __restrict__ b_e,
                                                int nb, int i) {
  const int as = a_s[i], ae = a_e[i];
  if (as == kPad) return 0;
  const int j = lower_bound(kContainedIn ? b_e : b_s, 0, nb,
                            kContainedIn ? ae : as);
  if (j >= nb) return 0;
  const int bs = b_s[j], be = b_e[j];
  return bs != kPad && (kContainedIn ? bs <= as : be <= ae);
}

// The first design's kernel, a thread an element, over all of A: a list
// of one tile (`direct`).
template <bool kContainedIn>
__global__ void __launch_bounds__(kThreads)
join_direct_kernel(const int* __restrict__ a_s, const int* __restrict__ a_e,
                   const int* __restrict__ b_s, const int* __restrict__ b_e,
                   int* __restrict__ out, int na, int nb) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < na) out[i] = first_design_hit<kContainedIn>(a_s, a_e, b_s, b_e, nb, i);
}

// The same over the tiles listed in `wide` (block b: tile wide[b / (tile /
// kThreads)]), tail-launched by join_tiles_kernel.  It takes no shared
// memory, so the L1 keeps its full size for B's top levels.
template <bool kContainedIn>
__global__ void __launch_bounds__(kThreads)
join_wide_kernel(const int* __restrict__ a_s, const int* __restrict__ a_e,
                 const int* __restrict__ b_s, const int* __restrict__ b_e,
                 int* __restrict__ out, int na, int nb,
                 const int* __restrict__ wide, int tile) {
  const int chunks = tile / kThreads;
  const int i = wide[blockIdx.x / chunks] * tile +
                (blockIdx.x % chunks) * kThreads + threadIdx.x;
  if (i < na) out[i] = first_design_hit<kContainedIn>(a_s, a_e, b_s, b_e, nb, i);
}

// 8 blocks a SM (32 registers a thread): the more tiles' chains of loads in
// flight, the nearer the memory bound.  With 8 elements a thread a few
// registers spill (at most 36 bytes, to the L1); 6 blocks of 40 registers,
// which do not spill, measured slower at J1 (H100 SXM).
template <bool kContainedIn, int kVec>
__global__ void __launch_bounds__(kThreads, 8)
join_tiles_kernel(const int* __restrict__ a_s, const int* __restrict__ a_e,
                  const int* __restrict__ b_s, const int* __restrict__ b_e,
                  int* __restrict__ out, int na, int nb, int budget, int vec_b,
                  unsigned long long* __restrict__ ctrl,
                  int* __restrict__ wide, int* __restrict__ counts) {
  extern __shared__ int4 staged[];
  __shared__ int red[2][kWarps];
  int* win_key = reinterpret_cast<int*>(staged);
  int* win_other = win_key + capacity(budget);
  int* tile_y = win_other + capacity(budget);

  const int* __restrict__ key_b = kContainedIn ? b_e : b_s;
  const int* __restrict__ other_b = kContainedIn ? b_s : b_e;
  const int t = threadIdx.x, lane = t & 31;
  const int base = blockIdx.x * kTile;
  const int n = min(kTile, na - base);

  // The first level's probe, loaded with the tile's probe keys.
  const bool levels = nb > kSlack;
  const int step1 = probe_step(0, nb);
  const long long p1 = (long long)(t + 1) * step1 - 1;
  const int v1 = levels && p1 < nb ? __ldg(key_b + p1) : 0;

  // x: the probe keys (a_e for contained_in, a_s for containing); y, read
  // once the tile is known to be staged: the other ends, which the
  // candidate is checked against.  The window covers the keys that are not
  // PAD; a hit also needs a_s != PAD (so a_e = PAD never matches, as in the
  // plain version).
  const int* __restrict__ a_x = (kContainedIn ? a_e : a_s) + base;
  const int* __restrict__ a_y = (kContainedIn ? a_s : a_e) + base;
  int x[kPer];
  load_tile<kPer, kVec>(a_x, n, t, x);
  int kmin = INT_MAX, kmax = INT_MIN;
  unsigned valid = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (x[j] != kPad) {
      valid |= 1u << j;
      kmin = min(kmin, x[j]);
      kmax = max(kmax, x[j]);
    }
  }
  const int own_min = kmin, own_max = kmax;   // this thread's elements'
  kmin = __reduce_min_sync(~0u, kmin);
  kmax = __reduce_max_sync(~0u, kmax);
  if (lane == 0) {
    red[0][t >> 5] = kmin;
    red[1][t >> 5] = kmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    kmin = min(kmin, red[0][w]);
    kmax = max(kmax, red[1][w]);
  }

  int path = 2;                          // 0 staged, 1 device memory, 2 none
  unsigned hits = 0;
  if (kmin <= kmax && nb > 0) {
    // Lower bounds of kmin in [lo0, hi0] and of kmax in [lo1, hi1]; the
    // window holds at least B[hi0 .. min(lo1, NB-1)].
    int lo0 = 0, hi0 = nb, lo1 = 0, hi1 = nb;
    bool too_wide = false;
    int gl = 0, glen = 0;                // a wide tile's candidates' range
    if (levels) {
      const int c0 = __syncthreads_count(p1 < nb && v1 < kmin);
      const int c1 = __syncthreads_count(p1 < nb && v1 < kmax);
      narrow(c0, step1, lo0, hi0);
      narrow(c1, step1, lo1, hi1);
      too_wide = min(lo1, nb - 1) - hi0 + 1 > budget;
      if (!too_wide) copy_tile<kPer, kVec>(tile_y, a_y, n, t);
      while (!too_wide && (hi0 - lo0 > kSlack || hi1 - lo1 > kSlack)) {
        const int st0 = probe_step(lo0, hi0), st1 = probe_step(lo1, hi1);
        const bool below0 = probe_below(key_b, lo0, hi0, st0, t, kmin);
        const bool below1 = probe_below(key_b, lo1, hi1, st1, t, kmax);
        const int d0 = __syncthreads_count(below0);
        const int d1 = __syncthreads_count(below1);
        narrow(d0, st0, lo0, hi0);
        narrow(d1, st1, lo1, hi1);
        too_wide = min(lo1, nb - 1) - hi0 + 1 > budget;
      }
    } else {
      copy_tile<kPer, kVec>(tile_y, a_y, n, t);
    }
    if (!too_wide) {
      // Stage B[lo0 .. min(hi1, NB-1)] (at most budget + 2 kSlack entries),
      // entry g at [g - a0].
      const int hi = min(hi1, nb - 1);
      const int a0 = vec_b ? lo0 & ~3 : lo0;
      for (int i = a0 + 4 * t; i <= hi; i += 4 * kThreads) {
        if (vec_b && i + 3 < nb) {
          cp_async16(win_key + (i - a0), key_b + i);
          cp_async16(win_other + (i - a0), other_b + i);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (i + c <= hi) {
              cp_async4(win_key + (i - a0 + c), key_b + i + c);
              cp_async4(win_other + (i - a0 + c), other_b + i + c);
            }
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      const int lo = lo0 + count_below(win_key, a0, lo0, hi0, kmin, lane);
      const int last = min(lo1 + count_below(win_key, a0, lo1, hi1, kmax, lane),
                           nb - 1);
      const int w = last - lo + 1;       // the exact window
      too_wide = w > budget;
      if (!too_wide && w > 0 && valid != 0) {
        hits = window_hits<kContainedIn, kPer, false>(
            win_key + (lo - a0), win_other + (lo - a0), lo, w, nb, x,
            tile_y + kPer * t, valid, own_min, own_max);
      }
      if (too_wide) {
        gl = lo;
        glen = w;
      }
    } else {
      gl = lo0;
      glen = min(hi1, nb - 1) - lo0 + 1;
    }
    path = too_wide ? 1 : 0;
    // A small grid (a block or so a SM) searches its wide tiles itself, in
    // device memory, rather than wait for a tail launch.
    if (too_wide && gridDim.x <= kInlineGrid && valid != 0) {
      hits = window_hits<kContainedIn, kPer, true>(
          key_b + gl, other_b + gl, gl, glen, nb, x, a_y + kPer * t, valid,
          own_min, own_max);
    }
  }
  const bool listed = path == 1 && gridDim.x > kInlineGrid;
  if (!listed) store_tile<kPer, kVec>(out + base, n, t, hits);
  if (t == 0) {
    if (counts != nullptr) atomicAdd(counts + path, 1);
    // ctrl counts the blocks done (high half) and the tiles listed (low
    // half).  The last block launches the wide tiles' kernel, which runs
    // once this grid is done (so every list entry is in place) and before
    // the stream's next work, and leaves ctrl at zero for the next launch
    // on the stream.
    const unsigned long long seen =
        atomicAdd(ctrl, (1ull << 32) | unsigned(listed));
    const int n_listed = int(seen & 0xffffffffu) + listed;
    if (listed) wide[n_listed - 1] = blockIdx.x;
    if (seen >> 32 == gridDim.x - 1) {
      *ctrl = 0;
      if (n_listed > 0) {
        join_wide_kernel<kContainedIn>
            <<<n_listed * kPer, kThreads, 0, cudaStreamTailLaunch>>>(
                a_s, a_e, b_s, b_e, out, na, nb, wide, kTile);
      }
    }
  }
}

template <bool kContainedIn>
cudaError_t launch(const int* as, const int* ae, const int* bs, const int* be,
                   int* out, int na, int nb, int budget, int vec_a, int vec_b,
                   int grid, int direct, unsigned long long* ctrl, int* wide,
                   int* counts, cudaStream_t s) {
  const size_t smem = sizeof(int) * (2 * capacity(budget) + kTile);
  if (direct) {
    join_direct_kernel<kContainedIn>
        <<<(na - 1) / kThreads + 1, kThreads, 0, s>>>(as, ae, bs, be, out, na,
                                                      nb);
  } else if (vec_a) {
    join_tiles_kernel<kContainedIn, 4><<<grid, kThreads, smem, s>>>(
        as, ae, bs, be, out, na, nb, budget, vec_b, ctrl, wide, counts);
  } else {
    join_tiles_kernel<kContainedIn, 1><<<grid, kThreads, smem, s>>>(
        as, ae, bs, be, out, na, nb, budget, vec_b, ctrl, wide, counts);
  }
  return cudaGetLastError();
}

}  // namespace

// The launch of kernels/interval_join/kernel.py's plan on `stream`.
// join_tiles_kernel: `tile` (= kTile) elements of A a block of `threads`
// (= kThreads), a window budget of `budget` entries (a multiple of 4; the
// staged arrays and the tile's other ends within 48 KB of shared memory),
// 16-byte accesses of A and the mask when vec_a, 16-byte copies of B's
// windows when vec_b, `grid` = ceil(na / tile) blocks.  Past kInlineGrid
// blocks its last block launches join_wide_kernel over the tiles it found
// too wide, if any, as a tail launch (the stream's next work waits for
// it).  `ctrl` (uint64 [1]) must be zero, and is zero again once the
// launch has run: one for each stream.  `wide` (int32 [grid]) is scratch.
// With `direct` (a list of one tile) join_direct_kernel alone; ctrl and
// wide may then be null.  `counts` (int32 [3], or null) gains each
// join_tiles_kernel tile's path: staged, device memory, nothing to search.
// Returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// launch off the plan.  Does not synchronise and allocates nothing: the
// caller owns every buffer.
extern "C" int interval_join_launch(const void* a_s, const void* a_e,
                                    const void* b_s, const void* b_e,
                                    void* out, int na, int nb, int containing,
                                    int tile, int threads, int budget,
                                    int vec_a, int vec_b, int grid,
                                    int direct, void* ctrl, void* wide,
                                    void* counts, void* stream) {
  if (na <= 0 || nb < 0 || tile != kTile || threads != kThreads ||
      grid != (na - 1) / kTile + 1 || budget < 4 || budget % 4 != 0 ||
      sizeof(int) * (2 * capacity(budget) + kTile) > 48 * 1024 ||
      (direct && grid != 1) ||
      (!direct && (ctrl == nullptr || wide == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = (cudaStream_t)stream;
  const auto as = (const int*)a_s, ae = (const int*)a_e;
  const auto bs = (const int*)b_s, be = (const int*)b_e;
  const auto o = (int*)out;
  const auto k = (unsigned long long*)ctrl;
  const auto w = (int*)wide, c = (int*)counts;
  return (int)(containing ? launch<false>(as, ae, bs, be, o, na, nb, budget,
                                          vec_a, vec_b, grid, direct, k, w, c,
                                          s)
                          : launch<true>(as, ae, bs, be, o, na, nb, budget,
                                         vec_a, vec_b, grid, direct, k, w, c,
                                         s));
}
