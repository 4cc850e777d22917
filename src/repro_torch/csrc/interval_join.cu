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
// probe per element gives the dense definition exactly; the plain version
// (kernels/interval_join/ref.py) is the same probe with torch.searchsorted.
// A may be in any order.
//
// Bound: memory.  The least traffic is each list read once and the mask
// written once, bytes = 4 * (2*NA + 2*NB + NA), over the card's memory
// rate (3.35 TB/s on an H100 SXM); there is no arithmetic to speak of.
//
// Design.  The TPU kernel visits every (A tile x B tile) pair and tests
// each pair with a dense [TA, TB] compare, carrying an OR across the
// sequential B axis; at 25 M x 2.6 M entries that is about 10^9 tile
// visits.  Here each thread owns one element of A, binary-searches B's
// probe keys (b_e for contained_in, b_s for containing) for its lower
// bound, reads that one candidate and writes its output once: no atomics,
// no order between blocks, no shared memory.  On sorted lists neighbouring
// threads walk the same path through B, so their reads coalesce, and the
// top levels of every search are shared by all threads and stay in L1; at
// the deployment widths B is ~21 MB and stays in the 50 MB L2.  wgmma and
// TMA do not apply (no products).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = INT_MAX;
constexpr int kThreads = 256;

// First index in [lo, hi) whose key is >= x, or hi.
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

template <bool kContainedIn>
__global__ void __launch_bounds__(kThreads)
interval_join_kernel(const int* __restrict__ a_s, const int* __restrict__ a_e,
                     const int* __restrict__ b_s, const int* __restrict__ b_e,
                     int* __restrict__ out, int na, int nb) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= na) return;
  const int as = a_s[i], ae = a_e[i];
  int hit = 0;
  if (as != kPad) {
    const int j = lower_bound(kContainedIn ? b_e : b_s, 0, nb,
                              kContainedIn ? ae : as);
    if (j < nb) {
      const int bs = b_s[j], be = b_e[j];
      hit = bs != kPad && (kContainedIn ? bs <= as : be <= ae);
    }
  }
  out[i] = hit;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Does not synchronise and allocates nothing: the caller owns every buffer.
extern "C" int interval_join_launch(const void* a_s, const void* a_e,
                                    const void* b_s, const void* b_e,
                                    void* out, int na, int nb, int containing,
                                    void* stream) {
  if (na <= 0 || nb < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (na - 1) / kThreads + 1;
  const auto s = (cudaStream_t)stream;
  const auto as = (const int*)a_s, ae = (const int*)a_e;
  const auto bs = (const int*)b_s, be = (const int*)b_e;
  if (containing) {
    interval_join_kernel<false><<<blocks, kThreads, 0, s>>>(
        as, ae, bs, be, (int*)out, na, nb);
  } else {
    interval_join_kernel<true><<<blocks, kThreads, 0, s>>>(
        as, ae, bs, be, (int*)out, na, nb);
  }
  return (int)cudaGetLastError();
}
