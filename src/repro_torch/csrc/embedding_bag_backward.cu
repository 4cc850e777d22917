// EmbeddingBag's backward with respect to the table, hand-written for Hopper
// (sm_90a).
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
// fill mode drops, and so does this kernel.  Items of weight 0 add nothing
// and are skipped.  Each product is __fmul_rn(w, g) in float32, added with
// a float32 atomicAdd; a bfloat16 table's gradient is accumulated here in
// float32 and cast once by the wrapper.
//
// Sum order.  The atomics add a row's contributions in whatever order the
// warps reach them, which changes from run to run, so the result is not
// bit-reproducible: each element is a float32 sum of its n contributions in
// some order, within n * 2^-23 * sum|contributions| of the exact sum (the
// plain version, kernels/embedding_bag/ref.py embedding_bag_backward_ref,
// adds them in item order).  A row named once is exact.  A sorted,
// deterministic segmented reduction is a later redesign (ROADMAP).
//
// Bound: memory.  The least traffic reads grad_out, ids and weights once
// and reads and writes each distinct row named once: bytes = B * D * elt +
// 8 * B * L + 2 * rows * D * 4.  One product and one add an item and
// element is far under the card's rate.  The zero fill of the [V, D]
// gradient is the caller's (a dense gradient, as autograd hands it on).
//
// Design.  A warp takes items (b, i) of the flattened [B * L] in a
// grid-stride walk; its lanes split into groups of LANES lanes (a power of
// two, at most 32: the fewest that hold a row's vectors), one item a
// group, 32 / LANES items a warp at once: 2 at DLRM's D = 64 float32, 1
// at two-tower's D = 256 (two vectors a lane).  A lane loads its VEC
// elements of grad_out[b] (16 bytes when D is a multiple of 16 bytes' worth
// and grad_out is 16-byte aligned, else one element) and issues VEC
// float32 reductions into the row (RED.ADD.F32, the result unused).  No
// shared memory.  wgmma and TMA do not apply (no products of tiles; rows
// are scattered, not tiled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_kernel(const T* __restrict__ grad_out,
                                  const int* __restrict__ indices,
                                  const float* __restrict__ weights,
                                  float* __restrict__ grad, long long v,
                                  long long n_items, int l, int d,
                                  int lanes_log2) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int groups = 32 >> lanes_log2;
  const int group = lane >> lanes_log2;
  const int sub = lane & (lanes - 1);
  const int vectors = d / VEC;         // VEC > 1 only where VEC divides D
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long item = warp * groups + group; item < n_items;
       item += n_warps * groups) {
    // every lane of the group reads the same id and weight (a broadcast)
    const float w = __ldg(weights + item);
    long long id = __ldg(indices + item);
    if (w == 0.f || id < -v || id >= v) continue;   // the group together
    if (id < 0) id += v;
    const T* g = grad_out + (item / l) * (long long)d;
    float* dst = grad + id * (long long)d;
    for (int j = sub; j < vectors; j += lanes) {
      float x[VEC];
      Load<T, VEC>::get(g + j * VEC, x);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        atomicAdd(dst + j * VEC + k, __fmul_rn(w, x[k]));
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* grad_out, const int* ids, const float* w,
                   float* grad, long long v, long long n_items, int l, int d,
                   int lanes_log2, int grid, cudaStream_t s) {
  embedding_bag_backward_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      (const T*)grad_out, ids, w, grad, v, n_items, l, d, lanes_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int embedding_bag_backward_warps() { return kWarps; }

// grad [v, d] (float32, zeroed) += the bags' weighted grad_out rows, with
// the launch plan of kernel.py's `backward_plan`: bf16 selects a bfloat16
// grad_out (else float32); vec selects 16-byte loads, which need grad_out
// 16-byte aligned and rows a multiple of 16 bytes long; 2^lanes_log2
// lanes an item; grid blocks of 8 warps walk the n_bags * l items.
// Returns the CUDA error of the launch.
extern "C" int embedding_bag_backward_launch(
    const void* grad_out, const void* indices, const void* weights,
    void* grad, long long v, long long n_bags, int l, int d, int bf16,
    int vec, int lanes_log2, int grid, void* stream) {
  if (n_bags <= 0 || l <= 0 || d <= 0 || v <= 0 || grid <= 0 ||
      lanes_log2 < 0 || lanes_log2 > 5)
    return (int)cudaErrorInvalidValue;
  if (vec && d % (bf16 ? 8 : 4) != 0) return (int)cudaErrorInvalidValue;
  const auto ids = (const int*)indices;
  const auto wt = (const float*)weights;
  const auto out = (float*)grad;
  const auto s = (cudaStream_t)stream;
  const long long n = n_bags * (long long)l;
  cudaError_t err;
  if (bf16)
    err = vec ? launch<__nv_bfloat16, 8>(grad_out, ids, wt, out, v, n, l, d,
                                         lanes_log2, grid, s)
              : launch<__nv_bfloat16, 1>(grad_out, ids, wt, out, v, n, l, d,
                                         lanes_log2, grid, s);
  else
    err = vec ? launch<float, 4>(grad_out, ids, wt, out, v, n, l, d,
                                 lanes_log2, grid, s)
              : launch<float, 1>(grad_out, ids, wt, out, v, n, l, d,
                                 lanes_log2, grid, s);
  return (int)err;
}
