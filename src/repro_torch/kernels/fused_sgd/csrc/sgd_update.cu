// Fused SGD step  out = w - lr * g  for Hopper (sm_90a), over every leaf of
// a parameter tree in one launch.
//
// Replaces the TPU kernel repro/kernels/fused_sgd/kernel.py::_sgd_kernel
// (via sgd_update_pallas).  Elementwise and bound by bytes: each element
// reads w and g once and writes out once, 3 * sizeof(T) bytes, against
// 2 flops.  The design does nothing but stream:
// * One launch per tree: a table of up to kMaxLeaves leaves travels by value
//   in the kernel's parameters (about 2.5 KB of the 4 KB), with each leaf's
//   three base pointers, element count and first tile (a prefix sum).  One
//   block a tile over the tiles of all leaves; a block finds its leaf by a
//   binary search of the prefix sums.  (A grid of one wave of blocks walking
//   the tiles with a grid-stride loop was slower on the H100 at granite-8b
//   widths.)  Nothing is
//   copied to the device, so a CUDA graph captures the launch as it is.
// * 16-byte vector loads and stores (4 f32 or 8 bf16 lanes) where the leaf's
//   three pointers are 16-byte aligned and its length a multiple of the
//   vector, kUnroll vectors of w and of g a thread in flight before the
//   stores; elsewhere (an offset view, an odd length) the scalar path of the
//   same kernel, its elements kThreads apart, coalesced.
// The arithmetic is the plain version's exactly: f32 product and difference,
// each rounded once (no FMA contraction), then one round-to-nearest-even
// cast back to the parameter dtype.  ``out`` may alias ``w``: every element
// is read and written by the same thread.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;     // MAX_LEAVES in kernels/_leaves.py
constexpr int kUnroll = 2;         // 16-byte vectors of w (and of g) a thread has in flight

struct LeafTable {
  const void* w[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* out[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first_tile[kMaxLeaves + 1];  // first_tile[count]: the launch's tile count
  unsigned long long vec;                // bit l set: leaf l takes vector loads
  int count;
};
static_assert(sizeof(LeafTable) + 64 <= 4096, "leaf table must fit the 4 KB parameter space");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ T step(T w, T g, float lr) {
  return from_f32<T>(__fsub_rn(to_f32(w), __fmul_rn(lr, to_f32(g))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgd_update_kernel(const __grid_constant__ LeafTable tab, float lr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long kTile = (long long)kThreads * VEC * kUnroll;  // elements per tile
  const long long t = blockIdx.x;  // one tile a block
  int l = 0;                       // its leaf: first_tile[l] <= t < first_tile[l + 1]
  for (int hi = tab.count - 1; l < hi;) {
    const int mid = (l + hi + 1) / 2;
    if (t >= tab.first_tile[mid]) l = mid; else hi = mid - 1;
  }
  const T* w = static_cast<const T*>(tab.w[l]);
  const T* g = static_cast<const T*>(tab.g[l]);
  T* out = static_cast<T*>(tab.out[l]);
  const long long n = tab.n[l];
  const long long base = (t - tab.first_tile[l]) * kTile;
  if ((tab.vec >> l) & 1ull) {
    // kUnroll vectors a thread, kThreads * VEC apart: all loads, then the stores
    uint4 wv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + ((long long)u * kThreads + threadIdx.x) * VEC;
      if (i < n) {  // n is a multiple of VEC: the whole vector is in the leaf
        wv[u] = *reinterpret_cast<const uint4*>(w + i);
        gv[u] = *reinterpret_cast<const uint4*>(g + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + ((long long)u * kThreads + threadIdx.x) * VEC;
      if (i < n) {
        T* wa = reinterpret_cast<T*>(&wv[u]);
        const T* ga = reinterpret_cast<const T*>(&gv[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) wa[j] = step(wa[j], ga[j], lr);
        *reinterpret_cast<uint4*>(out + i) = wv[u];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC * kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads + threadIdx.x;
      if (i < n) out[i] = step(w[i], g[i], lr);
    }
  }
}

// leaves: count rows of (w, g, out, n, vec) as 64-bit integers
template <typename T>
cudaError_t launch(const long long* leaves, int count, float lr, cudaStream_t stream) {
  constexpr long long kTile = (long long)kThreads * (16 / sizeof(T)) * kUnroll;
  LeafTable tab = {};
  tab.count = count;
  for (int l = 0; l < count; ++l) {
    const long long* e = leaves + 5 * l;
    tab.w[l] = reinterpret_cast<const void*>(e[0]);
    tab.g[l] = reinterpret_cast<const void*>(e[1]);
    tab.out[l] = reinterpret_cast<void*>(e[2]);
    tab.n[l] = e[3];
    if (e[4]) tab.vec |= 1ull << l;
    tab.first_tile[l + 1] = tab.first_tile[l] + (e[3] + kTile - 1) / kTile;
  }
  const long long tiles = tab.first_tile[count];
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;  // one block a tile
  sgd_update_kernel<T><<<(unsigned)tiles, kThreads, 0, stream>>>(tab, lr);
  return cudaGetLastError();
}

}  // namespace

// ``leaves`` points at ``count`` host rows of five 64-bit integers (w, g,
// out, n, vec): each leaf's device addresses, its element count and whether
// it takes 16-byte vectors.  They are copied into the launch's parameters
// before this function returns.
extern "C" int sgd_update_launch(const long long* leaves, int count, float lr, int dtype,
                                 void* stream) {
  if (leaves == nullptr || count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < count; ++l)
    if (leaves[5 * l + 3] < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch<float>(leaves, count, lr, s);
    case DT_BF16: return (int)launch<__nv_bfloat16>(leaves, count, lr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
