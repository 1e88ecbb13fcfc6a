// Intra-cluster weighted aggregation  Y[d] = sum_{i in d} w_i W[i]  (eq. 2) for
// Hopper (sm_90a), over every leaf of a parameter tree in one launch.
//
// Replaces the TPU kernel repro/kernels/cluster_agg/kernel.py::cluster_agg_kernel
// (via cluster_agg_pallas).  Each leaf W is the row-major (C, M) stack of C
// client models of one parameter leaf, grouped into D contiguous clusters of
// g = C / D rows; ``weights`` is the (C,) f32 vector of per-client weights
// (m^, or participation-masked m^), a runtime device operand shared by all
// leaves.  Each output is the (D, M) stack of cluster models.  Bound by
// bytes: W read once and Y written once ((C + D) * M * sizeof(T) a leaf, less
// the rows of weight 0, which are not read), against 2 * C * M flops.
//
// Design:
// * One launch per tree: a table of up to kMaxLeaves leaves travels by value
//   in the kernel's parameters (each leaf's W and Y base pointers, M, first
//   column tile as a prefix sum, and a bit for 16-byte vectors).  Nothing is
//   copied to the device, so a CUDA graph captures the launch as it is.
// * One block per (column tile of one leaf, cluster): blockIdx.x is the tile
//   over all leaves (a binary search of the prefix sums finds its leaf),
//   blockIdx.y the cluster.  The block stages its cluster's g weights in
//   shared memory (kStage at a time) and every thread walks the g rows.
// * A thread owns VEC = 16 / sizeof(T) columns: one 16-byte load a row where
//   the leaf's pointers are 16-byte aligned and M is a multiple of VEC, else
//   the scalar path of the same kernel, its VEC columns kThreads apart
//   (coalesced).
// * The arithmetic is PR 12's per-leaf kernel's exactly, so the tree is
//   bitwise equal to it: one f32 accumulator a column, rows in order i = 0 ..
//   g-1, fmaf(w_i, W[i], acc), one cast to T at the end.  A row whose weight
//   is exactly 0 is neither read nor added (a branch uniform over the block),
//   so a masked client contributes nothing, whatever it holds, and costs no
//   bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;     // MAX_LEAVES in kernels/_leaves.py
constexpr int kStage = 1024;       // weights staged in shared memory at a time

struct LeafTable {
  const void* w[kMaxLeaves];
  void* out[kMaxLeaves];
  long long m[kMaxLeaves];
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
__global__ void __launch_bounds__(kThreads)
cluster_agg_kernel(const __grid_constant__ LeafTable tab, const float* __restrict__ weights,
                   int g) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long kTile = (long long)kThreads * VEC;  // columns per tile
  __shared__ float wt[kStage];
  const long long t = blockIdx.x;  // its leaf: first_tile[l] <= t < first_tile[l + 1]
  int l = 0;
  for (int hi = tab.count - 1; l < hi;) {
    const int mid = (l + hi + 1) / 2;
    if (t >= tab.first_tile[mid]) l = mid; else hi = mid - 1;
  }
  const long long M = tab.m[l];
  const int d = blockIdx.y;
  const T* rows = static_cast<const T*>(tab.w[l]) + (long long)d * g * M;
  T* out = static_cast<T*>(tab.out[l]) + (long long)d * M;
  const long long base = (t - tab.first_tile[l]) * kTile;
  const bool vec = (tab.vec >> l) & 1ull;
  // vector path: columns [c0, c0 + VEC); scalar path: c0 + j * kThreads
  const long long c0 = vec ? base + (long long)threadIdx.x * VEC : base + threadIdx.x;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < g; s0 += kStage) {
    const int n = min(kStage, g - s0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < n; i += kThreads) wt[i] = weights[(long long)d * g + s0 + i];
    __syncthreads();
    if (vec) {
      if (c0 < M) {  // M is a multiple of VEC: the whole vector is in the leaf
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const float c = wt[i];
          if (c != 0.f) {
            const uint4 raw = *reinterpret_cast<const uint4*>(rows + (s0 + i) * M + c0);
            const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = fmaf(c, to_f32(x[j]), acc[j]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float c = wt[i];
        if (c != 0.f) {
          const T* row = rows + (s0 + i) * M;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const long long col = c0 + (long long)j * kThreads;
            if (col < M) acc[j] = fmaf(c, to_f32(row[col]), acc[j]);
          }
        }
      }
    }
  }
  if (vec) {
    if (c0 < M) {
      uint4 raw;
      T* y = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) y[j] = from_f32<T>(acc[j]);
      *reinterpret_cast<uint4*>(out + c0) = raw;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const long long col = c0 + (long long)j * kThreads;
      if (col < M) out[col] = from_f32<T>(acc[j]);
    }
  }
}

// leaves: count rows of (w, out, M, vec) as 64-bit integers
template <typename T>
cudaError_t launch(const long long* leaves, int count, const float* weights, int D, int g,
                   cudaStream_t stream) {
  constexpr long long kTile = (long long)kThreads * (16 / sizeof(T));
  LeafTable tab = {};
  tab.count = count;
  for (int l = 0; l < count; ++l) {
    const long long* e = leaves + 4 * l;
    tab.w[l] = reinterpret_cast<const void*>(e[0]);
    tab.out[l] = reinterpret_cast<void*>(e[1]);
    tab.m[l] = e[2];
    if (e[3]) tab.vec |= 1ull << l;
    tab.first_tile[l + 1] = tab.first_tile[l] + (e[2] + kTile - 1) / kTile;
  }
  const long long tiles = tab.first_tile[count];
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;  // one block a tile and cluster
  const dim3 grid((unsigned)tiles, (unsigned)D);
  cluster_agg_kernel<T><<<grid, kThreads, 0, stream>>>(tab, weights, g);
  return cudaGetLastError();
}

}  // namespace

// ``leaves`` points at ``count`` host rows of four 64-bit integers (w, out,
// M, vec): each leaf's (C, M) input and (D, M) output base addresses on the
// device, its column count and whether it takes 16-byte vectors.  They are
// copied into the launch's parameters before this function returns.
// ``weights`` is a device pointer to C = D * g f32 values.
extern "C" int cluster_agg_launch(const long long* leaves, int count, const void* weights, int C,
                                  int D, int dtype, void* stream) {
  if (leaves == nullptr || count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  if (C < 1 || D < 1 || C % D || D > 65535) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < count; ++l)
    if (leaves[4 * l + 2] < 0) return (int)cudaErrorInvalidValue;
  const int g = C / D;
  const float* wt = static_cast<const float*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch<float>(leaves, count, wt, D, g, s);
    case DT_BF16: return (int)launch<__nv_bfloat16>(leaves, count, wt, D, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
