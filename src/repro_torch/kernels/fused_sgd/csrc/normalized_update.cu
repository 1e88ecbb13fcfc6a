// Normalized client update  out[r] = (w_final[r] - w_start[r]) * inv_theta[r]  (eq. 19)
// for Hopper (sm_90a), over every leaf of a parameter tree in one launch.
//
// Replaces the TPU kernel repro/kernels/fused_sgd/kernel.py::_norm_update_kernel
// (via normalized_update_pallas).  Each leaf's w_final and w_start are
// row-major (R, M): one row per client of the fired cluster, M parameters a
// row; inv_theta is one f32 factor per row (1 / theta_i), a runtime device
// operand shared by all leaves, or one scalar for every row.  Elementwise
// and bound by bytes: each element reads w_final and w_start once and writes
// out once, 3 * sizeof(T) bytes, against 2 flops.
//
// Design:
// * One launch per tree: a table of up to kMaxLeaves leaves travels by value
//   in the kernel's parameters (each leaf's three base pointers, M, first
//   tile of a row as a prefix sum, and a bit for 16-byte vectors).  Nothing
//   is copied to the device, so a CUDA graph captures the launch as it is.
// * The grid is (tile over the columns of all leaves) x (row): blockIdx.x
//   finds its leaf by a binary search of the prefix sums, blockIdx.y is the
//   row, so each thread reads its row's factor once.
// * 16-byte vector loads and stores (4 f32 or 8 bf16 lanes) where the leaf's
//   three pointers are 16-byte aligned and M a multiple of the vector (so
//   every row starts aligned), kUnroll vectors of each input a thread in
//   flight before the stores; elsewhere the scalar path of the same kernel,
//   its elements kThreads apart, coalesced.
// The arithmetic is the plain version's exactly: f32 difference and product,
// each rounded once (no FMA contraction), then one round-to-nearest-even cast
// back to the parameter dtype.  ``out`` may alias either input: every element
// is read and written by the same thread.  Built into the same library as
// sgd_update.cu, which defines error_string.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;     // MAX_LEAVES in kernels/_leaves.py
constexpr int kUnroll = 2;         // 16-byte vectors of each input a thread has in flight

struct LeafTable {
  const void* wf[kMaxLeaves];
  const void* w0[kMaxLeaves];
  void* out[kMaxLeaves];
  long long m[kMaxLeaves];               // elements a row
  long long first_tile[kMaxLeaves + 1];  // first_tile[count]: a row's tile count
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
__device__ __forceinline__ T norm_step(T wf, T w0, float s) {
  return from_f32<T>(__fmul_rn(__fsub_rn(to_f32(wf), to_f32(w0)), s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
normalized_update_kernel(const __grid_constant__ LeafTable tab,
                         const float* __restrict__ inv_theta, float inv_scalar) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long kTile = (long long)kThreads * VEC * kUnroll;  // elements per tile
  const long long t = blockIdx.x;  // its leaf: first_tile[l] <= t < first_tile[l + 1]
  int l = 0;
  for (int hi = tab.count - 1; l < hi;) {
    const int mid = (l + hi + 1) / 2;
    if (t >= tab.first_tile[mid]) l = mid; else hi = mid - 1;
  }
  const long long row = blockIdx.y;
  const float s = inv_theta != nullptr ? __ldg(inv_theta + row) : inv_scalar;
  const long long M = tab.m[l];
  const T* a = static_cast<const T*>(tab.wf[l]) + row * M;
  const T* b = static_cast<const T*>(tab.w0[l]) + row * M;
  T* o = static_cast<T*>(tab.out[l]) + row * M;
  const long long base = (t - tab.first_tile[l]) * kTile;
  if ((tab.vec >> l) & 1ull) {
    // kUnroll vectors a thread, kThreads * VEC apart: all loads, then the stores
    uint4 av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + ((long long)u * kThreads + threadIdx.x) * VEC;
      if (i < M) {  // M is a multiple of VEC: the whole vector is in the row
        av[u] = *reinterpret_cast<const uint4*>(a + i);
        bv[u] = *reinterpret_cast<const uint4*>(b + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + ((long long)u * kThreads + threadIdx.x) * VEC;
      if (i < M) {
        T* aa = reinterpret_cast<T*>(&av[u]);
        const T* ba = reinterpret_cast<const T*>(&bv[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) aa[j] = norm_step(aa[j], ba[j], s);
        *reinterpret_cast<uint4*>(o + i) = av[u];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC * kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads + threadIdx.x;
      if (i < M) o[i] = norm_step(a[i], b[i], s);
    }
  }
}

// leaves: count rows of (w_final, w_start, out, M, vec) as 64-bit integers
template <typename T>
cudaError_t launch(const long long* leaves, int count, const float* inv_theta, float inv_scalar,
                   long long R, cudaStream_t stream) {
  constexpr long long kTile = (long long)kThreads * (16 / sizeof(T)) * kUnroll;
  LeafTable tab = {};
  tab.count = count;
  for (int l = 0; l < count; ++l) {
    const long long* e = leaves + 5 * l;
    tab.wf[l] = reinterpret_cast<const void*>(e[0]);
    tab.w0[l] = reinterpret_cast<const void*>(e[1]);
    tab.out[l] = reinterpret_cast<void*>(e[2]);
    tab.m[l] = e[3];
    if (e[4]) tab.vec |= 1ull << l;
    tab.first_tile[l + 1] = tab.first_tile[l] + (e[3] + kTile - 1) / kTile;
  }
  const long long tiles = tab.first_tile[count];
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;  // one block a tile and row
  const dim3 grid((unsigned)tiles, (unsigned)R);
  normalized_update_kernel<T><<<grid, kThreads, 0, stream>>>(tab, inv_theta, inv_scalar);
  return cudaGetLastError();
}

}  // namespace

// ``leaves`` points at ``count`` host rows of five 64-bit integers
// (w_final, w_start, out, M, vec): each leaf's (R, M) operands' base
// addresses on the device (out may equal either input), its elements a row
// and whether it takes 16-byte vectors.  They are copied into the launch's
// parameters before this function returns.  ``inv_theta`` is a device
// pointer to R f32 factors, or null to scale every row by ``inv_scalar``.
extern "C" int normalized_update_launch(const long long* leaves, int count, const void* inv_theta,
                                        float inv_scalar, long long R, int dtype, void* stream) {
  if (leaves == nullptr || count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  if (R < 1 || R > 65535) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < count; ++l)
    if (leaves[5 * l + 3] < 0) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(inv_theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch<float>(leaves, count, f, inv_scalar, R, s);
    case DT_BF16: return (int)launch<__nv_bfloat16>(leaves, count, f, inv_scalar, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
