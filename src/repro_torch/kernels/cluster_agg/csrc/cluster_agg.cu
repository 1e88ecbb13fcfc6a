// Intra-cluster weighted aggregation  Y[d] = sum_{i in d} w_i W[i]  (eq. 2) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cluster_agg/kernel.py::cluster_agg_kernel
// (via cluster_agg_pallas).  W is the row-major (C, M) stack of C client
// models of one parameter leaf, grouped into D contiguous clusters of
// g = C / D rows; ``weights`` is the (C,) f32 vector of per-client weights
// (m^, or participation-masked m^), a runtime device operand.  The output is
// the (D, M) stack of cluster models.  Bound by bytes: W is read once and Y
// written once ((C + D) * M * sizeof(T)), against 2 * C * M flops.
//
// Design: one thread owns one (cluster, column) pair: blockIdx.y is the
// cluster, blockIdx.x * blockDim.x + threadIdx.x the column.  It walks its
// cluster's g rows (neighbouring threads read neighbouring addresses of each
// row, so every warp load is coalesced) and sums them against the weights
// in an f32 register.  The weights are the same for a whole block, so each
// read is a broadcast through the read-only cache.  A row whose weight is
// exactly 0 is neither read nor added (a uniform branch for the block), so
// a masked client contributes nothing and costs no bytes, and the result is
// exactly the sum of the other rows.  g and the weights are runtime values.
// The ragged tail is masked in the kernel: nothing is padded.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cluster_agg_kernel(const T* __restrict__ w, T* __restrict__ out,
                   const float* __restrict__ weights, int g, int64_t M) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= M) return;  // ragged edge: the last block masks its tail
  const int d = blockIdx.y;
  const T* rows = w + (int64_t)d * g * M + m;
  const float* wt = weights + (int64_t)d * g;
  float acc = 0.f;
#pragma unroll 4
  for (int i = 0; i < g; ++i) {
    const float c = __ldg(wt + i);
    if (c != 0.f) acc = fmaf(c, to_f32(rows[i * M]), acc);
  }
  out[d * M + m] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* w, void* out, const float* weights, int D, int g, int64_t M,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((M + kThreads - 1) / kThreads), (unsigned)D);
  cluster_agg_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(out), weights, g, M);
  return cudaGetLastError();
}

}  // namespace

// ``weights`` is a device pointer to C = D * g f32 values.
extern "C" int cluster_agg_launch(const void* w, void* out, const void* weights, int C, int D,
                                  long long M, int dtype, void* stream) {
  if (C < 1 || D < 1 || C % D || D > 65535) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  const int g = C / D;
  const float* wt = static_cast<const float*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch<float>(w, out, wt, D, g, M, s);
    case DT_BF16: return (int)launch<__nv_bfloat16>(w, out, wt, D, g, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
