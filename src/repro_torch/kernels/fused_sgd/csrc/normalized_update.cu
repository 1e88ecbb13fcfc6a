// Normalized client update  out[r] = (w_final[r] - w_start[r]) * inv_theta[r]  (eq. 19)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_sgd/kernel.py::_norm_update_kernel
// (via normalized_update_pallas).  w_final and w_start are row-major (R, M):
// one row per client of the fired cluster, one column per parameter of a
// leaf; inv_theta is one f32 factor per row (1 / theta_i), a runtime device
// operand, or one scalar for all rows.  Elementwise and bound by bytes: each
// element reads w_final and w_start once and writes out once,
// 3 * sizeof(T) bytes, against 2 flops.
//
// Design: blockIdx.y is the row, so each thread reads its row's factor once;
// the block grid-strides over the row's columns with 16-byte vector loads and
// stores (4 f32 or 8 bf16 lanes) when every row starts 16-byte aligned, and a
// scalar masked tail.  The arithmetic is the plain version's exactly: f32
// difference and product, each rounded once (no FMA contraction), then one
// round-to-nearest-even cast back to the parameter dtype.  ``out`` may alias
// either input: every element is read and written by the same thread.  Built
// into the same library as sgd_update.cu, which defines error_string.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py

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
__global__ void normalized_update_kernel(const T* wf, const T* w0, T* out,
                                         const float* __restrict__ inv_theta,
                                         float inv_scalar, int64_t M, int64_t m_vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t row = blockIdx.y;
  const float s = inv_theta != nullptr ? __ldg(inv_theta + row) : inv_scalar;
  const T* a = wf + row * M;
  const T* b = w0 + row * M;
  T* o = out + row * M;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < m_vec; i += stride) {
    uint4 av = reinterpret_cast<const uint4*>(a)[i];
    const uint4 bv = reinterpret_cast<const uint4*>(b)[i];
    T* aa = reinterpret_cast<T*>(&av);
    const T* ba = reinterpret_cast<const T*>(&bv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) aa[j] = norm_step(aa[j], ba[j], s);
    reinterpret_cast<uint4*>(o)[i] = av;
  }
  for (int64_t i = m_vec * VEC + tid; i < M; i += stride) o[i] = norm_step(a[i], b[i], s);
}

template <typename T>
cudaError_t launch(const void* wf, const void* w0, void* out, const float* inv_theta,
                   float inv_scalar, int64_t R, int64_t M, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // vector loads need every row start 16-byte aligned: aligned bases and M % VEC == 0
  const bool aligned = ((reinterpret_cast<uintptr_t>(wf) | reinterpret_cast<uintptr_t>(w0) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0 && M % VEC == 0;
  const int64_t m_vec = aligned ? M / VEC : 0;
  const int64_t work = m_vec + (M - m_vec * VEC);
  const int threads = 256;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (132 * 16 + R - 1) / R;  // about 16 blocks per SM over all rows
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, (unsigned)R);
  normalized_update_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(wf), static_cast<const T*>(w0), static_cast<T*>(out), inv_theta,
      inv_scalar, M, m_vec);
  return cudaGetLastError();
}

}  // namespace

// ``inv_theta`` is a device pointer to R f32 factors, or null to scale every
// row by ``inv_scalar``.
extern "C" int normalized_update_launch(const void* wf, const void* w0, void* out,
                                        const void* inv_theta, float inv_scalar, long long R,
                                        long long M, int dtype, void* stream) {
  if (R < 1 || R > 65535) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  const float* f = static_cast<const float*>(inv_theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch<float>(wf, w0, out, f, inv_scalar, R, M, s);
    case DT_BF16: return (int)launch<__nv_bfloat16>(wf, w0, out, f, inv_scalar, R, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
