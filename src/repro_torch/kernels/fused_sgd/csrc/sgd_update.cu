// Fused SGD step  out = w - lr * g  for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_sgd/kernel.py::_sgd_kernel
// (via sgd_update_pallas).  Elementwise and bound by bytes: each element
// reads w and g once and writes out once, 3 * sizeof(T) bytes, against
// 2 flops.  The design does nothing but stream: 16-byte vector loads and
// stores (4 f32 or 8 bf16 lanes) when all three pointers are 16-byte
// aligned, a scalar masked tail, a grid-stride loop.  The arithmetic is
// the plain version's exactly: f32 product and difference, each rounded
// once (no FMA contraction), then one round-to-nearest-even cast back to
// the parameter dtype.  ``out`` may alias ``w``: every element is read
// and written by the same thread.
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
__device__ __forceinline__ T step(T w, T g, float lr) {
  return from_f32<T>(__fsub_rn(to_f32(w), __fmul_rn(lr, to_f32(g))));
}

template <typename T>
__global__ void sgd_update_kernel(const T* w, const T* __restrict__ g, T* out,
                                  int64_t n, int64_t n_vec, float lr) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    uint4 wv = reinterpret_cast<const uint4*>(w)[i];
    const uint4 gv = reinterpret_cast<const uint4*>(g)[i];
    T* wa = reinterpret_cast<T*>(&wv);
    const T* ga = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) wa[j] = step(wa[j], ga[j], lr);
    reinterpret_cast<uint4*>(out)[i] = wv;
  }
  for (int64_t i = n_vec * VEC + tid; i < n; i += stride) out[i] = step(w[i], g[i], lr);
}

template <typename T>
cudaError_t launch(const void* w, const void* g, void* out, int64_t n, float lr,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t n_vec = aligned ? n / VEC : 0;
  const int64_t work = n_vec + (n - n_vec * VEC);
  const int threads = 256;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  sgd_update_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(g), static_cast<T*>(out), n, n_vec, lr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sgd_update_launch(const void* w, const void* g, void* out, long long n,
                                 float lr, int dtype, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch<float>(w, g, out, n, lr, s);
    case DT_BF16: return (int)launch<__nv_bfloat16>(w, g, out, n, lr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
