// Inter-cluster gossip mixing  Y' = Y @ P^alpha  (eq. 4 / eq. 21-22) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gossip_mix/kernel.py::gossip_mix_kernel
// (via gossip_mix_pallas).  Y is the row-major (D, M) stack of D cluster
// models of one parameter leaf; P is the (D, D) f32 mixing matrix with the
// column convention new[d] = sum_j p[j, d] y[j].  Bound by bytes: Y is read
// once and written once (2 * D * M * sizeof(T)), against 2 * alpha * D * D
// flops per column, far below the card's ratio.
//
// Design: one thread owns one column m.  It loads the column's D values into
// f32 registers (neighbouring threads read neighbouring addresses of each
// row, so every warp load is coalesced), applies P^T alpha times in
// registers, and writes the column back.  A column is read whole before it
// is written, so ``out`` may alias ``y`` (the async path mixes in place).
// P is passed by value in the kernel's parameters, zero-padded to 16 x 16
// (1 KB of the 4 KB parameter space): the asynchronous path builds a fresh
// P_t on the host every event, and a by-value operand needs neither a device
// allocation nor a host-to-device copy that would make the host wait.  With
// the padded stride the unrolled loops index P at compile-time offsets, so
// every P operand is a broadcast read from the constant bank.  alpha and P
// are runtime values; D is bounded by the register array size MAXD (4, 8 or
// 16, chosen at launch); D > 16 is refused.  The ragged tail is masked in the
// kernel: nothing is padded.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kThreads = 256;
constexpr int kMaxD = 16;

struct PMat {
  float v[kMaxD * kMaxD];  // p[j, d] at v[j * kMaxD + d], zero outside D x D
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const T* y, T* out, const __grid_constant__ PMat p, int D, int64_t M,
                  int alpha) {
  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= M) return;  // ragged edge: the last block masks its tail

  float v[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) v[d] = d < D ? to_f32(y[d * M + m]) : 0.f;
  // v <- P^T v, alpha times:  v'[d] = sum_j p[j, d] v[j]  (p is 0 outside D x D)
  for (int a = 0; a < alpha; ++a) {
    float z[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAXD; ++j) acc = fmaf(p.v[j * kMaxD + d], v[j], acc);
      z[d] = acc;
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d) v[d] = z[d];
  }
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < D) out[d * M + m] = from_f32<T>(v[d]);
}

template <typename T, int MAXD>
cudaError_t launch(const void* y, void* out, const PMat& p, int D, int64_t M, int alpha,
                   cudaStream_t stream) {
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  gossip_mix_kernel<T, MAXD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<T*>(out), p, D, M, alpha);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* y, void* out, const PMat& p, int D, int64_t M, int alpha,
                     cudaStream_t s) {
  if (D <= 4) return launch<T, 4>(y, out, p, D, M, alpha, s);
  if (D <= 8) return launch<T, 8>(y, out, p, D, M, alpha, s);
  return launch<T, 16>(y, out, p, D, M, alpha, s);
}

}  // namespace

// ``p_host`` points at D * D row-major f32 values in host memory; they are
// copied into the launch's parameters before this function returns.
extern "C" int gossip_mix_launch(const void* y, void* out, const float* p_host, int D,
                                 long long M, int alpha, int dtype, void* stream) {
  if (D < 1 || D > kMaxD || alpha < 0 || p_host == nullptr) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  PMat p = {};
  for (int j = 0; j < D; ++j)
    for (int d = 0; d < D; ++d) p.v[j * kMaxD + d] = p_host[j * D + d];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch_d<float>(y, out, p, D, M, alpha, s);
    case DT_BF16: return (int)launch_d<__nv_bfloat16>(y, out, p, D, M, alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
