// Fused Lemma-1 transition  W' = B^T (P^T)^alpha V^T W  for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_transition/kernel.py::
// fused_transition_kernel (via fused_transition_pallas).  W is the row-major
// (C, M) matrix of C client models of one parameter leaf; vt (D, C),
// p (D, D) and bt (C, D) are the f32 factors (a few KB).  Bound by bytes:
// W is read once and written once (2 * C * M * sizeof(T)), against
// 2 * M * (2 * C * D + alpha * D * D) flops, far below the card's ratio.
//
// Design: one thread owns one column m.  The three factors sit in shared
// memory (every thread of a block reads the same entry at a time, a
// broadcast).  The thread streams its column once, accumulating y = V^T w
// in f32 registers (neighbouring threads read neighbouring addresses of
// each row c, so every warp load is coalesced), applies P^T alpha times in
// registers, and writes B^T y back down the column.  The (D,) intermediate
// never leaves registers, and because a column belongs to one thread,
// ``out`` may alias ``w`` (in-place update).  alpha, p and vt are runtime
// operands: participation weights and faulted mixing matrices change their
// values every round without a rebuild.  D is bounded by the register
// array size MAXD (4, 8 or 16, chosen at launch); D > 16 is refused.
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

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
fused_transition_kernel(const T* w, T* out, const float* __restrict__ vt,
                        const float* __restrict__ p, const float* __restrict__ bt,
                        int C, int D, int64_t M, int alpha) {
  extern __shared__ float smem[];
  float* s_vt = smem;            // (D, C)
  float* s_p = s_vt + D * C;     // (D, D)
  float* s_bt = s_p + D * D;     // (C, D)
  for (int i = threadIdx.x; i < D * C; i += blockDim.x) s_vt[i] = vt[i];
  for (int i = threadIdx.x; i < D * D; i += blockDim.x) s_p[i] = p[i];
  for (int i = threadIdx.x; i < C * D; i += blockDim.x) s_bt[i] = bt[i];
  __syncthreads();

  const int64_t m = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (m >= M) return;  // ragged edge: the last block masks its tail

  float y[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) y[d] = 0.f;
  // y = V^T w
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float x = to_f32(w[c * M + m]);
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) y[d] = fmaf(s_vt[d * C + c], x, y[d]);
  }
  // y <- P^T y, alpha times:  y'[d] = sum_j p[j, d] y[j]
  for (int a = 0; a < alpha; ++a) {
    float z[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (d < D && j < D) acc = fmaf(s_p[j * D + d], y[j], acc);
      z[d] = acc;
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d) y[d] = z[d];
  }
  // w' = B^T y
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) acc = fmaf(s_bt[c * D + d], y[d], acc);
    out[c * M + m] = from_f32<T>(acc);
  }
}

template <typename T, int MAXD>
cudaError_t launch(const void* w, void* out, const float* vt, const float* p, const float* bt,
                   int C, int D, int64_t M, int alpha, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * D * C + D * D) * sizeof(float);
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  fused_transition_kernel<T, MAXD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(out), vt, p, bt, C, D, M, alpha);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* w, void* out, const float* vt, const float* p,
                     const float* bt, int C, int D, int64_t M, int alpha, cudaStream_t s) {
  if (D <= 4) return launch<T, 4>(w, out, vt, p, bt, C, D, M, alpha, s);
  if (D <= 8) return launch<T, 8>(w, out, vt, p, bt, C, D, M, alpha, s);
  return launch<T, 16>(w, out, vt, p, bt, C, D, M, alpha, s);
}

}  // namespace

extern "C" int fused_transition_launch(const void* w, void* out, const void* vt, const void* p,
                                       const void* bt, int C, int D, long long M, int alpha,
                                       int dtype, void* stream) {
  if (C < 1 || D < 1 || D > 16 || alpha < 0) return (int)cudaErrorInvalidValue;
  // the factors must fit the default 48 KB of dynamic shared memory
  if ((size_t)(2 * D * C + D * D) * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fvt = static_cast<const float*>(vt);
  const float* fp = static_cast<const float*>(p);
  const float* fbt = static_cast<const float*>(bt);
  switch (dtype) {
    case DT_F32: return (int)launch_d<float>(w, out, fvt, fp, fbt, C, D, M, alpha, s);
    case DT_BF16: return (int)launch_d<__nv_bfloat16>(w, out, fvt, fp, fbt, C, D, M, alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
