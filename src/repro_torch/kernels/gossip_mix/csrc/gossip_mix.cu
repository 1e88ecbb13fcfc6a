// Inter-cluster gossip mixing  Y' = Y @ P^alpha  (eq. 4 / eq. 21-22) for Hopper (sm_90a),
// over every leaf of a parameter tree in one launch.
//
// Replaces the TPU kernel repro/kernels/gossip_mix/kernel.py::gossip_mix_kernel
// (via gossip_mix_pallas).  Each leaf Y is the row-major (D, M) stack of D
// cluster models of one parameter leaf; P is the (D, D) f32 mixing matrix
// with the column convention new[d] = sum_j p[j, d] y[j], shared by all
// leaves.  Bound by bytes: Y is read once and written once (2 * D * M *
// sizeof(T) a leaf), against 2 * alpha * D * D flops a column, far below the
// card's ratio.
//
// Design:
// * One launch per tree: a table of up to kMaxLeaves leaves travels by value
//   in the kernel's parameters (each leaf's Y and out base pointers, M, first
//   column tile as a prefix sum, and a bit for vector access).  P is read
//   from device memory through a pointer beside the table: the asynchronous
//   path's P_t changes every event, and a CUDA graph that captures the launch
//   reads it from a fixed device buffer written before each replay, where a
//   by-value P would be baked in at capture.  Each block stages P into shared
//   memory, zero-padded to 16 x 16 (one value a thread: kThreads == 16 * 16),
//   before it reads its columns; with the padded stride the unrolled loops
//   index it at compile-time offsets, and every P operand is a broadcast
//   read, one address for the whole warp.
// * One block per column tile over all leaves: a binary search of the prefix
//   sums finds the block's leaf.
// * A thread owns COLS columns and holds their D values in f32 registers,
//   v[MAXD][COLS], and a pass's results beside them.  COLS = min(16 /
//   sizeof(T), 64 / MAXD) keeps each array at 64 floats or fewer in every
//   (T, MAXD) instantiation, so ptxas spills in none: 16-byte accesses (4
//   f32 or 8 bf16 columns) everywhere except bf16 at MAXD = 16, which takes
//   4 columns in 8-byte accesses.  Vector access where
//   the leaf's pointers are 16-byte aligned and M is a multiple of 16 bytes of
//   columns; elsewhere the scalar path of the same kernel, its COLS columns
//   kThreads apart, so every warp load stays coalesced.
// * The arithmetic of a column is fixed, whatever the leaf or its path:
//   alpha passes of v'[d] = fmaf(p[j, d], v[j], acc) over j = 0 .. MAXD-1 in
//   order (P is 0 outside D x D), one cast to T at the end, so a tree is
//   bitwise equal to its one-leaf calls, and to the kernel that took P by
//   value in its launch parameters (commit 28b3742) on the same P.  A column
//   is read whole before it is written and belongs to one thread, so ``out``
//   may alias Y (the async path mixes in place).  alpha, P and D are runtime
//   values; MAXD (4, 8 or 16) is chosen at launch; D > 16 is refused.
//   Ragged tails are masked in the kernel: nothing is padded.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kThreads = 256;
constexpr int kMaxD = 16;
constexpr int kMaxLeaves = 64;     // MAX_LEAVES in kernels/_leaves.py

struct LeafTable {
  const void* y[kMaxLeaves];
  void* out[kMaxLeaves];
  long long m[kMaxLeaves];
  long long first_tile[kMaxLeaves + 1];  // first_tile[count]: the launch's tile count
  unsigned long long vec;                // bit l set: leaf l takes vector accesses
  int count;
};
static_assert(sizeof(LeafTable) + 64 <= 4096, "the leaf table must fit the 4 KB parameter space");
static_assert(kThreads == kMaxD * kMaxD, "a block stages the padded P one value a thread");

// columns a thread owns: a 16-byte access, or fewer where MAXD * COLS would pass 64 floats
template <typename T, int MAXD>
struct Cols {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int value = kVec < 64 / MAXD ? kVec : 64 / MAXD;
};

template <int BYTES> struct Access;
template <> struct Access<16> { using type = uint4; };
template <> struct Access<8> { using type = uint2; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const __grid_constant__ LeafTable tab, const float* __restrict__ p_dev, int D,
                  int alpha) {
  constexpr int COLS = Cols<T, MAXD>::value;
  constexpr long long kTile = (long long)kThreads * COLS;  // columns per tile
  using V = typename Access<COLS * (int)sizeof(T)>::type;
  // p[j, d] at p[j * kMaxD + d], zero outside D x D; staged before any
  // thread of the block can leave at its leaf's tail
  __shared__ float p[kMaxD * kMaxD];
  {
    const int j = threadIdx.x / kMaxD, d = threadIdx.x % kMaxD;
    p[threadIdx.x] = j < D && d < D ? p_dev[j * D + d] : 0.f;
  }
  __syncthreads();
  const long long t = blockIdx.x;  // its leaf: first_tile[l] <= t < first_tile[l + 1]
  int l = 0;
  for (int hi = tab.count - 1; l < hi;) {
    const int mid = (l + hi + 1) / 2;
    if (t >= tab.first_tile[mid]) l = mid; else hi = mid - 1;
  }
  const long long M = tab.m[l];
  const T* y = static_cast<const T*>(tab.y[l]);
  T* out = static_cast<T*>(tab.out[l]);
  const long long base = (t - tab.first_tile[l]) * kTile;
  const bool vec = (tab.vec >> l) & 1ull;
  // vector path: columns [c0, c0 + COLS); scalar path: c0 + c * kThreads
  const long long c0 = vec ? base + (long long)threadIdx.x * COLS : base + threadIdx.x;
  if (c0 >= M) return;  // the last tile of a leaf masks its tail

  float v[MAXD][COLS];
  if (vec) {  // M is a multiple of the vector: the whole vector is in the leaf
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < D) {
        const V raw = *reinterpret_cast<const V*>(y + d * M + c0);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < COLS; ++c) v[d][c] = to_f32(x[c]);
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) v[d][c] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const long long col = c0 + (long long)c * kThreads;
        v[d][c] = d < D && col < M ? to_f32(y[d * M + col]) : 0.f;
      }
    }
  }
  // each column: v <- P^T v, alpha times:  v'[d] = sum_j p[j, d] v[j].  Each
  // P value is read once a pass and used at once for the thread's COLS
  // columns; the compiler barrier keeps a pass's MAXD^2 reads in that pass
  // (hoisted out of the alpha loop, 256 live values would spill at MAXD 16)
  for (int a = 0; a < alpha; ++a) {
    asm volatile("" ::: "memory");
    float z[MAXD][COLS];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      float acc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
#pragma unroll
      for (int j = 0; j < MAXD; ++j) {
        const float pj = p[j * kMaxD + d];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = fmaf(pj, v[j][c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) z[d][c] = acc[c];
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[d][c] = z[d][c];
    }
  }
  if (vec) {
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < D) {
        V raw;
        T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int c = 0; c < COLS; ++c) x[c] = from_f32<T>(v[d][c]);
        *reinterpret_cast<V*>(out + d * M + c0) = raw;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const long long col = c0 + (long long)c * kThreads;
        if (d < D && col < M) out[d * M + col] = from_f32<T>(v[d][c]);
      }
    }
  }
}

// leaves: count rows of (y, out, M, vec) as 64-bit integers
template <typename T, int MAXD>
cudaError_t launch(const long long* leaves, int count, const float* p, int D, int alpha,
                   cudaStream_t stream) {
  constexpr long long kTile = (long long)kThreads * Cols<T, MAXD>::value;
  LeafTable tab = {};
  tab.count = count;
  for (int l = 0; l < count; ++l) {
    const long long* e = leaves + 4 * l;
    tab.y[l] = reinterpret_cast<const void*>(e[0]);
    tab.out[l] = reinterpret_cast<void*>(e[1]);
    tab.m[l] = e[2];
    if (e[3]) tab.vec |= 1ull << l;
    tab.first_tile[l + 1] = tab.first_tile[l] + (e[2] + kTile - 1) / kTile;
  }
  const long long tiles = tab.first_tile[count];
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;  // one block a tile
  gossip_mix_kernel<T, MAXD><<<(unsigned)tiles, kThreads, 0, stream>>>(tab, p, D, alpha);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const long long* leaves, int count, const float* p, int D, int alpha,
                     cudaStream_t s) {
  if (D <= 4) return launch<T, 4>(leaves, count, p, D, alpha, s);
  if (D <= 8) return launch<T, 8>(leaves, count, p, D, alpha, s);
  return launch<T, 16>(leaves, count, p, D, alpha, s);
}

}  // namespace

// ``leaves`` points at ``count`` host rows of four 64-bit integers (y, out,
// M, vec): each leaf's (D, M) input and output base addresses on the device
// (they may be equal), its column count and whether it takes vector
// accesses (16-byte aligned pointers, M a multiple of 16 bytes of columns);
// the rows are copied into the launch's parameters before this function
// returns.  ``p_dev`` points at D * D row-major f32 values in device memory,
// which the kernel reads when it runs.
extern "C" int gossip_mix_launch(const long long* leaves, int count, const float* p_dev, int D,
                                 int alpha, int dtype, void* stream) {
  if (leaves == nullptr || count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > kMaxD || alpha < 0 || p_dev == nullptr) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < count; ++l)
    if (leaves[4 * l + 2] < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)launch_d<float>(leaves, count, p_dev, D, alpha, s);
    case DT_BF16: return (int)launch_d<__nv_bfloat16>(leaves, count, p_dev, D, alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
