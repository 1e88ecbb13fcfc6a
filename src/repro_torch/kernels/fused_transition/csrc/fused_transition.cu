// Fused Lemma-1 transition  W' = B^T (P^T)^alpha V^T W  for Hopper (sm_90a),
// over every leaf of a parameter tree in one launch.
//
// Replaces the TPU kernel repro/kernels/fused_transition/kernel.py::
// fused_transition_kernel (via fused_transition_pallas).  Each leaf is the
// row-major (C, M) matrix of C client models of one parameter tensor; vt
// (D, C), p (D, D) and bt (C, D) are the f32 factors (a few KB).  Bound by
// bytes: W is read once and written once (2 * C * M * sizeof(T) per leaf),
// against 2 * M * (2 * C * D + alpha * D * D) flops, far below the card's
// ratio.
//
// Design.
// * One launch per tree: a table of up to kMaxLeaves leaves travels by value
//   in the kernel's parameters (about 2 KB of the 4 KB), with each leaf's
//   base pointers, column count and first tile (a prefix sum).  The grid is
//   one wave of blocks on the card (SM count times the blocks that fit on
//   an SM) and walks the tile space with a grid-stride loop; a block finds a
//   tile's leaf by scanning the prefix sums forward.  Nothing is copied to
//   the device, so a CUDA graph captures the launch as it is.
// * 16-byte streams through a TMA ring: a tile is kTileBytes of each of the
//   C rows of a leaf.  One thread brings a block's next tiles into a ring of
//   kStages shared-memory buffers with 1-D bulk copies (cp.async.bulk, one
//   per row, completion on an mbarrier), so up to kStages * C * kTileBytes
//   a block are in flight without holding registers.  Every thread owns
//   LANES consecutive columns of the tile (16 bytes: 4 f32 or 8 bf16; 8
//   bytes of bf16 at MAXD = 16, so that y stays at 64 registers and no
//   instantiation spills) and reads them from shared memory row by row.
// * y = V^T w accumulates in f32 registers (fmaf, c = 0..C-1), P^T is applied
//   alpha times in registers, and B^T y goes back to device memory with
//   16-byte stores.  A column belongs to one thread, and a tile is read
//   whole before it is written, so ``out`` may alias ``w`` (in place).
// * The factors are runtime operands staged in shared memory, each row
//   padded with zeros to MAXD floats, so that a row of V, P or B^T is MAXD/4
//   vector loads, broadcast to the block: participation weights and faulted
//   mixing matrices change them every round without a rebuild.  (The
//   arithmetic per column is 2 C D + alpha D^2 FMAs, about 3 instructions a
//   byte in bf16, so the loads of the factors are not negligible.)  D is
//   bounded by the register array size MAXD (4, 8 or 16, chosen at launch);
//   D > 16 is refused.
// * The vector path needs each row of the tile 16-byte aligned: the leaf's
//   bases aligned and M a multiple of the vector (the launcher's ``vec``
//   flag; such leaves come first in the table).  The other leaves, an odd M
//   or an offset view, take the scalar path of the same kernel, its LANES
//   columns kThreads apart, so each warp load is still coalesced.
// Why a ring: 16-byte register loads of up to 8 rows a thread, with the same
// padded factors, ran about 5% slower at granite-8b widths (bf16, C = 8,
// alpha = 2), where the FMAs of a tile are many: a warp waits for its rows
// and then computes, while the ring streams a block's next tiles during
// the FMAs.  Loading the next tile's rows into registers as well left two
// blocks an SM and ran slower still.  ``ab.py`` beside ``ops.py`` times
// the designs against each other (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kThreads = 128;
constexpr int kMaxLeaves = 64;     // MAX_LEAVES in kernels/_leaves.py
constexpr int kStages = 3;         // ring buffers a block keeps in flight, at most
constexpr int kRowBatch = 8;       // rows of the scalar path loaded before their FMAs
constexpr int kRingAlign = 128;
constexpr int kSmemLimit = 227 * 1024;  // a block's shared memory on the H100
constexpr int kSmemPerSm = 228 * 1024;  // an SM's, 1 KB of it reserved for each block

struct LeafTable {
  const void* w[kMaxLeaves];
  void* out[kMaxLeaves];
  long long m[kMaxLeaves];
  long long first_tile[kMaxLeaves + 1];  // first_tile[n]: the launch's tile count
  long long vec_tiles;                   // tiles [0, vec_tiles) are vector tiles
  int n;
};
static_assert(sizeof(LeafTable) + 64 <= 4096, "leaf table must fit the 4 KB parameter space");

template <typename T, int MAXD>
__host__ __device__ constexpr int lanes() {
  return MAXD <= 8 || sizeof(T) == 4 ? 16 / (int)sizeof(T) : 4;
}
template <typename T, int MAXD>
__host__ __device__ constexpr int tile_cols() {  // columns of one tile
  return kThreads * lanes<T, MAXD>();
}

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// LANES values of T packed in 32-bit words <-> f32 (bf16 two to a word,
// round to nearest even on the way back)
template <typename T, int LANES>
__device__ __forceinline__ void unpack(const uint32_t* wd, float* x) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) x[j] = __uint_as_float(wd[j]);
  } else {
#pragma unroll
    for (int i = 0; i < LANES / 2; ++i) {
      x[2 * i] = __uint_as_float(wd[i] << 16);
      x[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
    }
  }
}
template <typename T, int LANES>
__device__ __forceinline__ void pack(const float* x, uint32_t* wd) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) wd[j] = __float_as_uint(x[j]);
  } else {
#pragma unroll
    for (int i = 0; i < LANES / 2; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      wd[i] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
}

// -- PTX: shared addresses, mbarriers, 1-D bulk copies -----------------------
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16) from a 16-byte aligned global address
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// MAXD consecutive f32 of a padded factor row, 16 bytes at a time
template <int MAXD>
__device__ __forceinline__ void load_row(const float* row, float* a) {
#pragma unroll
  for (int q = 0; q < MAXD / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(row)[q];
    a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z, a[4 * q + 3] = v.w;
  }
}

// y += V^T[:, c] w[c] for one row c (f32 values x[j]): called for c = 0..C-1
template <int MAXD, int LANES>
__device__ __forceinline__ void accumulate(float (&y)[MAXD][LANES], const float* x,
                                           const float* s_v, int D, int c) {
  float a[MAXD];
  load_row<MAXD>(s_v + c * MAXD, a);
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < LANES; ++j) y[d][j] = fmaf(a[d], x[j], y[d][j]);
  }
}

// y <- P^T y, alpha times:  y'[d] = sum_i p[i, d] y[i], lane by lane
template <int MAXD, int LANES>
__device__ __forceinline__ void mix(float (&y)[MAXD][LANES], const float* s_p, int D,
                                    int alpha) {
  for (int a = 0; a < alpha; ++a) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      float z[MAXD];
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < MAXD; ++i)
          if (d < D && i < D) acc = fmaf(s_p[i * MAXD + d], y[i][j], acc);
        z[d] = acc;
      }
#pragma unroll
      for (int d = 0; d < MAXD; ++d) y[d][j] = z[d];
    }
  }
}

// row c of w' = B^T y
template <int MAXD, int LANES>
__device__ __forceinline__ void expand(const float (&y)[MAXD][LANES], float* o,
                                       const float* s_bt, int D, int c) {
  float b[MAXD];
  load_row<MAXD>(s_bt + c * MAXD, b);
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) acc = fmaf(b[d], y[d][j], acc);
    o[j] = acc;
  }
}

// shared memory before the ring: the padded factors and kStages mbarriers
__host__ __device__ constexpr int ring_offset(int C, int MAXD) {
  return ((2 * C + MAXD) * MAXD * 4 + 8 * kStages + kRingAlign - 1) / kRingAlign * kRingAlign;
}

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
fused_transition_kernel(const __grid_constant__ LeafTable tab, const float* __restrict__ vt,
                        const float* __restrict__ p, const float* __restrict__ bt,
                        int C, int D, int alpha, int stages) {
  constexpr int LANES = lanes<T, MAXD>();
  constexpr int kTileCols = tile_cols<T, MAXD>();
  constexpr int kTileBytes = kTileCols * (int)sizeof(T);  // of one row
  using Raw = typename RawOf<LANES * sizeof(T)>::type;

  // factors in rows padded to MAXD with zeros, so a row is MAXD / 4 vector loads
  extern __shared__ __align__(kRingAlign) unsigned char smem[];
  float* s_v = reinterpret_cast<float*>(smem);  // (C, MAXD): V, s_v[c, d] = vt[d, c]
  float* s_p = s_v + C * MAXD;                   // (MAXD, MAXD)
  float* s_bt = s_p + MAXD * MAXD;               // (C, MAXD)
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_bt + C * MAXD);
  unsigned char* ring = smem + ring_offset(C, MAXD);
  const int tid = threadIdx.x;
  for (int i = tid; i < C * MAXD; i += blockDim.x) {
    const int c = i / MAXD, d = i % MAXD;
    s_v[i] = d < D ? vt[d * C + c] : 0.f;
    s_bt[i] = d < D ? bt[c * D + d] : 0.f;
  }
  for (int i = tid; i < MAXD * MAXD; i += blockDim.x) {
    const int r = i / MAXD, d = i % MAXD;
    s_p[i] = r < D && d < D ? p[r * D + d] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // -- vector tiles: the k-th tile of this block is t = blockIdx.x + k * gridDim.x,
  //    in ring slot k % stages
  const long long vec_tiles = stages > 0 ? tab.vec_tiles : 0;
  int fetch_leaf = 0;  // thread 0's leaf cursor for the copies
  auto fetch = [&](long long k) {
    const long long t = blockIdx.x + k * gridDim.x;
    if (t >= vec_tiles) return;
    while (t >= tab.first_tile[fetch_leaf + 1]) ++fetch_leaf;
    const long long M = tab.m[fetch_leaf];
    const long long base = (t - tab.first_tile[fetch_leaf]) * kTileCols;
    const long long cols = M - base < kTileCols ? M - base : kTileCols;
    const uint32_t bytes = (uint32_t)(cols * (long long)sizeof(T));  // a multiple of 16
    const int slot = (int)(k % stages);
    uint64_t* bar = &bars[slot];
    unsigned char* dst = ring + (size_t)slot * C * kTileBytes;
    const T* src = static_cast<const T*>(tab.w[fetch_leaf]) + base;
    mbar_expect_tx(bar, bytes * C);
    for (int c = 0; c < C; ++c) bulk_load(dst + (size_t)c * kTileBytes, src + c * M, bytes, bar);
  };
  if (tid == 0)
    for (int k = 0; k < stages; ++k) fetch(k);

  int l = 0;
  long long k = 0;
  for (long long t = blockIdx.x; t < vec_tiles; t += gridDim.x, ++k) {
    while (t >= tab.first_tile[l + 1]) ++l;
    const int slot = (int)(k % stages);
    const long long M = tab.m[l];
    const long long m0 = (t - tab.first_tile[l]) * kTileCols + (long long)tid * LANES;
    mbar_wait(&bars[slot], (uint32_t)((k / stages) & 1));
    if (m0 < M) {  // M is a multiple of LANES: the thread's vector lies in the leaf
      const unsigned char* src = ring + (size_t)slot * C * kTileBytes + tid * sizeof(Raw);
      float y[MAXD][LANES];
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
#pragma unroll
        for (int j = 0; j < LANES; ++j) y[d][j] = 0.f;
      for (int c = 0; c < C; ++c) {
        const Raw r = *reinterpret_cast<const Raw*>(src + (size_t)c * kTileBytes);
        float x[LANES];
        unpack<T, LANES>(reinterpret_cast<const uint32_t*>(&r), x);
        accumulate<MAXD, LANES>(y, x, s_v, D, c);
      }
      mix<MAXD, LANES>(y, s_p, D, alpha);
      T* dst = static_cast<T*>(tab.out[l]) + m0;
      for (int c = 0; c < C; ++c) {
        float o[LANES];
        expand<MAXD, LANES>(y, o, s_bt, D, c);
        Raw r;
        pack<T, LANES>(o, reinterpret_cast<uint32_t*>(&r));
        *reinterpret_cast<Raw*>(dst + c * M) = r;
      }
    }
    __syncthreads();  // every thread is done with the slot: refill it
    if (tid == 0) fetch(k + stages);
  }

  // -- scalar tiles: this thread's LANES columns lie kThreads apart
  const long long tiles = tab.first_tile[tab.n];
  for (long long t = vec_tiles + blockIdx.x; t < tiles; t += gridDim.x) {
    while (t >= tab.first_tile[l + 1]) ++l;
    const T* w = static_cast<const T*>(tab.w[l]);
    T* out = static_cast<T*>(tab.out[l]);
    const long long M = tab.m[l];
    const long long m0 = (t - tab.first_tile[l]) * kTileCols + tid;
    if (m0 >= M) continue;  // ragged edge of the leaf's last tile
    float y[MAXD][LANES];
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
#pragma unroll
      for (int j = 0; j < LANES; ++j) y[d][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kRowBatch) {  // the loads of a batch of rows, then the FMAs
      float x[kRowBatch][LANES];
#pragma unroll
      for (int b = 0; b < kRowBatch; ++b)
#pragma unroll
        for (int j = 0; j < LANES; ++j) {
          const long long m = m0 + (long long)j * kThreads;
          x[b][j] = c0 + b < C && m < M ? to_f32(w[(c0 + b) * M + m]) : 0.f;
        }
#pragma unroll
      for (int b = 0; b < kRowBatch; ++b)
        if (c0 + b < C) accumulate<MAXD, LANES>(y, x[b], s_v, D, c0 + b);
    }
    mix<MAXD, LANES>(y, s_p, D, alpha);
    for (int c = 0; c < C; ++c) {
      float o[LANES];
      expand<MAXD, LANES>(y, o, s_bt, D, c);
#pragma unroll
      for (int j = 0; j < LANES; ++j) {
        const long long m = m0 + (long long)j * kThreads;
        if (m < M) out[c * M + m] = from_f32<T>(o[j]);
      }
    }
  }
}

// leaves: n rows of (w, out, M, vec) as 64-bit integers
template <typename T, int MAXD>
cudaError_t launch(const long long* leaves, int n, const float* vt, const float* p,
                   const float* bt, int C, int D, int alpha, cudaStream_t stream) {
  constexpr long long kTileCols = tile_cols<T, MAXD>();
  constexpr int kTileBytes = (int)(kTileCols * sizeof(T));
  auto kernel = fused_transition_kernel<T, MAXD>;
  // shared memory: factors, mbarriers, then a ring of up to kStages tiles,
  // fewer (down to 2) where that keeps two blocks on an SM (C = 20 in f32);
  // with no room for two (C beyond any path's), every leaf takes the
  // scalar path
  const int fixed = ring_offset(C, MAXD);
  const auto smem_of = [&](int s) { return (long long)fixed + (long long)s * C * kTileBytes; };
  int stages = kStages;
  while (stages > 2 && 2 * (smem_of(stages) + 1024) > kSmemPerSm) --stages;
  if (smem_of(stages) > kSmemLimit) stages = 0;
  const size_t smem = (size_t)smem_of(stages);

  LeafTable tab = {};
  tab.n = n;
  int order[kMaxLeaves];  // vector leaves first, each group in the caller's order
  int placed = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int l = 0; l < n; ++l)
      if ((leaves[4 * l + 3] != 0 && stages > 0) == (pass == 0)) order[placed++] = l;
  for (int i = 0; i < n; ++i) {
    const long long* e = leaves + 4 * order[i];
    tab.w[i] = reinterpret_cast<const void*>(e[0]);
    tab.out[i] = reinterpret_cast<void*>(e[1]);
    tab.m[i] = e[2];
    tab.first_tile[i + 1] = tab.first_tile[i] + (e[2] + kTileCols - 1) / kTileCols;
    if (e[3] != 0 && stages > 0) tab.vec_tiles = tab.first_tile[i + 1];
  }
  const long long tiles = tab.first_tile[n];
  if (tiles == 0) return cudaSuccess;

  // one wave of blocks: the SM count times the blocks that fit on an SM.
  // The shared-memory opt-in holds for the current device only, so it is
  // set, and occupancy asked, at every launch (a few host microseconds).
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long blocks = tiles < full ? tiles : full;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(tab, vt, p, bt, C, D, alpha, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const long long* leaves, int n, const float* vt, const float* p,
                     const float* bt, int C, int D, int alpha, cudaStream_t s) {
  if (D <= 4) return launch<T, 4>(leaves, n, vt, p, bt, C, D, alpha, s);
  if (D <= 8) return launch<T, 8>(leaves, n, vt, p, bt, C, D, alpha, s);
  return launch<T, 16>(leaves, n, vt, p, bt, C, D, alpha, s);
}

}  // namespace

// ``leaves`` points at n host rows of four 64-bit integers (w, out, M, vec):
// each leaf's (C, M) input and output base addresses on the device, its
// column count and whether it takes 16-byte vectors.  They are copied into
// the launch's parameters before this function returns.
extern "C" int fused_transition_launch(const long long* leaves, int n, const void* vt,
                                       const void* p, const void* bt, int C, int D, int alpha,
                                       int dtype, void* stream) {
  if (leaves == nullptr || n < 1 || n > kMaxLeaves) return (int)cudaErrorInvalidValue;
  if (C < 1 || D < 1 || D > 16 || alpha < 0) return (int)cudaErrorInvalidValue;
  // the factors must fit the default 48 KB of dynamic shared memory
  if ((size_t)(2 * D * C + D * D) * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n; ++l)
    if (leaves[4 * l + 2] < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fvt = static_cast<const float*>(vt);
  const float* fp = static_cast<const float*>(p);
  const float* fbt = static_cast<const float*>(bt);
  switch (dtype) {
    case DT_F32: return (int)launch_d<float>(leaves, n, fvt, fp, fbt, C, D, alpha, s);
    case DT_BF16: return (int)launch_d<__nv_bfloat16>(leaves, n, fvt, fp, fbt, C, D, alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
