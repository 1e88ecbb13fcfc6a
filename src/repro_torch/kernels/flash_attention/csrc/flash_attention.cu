// Causal GQA flash attention backward on the CUDA cores, for Hopper (sm_90a).
//
// No TPU counterpart (the reference differentiates its plain attention
// through XLA); FlashAttention-2 style, no atomics.  These kernels serve the
// f32 backward and the bf16 backward with hd % 8 != 0, at every hd up to
// 256.  bf16 with hd % 8 == 0 runs on the tensor cores at every hd up to 256
// (flash_attention_sm90.cu; before its wide kernels, this file's hd-256
// tile took bf16 past hd 128 too); every forward runs on the tensor cores
// (flash_attention_sm90.cu for bf16 with hd % 8 == 0,
// flash_attention_split_tf32.cu for the rest).
//
// Layouts as the reference's wrapper takes them: q (B, S, Hq, hd), k and v
// (B, S, Hkv, hd), row-major, f32 or bf16; the KV head of query head h is
// h / (Hq / Hkv).  lse and delta are f32 (B, Hq, S).  Scores are
// (q . k) * hd^-0.5, then cap * tanh(s / cap) when a cap is set; key kp is
// live for query qp when kp <= qp (and qp - kp < window when a window is
// set).  NEG_INF = -1e30, masked probabilities are exactly 0; f32 arithmetic
// throughout, outputs in the input dtype.  A query-row map (Shape::rl, cs,
// r0; flash_attention_sm90.cu) puts query row j of q (B, Sq, Hq, hd) at
// position (j / rl) * cs + r0 + j % rl of k and v (B, Sk, Hkv, hd); without
// one rl = cs = Sq, r0 = 0 and row j sits at j.
//
// What bounds it: at the path's shapes the work is about 2.5 x 4 * hd flops
// per live (query, key) pair against (4 + 4) * S * H * hd elements of
// traffic, far above the card's bytes-to-flops ratio, so the bound is
// operations.  These kernels run on the CUDA cores in f32 (no wgmma, no
// TMA): they are the simple, correct first version.
//
// Design.  A block of 8 warps owns a tile of rows (dQ: query rows, 8 or 4
// per warp; dK/dV: key rows).  The other operand streams through shared
// memory in f32 tiles, converted once on load; shared rows that lanes index
// by row are padded by 4 floats, so the 16-byte loads of 8 lanes fall on
// distinct banks.  In the score phase each lane owns one or two columns of
// the tile and all of its warp's rows, and the rows it shares with the warp
// are broadcast reads.  Row statistics are warp shuffles.  dS goes through
// shared memory to the product phase, where each lane owns hd / 32 output
// columns of every row of its warp, kept in registers for the whole loop.
// Only live tiles are visited: from the window's first key (or 0) to the
// diagonal for dQ; from the diagonal to the window's reach for dK/dV, which
// loops over the G query heads of its KV head too, so GQA sums without
// atomics.  The heaviest tiles (last along S) are launched first.  Any S
// (the ragged edge is masked by position), any hd <= 256 (the tile width HD
// is 64, 128 or 256, zero-filled beyond hd).  Tile sizes keep every block
// under the 227 KB of shared memory (the attribute is raised above 48 KB at
// every launch).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Shape {
  int B, Sq, Sk, Hq, Hkv, hd;  // Sq query rows, Sk keys
  int rl, cs, r0;  // query row j at position (j / rl) * cs + r0 + j % rl
  int window;      // <= 0: no window
  float cap;       // <= 0: no cap
  float scale;     // hd^-0.5 of the original hd
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the position of query row j (without a map, j)
__device__ __forceinline__ int qpos(int j, const Shape& sh) {
  return j / sh.rl * sh.cs + sh.r0 + j % sh.rl;
}

// the map's inverse: the number of query rows at positions below p
__device__ __forceinline__ int rows_before(int p, const Shape& sh) {
  const int n = p / sh.cs;
  return min(sh.Sq, n * sh.rl + min(max(p - n * sh.cs - sh.r0, 0), sh.rl));
}

// key kp is live for query row j at position qp
__device__ __forceinline__ bool live(int j, int qp, int kp, const Shape& sh) {
  return kp <= qp && j < sh.Sq && (sh.window <= 0 || qp - kp < sh.window);
}

__device__ __forceinline__ float capped(float raw, float cap) {
  return cap > 0.f ? cap * tanhf(raw / cap) : raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ const float4& ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [row0, row0 + rows) of head h of a (B, S, H, hd) tensor into dst
// (row stride ld floats), as f32; rows >= S and columns >= hd are zero.
template <typename T, int HD>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src, int b, int h, int H,
                          int S, const Shape& sh, int row0, int rows) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, s = row0 + r;
    float x = 0.f;
    if (s < S && d < sh.hd) x = to_f32(src[(((int64_t)b * S + s) * H + h) * sh.hd + d]);
    dst[r * ld + d] = x;
  }
}

// ---------------------------------------------------------------------------
// Backward 1: delta = rowsum(dO * O) in f32, one warp per (b, s, h) row.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, const Shape sh) {
  const int64_t row = blockIdx.x * (int64_t)kWarps + threadIdx.x / 32;
  if (row >= (int64_t)sh.B * sh.Sq * sh.Hq) return;
  const int lane = threadIdx.x % 32;
  const T* o = out + row * sh.hd;
  const T* g = dout + row * sh.hd;
  float acc = 0.f;
  for (int d = lane; d < sh.hd; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int64_t sh_ = (int64_t)sh.Sq * sh.Hq;
    const int64_t b = row / sh_, s = (row % sh_) / sh.Hq, h = row % sh.Hq;
    delta[(b * sh.Hq + h) * sh.Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// Backward 2: dK, dV.  One block per (b * Hkv + kvh, tile of BK = 8 * RK key
// rows); loops over the G query heads of kvh and their live query tiles of
// BQ = 32 * JQ rows.
// ---------------------------------------------------------------------------
template <typename T, int HD, int RK, int BQ>
struct DkDv {
  static constexpr int BK = kWarps * RK, JQ = BQ / 32, NC = HD / 32, LD = HD + 4;
  static constexpr size_t smem =
      sizeof(float) * (2 * BK * HD + 2 * BQ * LD + 2 * BK * BQ + 2 * BQ) + sizeof(int) * BQ;
};

template <typename T, int HD, int RK, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, const Shape sh) {
  using F = DkDv<T, HD, RK, BQ>;
  constexpr int BK = F::BK, JQ = F::JQ, NC = F::NC, LD = F::LD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // BK x HD (broadcast reads)
  float* Vs = Ks + BK * HD;                     // BK x HD
  float* Qs = Vs + BK * HD;                     // BQ x LD
  float* Gs = Qs + BQ * LD;                     // BQ x LD: dO
  float* Ps = Gs + BQ * LD;                     // BK x BQ
  float* Ds = Ps + BK * BQ;                     // BK x BQ: dS
  float* Ls = Ds + BK * BQ;                     // BQ: lse
  float* Es = Ls + BQ;                          // BQ: delta
  int* Qp = reinterpret_cast<int*>(Es + BQ);     // BQ: the queries' positions

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / sh.Hkv, kvh = blockIdx.x % sh.Hkv, G = sh.Hq / sh.Hkv;
  const int k0 = (gridDim.y - 1 - blockIdx.y) * BK;  // heaviest tiles first
  load_tile<T, HD>(Ks, HD, k, b, kvh, sh.Hkv, sh.Sk, sh, k0, BK);
  load_tile<T, HD>(Vs, HD, v, b, kvh, sh.Hkv, sh.Sk, sh, k0, BK);

  float gk[RK][NC], gv[RK][NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.f;

  // the query rows whose positions reach these keys (the map's inverse)
  const int k_last = min(k0 + BK, sh.Sk) - 1;
  const int q_end = sh.window > 0 ? rows_before(k_last + sh.window, sh) : sh.Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + ((int64_t)b * sh.Hq + h) * sh.Sq;
    const float* delta_h = delta + ((int64_t)b * sh.Hq + h) * sh.Sq;
    for (int q0 = rows_before(k0, sh) / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD>(Qs, LD, q, b, h, sh.Hq, sh.Sq, sh, q0, BQ);
      load_tile<T, HD>(Gs, LD, dout, b, h, sh.Hq, sh.Sq, sh, q0, BQ);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < sh.Sq;
        Qp[r] = qpos(q0 + r, sh);
        Ls[r] = in ? lse_h[q0 + r] : 0.f;
        Es[r] = in ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[RK][JQ], dp[RK][JQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < JQ; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < HD; d += 4) {
        float4 qv[JQ], gq[JQ];
#pragma unroll
        for (int j = 0; j < JQ; ++j) {
          qv[j] = ld4(&Qs[(lane + 32 * j) * LD + d]);
          gq[j] = ld4(&Gs[(lane + 32 * j) * LD + d]);
        }
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          const float4 kk = ld4(&Ks[(warp * RK + i) * HD + d]);
          const float4 vv = ld4(&Vs[(warp * RK + i) * HD + d]);
#pragma unroll
          for (int j = 0; j < JQ; ++j) {
            s[i][j] = dot4(kk, qv[j], s[i][j]);
            dp[i][j] = dot4(vv, gq[j], dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int r = warp * RK + i, kp = k0 + r;
#pragma unroll
        for (int j = 0; j < JQ; ++j) {
          const int c = lane + 32 * j, qr = q0 + c;
          float p = 0.f, ds = 0.f;
          if (live(qr, Qp[c], kp, sh)) {
            const float raw = s[i][j] * sh.scale;
            p = expf(capped(raw, sh.cap) - Ls[c]);
            ds = p * (dp[i][j] - Es[c]);
            if (sh.cap > 0.f) {
              const float t = tanhf(raw / sh.cap);
              ds *= 1.f - t * t;
            }
          }
          Ps[r * BQ + c] = p;
          Ds[r * BQ + c] = ds;
        }
      }
      __syncwarp();  // a warp's P and dS rows are its own

      for (int c0 = 0; c0 < BQ; c0 += 4) {
        float4 pp[RK], dd[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pp[i] = ld4(&Ps[(warp * RK + i) * BQ + c0]);
          dd[i] = ld4(&Ds[(warp * RK + i) * BQ + c0]);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float go = Gs[(c0 + cc) * LD + lane + 32 * c];
            const float qq = Qs[(c0 + cc) * LD + lane + 32 * c];
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              gv[i][c] = fmaf(comp(pp[i], cc), go, gv[i][c]);
              gk[i][c] = fmaf(comp(dd[i], cc), qq, gk[i][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kp = k0 + warp * RK + i;
    if (kp >= sh.Sk) continue;
    const int64_t off = (((int64_t)b * sh.Sk + kp) * sh.Hkv + kvh) * sh.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < sh.hd) {
        dk[off + d] = from_f32<T>(gk[i][c] * sh.scale);
        dv[off + d] = from_f32<T>(gv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 3: dQ.  One block per (b * Hq + h, tile of BQ = 8 * RQ query rows),
// looping over the live key tiles as the forward does.
// ---------------------------------------------------------------------------
template <typename T, int HD, int RQ, int BK>
struct Dq {
  static constexpr int BQ = kWarps * RQ, JK = BK / 32, NC = HD / 32, LD = HD + 4;
  static constexpr size_t smem =
      sizeof(float) * (2 * BQ * HD + 2 * BK * LD + BQ * BK) + sizeof(int) * BQ;
};

template <typename T, int HD, int RQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, const Shape sh) {
  using F = Dq<T, HD, RQ, BK>;
  constexpr int BQ = F::BQ, JK = F::JK, NC = F::NC, LD = F::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x HD (broadcast reads)
  float* Gs = Qs + BQ * HD;                     // BQ x HD: dO
  float* Ks = Gs + BQ * HD;                     // BK x LD
  float* Vs = Ks + BK * LD;                     // BK x LD
  float* Ds = Vs + BK * LD;                     // BQ x BK: dS
  int* Qp = reinterpret_cast<int*>(Ds + BQ * BK);  // BQ: the rows' positions

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / sh.Hq, h = bh % sh.Hq, kvh = h / (sh.Hq / sh.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  load_tile<T, HD>(Qs, HD, q, b, h, sh.Hq, sh.Sq, sh, q0, BQ);
  load_tile<T, HD>(Gs, HD, dout, b, h, sh.Hq, sh.Sq, sh, q0, BQ);

  // the rows' positions, in shared memory (read where a pair is tested;
  // held in registers across the loop they made ptxas spill)
  for (int r = threadIdx.x; r < BQ; r += kThreads) Qp[r] = qpos(q0 + r, sh);
  float lr[RQ], er[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qr = q0 + warp * RQ + i;
    const bool in = qr < sh.Sq;
    lr[i] = in ? lse[(int64_t)bh * sh.Sq + qr] : 0.f;
    er[i] = in ? delta[(int64_t)bh * sh.Sq + qr] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the key tiles from the window's reach of the first row's position to
  // the last row's position
  const int p_last = qpos(min(q0 + BQ, sh.Sq) - 1, sh);
  const int k_first = sh.window > 0 ? max(0, qpos(q0, sh) - sh.window + 1) : 0;
  for (int k0 = (k_first / BK) * BK; k0 <= p_last; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(Ks, LD, k, b, kvh, sh.Hkv, sh.Sk, sh, k0, BK);
    load_tile<T, HD>(Vs, LD, v, b, kvh, sh.Hkv, sh.Sk, sh, k0, BK);
    __syncthreads();

    float s[RQ][JK], dp[RQ][JK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < HD; d += 4) {
      float4 kv[JK], vv[JK];
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        kv[j] = ld4(&Ks[(lane + 32 * j) * LD + d]);
        vv[j] = ld4(&Vs[(lane + 32 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 qq = ld4(&Qs[(warp * RQ + i) * HD + d]);
        const float4 gg = ld4(&Gs[(warp * RQ + i) * HD + d]);
#pragma unroll
        for (int j = 0; j < JK; ++j) {
          s[i][j] = dot4(qq, kv[j], s[i][j]);
          dp[i][j] = dot4(gg, vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = warp * RQ + i;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int kp = k0 + lane + 32 * j;
        float ds = 0.f;
        if (live(q0 + r, Qp[r], kp, sh)) {
          const float raw = s[i][j] * sh.scale;
          const float p = expf(capped(raw, sh.cap) - lr[i]);
          ds = p * (dp[i][j] - er[i]);
          if (sh.cap > 0.f) {
            const float t = tanhf(raw / sh.cap);
            ds *= 1.f - t * t;
          }
        }
        Ds[r * BK + lane + 32 * j] = ds;
      }
    }
    __syncwarp();  // a warp's dS rows are its own

    for (int j = 0; j < BK; j += 4) {
      float4 dd[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dd[i] = ld4(&Ds[(warp * RQ + i) * BK + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float kk = Ks[(j + jj) * LD + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(comp(dd[i], jj), kk, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qr = q0 + warp * RQ + i;
    if (qr >= sh.Sq) continue;
    T* o = dq + (((int64_t)b * sh.Sq + qr) * sh.Hq + h) * sh.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < sh.hd) o[d] = from_f32<T>(acc[i][c] * sh.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
// Raises the dynamic shared-memory limit of the kernel with tile traits F.
// The attribute holds for the current device only, so it is set at every
// launch (a few host microseconds), never cached in a static: a cache would
// skip it on a second card, where every launch above 48 KB would be refused.
template <typename F, typename K>
cudaError_t allow_smem(K kernel) {
  return F::smem <= 48 * 1024 ? cudaSuccess
      : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::smem);
}

template <typename T, int HD, int R, int B2>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const float* lse, float* delta, void* dq, void* dk, void* dv, const Shape& sh,
                cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(dout);
  const int64_t rows = (int64_t)sh.B * sh.Sq * sh.Hq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      static_cast<const T*>(out), g_, delta, sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  using KV = DkDv<T, HD, R, B2>;
  auto kv_kern = flash_bwd_dkdv_kernel<T, HD, R, B2>;
  if ((e = allow_smem<KV>(kv_kern)) != cudaSuccess) return e;
  dim3 kv_grid(sh.B * sh.Hkv, (sh.Sk + KV::BK - 1) / KV::BK);
  kv_kern<<<kv_grid, kThreads, KV::smem, st>>>(q_, k_, v_, g_, lse, delta, static_cast<T*>(dk),
                                               static_cast<T*>(dv), sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  using QD = Dq<T, HD, R, B2>;
  auto q_kern = flash_bwd_dq_kernel<T, HD, R, B2>;
  if ((e = allow_smem<QD>(q_kern)) != cudaSuccess) return e;
  dim3 q_grid(sh.B * sh.Hq, (sh.Sq + QD::BQ - 1) / QD::BQ);
  q_kern<<<q_grid, kThreads, QD::smem, st>>>(q_, k_, v_, g_, lse, delta, static_cast<T*>(dq), sh);
  return cudaGetLastError();
}

// Tile sizes by head width (rows per warp, the streamed tile): hd <= 128
// streams 64-row tiles with 8 rows per warp; hd <= 256 halves what shared
// memory would not hold (4 rows per warp, 32-row tiles).
template <typename T>
cudaError_t bwd_hd(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, const Shape& sh, cudaStream_t st) {
  if (sh.hd <= 64) return bwd<T, 64, 8, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, st);
  if (sh.hd <= 128) return bwd<T, 128, 8, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, st);
  return bwd<T, 256, 4, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, st);
}

// refuses a query-row map a row of which sits at or past Sk
bool make_shape(Shape* sh, int B, int Sq, int Sk, int Hq, int Hkv, int hd, int rl, int cs,
                int r0, int window, float cap, float scale) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv || hd < 1 || hd > 256 ||
      rl < 1 || cs < rl || r0 < 0 || r0 > cs - rl ||
      (int64_t)((Sq - 1) / rl) * cs + r0 + (Sq - 1) % rl >= Sk)
    return false;
  *sh = Shape{B, Sq, Sk, Hq, Hkv, hd, rl, cs, r0, window, cap, scale};
  return true;
}

}  // namespace

// dq, dk, dv (the shapes of q, k, v) are written; delta is (B, Hq, Sq) f32
// scratch; query row j sits at position (j / rl) * cs + r0 + j % rl of the
// Sk keys (rl = cs = Sq, r0 = 0 without a map).  Three launches: delta,
// dK/dV, dQ.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Sk, int Hq, int Hkv, int hd, int rl, int cs,
                                          int r0, int window, float cap, float scale, int dtype,
                                          void* stream) {
  Shape sh;
  if (!make_shape(&sh, B, Sq, Sk, Hq, Hkv, hd, rl, cs, r0, window, cap, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return (int)bwd_hd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, st);
    case DT_BF16:
      return (int)bwd_hd<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  if (err >= 10000)  // flash_attention_sm90.cu: 10000 + the CUresult
    return "cuTensorMapEncodeTiled refused a TMA descriptor (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
