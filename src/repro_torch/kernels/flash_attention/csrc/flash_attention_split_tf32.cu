// Causal GQA flash attention forward on Hopper's tensor cores in split TF32
// (sm_90a): f32 at any hd <= 256, and bf16 where hd % 8 != 0.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_kernel (via
// flash_attention_pallas) for the cases ops.route() sends to "split_tf32";
// bf16 with hd % 8 == 0 runs the wgmma/TMA kernel of flash_attention_sm90.cu.
// It takes the place of the CUDA-core flash_fwd_kernel that
// flash_attention.cu held before (f32 FMAs on the CUDA cores, one scalar
// load a thread per element, 8-warp blocks of 64 query rows, one grid row
// per (b, h): 64 blocks at federated-lm-ring's shape).  The function is the
// one of ref.py: scores (q . k) * hd^-0.5, then cap * tanh(s / cap) under a
// cap; key kp live for query qp when kp <= qp (and qp - kp < window);
// NEG_INF = -1e30, masked probabilities exactly 0, l clamped at 1e-30 in the
// division; lse = m + log l, f32 (B, Hq, S); out in the input dtype; any S.
// A query-row map (Shape::rl, cs, r0; flash_attention_sm90.cu) puts query
// row j of q (B, Sq, Hq, hd) at position (j / rl) * cs + r0 + j % rl of k
// and v (B, Sk, Hkv, hd); without one rl = cs = Sq, r0 = 0 and row j sits
// at j.  A block's key tiles run from its first row's position (less the
// window) to its last row's; a warp skips a stage its rows' positions
// cannot see, and masks by position where its rows span chunks.
//
// Split TF32 is an f32-accurate emulation, not TF32: every f32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and each
// product runs as lo.hi + hi.lo + hi.hi on the tensor cores with f32
// accumulation (mma.sync m16n8k8 .tf32), which keeps about 21 of f32's 24
// bits where plain TF32 keeps 11.  PyTorch's own TF32 flags stay off.  A
// bf16 value is exact in tf32, so a bf16 input's lo is 0 and its products
// with lo are skipped (Q K^T is one product, P V two: P is f32 and split).
//
// What bounds it: at the path's shapes, operations.  The count is 4 * hd
// flops per live (query, key) pair, at 495 / 3 = 165 TFLOP/s (the card's
// dense TF32 rate over the 3 products a split product takes), against q, k,
// v and out read or written once (and lse) over 3.35 TB/s; the larger of
// the two is this route's bound in PERF.md section 3, replacing the 67
// TFLOP/s f32 bound of the CUDA-core kernel, so that no share of a bound
// reads over 100%.
//
// Design.
// * mma.sync m16n8k8 .tf32, 16 query rows a warp, 4 warps a block.  Where
//   64-row blocks would fill the card (B * Hq * S / 64 >= 2 waves), the 4
//   warps own 64 rows and share every key; below that (federated-lm-ring's
//   (16, 64, 4, 4, 64)) two key groups of 2 warps own 32 rows, each group
//   takes half of every stage's keys, and the groups' (m, l, O) merge at
//   the end, which halves the chain of dependent products a block waits on
//   and launches 128 blocks there.  Heaviest query tiles (last along S)
//   first; only live key tiles are visited, and a warp skips a stage whose
//   keys its rows cannot see.
// * K and V stream in stages of keys through shared memory (a ring of 2
//   stages where it fits, else one stage: two blocks an SM then overlap
//   each other's loads), loaded by cp.async (16 bytes a copy, zero-filled
//   past S and past hd) where the tensor is f32 on a 16-byte boundary with
//   hd % 4 == 0.  Any other case (bf16, hd % 4 != 0) takes the scalar path
//   of the same kernel: one load a thread per element, converted to f32.
// * Split once: each K/V stage as it lands, in place, into two planes (hi,
//   lo) by the whole block, so no warp redoes a split; Q once per block,
//   staged through shared memory and split into registers (hd <= 64 in
//   f32, hd <= 128 in bf16), hi into registers and lo back into shared
//   memory (f32 at hd 128: both in registers took 255 and spilled), or
//   both planes in shared memory (hd 256).
// * S = Q K^T with the k dimension (hd) permuted so that a lane's two
//   operands are neighbours (k slot t <-> d 2t, slot t + 4 <-> 2t + 1):
//   each fragment is one 8-byte shared load.  Rows are padded (8 floats for
//   Q and K, 4 for V) so that the fragment loads fall on distinct banks.
// * The online softmax runs on the accumulator, in log2 units (exp2f): a
//   row's values sit in the 4 threads of a quad, so its max is 2 shuffles;
//   l is summed per lane and reduced once at the end.
// * P stays in registers: the accumulator of S holds keys 2t and 2t + 1 of
//   rows g and g + 8, and P V takes the key order permuted the same way (k
//   slot t <-> key 2t, t + 4 <-> 2t + 1), so the S accumulator is the A
//   fragment of P V with no shuffle; V's B fragments are read to match.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Shape {
  int B, Sq, Sk, Hq, Hkv, hd;  // Sq query rows, Sk keys
  int rl, cs, r0;  // query row j at position (j / rl) * cs + r0 + j % rl
  int window;      // <= 0: no window
  float cap;       // <= 0: no cap
  float scale;     // hd^-0.5 of the original hd
};

// Tile geometry of one instantiation.  KS key groups of RG = kWarps / KS
// warps: the block owns RG * 16 query rows, a ring stage holds KS * BK keys,
// and key group g takes the stage's g-th BK keys.  P planes (hi, lo for f32;
// hi for bf16).  Q's planes sit where registers allow (QMODE): 0, all in
// registers (at most 64 a thread); 1, hi in registers and lo in shared
// memory (f32 at hd 128: both would take 128 registers beside the
// accumulator's 64, and ptxas spills); 2, all in shared memory (hd 256).
template <typename T, int HD, int BK, int ST, int KS>
struct SplitCfg {
  static constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  static constexpr int RG = kWarps / KS, BQ = RG * 16, BKS = KS * BK;
  static constexpr int QMODE = HD * P <= 128 ? 0 : HD <= 128 ? 1 : 2;
  static constexpr int LDQ = HD + 8, LDK = HD + 8, LDV = HD + 4;  // floats a row
  static constexpr int QF = BQ * LDQ;                    // floats of one Q plane
  static constexpr int KF = BKS * LDK, VF = BKS * LDV;   // floats of one K / V plane
  static constexpr int STAGE = P * (KF + VF);
  static constexpr int QPLANES = QMODE == 2 ? P : 1;     // raw Q (then lo), or its planes
  static constexpr size_t smem = sizeof(float) * (QPLANES * QF + ST * STAGE);
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

// key kp is live for query row j at position qp
__device__ __forceinline__ bool live(int j, int qp, int kp, const Shape& sh) {
  return kp <= qp && j < sh.Sq && (sh.window <= 0 || qp - kp < sh.window);
}

__device__ __forceinline__ float capped(float raw, float cap) {
  return cap > 0.f ? cap * tanhf(raw / cap) : raw;
}

// ---------------------------------------------------------------------------
// PTX: cp.async, tf32 rounding, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// c += a b for one m16n8k8 tile: a = {(g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4)}, b = {(k = t, n = g), (k = t + 4, n = g)}, c = {(g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1)}, g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma(float (&c)[4], const float (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// ---------------------------------------------------------------------------
// Tiles: load (async where it can), split in place
// ---------------------------------------------------------------------------
// rows [row0, row0 + rows) of head h of a (B, S, H, hd) tensor into dst (row
// stride ld floats) as f32; rows >= S and columns >= hd are zero.  vec: f32,
// hd % 4 == 0 and a 16-byte aligned base, so 16-byte cp.async copies.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src, int b,
                                          int h, int H, int S, const Shape& sh, int row0,
                                          int rows, bool vec) {
  if (std::is_same<T, float>::value && vec) {
    const float* base = reinterpret_cast<const float*>(src);
    for (int idx = threadIdx.x; idx < rows * (HD / 4); idx += kThreads) {
      const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4, s = row0 + r;
      const bool in = s < S && c < sh.hd;
      const float* g = in ? base + (((int64_t)b * S + s) * H + h) * sh.hd + c : base;
      cp_async16(dst + r * ld + c, g, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD, s = row0 + r;
      float x = 0.f;
      if (s < S && d < sh.hd) x = to_f32(src[(((int64_t)b * S + s) * H + h) * sh.hd + d]);
      dst[r * ld + d] = x;
    }
  }
}

// hi <- tf32(x), lo <- tf32(x - hi) for the rows x columns HD of a plane
template <int HD>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int ld, int rows) {
  for (int idx = threadIdx.x; idx < rows * (HD / 4); idx += kThreads) {
    const int off = (idx / (HD / 4)) * ld + (idx % (HD / 4)) * 4;
    float4 x = *reinterpret_cast<const float4*>(hi + off), h, l;
    h.x = tf32(x.x); h.y = tf32(x.y); h.z = tf32(x.z); h.w = tf32(x.w);
    l.x = tf32(x.x - h.x); l.y = tf32(x.y - h.y); l.z = tf32(x.z - h.z); l.w = tf32(x.w - h.w);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// ---------------------------------------------------------------------------
// The kernel: one block per (b * Hq + h, tile of BQ query rows)
// ---------------------------------------------------------------------------
template <typename T, int HD, int BK, int ST, int KS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_split_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ lse, const Shape sh, bool vec) {
  using C = SplitCfg<T, HD, BK, ST, KS>;
  constexpr int P = C::P, RG = C::RG, BQ = C::BQ, BKS = C::BKS, LDQ = C::LDQ, LDK = C::LDK,
                LDV = C::LDV, NT = BK / 8, NC = HD / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // QPLANES of BQ x LDQ
  float* ring = Qs + C::QPLANES * C::QF;        // ST stages of (K planes, V planes)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int rg = warp % RG, kg = warp / RG;  // this warp's row group and key group
  const int bh = blockIdx.x, b = bh / sh.Hq, h = bh % sh.Hq, kvh = h / (sh.Hq / sh.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int qw = q0 + rg * 16;                       // this warp's first row
  const int q_last = min(q0 + BQ, sh.Sq) - 1;
  const int k_first = sh.window > 0 ? max(0, qpos(q0, sh) - sh.window + 1) : 0;
  const int k_begin = (k_first / BKS) * BKS;
  const int n_tiles = (qpos(q_last, sh) - k_begin) / BKS + 1;
  const int kc_end = (sh.hd + 7) / 8;  // 8-column chunks that hold data
  const float scale2 = sh.scale * kLog2e;

  auto load_kv = [&](int stage, int k0) {
    float* Ks = ring + stage * C::STAGE;
    load_rows<T, HD>(Ks, LDK, k, b, kvh, sh.Hkv, sh.Sk, sh, k0, BKS, vec);
    load_rows<T, HD>(Ks + P * C::KF, LDV, v, b, kvh, sh.Hkv, sh.Sk, sh, k0, BKS, vec);
  };

  load_rows<T, HD>(Qs, LDQ, q, b, h, sh.Hq, sh.Sq, sh, q0, BQ, vec);
  // the block's rows' positions, read where a stage is skipped or masked
  // (in shared memory: registers held across the loop made ptxas spill)
  __shared__ int pos_s[BQ];
  for (int i = threadIdx.x; i < BQ; i += kThreads) pos_s[i] = qpos(q0 + i, sh);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < ST; ++st) {
    if (st < n_tiles) load_kv(st, k_begin + st * BKS);
    cp_async_commit();  // empty groups keep the count uniform
  }
  cp_async_wait<ST>();  // Q has landed
  __syncthreads();

  // Q's A fragments, k slot t <-> column 2t and t + 4 <-> 2t + 1 of each
  // 8-column chunk: {(g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)};
  // split once, each lane its own fragments.  QMODE 1 writes lo back in
  // place once every warp has read its x (the key groups share rows): each
  // element of a row group's rows belongs to one lane of a warp
  constexpr int QM = C::QMODE;
  float qh[QM < 2 ? NC : 1][4], ql[QM < 2 && P == 2 ? NC : 1][4];
  if constexpr (QM < 2) {
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      const float* row = Qs + (rg * 16 + gq) * LDQ + kc * 8 + 2 * tq;
      const float2 x0 = *reinterpret_cast<const float2*>(row);
      const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * LDQ);
      const float x[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qh[kc][e] = tf32(x[e]);
        if constexpr (P == 2) ql[kc][e] = tf32(x[e] - qh[kc][e]);
      }
    }
    if constexpr (QM == 1) {  // lo leaves the registers for shared memory
      __syncthreads();
      if (kg == 0) {
#pragma unroll
        for (int kc = 0; kc < NC; ++kc) {
          float* row = Qs + (rg * 16 + gq) * LDQ + kc * 8 + 2 * tq;
          *reinterpret_cast<float2*>(row) = make_float2(ql[kc][0], ql[kc][2]);
          *reinterpret_cast<float2*>(row + 8 * LDQ) = make_float2(ql[kc][1], ql[kc][3]);
        }
      }  // made visible by the first tile's barrier
    }
  } else if constexpr (P == 2) {
    split_rows<HD>(Qs, Qs + C::QF, LDQ, BQ);  // made visible by the first tile's barrier
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const float* Kh = ring + (j % ST) * C::STAGE;
    const float* Vh = Kh + P * C::KF;
    cp_async_wait<ST - 1>();  // this thread's copies of tile j have landed
    __syncthreads();          // everyone's (and Q's)
    if constexpr (P == 2) {   // split K and V once, in place, by the whole block
      split_rows<HD>(const_cast<float*>(Kh), const_cast<float*>(Kh) + C::KF, LDK, BKS);
      split_rows<HD>(const_cast<float*>(Vh), const_cast<float*>(Vh) + C::VF, LDV, BKS);
      __syncthreads();
    }
    // this warp's keys: the kg-th BK of the stage; skipped where every pair
    // with its rows is masked
    const int kf = k_begin + j * BKS + kg * BK;
    const int pw0 = pos_s[rg * 16], pw1 = pos_s[rg * 16 + 15];  // the warp's first and last
    const bool skip = kf > pw1 || (sh.window > 0 && pw0 - (kf + BK - 1) >= sh.window);
    if (!skip) {
      const float* Kw = Kh + kg * BK * LDK;
      const float* Vw = Vh + kg * BK * LDV;

      // S = Q K^T over the chunks of hd that hold data; the two small
      // products sum apart from hi.hi (sc), so twice as many independent
      // chains of products are in flight
      float s[NT][4], sc[P == 2 ? NT : 1][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        if constexpr (P == 2) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) {
        if (kc < kc_end) {
          const int d = kc * 8 + 2 * tq;
          float ah[4], al[4];
          if constexpr (QM < 2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[e] = qh[kc][e];
              if constexpr (QM == 0 && P == 2) al[e] = ql[kc][e];
            }
            if constexpr (QM == 1) {  // lo, from shared memory
              const float* row = Qs + (rg * 16 + gq) * LDQ + d;
              const float2 x0 = *reinterpret_cast<const float2*>(row);
              const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * LDQ);
              al[0] = x0.x; al[1] = x1.x; al[2] = x0.y; al[3] = x1.y;
            }
          } else {
#pragma unroll
            for (int pl = 0; pl < P; ++pl) {
              const float* row = Qs + pl * C::QF + (rg * 16 + gq) * LDQ + d;
              const float2 x0 = *reinterpret_cast<const float2*>(row);
              const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * LDQ);
              float* a = pl == 0 ? ah : al;
              a[0] = x0.x; a[1] = x1.x; a[2] = x0.y; a[3] = x1.y;
            }
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* kr = Kw + (n * 8 + gq) * LDK + d;
            const float2 bh2 = *reinterpret_cast<const float2*>(kr);
            if constexpr (P == 2) {
              const float2 bl2 = *reinterpret_cast<const float2*>(kr + C::KF);
              mma(sc[n], al, bh2.x, bh2.y);
              mma(sc[n], ah, bl2.x, bl2.y);
            }
            mma(s[n], ah, bh2.x, bh2.y);
          }
        }
      }

      if constexpr (P == 2) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += sc[n][e];
      }
      // online softmax on the accumulator, in log2 units: element e of tile
      // n is row gq + 8 (e / 2), key kf + 8 n + 2 tq + e % 2
      const bool full = kf + BK - 1 <= pw0 && (sh.window <= 0 || pw1 - kf < sh.window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kf + n * 8 + 2 * tq + e % 2;
          const int r = gq + 8 * (e / 2);
          const float x = full || live(qw + r, pos_s[rg * 16 + r], kp, sh)
              ? (sh.cap > 0.f ? capped(s[n][e] * sh.scale, sh.cap) * kLog2e : s[n][e] * scale2)
              : kNegInf;
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kf + n * 8 + 2 * tq + e % 2, r = gq + 8 * (e / 2);
          const float p =
              full || live(qw + r, pos_s[rg * 16 + r], kp, sh) ? exp2f(s[n][e] - m[e / 2]) : 0.f;
          s[n][e] = p;
          l[e / 2] += p;
        }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        o[n][0] *= corr[0]; o[n][1] *= corr[0];
        o[n][2] *= corr[1]; o[n][3] *= corr[1];
      }

      // O += P V: chunk jc of 8 keys is S tile jc, k slot t <-> key 2t and t
      // + 4 <-> 2t + 1, so the A fragment is {c0, c2, c1, c3} of that tile
#pragma unroll
      for (int jc = 0; jc < NT; ++jc) {
        const float pa[4] = {s[jc][0], s[jc][2], s[jc][1], s[jc][3]};
        float ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ph[e] = tf32(pa[e]);
          pl[e] = tf32(pa[e] - ph[e]);
        }
        const float* v0 = Vw + (jc * 8 + 2 * tq) * LDV + gq;  // keys 2t, 2t + 1; column gq
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (n < kc_end) {
            const float b0 = v0[n * 8], b1 = v0[n * 8 + LDV];
            mma(o[n], pl, b0, b1);
            if constexpr (P == 2) mma(o[n], ph, v0[C::VF + n * 8], v0[C::VF + n * 8 + LDV]);
            mma(o[n], ph, b0, b1);
          }
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (j + ST < n_tiles) load_kv(j % ST, k_begin + (j + ST) * BKS);
    cp_async_commit();
  }
  cp_async_wait<0>();  // nothing outstanding at exit

#pragma unroll
  for (int i = 0; i < 2; ++i) {  // l summed over the quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if constexpr (KS > 1) {
    // merge the key groups' (m, l, O) into key group 0 through shared memory
    // (the ring is free: the last barrier above passed after every read)
    constexpr int NV = NC * 4 + 4;
    float* xs = ring;  // NV x (KS - 1) x RG x 32, lane-minor
    const int slot = (rg * 32 + lane);
    if (kg > 0) {
      float* dst = xs + (kg - 1) * RG * 32 + slot;
      const int str = (KS - 1) * RG * 32;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(n * 4 + e) * str] = o[n][e];
      dst[(NC * 4) * str] = m[0]; dst[(NC * 4 + 1) * str] = m[1];
      dst[(NC * 4 + 2) * str] = l[0]; dst[(NC * 4 + 3) * str] = l[1];
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll 1
    for (int g = 1; g < KS; ++g) {
      const float* src = xs + (g - 1) * RG * 32 + slot;
      const int str = (KS - 1) * RG * 32;
      float f0[2], f1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = src[(NC * 4 + i) * str], l1 = src[(NC * 4 + 2 + i) * str];
        const float mm = fmaxf(m[i], m1);
        f0[i] = exp2f(m[i] - mm);
        f1[i] = exp2f(m1 - mm);
        m[i] = mm;
        l[i] = l[i] * f0[i] + l1 * f1[i];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = o[n][e] * f0[e / 2] + src[(n * 4 + e) * str] * f1[e / 2];
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qw + gq + 8 * i;
    if (qr >= sh.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (((int64_t)b * sh.Sq + qr) * sh.Hq + h) * sh.hd;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int d = n * 8 + 2 * tq;
      if (d < sh.hd) orow[d] = from_f32<T>(o[n][2 * i] * inv);
      if (d + 1 < sh.hd) orow[d + 1] = from_f32<T>(o[n][2 * i + 1] * inv);
    }
    if (tq == 0) lse[(int64_t)bh * sh.Sq + qr] = (m[i] + log2f(l[i])) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
template <typename T, int HD, int BK, int ST, int KS>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                const Shape& sh, cudaStream_t st) {
  using C = SplitCfg<T, HD, BK, ST, KS>;
  auto kern = flash_fwd_split_tf32_kernel<T, HD, BK, ST, KS>;
  // the shared-memory opt-in holds for the current device only, so it is set
  // at every launch (a few host microseconds), never cached
  if (C::smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
    if (e != cudaSuccess) return e;
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = std::is_same<T, float>::value && sh.hd % 4 == 0 && aligned(q) &&
                   aligned(k) && aligned(v);
  const dim3 grid(sh.B * sh.Hq, (sh.Sq + C::BQ - 1) / C::BQ);
  kern<<<grid, kThreads, C::smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(out), lse, sh,
                                        vec);
  return cudaGetLastError();
}

// Two shapes of block, both 4 warps.  Where 64-row blocks would not fill
// the card twice over (federated-lm-ring's (16, 64, 4, 4, 64) would launch
// 64), 2 key groups of 2 warps split each stage's keys over 32-row blocks
// and merge at the end; else 4 warps of 16 rows share every key.  Tiles
// and stages as shared memory allows, f32 (bf16 needs half): 153 KB (hd 64,
// 2 stages of 64 keys), 155 KB (hd 128, one stage of 64 keys) and 202 KB
// (hd 256, one of 32) with key groups; 54 KB (hd 64, 2 stages of 16 keys),
// 103 KB (hd 128, one stage of 32 keys: 2 blocks an SM, which measured
// faster than 2 stages of 16) and 202 KB (hd 256, one stage of 16) without.
template <typename T>
cudaError_t fwd_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                   const Shape& sh, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool split_keys = (long long)sh.B * sh.Hq * ((sh.Sq + 63) / 64) < 2LL * sms;
  if (split_keys) {
    if (sh.hd <= 64) return fwd<T, 64, 32, 2, 2>(q, k, v, out, lse, sh, st);
    if (sh.hd <= 128) return fwd<T, 128, 32, 1, 2>(q, k, v, out, lse, sh, st);
    return fwd<T, 256, 16, 1, 2>(q, k, v, out, lse, sh, st);
  }
  if (sh.hd <= 64) return fwd<T, 64, 16, 2, 1>(q, k, v, out, lse, sh, st);
  if (sh.hd <= 128) return fwd<T, 128, 32, 1, 1>(q, k, v, out, lse, sh, st);
  return fwd<T, 256, 16, 1, 1>(q, k, v, out, lse, sh, st);
}

}  // namespace

// out (B, Sq, Hq, hd) and lse (B, Hq, Sq) f32 are written; query row j sits
// at position (j / rl) * cs + r0 + j % rl of the Sk keys (rl = cs = Sq, r0 =
// 0 without a map; a map a row of which sits at or past Sk is refused);
// window <= 0 and cap <= 0 mean none; scale is hd^-0.5, rounded to f32 by
// the caller.
extern "C" int flash_attention_fwd_split_tf32_launch(const void* q, const void* k, const void* v,
                                                     void* out, float* lse, int B, int Sq, int Sk,
                                                     int Hq, int Hkv, int hd, int rl, int cs,
                                                     int r0, int window, float cap, float scale,
                                                     int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv || hd < 1 || hd > 256 ||
      Sq > 65535 * 32 || rl < 1 || cs < rl || r0 < 0 || r0 > cs - rl ||
      (int64_t)((Sq - 1) / rl) * cs + r0 + (Sq - 1) % rl >= Sk)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, Sq, Sk, Hq, Hkv, hd, rl, cs, r0, window, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)fwd_hd<float>(q, k, v, out, lse, sh, st);
    case DT_BF16: return (int)fwd_hd<__nv_bfloat16>(q, k, v, out, lse, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
