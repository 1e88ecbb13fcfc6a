// Causal GQA flash attention backward on Hopper's tensor cores in split TF32
// (sm_90a): f32 at any hd <= 256, and bf16 where hd % 8 != 0.
//
// No TPU counterpart (the reference differentiates its plain attention
// through XLA).  ops.route(dtype, hd, backward=True) sends here every
// backward that is not bf16 with hd % 8 == 0, which runs the wgmma/TMA
// kernels of flash_attention_sm90.cu.  These kernels take the place of the
// CUDA-core kernels that flash_attention.cu held before (f32 FMAs, one scalar
// load a thread per element, 8-warp blocks of 64 rows: 64 blocks a kernel at
// federated-lm-ring's shape).  The function is flash_attention_bwd_ref's:
// P = exp(capped(s) - lse) (0 where masked), dV = P^T dO, dP = dO V^T,
// delta = rowsum(dO * O), dS = P (dP - delta), times 1 - tanh^2(s / cap)
// under a cap, dQ = scale dS K, dK = scale dS^T Q; GQA sums the G query
// heads of a KV head into its dK and dV; any S; the query-row map
// (Shape::rl, cs, r0) of flash_attention_sm90.cu, a key no row reads gets
// zeros.
//
// Split TF32, as flash_attention_split_tf32.cu: every f32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), and each product runs as lo.hi +
// hi.lo + hi.hi on mma.sync m16n8k8 .tf32 with f32 accumulation, about 21
// bits where TF32 keeps 11.  P and dS are split in registers.  A bf16 value
// is exact in tf32: a bf16 input's lo is 0 and its products with lo are
// skipped.  PyTorch's TF32 flags stay off.  wgmma is left for later: its
// .tf32 form takes K-major operands only, and dV = P^T dO and dK = dS^T Q
// would need transposes in shared memory.
//
// What bounds it: operations.  2.5 x 4 * hd flops per live (query, key) pair
// at 165 TFLOP/s (the dense TF32 rate over split TF32's 3 products) against
// q, k, v, out, dO, lse and the gradients read or written once over 3.35
// TB/s.  The kernels run 7 products where the count charges 5: dQ's kernel
// forms S and dP again (FlashAttention-2, which sums dQ without atomics).
//
// Design.  Three launches: delta; dK/dV; dQ.  4-warp blocks, 16 rows a warp
// on the M side of every product.
// * dK/dV: block = (b * Hkv + kvh, BK keys), keys the M rows.  K and V land
//   once; Q, dO, lse, delta and the rows' positions
//   stream through a ring of shared-memory stages by cp.async, over the G
//   query heads of kvh and their live query tiles, so GQA sums in registers
//   without atomics.  S^T = K Q^T and dP^T = V dO^T; P^T and dS^T = P^T (dP^T
//   - delta) stay in the accumulators, and dV += P^T dO and dK += dS^T Q take
//   them as A fragments with the query order permuted as the forward
//   permutes P (k slot t <-> query 2t, t + 4 <-> 2t + 1), so no value is
//   shuffled.
// * dQ: block = (b * Hq + h, BQ query rows), queries the M rows; Q and dO
//   land once, K and V stream; S = Q K^T, dP = dO V^T, dQ += dS K.
// * Operands sit in shared memory as f32 (bf16 converted on load) and are
//   split into hi and lo in registers as each fragment loads.  Split planes
//   in shared memory, as the forward keeps them, doubled it: at hd 128 a
//   dK/dV block took 209 KB, one 4-warp block an SM, slower than the
//   CUDA-core kernels it replaces; raw, it takes 105 KB and two blocks
//   share an SM.  The two score products run
//   in one loop, so four chains of products are in flight a warp.  Rows are
//   padded to HD + 8 floats: the score products' fragments are 8-byte loads
//   on distinct banks; the second products' B reads are scalar and meet
//   2-way conflicts.
// * Small grids: where 64-row blocks would not fill the card twice over
//   (federated-lm-ring's (16, 64, 4, 4, 64) launches 64 of each), two groups
//   of 2 warps own 32 rows and split each stage's streamed rows (dK/dV: the
//   queries; dQ: the keys), and sum their accumulators in a fixed order at
//   the end (128 blocks there).
// * Wide heads (HD 256 tile: hd 129-256): two column groups of 2 warps each
//   own half of the output columns of the same 16 rows, so a thread holds at
//   most 128 accumulator registers (dK and dV at hd 128, as at hd 256); both
//   groups form the whole S and dP.
// * Only live tiles are visited, the heaviest first; a warp skips a stage
//   whose rows and keys cannot meet, and masks by position only where a
//   stage crosses the diagonal, the window's edge or the ragged end.  The
//   block's query positions sit in shared memory (registers held across
//   the loop made ptxas spill in the forward).
// * No atomics: two calls give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };  // dtype codes shared with ops.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

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

// p = exp(capped(s scale) - lse), and pg = p times the cap's derivative 1 -
// tanh^2 (p without a cap), so that dS = pg (dP - delta)
__device__ __forceinline__ void prob(float s, float lse, const Shape& sh, float& p, float& pg) {
  const float raw = s * sh.scale;
  if (sh.cap > 0.f) {
    const float t = tanhf(raw / sh.cap);
    p = exp2f((sh.cap * t - lse) * kLog2e);
    pg = p * (1.f - t * t);
  } else {
    p = pg = exp2f((raw - lse) * kLog2e);
  }
}

// ---------------------------------------------------------------------------
// cp.async, tf32 rounding, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to tf32, to nearest with ties away from zero, bit for bit as
// cvt.rna.tf32.f32 rounds a finite x, on the integer units: the splits in
// registers issue about one conversion a product, and cvt.rna's issue rate
// bound the kernels
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
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
// Tiles: load (async where it can); splits
// ---------------------------------------------------------------------------
// rows [row0, row0 + rows) of head h of a (B, S, H, hd) tensor into dst (row
// stride ld floats) as f32; rows >= S and columns >= hd are zero.  vec: f32,
// hd % 4 == 0 and 16-byte aligned bases, so 16-byte cp.async copies.
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

// hi = tf32(x), lo = tf32(x - hi) where SPLIT (an f32 input); a bf16
// input's value is exact in tf32 (hi = x, and lo is never read)
template <bool SPLIT>
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  if constexpr (SPLIT) {
    hi = tf32(x);
    lo = tf32(x - hi);
  } else {
    hi = x;
    lo = 0.f;
  }
}

// the A fragment of 16 rows at a (row stride LD) and 8-column chunk d,
// split: {(g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)}
template <bool SPLIT, int LD>
__device__ __forceinline__ void a_frag(float (&hi)[4], float (&lo)[4], const float* a, int gq,
                                       int d) {
  const float2 x0 = *reinterpret_cast<const float2*>(a + gq * LD + d);
  const float2 x1 = *reinterpret_cast<const float2*>(a + (gq + 8) * LD + d);
  const float x[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) split<SPLIT>(x[e], hi[e], lo[e]);
}

// ---------------------------------------------------------------------------
// The two products
// ---------------------------------------------------------------------------
// s1 = A1 B1^T and s2 = A2 B2^T in one loop, for 16 rows of each A and NT
// * 8 rows of each B (row stride LD, f32 in shared memory, split here), over
// the 8-column chunks of hd that hold data, the k dimension permuted so that
// a lane's two operands are neighbours (k slot t <-> column 2t, t + 4 <-> 2t
// + 1): each fragment is one 8-byte load.  The two small products of a
// split sum apart from hi.hi (in c1, c2), so twice as many independent
// chains of products are in flight.
template <bool SPLIT, int NT, int HD, int LD>
__device__ __forceinline__ void scores(float (&s1)[NT][4], float (&s2)[NT][4], const float* a1,
                                       const float* b1, const float* a2, const float* b2,
                                       int kc_end, int gq, int tq) {
  float c1[NT][4], c2[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s1[n][e] = s2[n][e] = c1[n][e] = c2[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc) {
    if (kc < kc_end) {
      const int d = kc * 8 + 2 * tq;
      float h1[4], l1[4], h2[4], l2[4];
      a_frag<SPLIT, LD>(h1, l1, a1, gq, d);
      a_frag<SPLIT, LD>(h2, l2, a2, gq, d);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 x1 = *reinterpret_cast<const float2*>(b1 + (n * 8 + gq) * LD + d);
        const float2 x2 = *reinterpret_cast<const float2*>(b2 + (n * 8 + gq) * LD + d);
        float bh1[2], bl1[2], bh2[2], bl2[2];
        split<SPLIT>(x1.x, bh1[0], bl1[0]);
        split<SPLIT>(x1.y, bh1[1], bl1[1]);
        split<SPLIT>(x2.x, bh2[0], bl2[0]);
        split<SPLIT>(x2.y, bh2[1], bl2[1]);
        if constexpr (SPLIT) {
          mma(c1[n], l1, bh1[0], bh1[1]);
          mma(c2[n], l2, bh2[0], bh2[1]);
          mma(c1[n], h1, bl1[0], bl1[1]);
          mma(c2[n], h2, bl2[0], bl2[1]);
        }
        mma(s1[n], h1, bh1[0], bh1[1]);
        mma(s2[n], h2, bh2[0], bh2[1]);
      }
    }
  }
  if constexpr (SPLIT) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1[n][e] += c1[n][e];
        s2[n][e] += c2[n][e];
      }
  }
}

// acc += X B: X (16 x NT * 8) in a score product's accumulator layout, split
// into hi and lo here, as the A fragment {c0, c2, c1, c3} of each 8-column
// tile (k slot t <-> column 2t, t + 4 <-> 2t + 1, the order the score
// product left); B's rows are X's columns (row stride LD, f32, split here),
// its columns the output chunks n < n_end from b
template <bool SPLIT, int NT, int NO, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[NO][4], const float (&x)[NT][4],
                                           const float* b, int n_end, int gq, int tq) {
#pragma unroll
  for (int jc = 0; jc < NT; ++jc) {
    const float xa[4] = {x[jc][0], x[jc][2], x[jc][1], x[jc][3]};
    float xh[4], xl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xh[e] = tf32(xa[e]);
      xl[e] = tf32(xa[e] - xh[e]);
    }
    const float* b0 = b + (jc * 8 + 2 * tq) * LD + gq;  // rows 2t, 2t + 1; column g
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n < n_end) {
        float bh0, bl0, bh1, bl1;
        split<SPLIT>(b0[n * 8], bh0, bl0);
        split<SPLIT>(b0[n * 8 + LD], bh1, bl1);
        mma(acc[n], xl, bh0, bh1);
        if constexpr (SPLIT) mma(acc[n], xh, bl0, bl1);
        mma(acc[n], xh, bh0, bh1);
      }
    }
  }
}

// the accumulators of warp groups 1.. of a block added into group 0's, in
// group order, through shared memory xs (a free ring): W = the warps of a
// group times 32 lanes, slot = this lane's index among them; returns false
// for the threads of groups 1.. (done)
template <int NA, int NO, int GROUPS>
__device__ __forceinline__ bool merge_groups(float (&acc)[NA][NO][4], float* xs, int group,
                                             int slot, int W) {
  const int str = (GROUPS - 1) * W;
  __syncthreads();  // every warp is done with the ring
  if (group > 0) {
    float* dst = xs + (group - 1) * W + slot;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[((a * NO + n) * 4 + e) * str] = acc[a][n][e];
  }
  __syncthreads();
  if (group > 0) return false;
#pragma unroll 1
  for (int g = 1; g < GROUPS; ++g) {
    const float* src = xs + (g - 1) * W + slot;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] += src[((a * NO + n) * 4 + e) * str];
  }
  return true;
}

// rows r, r + 8 of a warp's accumulator (scaled by f) into row-major (B, S,
// H, hd) dst at head h, columns c0 + the chunks n < n_end
template <typename T, int NO>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, const float (&acc)[NO][4],
                                          float f, int b, int r, int h, int H, int S, int c0,
                                          int n_end, int tq, const Shape& sh) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = r + 8 * i;
    if (s >= S) continue;
    T* row = dst + (((int64_t)b * S + s) * H + h) * sh.hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = c0 + n * 8 + 2 * tq;
      if (n < n_end && d < sh.hd) row[d] = from_f32<T>(acc[n][2 * i] * f);
      if (n < n_end && d + 1 < sh.hd) row[d + 1] = from_f32<T>(acc[n][2 * i + 1] * f);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 1: delta = rowsum(dO * O) in f32, (B, Hq, Sq); one warp a row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_split_tf32_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                  float* __restrict__ delta, const Shape sh) {
  const int64_t row = blockIdx.x * 8ll + threadIdx.x / 32;  // (b, s, h) row-major
  if (row >= (int64_t)sh.B * sh.Sq * sh.Hq) return;
  const int lane = threadIdx.x % 32;
  const T* o = out + row * sh.hd;
  const T* g = dout + row * sh.hd;
  float acc = 0.f;
  for (int d = lane; d < sh.hd; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int64_t per_b = (int64_t)sh.Sq * sh.Hq;
    const int64_t b = row / per_b, s = (row % per_b) / sh.Hq, h = row % sh.Hq;
    delta[(b * sh.Hq + h) * sh.Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// Backward 2: dK, dV.  Block = (b * Hkv + kvh, BK = RG * 16 keys); warp (qg,
// rg, cg) owns keys rg * 16.. and output columns cg * HO.., and takes the
// qg-th BQ query rows of each stage of QS * BQ.
// ---------------------------------------------------------------------------
template <typename T, int HD, int BQ, int ST, int QS, int CS>
struct KvCfg {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int RG = kWarps / (QS * CS), BK = RG * 16, BQS = QS * BQ, HO = HD / CS;
  static constexpr int LD = HD + 8;
  static constexpr int OWN = BK * LD;   // floats of K (or V)
  static constexpr int STR = BQS * LD;  // floats of Q (or dO) in a stage
  static constexpr int STAGE = 2 * STR + 3 * BQS;  // Q, dO; lse, delta, positions
  static constexpr size_t smem = sizeof(float) * (2 * OWN + ST * STAGE);
  static_assert(RG * QS * CS == kWarps && HO % 8 == 0 && BQ % 8 == 0, "tile geometry");
};

// (a minimum of one block an SM: with the block size alone ptxas cut the
// small-grid hd-64 instantiation to 168 registers, three blocks' worth, and
// spilled)
template <typename T, int HD, int BQ, int ST, int QS, int CS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_split_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 T* __restrict__ dk, T* __restrict__ dv, const Shape sh,
                                 bool vec) {
  using C = KvCfg<T, HD, BQ, ST, QS, CS>;
  constexpr bool SPLIT = C::SPLIT;
  constexpr int RG = C::RG, BK = C::BK, BQS = C::BQS, LD = C::LD, HO = C::HO, NT = BQ / 8,
                NO = HO / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // BK x LD
  float* Vs = Ks + C::OWN;
  float* ring = Vs + C::OWN;  // ST stages of (Q, dO, lse, delta, positions)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int cg = warp % CS, rg = (warp / CS) % RG, qg = warp / (CS * RG);
  const int b = blockIdx.x / sh.Hkv, kvh = blockIdx.x % sh.Hkv, G = sh.Hq / sh.Hkv;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most queries
  const int kw = k0 + rg * 16;     // this warp's first key
  const int k_last = min(k0 + BK, sh.Sk) - 1;
  // the query rows whose positions reach these keys (the map's inverse)
  const int q_begin = rows_before(k0, sh) / BQS * BQS;
  const int q_end = sh.window > 0 ? rows_before(k_last + sh.window, sh) : sh.Sq;
  const int nq = q_end > q_begin ? (q_end - q_begin + BQS - 1) / BQS : 0;
  const int n_tiles = G * nq;  // over the G query heads of kvh
  const int kc_end = (sh.hd + 7) / 8;
  const int c0 = cg * HO, n_end = min(NO, (sh.hd - c0 + 7) / 8);

  auto load_stage = [&](int stage, int j) {
    float* Qt = ring + stage * C::STAGE;
    float* Gt = Qt + C::STR;
    float* Lt = Gt + C::STR;
    float* Et = Lt + BQS;
    int* Pt = reinterpret_cast<int*>(Et + BQS);
    const int h = kvh * G + j / nq, q0 = q_begin + (j % nq) * BQS;
    load_rows<T, HD>(Qt, LD, q, b, h, sh.Hq, sh.Sq, sh, q0, BQS, vec);
    load_rows<T, HD>(Gt, LD, dout, b, h, sh.Hq, sh.Sq, sh, q0, BQS, vec);
    const int64_t row = ((int64_t)b * sh.Hq + h) * sh.Sq + q0;
    for (int i = threadIdx.x; i < BQS; i += kThreads) {
      const bool in = q0 + i < sh.Sq;
      cp_async4(Lt + i, in ? lse + row + i : lse, in ? 4 : 0);
      cp_async4(Et + i, in ? delta + row + i : delta, in ? 4 : 0);
      Pt[i] = qpos(q0 + i, sh);
    }
  };

  load_rows<T, HD>(Ks, LD, k, b, kvh, sh.Hkv, sh.Sk, sh, k0, BK, vec);
  load_rows<T, HD>(Vs, LD, v, b, kvh, sh.Hkv, sh.Sk, sh, k0, BK, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < ST; ++st) {
    if (st < n_tiles) load_stage(st, st);
    cp_async_commit();  // empty groups keep the count uniform
  }
  cp_async_wait<ST>();  // K and V have landed (made visible by the first stage's barrier)

  float acc[2][NO][4];  // dK, dV
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const float* Qt = ring + (j % ST) * C::STAGE;
    const float* Gt = Qt + C::STR;
    const float* Lt = Gt + C::STR;
    const float* Et = Lt + BQS;
    const int* Pt = reinterpret_cast<const int*>(Et + BQS);
    cp_async_wait<ST - 1>();  // this thread's copies of stage j have landed
    __syncthreads();          // everyone's
    const int q0 = q_begin + (j % nq) * BQS, i0 = qg * BQ, qs = q0 + i0;  // this warp's queries
    if (qs < sh.Sq && kw < sh.Sk) {
      const int pmin = Pt[i0], pmax = Pt[min(qs + BQ, sh.Sq) - 1 - q0];
      const bool skip = pmax < kw || (sh.window > 0 && pmin - (kw + 15) >= sh.window);
      if (!skip) {
        float s[NT][4], dp[NT][4];
        scores<SPLIT, NT, HD, LD>(s, dp, Ks + rg * 16 * LD, Qt + i0 * LD, Vs + rg * 16 * LD,
                                  Gt + i0 * LD, kc_end, gq, tq);
        // element e of tile n: key kw + gq + 8 (e / 2), query row i0 + 8 n + 2 tq + e % 2
        const bool full = pmin >= kw + 15 && qs + BQ <= sh.Sq &&
                          (sh.window <= 0 || pmax - kw < sh.window);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + n * 8 + 2 * tq + (e & 1);
            float p = 0.f, pg = 0.f;
            if (full || live(q0 + i, Pt[i], kw + gq + 8 * (e >> 1), sh))
              prob(s[n][e], Lt[i], sh, p, pg);
            s[n][e] = p;
            dp[n][e] = pg * (dp[n][e] - Et[i]);
          }
        // dV += P^T dO, dK += dS^T Q over this warp's output columns
        accumulate<SPLIT, NT, NO, LD>(acc[1], s, Gt + i0 * LD + c0, n_end, gq, tq);
        accumulate<SPLIT, NT, NO, LD>(acc[0], dp, Qt + i0 * LD + c0, n_end, gq, tq);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (j + ST < n_tiles) load_stage(j % ST, j + ST);
    cp_async_commit();
  }
  cp_async_wait<0>();  // nothing outstanding at exit

  if constexpr (QS > 1) {
    static_assert(2 * NO * 4 * (QS - 1) * RG * CS * 32 <= ST * C::STAGE, "merge buffer");
    if (!merge_groups<2, NO, QS>(acc, ring, qg, (rg * CS + cg) * 32 + lane, RG * CS * 32))
      return;
  }
  const int r = kw + gq;
  store_acc<T, NO>(dk, acc[0], sh.scale, b, r, kvh, sh.Hkv, sh.Sk, c0, n_end, tq, sh);
  store_acc<T, NO>(dv, acc[1], 1.f, b, r, kvh, sh.Hkv, sh.Sk, c0, n_end, tq, sh);
}

// ---------------------------------------------------------------------------
// Backward 3: dQ.  Block = (b * Hq + h, BQ = RG * 16 query rows); warp (kg,
// rg, cg) owns rows rg * 16.. and output columns cg * HO.., and takes the
// kg-th BK keys of each stage of KS * BK.
// ---------------------------------------------------------------------------
template <typename T, int HD, int BK, int ST, int KS, int CS>
struct QCfg {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int RG = kWarps / (KS * CS), BQ = RG * 16, BKS = KS * BK, HO = HD / CS;
  static constexpr int LD = HD + 8;
  static constexpr int OWN = BQ * LD;   // floats of Q (or dO)
  static constexpr int STR = BKS * LD;  // floats of K (or V) in a stage
  static constexpr int STAGE = 2 * STR;
  static constexpr size_t smem = sizeof(float) * (2 * OWN + ST * STAGE);
  static_assert(RG * KS * CS == kWarps && HO % 8 == 0 && BK % 8 == 0, "tile geometry");
};

template <typename T, int HD, int BK, int ST, int KS, int CS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_split_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dq, const Shape sh, bool vec) {
  using C = QCfg<T, HD, BK, ST, KS, CS>;
  constexpr bool SPLIT = C::SPLIT;
  constexpr int RG = C::RG, BQ = C::BQ, BKS = C::BKS, LD = C::LD, HO = C::HO, NT = BK / 8,
                NO = HO / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* Gs = Qs + C::OWN;                      // dO
  float* ring = Gs + C::OWN;                    // ST stages of (K, V)
  __shared__ int pos_s[BQ];  // the rows' positions (registers across the loop spill)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int cg = warp % CS, rg = (warp / CS) % RG, kg = warp / (CS * RG);
  const int bh = blockIdx.x, b = bh / sh.Hq, h = bh % sh.Hq, kvh = h / (sh.Hq / sh.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int qw = q0 + rg * 16;                       // this warp's first row
  const int q_last = min(q0 + BQ, sh.Sq) - 1;
  const int k_first = sh.window > 0 ? max(0, qpos(q0, sh) - sh.window + 1) : 0;
  const int k_begin = (k_first / BKS) * BKS;
  const int n_tiles = (qpos(q_last, sh) - k_begin) / BKS + 1;
  const int kc_end = (sh.hd + 7) / 8;
  const int c0 = cg * HO, n_end = min(NO, (sh.hd - c0 + 7) / 8);

  auto load_kv = [&](int stage, int k0) {
    float* Kt = ring + stage * C::STAGE;
    load_rows<T, HD>(Kt, LD, k, b, kvh, sh.Hkv, sh.Sk, sh, k0, BKS, vec);
    load_rows<T, HD>(Kt + C::STR, LD, v, b, kvh, sh.Hkv, sh.Sk, sh, k0, BKS, vec);
  };

  load_rows<T, HD>(Qs, LD, q, b, h, sh.Hq, sh.Sq, sh, q0, BQ, vec);
  load_rows<T, HD>(Gs, LD, dout, b, h, sh.Hq, sh.Sq, sh, q0, BQ, vec);
  for (int i = threadIdx.x; i < BQ; i += kThreads) pos_s[i] = qpos(q0 + i, sh);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < ST; ++st) {
    if (st < n_tiles) load_kv(st, k_begin + st * BKS);
    cp_async_commit();
  }
  // lse and delta of this thread's rows qw + gq and qw + gq + 8
  float lr[2], er[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + gq + 8 * i;
    const bool in = r < sh.Sq;
    lr[i] = in ? lse[(int64_t)bh * sh.Sq + r] : 0.f;
    er[i] = in ? delta[(int64_t)bh * sh.Sq + r] : 0.f;
  }
  cp_async_wait<ST>();  // Q and dO have landed (made visible by the first stage's barrier)

  float acc[1][NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[0][n][0] = acc[0][n][1] = acc[0][n][2] = acc[0][n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const float* Kt = ring + (j % ST) * C::STAGE;
    const float* Vt = Kt + C::STR;
    cp_async_wait<ST - 1>();
    __syncthreads();
    const int kf = k_begin + j * BKS + kg * BK;  // this warp's keys
    if (qw < sh.Sq) {
      const int pw0 = pos_s[rg * 16], pw1 = pos_s[rg * 16 + 15];
      const bool skip = kf > pw1 || (sh.window > 0 && pw0 - (kf + BK - 1) >= sh.window);
      if (!skip) {
        float s[NT][4], dp[NT][4];
        scores<SPLIT, NT, HD, LD>(s, dp, Qs + rg * 16 * LD, Kt + kg * BK * LD,
                                  Gs + rg * 16 * LD, Vt + kg * BK * LD, kc_end, gq, tq);
        // element e of tile n: row qw + gq + 8 (e / 2), key kf + 8 n + 2 tq + e % 2
        const bool full = kf + BK - 1 <= pw0 && qw + 16 <= sh.Sq &&
                          (sh.window <= 0 || pw1 - kf < sh.window);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = gq + 8 * (e >> 1);
            float p = 0.f, pg = 0.f;
            if (full || live(qw + r, pos_s[rg * 16 + r], kf + n * 8 + 2 * tq + (e & 1), sh))
              prob(s[n][e], lr[e >> 1], sh, p, pg);
            dp[n][e] = pg * (dp[n][e] - er[e >> 1]);
          }
        // dQ += dS K over this warp's output columns
        accumulate<SPLIT, NT, NO, LD>(acc[0], dp, Kt + kg * BK * LD + c0, n_end, gq, tq);
      }
    }
    __syncthreads();
    if (j + ST < n_tiles) load_kv(j % ST, k_begin + (j + ST) * BKS);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {
    static_assert(NO * 4 * (KS - 1) * RG * CS * 32 <= ST * C::STAGE, "merge buffer");
    if (!merge_groups<1, NO, KS>(acc, ring, kg, (rg * CS + cg) * 32 + lane, RG * CS * 32))
      return;
  }
  store_acc<T, NO>(dq, acc[0], sh.scale, b, qw + gq, h, sh.Hq, sh.Sq, c0, n_end, tq, sh);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
// Raises the dynamic shared-memory limit of kernel to bytes.  The attribute
// holds for the current device only, so it is set at every launch (a few
// host microseconds), never cached: a cache would skip it on a second card.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes <= 48 * 1024 ? cudaSuccess
      : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
};

template <typename T, int HD, int BQ, int ST, int QS, int CS>
cudaError_t dkdv(const Args& a, const Shape& sh, bool vec, cudaStream_t st) {
  using C = KvCfg<T, HD, BQ, ST, QS, CS>;
  auto kern = flash_bwd_dkdv_split_tf32_kernel<T, HD, BQ, ST, QS, CS>;
  const cudaError_t e = allow_smem(kern, C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(sh.B * sh.Hkv, (sh.Sk + C::BK - 1) / C::BK);
  kern<<<grid, kThreads, C::smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), sh, vec);
  return cudaGetLastError();
}

template <typename T, int HD, int BK, int ST, int KS, int CS>
cudaError_t dq(const Args& a, const Shape& sh, bool vec, cudaStream_t st) {
  using C = QCfg<T, HD, BK, ST, KS, CS>;
  auto kern = flash_bwd_dq_split_tf32_kernel<T, HD, BK, ST, KS, CS>;
  const cudaError_t e = allow_smem(kern, C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(sh.B * sh.Hq, (sh.Sq + C::BQ - 1) / C::BQ);
  kern<<<grid, kThreads, C::smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), sh, vec);
  return cudaGetLastError();
}

// Tiles by head width (shared memory, dK/dV and dQ): hd <= 64, 64 keys
// (dK/dV) or rows (dQ) a block against stages of 32 streamed rows, 2 stages
// (73 and 72 KB); hd <= 128, stages of 16 (102 KB each: two blocks an SM);
// hd <= 256, two column groups over 32 rows, one stage of 16 (99 KB).  Where
// 64-row blocks would not fill the card twice over, 2 groups of 2 warps
// split each stage (up to hd 128): 32 rows a block, twice the blocks.
template <typename T>
cudaError_t bwd(const Args& a, const Shape& sh, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)sh.B * sh.Sq * sh.Hq;
  flash_bwd_delta_split_tf32_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.delta, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = std::is_same<T, float>::value && sh.hd % 4 == 0 && aligned(a.q) &&
                   aligned(a.k) && aligned(a.v) && aligned(a.dout);
  const bool kv_split = (long long)sh.B * sh.Hkv * ((sh.Sk + 63) / 64) < 2LL * sms;
  const bool q_split = (long long)sh.B * sh.Hq * ((sh.Sq + 63) / 64) < 2LL * sms;
  if (sh.hd <= 64) {
    e = kv_split ? dkdv<T, 64, 16, 2, 2, 1>(a, sh, vec, st) : dkdv<T, 64, 32, 2, 1, 1>(a, sh, vec, st);
    if (e != cudaSuccess) return e;
    return q_split ? dq<T, 64, 16, 2, 2, 1>(a, sh, vec, st) : dq<T, 64, 32, 2, 1, 1>(a, sh, vec, st);
  }
  if (sh.hd <= 128) {
    e = kv_split ? dkdv<T, 128, 16, 2, 2, 1>(a, sh, vec, st)
                 : dkdv<T, 128, 16, 2, 1, 1>(a, sh, vec, st);
    if (e != cudaSuccess) return e;
    return q_split ? dq<T, 128, 16, 2, 2, 1>(a, sh, vec, st) : dq<T, 128, 16, 2, 1, 1>(a, sh, vec, st);
  }
  if ((e = dkdv<T, 256, 16, 1, 1, 2>(a, sh, vec, st)) != cudaSuccess) return e;
  return dq<T, 256, 16, 1, 1, 2>(a, sh, vec, st);
}

}  // namespace

// dq, dk, dv (the shapes of q, k, v) are written; delta is (B, Hq, Sq) f32
// scratch; query row j sits at position (j / rl) * cs + r0 + j % rl of the
// Sk keys (rl = cs = Sq, r0 = 0 without a map; a map a row of which sits at
// or past Sk is refused); window <= 0 and cap <= 0 mean none; scale is
// hd^-0.5, rounded to f32 by the caller.  Three launches: delta, dK/dV, dQ.
extern "C" int flash_attention_bwd_split_tf32_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq,
    int Hkv, int hd, int rl, int cs, int r0, int window, float cap, float scale, int dtype,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv || hd < 1 || hd > 256 ||
      Sq > 65535 * 32 || Sk > 65535 * 32 || rl < 1 || cs < rl || r0 < 0 || r0 > cs - rl ||
      (int64_t)((Sq - 1) / rl) * cs + r0 + (Sq - 1) % rl >= Sk)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, Sq, Sk, Hq, Hkv, hd, rl, cs, r0, window, cap, scale};
  const Args a{q, k, v, out, dout, lse, delta, dq, dk, dv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)bwd<float>(a, sh, st);
    case DT_BF16: return (int)bwd<__nv_bfloat16>(a, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  if (err >= 10000)  // flash_attention_sm90.cu: 10000 + the CUresult
    return "cuTensorMapEncodeTiled refused a TMA descriptor (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
