// Causal GQA flash attention in bf16 on Hopper's tensor cores (sm_90a):
// forward, and the dK/dV and dQ kernels of the backward.
//
// Forward: replaces the TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_kernel (via
// flash_attention_pallas) for bf16 inputs with hd % 8 == 0 and hd <= 256.
// Backward: no TPU counterpart (the reference differentiates its plain
// attention through XLA); here for bf16 with hd % 8 == 0 and hd <= 256.
// Every other call (f32, hd % 8 != 0) runs in split TF32
// (flash_attention_split_tf32.cu forward, flash_attention_bwd_split_tf32.cu
// backward); ops.py picks by dtype and hd,
// never by a failure.  The function is the one of ref.py: scores
// (q . k) * hd^-0.5, then cap * tanh(s / cap) under a cap; key kp live for
// query qp when kp <= qp (and qp - kp < window); masked probabilities
// exactly 0, l clamped at 1e-30; lse = m + log l, f32 (B, Hq, S); any S.
// A query-row map (Shape::rl, cs, r0) puts query row j of q (B, Sq, Hq, hd)
// at position (j / rl) * cs + r0 + j % rl of k and v (B, Sk, Hkv, hd): one
// rank's rows of a sequence-parallel split (rl rows of each chunk of cs
// positions), each causal over the keys up to its position, all of the
// rank's chunks in one launch.  Without a map rl = cs = Sq, r0 = 0, and row
// j sits at j.  A tile's key range runs from its first row's position (less
// the window) to its last row's, a dK/dV key block's query tiles from the
// map's inverse (rows_before); a tile whose rows span chunks masks each
// pair by position.
//
// What bounds it: operations.  4 * hd flops per live (query, key) pair
// forward, 2.5x that backward, against q, k, v, o (dO, dq, dk, dv) and lse
// read or written once: at granite-8b's (8, 2048, 32, 8, 128) some 2,000
// flops per byte, far above the card's 295 for bf16.  The backward as
// designed executes 7 products per pair (S and dP twice: once in dK/dV, once
// in dQ) against the 5 the bound counts, so it can reach at most about 71%
// of its bound; that buys a backward without atomics, bitwise
// deterministic from run to run.  A head width between two tiles runs on the
// wider one, its columns past hd zero (forward tiles 64, 128 and 256 wide;
// backward also 160).
//
// Design.  Every product runs on the tensor cores with wgmma (bf16 in, f32
// accumulate).  A block has two consumer warpgroups of 64 rows each and a
// producer warpgroup, one thread of which issues every TMA load and keeps a
// ring of streamed tiles in flight (3 stages where shared memory holds
// them, 2 for the hd-256 forward), handshaking with mbarriers (full: the
// bytes arrived; empty: both consumers are done with the stage).
// setmaxnreg moves registers from the producer (24) to the consumers (240);
// the wrapper checks at first launch that the allocation covers that.  The
// waits are plain spins: a cold path in them (a timeout) made ptxas spill
// the dK/dV accumulators.  Tiles land in
// shared memory by TMA in 64-column panels (128 bytes, the widest box under
// the 128-byte swizzle) that the wgmma descriptors read as they are; TMA
// zero-fills rows >= S and columns >= hd, and scores are masked by position
// (a zero key scores 0, not -inf), only on tiles that cross the diagonal or
// the window's edge or hold the ragged end.  Only live tiles are visited,
// the heaviest first.
// * Forward: block = (b * Hq + h, 128 query rows).  Q once; K and V
//   stream in 128-key tiles (64 for hd 256: 192 KB of shared memory).  S =
//   Q K^T is an SS wgmma; the online softmax runs on the accumulator (a
//   row's values sit in the 4 threads of a quad: max and sum are 2
//   shuffles); P is rounded to bf16 in registers and is the A operand of an
//   RS wgmma with V as an MN-major B (O += P V).
// * dK/dV: block = (b * Hkv + kvh, 128 key rows), K and V once; loops over
//   the G query heads of kvh and their live 64-row query tiles, Q, dO, lse
//   and delta streaming through the ring.  S^T = K Q^T and dP^T = V dO^T
//   are SS; P^T and dS^T go to bf16 registers straight from those
//   accumulators and feed dV += P^T dO and dK += dS^T Q as RS wgmmas with dO
//   and Q as MN-major B.  dK and dV sum over the G heads in registers.
// * dQ: block = (b * Hq + h, 128 query rows), Q and dO once, K and V stream
//   in 64-key tiles; S and dP are SS again, dS in bf16 registers feeds dQ +=
//   dS K (RS, K as MN-major B).
// * Wide heads (hd 136-160 on a tile of 160 columns, 168-256 on 256).  A thread
//   has room for one HD/2 accumulator: 128 registers at hd 256, where dK and
//   dV together would take all 256 before S, dP and their bf16 copies.  So
//   the dK/dV block is (b * Hkv + kvh, 64 key rows), owned by both consumer
//   warpgroups: warpgroup 0 computes S^T = K Q^T, P^T and pg (p times the
//   cap's derivative) and sums dV += P^T dO; warpgroup 1 computes dP^T = V
//   dO^T, takes pg through a double-buffered f32 buffer in shared memory
//   (thread t of one warpgroup holds the same fragment entries as thread t
//   of the other, so each writes and reads its own float4s, without a bank
//   conflict), forms dS^T in f32 and sums dK += dS^T Q.  Each warpgroup
//   issues two products a tile; named barriers (bar.sync/bar.arrive, 256
//   threads) hand the buffer over.  dQ is the kernel of hd <= 128
//   with 32-key tiles, so that its accumulator, S and dP fit together.
// * A first launch writes delta = rowsum(dO * O) and lse * log2(e) in
//   rows padded to 64, so the dK/dV producer copies a tile's with one bulk
//   copy each.
// Tensors are described to TMA as 4-D (hd, H, S, B) with 16-byte strides
// (hence hd % 8 == 0 and 16-byte aligned bases, which the wrapper checks);
// the descriptors are built per call on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no
// libcuda) and passed by value as __grid_constant__ parameters, so a CUDA
// graph captures them.  Left for later: pingpong between the two consumer
// warpgroups, persistent blocks, fp8; in the wide dK/dV kernel, warpgroup 1
// waits each tile for warpgroup 0's pg, so their products overlap only as
// far as the ring lets warpgroup 0 run ahead (one tile at hd 256).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTmaErrorBase = 10000;        // + CUresult of a refused descriptor
constexpr int kAlign = 1024;                // the 128-byte swizzle's atom

struct Shape {
  int B, Sq, Sk, Hq, Hkv, hd;  // Sq query rows, Sk keys
  int rl, cs, r0;  // query row j at position (j / rl) * cs + r0 + j % rl
  int window;      // <= 0: no window
  float cap;       // <= 0: no cap
  float scale;     // hd^-0.5 of the original hd
};

// Sq rounded up to the dK/dV kernel's 64-row query tile
int padded_rows(int S) { return (S + 63) / 64 * 64; }

// the position of query row j: row j % rl of chunk j / rl (rows past Sq
// continue the pattern); without a map (rl = cs = Sq, r0 = 0) j itself
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

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(saddr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// one 64-column panel of `rows` rows at (col, head, row, batch) of a 4-D map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
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

// a ROWS x HD bf16 tile: HD / 64 panels (rounded up) of ROWS rows of 128
// bytes; a panel's columns past HD are TMA's zero fill, read by no product
template <int ROWS, int HD>
struct Tile {
  static constexpr int kPanels = (HD + 63) / 64;
  static constexpr int kBytes = ROWS * kPanels * 128;
  static constexpr int kPanel = ROWS * 128;
};

template <int ROWS, int HD>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row, int batch) {
#pragma unroll
  for (int p = 0; p < Tile<ROWS, HD>::kPanels; ++p)
    tma_load(dst + p * Tile<ROWS, HD>::kPanel, map, bar, 64 * p, head, row, batch);
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major operand: rows [r0, r0 + 64 or N) of a ROWS-row tile, k-step kk
// (16 columns); the step moves 32 bytes inside a panel's 128-byte rows
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int r0, int kk) {
  return sw128(tile + (kk / 4) * ROWS * 128 + r0 * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major B operand: rows [16 kk, 16 kk + 16) of a ROWS-row tile as K, its
// columns as N; 8 rows make a 1024-byte atom, panels are ROWS * 128 apart
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int kk) {
  return sw128(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across wgmma
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D (64 x 32, f32) += A (64 x 16, smem) B (16 x 32, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, smem) B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128, f32) += A (64 x 16, smem) B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 160, f32) += A (64 x 16, bf16 registers) B (16 x 160, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[80], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// ---------------------------------------------------------------------------
// Accumulator fragments.  In a 64 x N f32 accumulator, thread (warp w4 of its
// warpgroup, lane) holds N / 2 values; value i sits at row 16 w4 + lane / 4 +
// 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 (lane & 3) + (i & 1).  The A
// fragment of a 64 x 16 bf16 register operand has the same layout as 16
// columns of it, so 8 consecutive values make one k-step's 4 registers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int frag_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void to_bf16(const float (&x)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows r and r + 8 (global rows ra, ra + 8) of a 64 x HD accumulator,
// times f[0] / f[1], into head h of a (B, S, H, hd) bf16 tensor
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[HD / 2],
                                           const float (&f)[2], int b, int ra, int h, int H,
                                           int S, int lane, const Shape& sh) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = ra + frag_row(i), col = frag_col(i, lane);
    if (row < S && col < sh.hd) {
      const float s = f[(i >> 1) & 1];
      *reinterpret_cast<__nv_bfloat162*>(dst + (((int64_t)b * S + row) * H + h) * sh.hd +
                                         col) = __floats2bfloat162_rn(acc[i] * s, acc[i + 1] * s);
    }
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + kAlign - 1) &
                                    ~static_cast<uintptr_t>(kAlign - 1));
}

// the first n_one barriers wait for one arrival (plus bytes), the next
// n_empty for every consumer thread
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n_one, int n_empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_one + n_empty; ++i) mbar_init(&bars[i], i < n_one ? 1 : kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward: block = (b * Hq + h, 128 query rows), BK-key tiles in an ST-stage
// ring
// ---------------------------------------------------------------------------
template <int HD, int BK, int ST>
struct FwdCfg {
  static constexpr int BQ = 128;
  static constexpr int kQ = Tile<BQ, HD>::kBytes, kKV = Tile<BK, HD>::kBytes;
  static constexpr int smem = kAlign + kQ + 2 * ST * kKV + 8 * (1 + 3 * ST);
};

template <int HD, int BK, int ST>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
                      float* __restrict__ lse, const Shape sh) {
  using C = FwdCfg<HD, BK, ST>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = aligned_smem(smem_raw);
  uint8_t* Ks = Qs + C::kQ;         // stage s at Ks + s * kKV
  uint8_t* Vs = Ks + ST * C::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * C::kKV);
  uint64_t *k_full = q_full + 1, *v_full = k_full + ST, *empty = v_full + ST;
  init_barriers(q_full, 1 + 2 * ST, ST);

  const int bh = blockIdx.x, b = bh / sh.Hq, h = bh % sh.Hq, kvh = h / (sh.Hq / sh.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // heaviest tiles first
  const int q_last = min(q0 + C::BQ, sh.Sq) - 1;
  // the key tiles between the window's reach from the first row's position
  // and the last row's position
  const int t0 = (sh.window > 0 ? max(0, qpos(q0, sh) - sh.window + 1) : 0) / BK;
  const int n_tiles = qpos(q_last, sh) / BK - t0 + 1;

  if (threadIdx.x >= kConsumers) {  // producer: one thread issues every load
    regs_down<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, C::kQ);
      tma_tile<C::BQ, HD>(Qs, &mq, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST, k0 = (t0 + j) * BK;
        mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], C::kKV);
        tma_tile<BK, HD>(Ks + s * C::kKV, &mk, &k_full[s], kvh, k0, b);
        mbar_expect_tx(&v_full[s], C::kKV);
        tma_tile<BK, HD>(Vs + s * C::kKV, &mv, &v_full[s], kvh, k0, b);
      }
    }
  } else {
    regs_up<kConsumerRegs>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, w4 = (threadIdx.x % 128) / 32;
    const int r0 = 64 * wg;                       // this warpgroup's rows in the tile
    const int qw = q0 + r0;                       // its first query
    const int qa = qw + 16 * w4 + lane / 4;       // this thread's rows: qa, qa + 8
    const int qp[2] = {qpos(qa, sh), qpos(qa + 8, sh)};            // at these positions
    const int pw0 = qpos(qw, sh), pw1 = qpos(qw + 63, sh);         // the warpgroup's range
    float acc[HD / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST, k0 = (t0 + j) * BK;
      const uint32_t parity = (j / ST) & 1;
      const uint8_t* Kt = Ks + s * C::kKV;
      float sc[BK / 2];
      mbar_wait(&k_full[s], parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, kmajor<C::BQ>(Qs, r0, kk), kmajor<BK>(Kt, 0, kk), kk > 0);
      wg_commit();
      wg_wait();
      pin(sc);

      // masking only where a pair of this warpgroup's rows and the tile is dead
      const bool masked = k0 + BK - 1 > pw0 || qw + 63 >= sh.Sq ||
                          (sh.window > 0 && pw1 - k0 >= sh.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = sc[i] * sh.scale;
        if (sh.cap > 0.f) x = sh.cap * tanhf(x / sh.cap);
        const int r = (i >> 1) & 1;
        if (masked && !live(qa + 8 * r, qp[r], k0 + frag_col(i, lane), sh)) x = kNegInf;
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2], ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
        ml[r] = mx[r] * kLog2e;
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = masked && sc[i] == kNegInf ? 0.f : exp2f(fmaf(sc[i], kLog2e, -ml[r]));
        sc[i] = p;
        l[r] += p;  // this thread's share; the quad's shares are summed at the end
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      uint32_t pa[BK / 16][4];
      to_bf16(sc, pa);

      mbar_wait(&v_full[s], parity);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, pa[kk], mnmajor<BK>(Vs + s * C::kKV, kk), 1);
      wg_commit();
      wg_wait();
      pin(acc);
      mbar_arrive(&empty[s]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    store_rows<HD>(out, acc, inv, b, qa, h, sh.Hq, sh.Sq, lane, sh);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qa + 8 * r < sh.Sq) lse[(int64_t)bh * sh.Sq + qa + 8 * r] = m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, rows: delta = rowsum(dO * O), and lse * log2(e), f32, into
// (B * Hq, Sp) with Sp = Sq rounded up to 64 and zeros in the pad, so that the
// dK/dV kernel copies a query tile's values with one aligned bulk copy.  One
// warp per (b, s, h) of the padded rows.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
flash_bwd_rows_sm90_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, float* __restrict__ delta_p,
                           float* __restrict__ lse_p, int sp, const Shape sh) {
  const int64_t row = blockIdx.x * 8ll + threadIdx.x / 32;
  if (row >= (int64_t)sh.B * sp * sh.Hq) return;
  const int lane = threadIdx.x % 32;
  const int64_t bs = row / sh.Hq;
  const int h = row % sh.Hq, b = bs / sp, s = bs % sp;
  float acc = 0.f;
  if (s < sh.Sq) {
    const int64_t off = (((int64_t)b * sh.Sq + s) * sh.Hq + h) * sh.hd;
    for (int d = lane; d < sh.hd; d += 32)
      acc = fmaf(__bfloat162float(out[off + d]), __bfloat162float(dout[off + d]), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if (lane == 0) {
    const int64_t dst = ((int64_t)b * sh.Hq + h) * sp + s;
    delta_p[dst] = acc;
    lse_p[dst] = s < sh.Sq ? lse[((int64_t)b * sh.Hq + h) * sh.Sq + s] * kLog2e : 0.f;
  }
}

// p = exp(capped(raw) - lse) from the raw product s . scale (lse_l2 = lse *
// log2(e)), and pg = p times the cap's derivative 1 - tanh^2 (p without a
// cap), so that dS = pg (dP - delta)
__device__ __forceinline__ void prob(float s, float lse_l2, const Shape& sh, float& p,
                                     float& pg) {
  const float raw = s * sh.scale;
  if (sh.cap > 0.f) {
    const float t = tanhf(raw / sh.cap);
    p = exp2f(fmaf(sh.cap * t, kLog2e, -lse_l2));
    pg = p * (1.f - t * t);
  } else {
    p = pg = exp2f(fmaf(raw, kLog2e, -lse_l2));
  }
}

// ---------------------------------------------------------------------------
// Backward, dK/dV: block = (b * Hkv + kvh, 128 key rows); over the G query
// heads of kvh and their live 64-row query tiles, in an ST-stage ring
// ---------------------------------------------------------------------------
template <int HD, int ST>
struct DkDvCfg {
  static constexpr int BK = 128, BQ = 64;
  static constexpr int kKV = Tile<BK, HD>::kBytes, kQ = Tile<BQ, HD>::kBytes;
  static constexpr int kRows = BQ * 4;  // one tile's lse (or delta) bytes
  static constexpr int smem = kAlign + 2 * kKV + ST * (2 * kQ + 2 * kRows) + 8 * (1 + 2 * ST);
};

template <int HD, int ST>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse_p, const float* __restrict__ delta_p,
                           int sp, bf16* __restrict__ dk, bf16* __restrict__ dv,
                           const Shape sh) {
  using C = DkDvCfg<HD, ST>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = aligned_smem(smem_raw);
  uint8_t* Vs = Ks + C::kKV;
  uint8_t* Qs = Vs + C::kKV;        // stage s at Qs + s * kQ
  uint8_t* Gs = Qs + ST * C::kQ;    // dO, likewise
  float* Ls = reinterpret_cast<float*>(Gs + ST * C::kQ);  // lse log2(e), stage s at + s * BQ
  float* Es = Ls + ST * BQ;                               // delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Es + ST * BQ);
  uint64_t *full = kv_full + 1, *empty = full + ST;
  init_barriers(kv_full, 1 + ST, ST);

  const int b = blockIdx.x / sh.Hkv, kvh = blockIdx.x % sh.Hkv, G = sh.Hq / sh.Hkv;
  const int k0 = blockIdx.y * C::BK;  // the first key tiles see the most queries
  const int k_last = min(k0 + C::BK, sh.Sk) - 1;
  // the query rows whose positions reach these keys: from the first at or
  // past k0 to the last before k_last + window
  const int q_begin = rows_before(k0, sh) / BQ * BQ;
  const int q_end = sh.window > 0 ? rows_before(k_last + sh.window, sh) : sh.Sq;

  if (threadIdx.x >= kConsumers) {  // producer: one thread issues every load
    regs_down<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * C::kKV);
      tma_tile<C::BK, HD>(Ks, &mk, kv_full, kvh, k0, b);
      tma_tile<C::BK, HD>(Vs, &mv, kv_full, kvh, k0, b);
      int j = 0;
      for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const int64_t rows = ((int64_t)b * sh.Hq + h) * sp;
        for (int q0 = q_begin; q0 < q_end; q0 += BQ, ++j) {
          const int s = j % ST;
          mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * C::kQ + 2 * C::kRows);
          tma_tile<BQ, HD>(Qs + s * C::kQ, &mq, &full[s], h, q0, b);
          tma_tile<BQ, HD>(Gs + s * C::kQ, &mdo, &full[s], h, q0, b);
          bulk_load(Ls + s * BQ, lse_p + rows + q0, C::kRows, &full[s]);
          bulk_load(Es + s * BQ, delta_p + rows + q0, C::kRows, &full[s]);
        }
      }
    }
  } else {
    regs_up<kConsumerRegs>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, w4 = (threadIdx.x % 128) / 32;
    const int r0 = 64 * wg, kw = k0 + r0;       // this warpgroup's rows, first key
    const int ka = kw + 16 * w4 + lane / 4;     // this thread's keys: ka, ka + 8
    float gk[HD / 2], gv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) gk[i] = gv[i] = 0.f;
    mbar_wait(kv_full, 0);

    int j = 0;
    for (int g = 0; g < G; ++g) {
      for (int q0 = q_begin; q0 < q_end; q0 += BQ, ++j) {
        const int s = j % ST;
        const uint8_t* Qt = Qs + s * C::kQ;
        const uint8_t* Gt = Gs + s * C::kQ;
        float st[BQ / 2], dpt[BQ / 2];
        mbar_wait(&full[s], (j / ST) & 1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(st, kmajor<C::BK>(Ks, r0, kk), kmajor<BQ>(Qt, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(dpt, kmajor<C::BK>(Vs, r0, kk), kmajor<BQ>(Gt, 0, kk), kk > 0);
        wg_commit();
        wg_wait();
        pin(st);
        pin(dpt);

        // rows are keys, columns queries: dead pairs where a query precedes a key
        const bool masked = qpos(q0, sh) < kw + 63 || q0 + BQ > sh.Sq || kw + 63 >= sh.Sk ||
                            (sh.window > 0 && qpos(q0 + BQ - 1, sh) - kw >= sh.window);
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int c = frag_col(i, lane);
          float p = 0.f, pg = 0.f;
          if (!masked || live(q0 + c, qpos(q0 + c, sh), ka + frag_row(i), sh))
            prob(st[i], Ls[s * BQ + c], sh, p, pg);
          st[i] = p;
          dpt[i] = pg * (dpt[i] - Es[s * BQ + c]);
        }
        to_bf16(st, pa);
        to_bf16(dpt, da);
        pin(gv);
        pin(gk);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(gv, pa[kk], mnmajor<BQ>(Gt, kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(gk, da[kk], mnmajor<BQ>(Qt, kk), 1);
        wg_commit();
        wg_wait();
        pin(gv);
        pin(gk);
        mbar_arrive(&empty[s]);
      }
    }
    const float f_k[2] = {sh.scale, sh.scale}, f_v[2] = {1.f, 1.f};
    store_rows<HD>(dk, gk, f_k, b, ka, kvh, sh.Hkv, sh.Sk, lane, sh);
    store_rows<HD>(dv, gv, f_v, b, ka, kvh, sh.Hkv, sh.Sk, lane, sh);
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ: block = (b * Hq + h, 128 query rows), BK-key tiles in an
// ST-stage ring: 64 keys up to hd 128, 32 at wide heads, so that the HD/2
// accumulator, S and dP fit a thread's registers together
// ---------------------------------------------------------------------------
template <int HD, int ST, int K>
struct DqCfg {
  static constexpr int BQ = 128, BK = K;
  static constexpr int kQ = Tile<BQ, HD>::kBytes, kKV = Tile<BK, HD>::kBytes;
  static constexpr int smem = kAlign + 2 * kQ + 2 * ST * kKV + 8 * (1 + 2 * ST);
};

template <int HD, int ST, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse_p, const float* __restrict__ delta_p,
                         int sp, bf16* __restrict__ dq, const Shape sh) {
  using C = DqCfg<HD, ST, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = aligned_smem(smem_raw);
  uint8_t* Gs = Qs + C::kQ;         // dO
  uint8_t* Ks = Gs + C::kQ;         // stage s at Ks + s * kKV
  uint8_t* Vs = Ks + ST * C::kKV;
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(Vs + ST * C::kKV);
  uint64_t *full = qg_full + 1, *empty = full + ST;
  init_barriers(qg_full, 1 + ST, ST);

  const int bh = blockIdx.x, b = bh / sh.Hq, h = bh % sh.Hq, kvh = h / (sh.Hq / sh.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // heaviest tiles first
  const int q_last = min(q0 + C::BQ, sh.Sq) - 1;
  const int t0 = (sh.window > 0 ? max(0, qpos(q0, sh) - sh.window + 1) : 0) / BK;
  const int n_tiles = qpos(q_last, sh) / BK - t0 + 1;

  if (threadIdx.x >= kConsumers) {  // producer: one thread issues every load
    regs_down<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qg_full, 2 * C::kQ);
      tma_tile<C::BQ, HD>(Qs, &mq, qg_full, h, q0, b);
      tma_tile<C::BQ, HD>(Gs, &mdo, qg_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST, k0 = (t0 + j) * BK;
        mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKV);
        tma_tile<BK, HD>(Ks + s * C::kKV, &mk, &full[s], kvh, k0, b);
        tma_tile<BK, HD>(Vs + s * C::kKV, &mv, &full[s], kvh, k0, b);
      }
    }
  } else {
    regs_up<kConsumerRegs>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, w4 = (threadIdx.x % 128) / 32;
    const int r0 = 64 * wg, qw = q0 + r0;
    const int qa = qw + 16 * w4 + lane / 4;     // this thread's rows: qa, qa + 8
    const int qp[2] = {qpos(qa, sh), qpos(qa + 8, sh)};          // at these positions
    const int pw0 = qpos(qw, sh), pw1 = qpos(qw + 63, sh);       // the warpgroup's range
    float lse_l2[2], dlt[2], acc[HD / 2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // padded rows: in range for every row of the tile
      lse_l2[r] = lse_p[(int64_t)bh * sp + min(qa + 8 * r, sp - 1)];
      dlt[r] = delta_p[(int64_t)bh * sp + min(qa + 8 * r, sp - 1)];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    mbar_wait(qg_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST, k0 = (t0 + j) * BK;
      const uint8_t* Kt = Ks + s * C::kKV;
      const uint8_t* Vt = Vs + s * C::kKV;
      float sc[BK / 2], dp[BK / 2];
      mbar_wait(&full[s], (j / ST) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, kmajor<C::BQ>(Qs, r0, kk), kmajor<BK>(Kt, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(dp, kmajor<C::BQ>(Gs, r0, kk), kmajor<BK>(Vt, 0, kk), kk > 0);
      wg_commit();
      wg_wait();
      pin(sc);
      pin(dp);

      const bool masked = k0 + BK - 1 > pw0 || qw + 63 >= sh.Sq ||
                          (sh.window > 0 && pw1 - k0 >= sh.window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = 0.f, pg = 0.f;
        if (!masked || live(qa + 8 * r, qp[r], k0 + frag_col(i, lane), sh))
          prob(sc[i], lse_l2[r], sh, p, pg);
        dp[i] = pg * (dp[i] - dlt[r]);
      }
      uint32_t da[BK / 16][4];
      to_bf16(dp, da);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, da[kk], mnmajor<BK>(Kt, kk), 1);
      wg_commit();
      wg_wait();
      pin(acc);
      mbar_arrive(&empty[s]);
    }
    const float f[2] = {sh.scale, sh.scale};
    store_rows<HD>(dq, acc, f, b, qa, h, sh.Hq, sh.Sq, lane, sh);
  }
}

// ---------------------------------------------------------------------------
// Backward, wide heads (HD 160 or 256), where a consumer thread holds one
// HD/2 accumulator and no more.  dK/dV: block = (b * Hkv + kvh, 64 key
// rows), owned by both consumer warpgroups: warpgroup 0 forms P^T and pg and
// sums dV, warpgroup 1 forms dS^T from the pg that warpgroup 0 hands it
// through shared memory and sums dK.  Named barriers 1 + buf (pg buffer buf
// written) and 3 + buf (read), 256 threads each: warpgroup 0 arrives on the
// first and syncs on the second, warpgroup 1 the other way round.
// ---------------------------------------------------------------------------
constexpr int kPgFull = 1, kPgFree = 3;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

template <int HD, int ST>
struct DkDvWideCfg {
  static constexpr int BK = 64, BQ = 64;
  static constexpr int kKV = Tile<BK, HD>::kBytes, kQ = Tile<BQ, HD>::kBytes;
  static constexpr int kRows = BQ * 4;      // one tile's lse (or delta) bytes
  static constexpr int kPg = BK * BQ * 4;   // one buffer of pg, f32
  static constexpr int smem =
      kAlign + 2 * kKV + ST * 2 * kQ + 2 * kPg + ST * 2 * kRows + 8 * (1 + 2 * ST);
};

template <int HD, int ST>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wide_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const __grid_constant__ CUtensorMap mdo,
                                const float* __restrict__ lse_p,
                                const float* __restrict__ delta_p, int sp,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, const Shape sh) {
  using C = DkDvWideCfg<HD, ST>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = aligned_smem(smem_raw);
  uint8_t* Vs = Ks + C::kKV;
  uint8_t* Qs = Vs + C::kKV;        // stage s at Qs + s * kQ
  uint8_t* Gs = Qs + ST * C::kQ;    // dO, likewise
  float4* Pg = reinterpret_cast<float4*>(Gs + ST * C::kQ);  // buffer buf at + buf * kPg / 16
  float* Ls = reinterpret_cast<float*>(Gs + ST * C::kQ + 2 * C::kPg);  // lse log2(e)
  float* Es = Ls + ST * BQ;                                             // delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Es + ST * BQ);
  uint64_t *full = kv_full + 1, *empty = full + ST;
  init_barriers(kv_full, 1 + ST, ST);

  const int b = blockIdx.x / sh.Hkv, kvh = blockIdx.x % sh.Hkv, G = sh.Hq / sh.Hkv;
  const int k0 = blockIdx.y * C::BK;  // the first key tiles see the most queries
  const int k_last = min(k0 + C::BK, sh.Sk) - 1;
  const int q_begin = rows_before(k0, sh) / BQ * BQ;
  const int q_end = sh.window > 0 ? rows_before(k_last + sh.window, sh) : sh.Sq;
  const int n_q = max(0, (q_end - q_begin + BQ - 1) / BQ);  // live query tiles of one head
  const int n = G * n_q;

  if (threadIdx.x >= kConsumers) {  // producer: one thread issues every load
    regs_down<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * C::kKV);
      tma_tile<C::BK, HD>(Ks, &mk, kv_full, kvh, k0, b);
      tma_tile<C::BK, HD>(Vs, &mv, kv_full, kvh, k0, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % ST, h = kvh * G + j / n_q, q0 = q_begin + (j % n_q) * BQ;
        const int64_t rows = ((int64_t)b * sh.Hq + h) * sp;
        mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kQ + 2 * C::kRows);
        tma_tile<BQ, HD>(Qs + s * C::kQ, &mq, &full[s], h, q0, b);
        tma_tile<BQ, HD>(Gs + s * C::kQ, &mdo, &full[s], h, q0, b);
        bulk_load(Ls + s * BQ, lse_p + rows + q0, C::kRows, &full[s]);
        bulk_load(Es + s * BQ, delta_p + rows + q0, C::kRows, &full[s]);
      }
    }
  } else {
    regs_up<kConsumerRegs>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int ka = k0 + 16 * (t / 32) + lane / 4;  // this thread's keys: ka, ka + 8
    // S^T = K Q^T and dV += P^T dO in warpgroup 0; dP^T = V dO^T and dK +=
    // dS^T Q in warpgroup 1
    const uint8_t* A = wg == 0 ? Ks : Vs;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int j = 0; j < n; ++j) {
      const int s = j % ST, q0 = q_begin + (j % n_q) * BQ, buf = j & 1;
      const uint8_t* Qt = Qs + s * C::kQ;
      const uint8_t* Gt = Gs + s * C::kQ;
      float4* pg = Pg + buf * (C::kPg / 16) + t;  // this thread's values, 128 float4 apart
      float x[BQ / 2];
      mbar_wait(&full[s], (j / ST) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(x, kmajor<C::BK>(A, 0, kk), kmajor<BQ>(wg == 0 ? Qt : Gt, 0, kk), kk > 0);
      wg_commit();
      wg_wait();
      pin(x);

      if (wg == 0) {
        // rows are keys, columns queries: dead pairs where a query precedes a key
        const bool masked = qpos(q0, sh) < k0 + 63 || q0 + BQ > sh.Sq || k0 + 63 >= sh.Sk ||
                            (sh.window > 0 && qpos(q0 + BQ - 1, sh) - k0 >= sh.window);
        if (j >= 2) bar_sync(kPgFree + buf);  // warpgroup 1 has read tile j - 2's pg
#pragma unroll
        for (int v = 0; v < BQ / 8; ++v) {
          float g4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * v + e, c = frag_col(i, lane);
            float p = 0.f, g = 0.f;
            if (!masked || live(q0 + c, qpos(q0 + c, sh), ka + frag_row(i), sh))
              prob(x[i], Ls[s * BQ + c], sh, p, g);
            x[i] = p;
            g4[e] = g;
          }
          pg[v * 128] = make_float4(g4[0], g4[1], g4[2], g4[3]);
        }
        bar_arrive(kPgFull + buf);
      } else {
        bar_sync(kPgFull + buf);
#pragma unroll
        for (int v = 0; v < BQ / 8; ++v) {
          const float4 g = pg[v * 128];
          const float g4[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * v + e;
            x[i] = g4[e] * (x[i] - Es[s * BQ + frag_col(i, lane)]);
          }
        }
        if (j + 2 < n) bar_arrive(kPgFree + buf);  // only where tile j + 2 waits for it
      }
      uint32_t a[BQ / 16][4];
      to_bf16(x, a);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(acc, a[kk], mnmajor<BQ>(wg == 0 ? Gt : Qt, kk), 1);
      wg_commit();
      wg_wait();
      pin(acc);
      mbar_arrive(&empty[s]);
    }
    const float f = wg == 0 ? 1.f : sh.scale, fs[2] = {f, f};
    store_rows<HD>(wg == 0 ? dv : dk, acc, fs, b, ka, kvh, sh.Hkv, sh.Sk, lane, sh);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and launchers
// ---------------------------------------------------------------------------
using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (B, S, H, hd) bf16 tensor as 4-D (hd, H, S, B); boxes of 64 columns x
// `rows` rows of one head and batch, 128-byte swizzle, zero fill out of range
int make_map(CUtensorMap* map, const void* ptr, const Shape& sh, int H, int S, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t hd = (cuuint64_t)sh.hd;
  cuuint64_t dims[4] = {hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)sh.B};
  cuuint64_t strides[3] = {hd * 2, hd * 2 * H, hd * 2 * H * S};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaErrorBase + (int)r;
}

// At every launch: checks that the kernel's register allocation covers what
// setmaxnreg moves (the consumers' increase would otherwise wait forever),
// and raises its dynamic shared-memory limit.  The register count is a
// property of the compiled function, so its check is cached once per tile
// traits F (kernels of one signature share a function-pointer type).  The
// shared-memory opt-in holds for the current device only, so it is set at
// every launch (a few host microseconds), never cached: a cache would skip
// it on a second card, where the launch would be refused.
template <typename F, typename K>
cudaError_t prepare(K kernel) {
  static const cudaError_t regs = [kernel] {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (attr.numRegs * kThreads < 128 * kProducerRegs + kConsumers * kConsumerRegs)
      return cudaErrorInvalidConfiguration;
    return cudaSuccess;
  }();
  if (regs != cudaSuccess) return regs;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::smem);
}

template <int HD, int BK, int ST>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse, const Shape& sh,
        cudaStream_t st) {
  using C = FwdCfg<HD, BK, ST>;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = make_map(&mq, q, sh, sh.Hq, sh.Sq, C::BQ)) ||
      (rc = make_map(&mk, k, sh, sh.Hkv, sh.Sk, BK)) ||
      (rc = make_map(&mv, v, sh, sh.Hkv, sh.Sk, BK)))
    return rc;
  auto kern = flash_fwd_sm90_kernel<HD, BK, ST>;
  if (cudaError_t e = prepare<C>(kern)) return (int)e;
  const dim3 grid(sh.B * sh.Hq, (sh.Sq + C::BQ - 1) / C::BQ);
  kern<<<grid, kThreads, C::smem, st>>>(mq, mk, mv, static_cast<bf16*>(out), lse, sh);
  return (int)cudaGetLastError();
}

// the rows, dK/dV and dQ launches with tile traits KV and QD
template <typename KV, typename QD, typename KvKern, typename QKern>
int bwd(KvKern kv_kern, QKern q_kern, const void* q, const void* k, const void* v,
        const void* out, const void* dout, const float* lse, float* rows, void* dq, void* dk,
        void* dv, const Shape& sh, cudaStream_t st) {
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  int rc;
  if ((rc = make_map(&kq, q, sh, sh.Hq, sh.Sq, KV::BQ)) ||
      (rc = make_map(&kk, k, sh, sh.Hkv, sh.Sk, KV::BK)) ||
      (rc = make_map(&kv, v, sh, sh.Hkv, sh.Sk, KV::BK)) ||
      (rc = make_map(&kdo, dout, sh, sh.Hq, sh.Sq, KV::BQ)) ||
      (rc = make_map(&qq, q, sh, sh.Hq, sh.Sq, QD::BQ)) ||
      (rc = make_map(&qk, k, sh, sh.Hkv, sh.Sk, QD::BK)) ||
      (rc = make_map(&qv, v, sh, sh.Hkv, sh.Sk, QD::BK)) ||
      (rc = make_map(&qdo, dout, sh, sh.Hq, sh.Sq, QD::BQ)))
    return rc;
  const int sp = padded_rows(sh.Sq);
  float* delta_p = rows;
  float* lse_p = rows + (int64_t)sh.B * sh.Hq * sp;
  const int64_t n_rows = (int64_t)sh.B * sp * sh.Hq;
  flash_bwd_rows_sm90_kernel<<<(unsigned)((n_rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, delta_p, lse_p, sp, sh);
  if (cudaError_t e = cudaGetLastError()) return (int)e;

  if (cudaError_t e = prepare<KV>(kv_kern)) return (int)e;
  const dim3 kv_grid(sh.B * sh.Hkv, (sh.Sk + KV::BK - 1) / KV::BK);
  kv_kern<<<kv_grid, kThreads, KV::smem, st>>>(kq, kk, kv, kdo, lse_p, delta_p, sp,
                                               static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                               sh);
  if (cudaError_t e = cudaGetLastError()) return (int)e;

  if (cudaError_t e = prepare<QD>(q_kern)) return (int)e;
  const dim3 q_grid(sh.B * sh.Hq, (sh.Sq + QD::BQ - 1) / QD::BQ);
  q_kern<<<q_grid, kThreads, QD::smem, st>>>(qq, qk, qv, qdo, lse_p, delta_p, sp,
                                             static_cast<bf16*>(dq), sh);
  return (int)cudaGetLastError();
}

// the cases ops.route() sends here, with a query-row map whose rows all sit
// below Sk; anything else is refused, not rerouted
bool make_shape(Shape* sh, int B, int Sq, int Sk, int Hq, int Hkv, int hd, int rl, int cs,
                int r0, int window, float cap, float scale, int dtype, int max_hd) {
  if (dtype != 1 || B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv || hd < 8 ||
      hd % 8 || hd > max_hd || rl < 1 || cs < rl || r0 < 0 || r0 > cs - rl ||
      (int64_t)((Sq - 1) / rl) * cs + r0 + (Sq - 1) % rl >= Sk)
    return false;
  *sh = Shape{B, Sq, Sk, Hq, Hkv, hd, rl, cs, r0, window, cap, scale};
  return true;
}

}  // namespace

// As flash_attention_fwd_split_tf32_launch, for bf16 (dtype code 1) with
// hd % 8 == 0, hd <= 256, and 16-byte aligned q, k, v.
extern "C" int flash_attention_fwd_sm90_launch(const void* q, const void* k, const void* v,
                                               void* out, float* lse, int B, int Sq, int Sk,
                                               int Hq, int Hkv, int hd, int rl, int cs, int r0,
                                               int window, float cap, float scale, int dtype,
                                               void* stream) {
  Shape sh;
  if (!make_shape(&sh, B, Sq, Sk, Hq, Hkv, hd, rl, cs, r0, window, cap, scale, dtype, 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // ring stages: as many as shared memory holds (224 KB at hd 128, 192 KB at 256)
  if (hd <= 64) return fwd<64, 128, 3>(q, k, v, out, lse, sh, st);
  if (hd <= 128) return fwd<128, 128, 3>(q, k, v, out, lse, sh, st);
  return fwd<256, 64, 2>(q, k, v, out, lse, sh, st);
}

// As flash_attention_bwd_launch, for bf16 with hd % 8 == 0 and hd <= 256,
// except that `rows` is f32 scratch of 2 * B * Hq * flash_attention_sm90_rows(Sq)
// (delta and lse * log2(e), padded).  Three launches: rows, dK/dV, dQ.
extern "C" int flash_attention_bwd_sm90_launch(const void* q, const void* k, const void* v,
                                               const void* out, const void* dout,
                                               const float* lse, float* rows, void* dq,
                                               void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                                               int Hkv, int hd, int rl, int cs, int r0,
                                               int window, float cap, float scale, int dtype,
                                               void* stream) {
  Shape sh;
  if (!make_shape(&sh, B, Sq, Sk, Hq, Hkv, hd, rl, cs, r0, window, cap, scale, dtype, 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // ring stages: as many as shared memory holds (dK/dV 231,992 bytes on the
  // hd-160 tile (three panels) and 231,464 on hd 256; dQ 197,704 and 230,456)
  if (hd <= 64)
    return bwd<DkDvCfg<64, 3>, DqCfg<64, 3, 64>>(flash_bwd_dkdv_sm90_kernel<64, 3>,
                                                 flash_bwd_dq_sm90_kernel<64, 3, 64>, q, k, v,
                                                 out, dout, lse, rows, dq, dk, dv, sh, st);
  if (hd <= 128)
    return bwd<DkDvCfg<128, 3>, DqCfg<128, 3, 64>>(flash_bwd_dkdv_sm90_kernel<128, 3>,
                                                   flash_bwd_dq_sm90_kernel<128, 3, 64>, q, k,
                                                   v, out, dout, lse, rows, dq, dk, dv, sh, st);
  if (hd <= 160)
    return bwd<DkDvWideCfg<160, 3>, DqCfg<160, 4, 32>>(
        flash_bwd_dkdv_wide_sm90_kernel<160, 3>, flash_bwd_dq_sm90_kernel<160, 4, 32>, q, k,
        v, out, dout, lse, rows, dq, dk, dv, sh, st);
  return bwd<DkDvWideCfg<256, 2>, DqCfg<256, 3, 32>>(
      flash_bwd_dkdv_wide_sm90_kernel<256, 2>, flash_bwd_dq_sm90_kernel<256, 3, 32>, q, k, v,
      out, dout, lse, rows, dq, dk, dv, sh, st);
}

// the padded row count of the backward's scratch
extern "C" int flash_attention_sm90_rows(int S) { return padded_rows(S); }
