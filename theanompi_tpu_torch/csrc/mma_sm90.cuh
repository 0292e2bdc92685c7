// Warp-level tensor-core building blocks of the port's bf16 kernels
// (K1 forward, K2 dK/dV, K3 dQ, K4 paged attention): the m16n8k16 bf16
// product with an fp32 accumulator, ldmatrix (plain and transposed),
// cp.async with zero fill (contiguous rows, or rows through a block
// table), and the padded bf16 tile layout they share; and those of the
// fp32 K1, K2, K3 and K4: the m16n8k8 TF32 product in three passes, its
// padded fp32 tiles and their split into hi and lo.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4;
// each 32-bit register holds two bf16, the lower column in the low
// half):
//   A 16x16 (row):  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                   a2 (g, 2t+8..)     a3 (g+8, 2t+8..)
//   B 16x8  (col):  b0 (k 2t..2t+1, n g)   b1 (k 2t+8.., n g)
//   C 16x8  (f32):  c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// Two neighbouring 16x8 accumulator tiles, rounded to bf16 pairwise,
// are exactly one A fragment (`acc_to_a`), so a product's result feeds
// the next product without leaving registers.
//
// The fp32 kernels (K1, K2, K3 and K4 at fp32) run on the tensor cores
// through TF32 in three passes: each operand x is split into hi =
// tf32(x) (K2, K3: to nearest, ties away from zero, as cvt.rna rounds;
// K1 and K4: truncated, `split_tf32_trunc`) and lo = tf32(x - hi)
// (truncated), and a product is lo*hi + hi*lo + hi*hi into one fp32
// accumulator (the dropped lo*lo and lo's truncation are each at most
// about 2^-21 of a term, 2^-20 for K1 and K4).  Fragment layouts of
// mma.sync.m16n8k8 with tf32 (one value a 32-bit register):
//   A 16x8 (row):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B 8x8  (col):  b0 (k t, n g)   b1 (k t+4, n g)
//   C 16x8 (f32):  as m16n8k16's
// A's k = t and t + 4 are not the accumulator's columns 2t and 2t + 1,
// but a sum over k does not care about its order: an accumulator tile
// read as an A fragment takes column 2t as k = t and 2t + 1 as k = t + 4
// (`acc_to_a_tf32x3`), and that product's B fragment reads its rows in
// the same places (`load_b_cols_tf32x3`), so P and dS feed the next
// product from registers here too.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tmt {

// Tiles of bf16 rows D wide, each row padded by 8 elements (16 bytes):
// the 8 row addresses of one ldmatrix phase then fall in 8 distinct
// 16-byte bank groups for every D in {16, 32, 64, 128}, so ldmatrix is
// free of bank conflicts, and every row starts 16-byte aligned for
// cp.async.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;  // elements per row in smem
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b on the tensor cores (bf16 operands, fp32 accumulator)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows [0, 16) x columns [c0, c0 + 16) of a
// row-major tile (row stride `stride` elements): ldmatrix_x4 with
// matrices (rows 0-7 | 8-15) x (cols c0 | c0 + 8) in a0..a3 order.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int c0, int lane) {
  ldmatrix_x4(a, tile + (lane % 16) * stride + c0 + (lane / 16) * 8);
}

// B fragments of a product X * Y^T, where Y is a row-major tile whose
// rows are the n dimension: rows [n0, n0 + 16) x k columns [k0, k0 +
// 16) give b[0], b[1] (n tile n0) and b[2], b[3] (n tile n0 + 8).
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int stride, int n0, int k0,
                                            int lane) {
  ldmatrix_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * stride + k0 +
                     ((lane / 8) % 2) * 8);
}

// B fragments of a product X * Y, where Y is a row-major tile whose
// rows are the k dimension: k rows [k0, k0 + 16) x n columns [n0, n0 +
// 16) give b[0], b[1] (n tile n0) and b[2], b[3] (n tile n0 + 8).
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int stride, int k0, int n0,
                                            int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) *
                                  stride + n0 + (lane / 16) * 8);
}

// 2^x on the special-function unit (relative error about 2^-22;
// results below 2^-126 flush to 0, as a softmax weight may)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as one bf16x2 register (round to nearest even), `lo`
// in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// accumulator tiles n and n + 1 (16 x 16 in all) as an A fragment
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (the
// source address is then not read, but must still be a valid pointer)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + R) of a [t, D] bf16 matrix into a padded tile by
// cp.async, kThreads threads (this one is `tid`) taking 16-byte chunks
// in turn; rows past t are zero-filled (their source clamped to row 0)
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int r0, int t, int tid) {
  using L = Tile<D>;
  for (int i = tid; i < R * L::kChunks; i += kThreads) {
    const int r = i / L::kChunks, c = (i % L::kChunks) * 8;
    const bool valid = r0 + r < t;
    cp_async_16(dst + r * L::kStride + c,
                src + (valid ? static_cast<size_t>(r0 + r) * D + c : 0),
                valid);
  }
}

// rows [t0, t0 + R) of a paged [T, D] matrix (bf16 or fp32) into a
// tile of row stride `stride` elements by cp.async, 16 bytes a copy,
// kThreads threads (this one is `tid`) in turn.  Row t is row t % bs of
// block table[t / bs - b0], and block b starts at base + b *
// block_stride, so a block's rows are contiguous but blocks lie
// anywhere (K4's pools, any bs); rows at or past t_end are zero-filled
// (their source clamped to base)
template <typename T, int D, int R, int kThreads>
__device__ __forceinline__ void load_paged_tile_async(
    T* dst, int stride, const T* base, size_t block_stride,
    const int* table, int b0, int bs, int t0, int t_end, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements per copy
  constexpr int kChunks = D / kPer;     // copies per row
  for (int i = tid; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int t = t0 + r;
    const bool valid = t < t_end;
    const T* src = base;
    if (valid)
      src += table[t / bs - b0] * block_stride +
             static_cast<size_t>(t % bs) * D + c;
    cp_async_16(dst + r * stride + c, src, valid);
  }
}

// rows [0, R) of a padded smem tile to rows [r0, r0 + R) of a [t, D]
// bf16 matrix, 16 bytes per store, kThreads threads (this one is
// `tid`) in turn, rows past t skipped; the caller synchronises the
// threads between writing the tile and this call
template <int D, int R, int kThreads>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* tile,
                                           int r0, int t, int tid) {
  using L = Tile<D>;
  for (int i = tid; i < R * L::kChunks; i += kThreads) {
    const int r = i / L::kChunks, c = (i % L::kChunks) * 8;
    if (r0 + r < t)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(tile + r * L::kStride + c);
  }
}

// accumulator tile (rows g, g + 8; columns 2t, 2t + 1 of an n8 tile at
// column c0) rounded to bf16 into rows [0, 16) of a padded smem tile
template <int D>
__device__ __forceinline__ void acc_to_smem(__nv_bfloat16* tile,
                                            const float (&c)[4], int c0,
                                            int lane) {
  const int g = lane / 4, col = c0 + (lane % 4) * 2;
  *reinterpret_cast<uint32_t*>(tile + g * Tile<D>::kStride + col) =
      pack_bf16(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(tile + (g + 8) * Tile<D>::kStride + col) =
      pack_bf16(c[2], c[3]);
}

// -- fp32 through TF32 in three passes ----------------------------------

// Tiles of fp32 rows D wide, each row padded by 4 floats: a fragment's
// 32 scalar reads then hit 32 distinct banks both along a row (A, and
// B of X * Y^T: row g, column t) and down the columns (B of X * Y: rows
// 2t and 2t + 1, column g), for every D in {16, 32, 64, 128}; rows
// start 16-byte aligned for cp.async.
template <int D>
struct F32Tile {
  static constexpr int kStride = D + 4;  // floats per row in smem
  static constexpr int kChunks = D / 4;  // 16-byte chunks per row
};

// x as hi = x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x
// (to nearest, ties away from zero: half a TF32 ulp added to the
// magnitude's bits, the 13 low bits cleared) and lo = x - hi truncated
// to TF32 (its 13 low bits cleared): the split of CUTLASS's "fast fp32",
// in four instructions where two cvt.rna and the subtraction take nine
// (ptxas guards each cvt against NaN and infinity), and the split sets
// the kernels' pace (PERF.md).  lo of a NaN is a NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// x as hi = x truncated to TF32 (its 13 low bits cleared) and lo = x -
// hi, exact in fp32, its 13 low bits left as they are: the tensor cores
// take a TF32 operand's 19 high bits, so lo enters the products
// truncated as split_tf32 truncates it (the fp32 K1's errors on the
// card match that, PERF.md).  Two instructions where split_tf32 takes
// four, for a lo up to twice as large: about 2^-20 of a term dropped,
// not 2^-21.  The fp32 K1 takes this split.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// split_tf32 (kTrunc false) or split_tf32_trunc
template <bool kTrunc>
__device__ __forceinline__ void split_tf32_as(float x, uint32_t& hi,
                                              uint32_t& lo) {
  if constexpr (kTrunc)
    split_tf32_trunc(x, hi, lo);
  else
    split_tf32(x, hi, lo);
}

// d += a * b on the tensor cores (tf32 operands, fp32 accumulator)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b to about fp32 accuracy: the two small terms, then hi * hi;
// b holds {hi0, hi1, lo0, lo1}
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&b)[4]) {
  mma_tf32(d, alo, b[0], b[1]);
  mma_tf32(d, ahi, b[2], b[3]);
  mma_tf32(d, ahi, b[0], b[1]);
}

// The A fragment (hi, lo) of rows [0, 16) x columns [k0, k0 + 8) of a
// row-major fp32 tile of row stride `stride` floats
__device__ __forceinline__ void load_a_tf32x3(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
                                              const float* tile, int stride,
                                              int k0, int lane) {
  const float* p = tile + (lane / 4) * stride + k0 + lane % 4;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * stride], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * stride + 4], hi[3], lo[3]);
}

// The B fragment {hi0, hi1, lo0, lo1} of a product X * Y^T, Y a
// row-major fp32 tile whose rows are the n dimension: rows [n0, n0 + 8)
// x k columns [k0, k0 + 8)
__device__ __forceinline__ void load_b_rows_tf32x3(uint32_t (&b)[4],
                                                   const float* tile,
                                                   int stride, int n0,
                                                   int k0, int lane) {
  const float* p = tile + (n0 + lane / 4) * stride + k0 + lane % 4;
  split_tf32(p[0], b[0], b[2]);
  split_tf32(p[4], b[1], b[3]);
}

// The B fragment {hi0, hi1, lo0, lo1} of a product X * Y, Y a row-major
// fp32 tile whose rows are the k dimension, k in the order of
// `acc_to_a_tf32x3`: k rows [k0, k0 + 8) x n columns [n0, n0 + 8);
// kTrunc splits with split_tf32_trunc
template <bool kTrunc = false>
__device__ __forceinline__ void load_b_cols_tf32x3(uint32_t (&b)[4],
                                                   const float* tile,
                                                   int stride, int k0,
                                                   int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane % 4)) * stride + n0 + lane / 4;
  split_tf32_as<kTrunc>(p[0], b[0], b[2]);
  split_tf32_as<kTrunc>(p[stride], b[1], b[3]);
}

// An accumulator tile (16 x 8) as the A fragment (hi, lo) of the next
// product, k = t from column 2t and k = t + 4 from column 2t + 1; kTrunc
// splits with split_tf32_trunc
template <bool kTrunc = false>
__device__ __forceinline__ void acc_to_a_tf32x3(uint32_t (&hi)[4],
                                                uint32_t (&lo)[4],
                                                const float (&c)[4]) {
  split_tf32_as<kTrunc>(c[0], hi[0], lo[0]);
  split_tf32_as<kTrunc>(c[2], hi[1], lo[1]);
  split_tf32_as<kTrunc>(c[1], hi[2], lo[2]);
  split_tf32_as<kTrunc>(c[3], hi[3], lo[3]);
}

// ldmatrix reads fp32 as pairs of b16: in an 8 x 4 fp32 matrix lane l
// gets row l / 4, column l % 4, which is where m16n8k8's tf32 A and B
// fragments want it.  The A fragment (hi, lo) of rows [0, 16) x columns
// [k0, k0 + 8) of a row-major fp32 tile in one ldmatrix (matrices rows
// 0-7 | 8-15 x columns k0 | k0 + 4, in a0..a3 order), split with
// split_tf32_trunc; rows padded to D + 4 floats put the 8 rows of each
// matrix in 8 distinct 16-byte bank groups
__device__ __forceinline__ void ldmatrix_a_tf32x3(uint32_t (&hi)[4],
                                                  uint32_t (&lo)[4],
                                                  const float* tile,
                                                  int stride, int k0,
                                                  int lane) {
  const int m = lane / 8;
  uint32_t r[4];
  ldmatrix_x4(r,
              tile + (lane % 8 + (m & 1) * 8) * stride + k0 + (m >> 1) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32_trunc(__uint_as_float(r[i]), hi[i], lo[i]);
}

// The B fragments {hi0, hi1, lo0, lo1} of n tiles n0 (b0) and n0 + 8
// (b1) of a product X * Y^T, Y a row-major fp32 tile whose rows are the
// n dimension, k columns [k0, k0 + 8), in one ldmatrix (matrices rows
// n0 | n0 + 8 x columns k0 | k0 + 4), split with split_tf32_trunc
__device__ __forceinline__ void ldmatrix_b_rows_tf32x3(uint32_t (&b0)[4],
                                                       uint32_t (&b1)[4],
                                                       const float* tile,
                                                       int stride, int n0,
                                                       int k0, int lane) {
  const int m = lane / 8;
  uint32_t r[4];
  ldmatrix_x4(r, tile + (n0 + lane % 8 + (m >> 1) * 8) * stride + k0 +
                     (m & 1) * 4);
  split_tf32_trunc(__uint_as_float(r[0]), b0[0], b0[2]);
  split_tf32_trunc(__uint_as_float(r[1]), b0[1], b0[3]);
  split_tf32_trunc(__uint_as_float(r[2]), b1[0], b1[2]);
  split_tf32_trunc(__uint_as_float(r[3]), b1[1], b1[3]);
}

// The B fragments {hi0, hi1, lo0, lo1} of n tile n0 at k steps k0 (b0)
// and k0 + 8 (b1) of a product X * Y^T, Y a row-major fp32 tile whose
// rows are the n dimension, in one ldmatrix (matrices rows n0 x columns
// k0 | k0 + 4 | k0 + 8 | k0 + 12), split with split_tf32_trunc: for a
// warp that owns one n tile (the fp32 K4's 8 positions)
__device__ __forceinline__ void ldmatrix_b_rows_k16_tf32x3(
    uint32_t (&b0)[4], uint32_t (&b1)[4], const float* tile, int stride,
    int n0, int k0, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, tile + (n0 + lane % 8) * stride + k0 + (lane / 8) * 4);
  split_tf32_trunc(__uint_as_float(r[0]), b0[0], b0[2]);
  split_tf32_trunc(__uint_as_float(r[1]), b0[1], b0[3]);
  split_tf32_trunc(__uint_as_float(r[2]), b1[0], b1[2]);
  split_tf32_trunc(__uint_as_float(r[3]), b1[1], b1[3]);
}

// rows [r0, r0 + R) of a [t, D] fp32 matrix into a padded tile by
// cp.async, kThreads threads (this one is `tid`) taking 16-byte chunks
// in turn; rows past t are zero-filled (their source clamped to row 0)
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_f32_tile_async(float* dst,
                                                    const float* src, int r0,
                                                    int t, int tid) {
  using L = F32Tile<D>;
  for (int i = tid; i < R * L::kChunks; i += kThreads) {
    const int r = i / L::kChunks, c = (i % L::kChunks) * 4;
    const bool valid = r0 + r < t;
    cp_async_16(dst + r * L::kStride + c,
                src + (valid ? static_cast<size_t>(r0 + r) * D + c : 0),
                valid);
  }
}

// an accumulator tile (rows g, g + 8; columns 2t, 2t + 1 of an n8 tile
// at column c0) into rows [r0, r0 + 16) of a [t, D] fp32 matrix, rows
// past t skipped
template <int D>
__device__ __forceinline__ void store_acc_f32(float* dst, const float (&c)[4],
                                              int r0, int c0, int t,
                                              int lane) {
  const int r = r0 + lane / 4, col = c0 + (lane % 4) * 2;
  if (r < t)
    *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * D + col) =
        make_float2(c[0], c[1]);
  if (r + 8 < t)
    *reinterpret_cast<float2*>(dst + static_cast<size_t>(r + 8) * D + col) =
        make_float2(c[2], c[3]);
}

}  // namespace tmt
