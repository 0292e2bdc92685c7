// Flash-attention backward (K2: dK/dV, K3: dQ) for Hopper.
//
// Replaces the TPU kernels `_flash_bwd_dkv_kernel` (K2,
// theanompi_tpu/ops/attention.py:239, `pl.pallas_call` at :425) and
// `_flash_bwd_dq_kernel` (K3, :292, `pl.pallas_call` at :450), both
// launched by `_flash_bwd_call`.  Given q, k, v, dO [B*H, T, D] and the
// explicit residuals lse, delta [B*H, T] (f32; delta = rowsum(dO*O) is
// computed by the caller, so ring attention can pass global residuals),
// each recomputes P = exp(S*scale - lse) under the causal mask and
//   K2: dV = P^T dO,  dS = P*(dO V^T - delta)*scale,  dK = dS^T Q
//   K3: dQ = dS K
// with fp32 accumulation and outputs in the input dtype.
//
// What bounds it on this card: 4 (K2) and 3 (K3) products of 2*D
// operations per live (q, k) pair against a few hundred MB of operands,
// so the tensor cores' bf16 rate (989 TF/s dense) bounds both.
//
// Common to every kernel here: no CTA carries anything to another (the
// TPU's sequential grid axis kept the accumulators in VMEM between grid
// steps).  K2 runs one CTA per (b*h, kv tile) that walks the q tiles
// and keeps dK and dV in registers; K3 one CTA per (b*h, q tile) that
// walks the kv tiles and keeps dQ in registers.  Each output tile has
// exactly one owner, so there are no atomics and the result is the
// same every run.  Tiles wholly above the causal diagonal are skipped
// (the TPU kernels' `needed`).  Rows past T are masked, so any T runs.
//
// K2 has two routes, chosen by dtype in `tm_flash_bwd_dkv`, each dtype
// exactly one:
//
// bf16: `flash_bwd_dkv_tc_kernel`, on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 accumulators; building blocks in
// mma_sm90.cuh).  One CTA of 4 warps per (b*h, 64-row kv tile), each
// warp owning 16 kv rows, so the products are taken transposed with kv
// rows as the mma M dimension: S^T = K Q^T and dP^T = V dO^T, with K
// and V (held in shared memory as bf16 for the whole CTA) as A
// fragments.  The CTA walks 32-row q tiles from k0 when causal; Q, dO,
// lse and delta of the next q tile arrive by cp.async into a 2-stage
// ring while this one computes, with one barrier per tile (rows padded
// by 16 bytes: ldmatrix without bank conflicts; 69 KB of shared memory
// at D = 128; 240 registers, no spills: two CTAs per SM).  P^T =
// exp2(S^T*scale*log2e - lse*log2e) and dS^T = P^T*(dP^T - delta)*scale
// come out in the accumulator layout, are rounded to bf16 in registers
// and are directly the A operands of dV += P^T dO and dK += dS^T Q,
// with the B fragments from ldmatrix.trans of the dO and Q tiles: no P
// or dS tile goes through shared memory.  dK and dV (16 rows x D each
// per warp) accumulate in fp32 registers; a 32-row q tile keeps S^T and
// dP^T at 16 registers each beside them (64-row q tiles were slightly
// faster but spilled; PERF.md).  The masks are applied only on tiles that cross
// the diagonal or the end of T.
//
// Numerics of the bf16 route: P^T and dS^T are rounded to bf16 before
// the two products (the operands dO and Q are bf16 already), where the
// TPU kernel keeps both products in fp32 (attention.py:272-284); this
// is what tensor-core flash backwards do.  Its error against the plain
// version in fp32 is measured by chip_smoke.py and emulated on the CPU
// by tests/test_torch_flash_bwd.py, both within atol = rtol = 1e-2.
//
// K3 has two routes the same way, chosen by dtype in `tm_flash_bwd_dq`:
//
// bf16: `flash_bwd_dq_tc_kernel`, K2's design with the roles of q and
// kv swapped.  One CTA of 4 warps per (b*h, 64-row q tile), each warp
// owning 16 q rows as the mma M dimension; causal q tiles launch in
// reverse, so the longest kv walks start first.  Q and dO arrive once
// by cp.async and their A fragments are re-read by ldmatrix on every
// kv tile (cheaper in registers than holding them, as for K1); each
// thread keeps lse and delta of its rows g and g + 8 in registers for
// the whole walk.  The CTA walks kv tiles of kDqBK rows from 0 up to
// the diagonal, K and V arriving by cp.async into a 2-stage ring with
// one barrier per tile.  S = Q K^T and dP = dO V^T take their B
// fragments from ldmatrix of the K and V tiles; P = exp2(S*scale*log2e
// - lse*log2e) and dS = P*(dP - delta)*scale come out in the
// accumulator layout, masked only on tiles that cross the diagonal or
// the end of the keys; dS is rounded to bf16 in registers and is
// directly the A operand of dQ += dS K, whose B fragments come from
// ldmatrix.trans of the same K tile.  No P or dS tile goes through
// shared memory, and no barrier other than the ring's.  dQ (16 rows x D
// per warp, 64 fp32 registers a thread at D = 128, beside 32 each for S
// and dP) leaves through the warp's own Q rows in shared memory, 16
// bytes a store.  Numerics: dQ += dS K takes bf16 dS and bf16 K, where
// the TPU kernel multiplies fp32 dS by K cast to fp32
// (attention.py:320-328); the CPU emulation of that rounding is in
// tests/test_torch_flash_bwd.py, within atol = rtol = 1e-2.
//
// fp32: `flash_bwd_dkv_kernel<float, D>` and `flash_bwd_dq_kernel<float,
// D>`, on the fp32 CUDA cores: operand tiles in fp32 in shared memory
// (rows padded by one float so a half-warp reads 16 banks; 166 KB for K2
// and 149 KB for K3 at D = 128, so each launch raises the dynamic
// limit), a 16 x 16 thread grid of 256 threads each owning 4 rows x
// D/16 columns of its accumulators.  The tensor cores' only fp32 input
// is TF32 (about three decimal digits), which cannot meet the fp32
// tolerance of 1e-4, so fp32 K2 and K3 stay here.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

using tmt::from_f;
using tmt::to_f;

constexpr int kB = 64;         // rows per q tile and per kv tile
constexpr int kThreads = 256;  // 16 x 16 thread grid, 8 warps

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO, P, dS, lse, delta
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V, dS, lse, delta
  return sizeof(float) * (4 * kB * (D + 1) + kB * (kB + 1) + 2 * kB);
}

// rows [r0, r0 + kB) of a [t, D] matrix into a [kB][D+1] fp32 tile,
// zeros past t
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int r0, int t) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < t ? to_f(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
}

// lse and delta of rows [r0, r0 + kB), zeros past t
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* lse,
                                          const float* delta, int r0,
                                          int t) {
  const int i = threadIdx.x;
  if (i < kB) {
    s_lse[i] = r0 + i < t ? lse[r0 + i] : 0.f;
    s_delta[i] = r0 + i < t ? delta[r0 + i] : 0.f;
  }
}

// For q rows ty+16a and kv rows tx+16b of the current tiles: P and
// dS = P*(dO V^T - delta)*scale, masked to zero outside [tq) x [tk),
// above the causal diagonal, written to sP (if given) and sS as
// [q][k] with row stride kB+1.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* sQ, const float* sO,
                                         const float* sK, const float* sV,
                                         const float* sL, const float* sD,
                                         float* sP, float* sS, int q0,
                                         int k0, int tq, int tk,
                                         float sm_scale, int causal) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = sQ[(ty + 16 * a) * (D + 1) + d];
      ov[a] = sO[(ty + 16 * a) * (D + 1) + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kv[b] = sK[(tx + 16 * b) * (D + 1) + d];
      vv[b] = sV[(tx + 16 * b) * (D + 1) + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
        dp[a][b] = fmaf(ov[a], vv[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, qi = q0 + r;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b, kj = k0 + c;
      const bool ok = qi < tq && kj < tk && (!causal || kj <= qi);
      const float p = ok ? expf(s[a][b] * sm_scale - sL[r]) : 0.f;
      if (sP != nullptr) sP[r * (kB + 1) + c] = p;
      sS[r * (kB + 1) + c] = p * (dp[a][b] - sD[r]) * sm_scale;
    }
  }
}

// K2: one CTA per (b*h, kv tile); walks the q tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int tq,
                         int tk, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* sK = smem;               // [kB][D+1]
  float* sV = sK + kB * (D + 1);  // [kB][D+1]
  float* sQ = sV + kB * (D + 1);  // [kB][D+1]
  float* sO = sQ + kB * (D + 1);  // [kB][D+1]: dO
  float* sP = sO + kB * (D + 1);  // [kB][kB+1]: P[q][k]
  float* sS = sP + kB * (kB + 1); // [kB][kB+1]: dS[q][k]
  float* sL = sS + kB * (kB + 1); // [kB] lse
  float* sD = sL + kB;            // [kB] delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;
  const size_t rbase = static_cast<size_t>(bh) * tq;

  load_tile<T, D>(sK, k + kbase, k0, tk);
  load_tile<T, D>(sV, v + kbase, k0, tk);

  constexpr int DC = D / 16;
  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  // causal: q tiles wholly before this kv tile see none of its keys
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < tq; q0 += kB) {
    __syncthreads();  // last tile's readers of sQ/sO/sP/sS are done
    load_tile<T, D>(sQ, q + qbase, q0, tq);
    load_tile<T, D>(sO, dout + qbase, q0, tq);
    load_rows(sL, sD, lse + rbase, delta + rbase, q0, tq);
    __syncthreads();
    p_and_ds<D>(sQ, sO, sK, sV, sL, sD, sP, sS, q0, k0, tq, tk, sm_scale,
                causal);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q for kv rows ty+16a, columns tx+16c
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        p[a] = sP[j * (kB + 1) + ty + 16 * a];
        ds[a] = sS[j * (kB + 1) + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float ov = sO[j * (D + 1) + tx + 16 * c];
        const float qv = sQ[j * (D + 1) + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc_v[a][c] = fmaf(p[a], ov, acc_v[a][c]);
          acc_k[a][c] = fmaf(ds[a], qv, acc_k[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj < tk) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const size_t at = kbase + static_cast<size_t>(kj) * D + tx + 16 * c;
        dk[at] = from_f<T>(acc_k[a][c]);
        dv[at] = from_f<T>(acc_v[a][c]);
      }
    }
  }
}

// K3: one CTA per (b*h, q tile); walks the kv tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;               // [kB][D+1]
  float* sO = sQ + kB * (D + 1);  // [kB][D+1]: dO
  float* sK = sO + kB * (D + 1);  // [kB][D+1]
  float* sV = sK + kB * (D + 1);  // [kB][D+1]
  float* sS = sV + kB * (D + 1);  // [kB][kB+1]: dS[q][k]
  float* sL = sS + kB * (kB + 1); // [kB] lse
  float* sD = sL + kB;            // [kB] delta

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;
  const size_t rbase = static_cast<size_t>(bh) * tq;

  load_tile<T, D>(sQ, q + qbase, q0, tq);
  load_tile<T, D>(sO, dout + qbase, q0, tq);
  load_rows(sL, sD, lse + rbase, delta + rbase, q0, tq);

  constexpr int DC = D / 16;
  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  // causal: kv tiles wholly above the diagonal hold no key these rows see
  const int k_end = causal ? min(tk, q0 + kB) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // last tile's readers of sK/sV/sS are done
    load_tile<T, D>(sK, k + kbase, k0, tk);
    load_tile<T, D>(sV, v + kbase, k0, tk);
    __syncthreads();
    p_and_ds<D>(sQ, sO, sK, sV, sL, sD, nullptr, sS, q0, k0, tq, tk,
                sm_scale, causal);
    __syncthreads();
    // dQ += dS K for q rows ty+16a, columns tx+16c
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = sS[(ty + 16 * a) * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sK[j * (D + 1) + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(ds[a], kv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi < tq) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
        dq[qbase + static_cast<size_t>(qi) * D + tx + 16 * c] =
            from_f<T>(acc[a][c]);
    }
  }
}

// -- K2, bf16: the tensor-core kernel -------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcBK = 64;                    // kv rows per CTA
constexpr int kTcBQ = 32;                    // q rows per tile
constexpr int kTcThreads = 32 * kTcBK / 16;  // one warp per 16 kv rows
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {  // K, V; two stages of Q, dO, lse, delta
  return sizeof(bf16) * tmt::Tile<D>::kStride * (2 * kTcBK + 4 * kTcBQ) +
         sizeof(float) * 4 * kTcBQ;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int tq, int tk, float sm_scale, float scale_log2,
                            int causal) {
  using tmt::Tile;
  constexpr int S = Tile<D>::kStride;
  constexpr int NQ = kTcBQ / 8;  // accumulator tiles across a q tile
  constexpr int ND = D / 8;      // accumulator tiles across D
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);  // [kTcBK][S]
  bf16* sV = sK + kTcBK * S;                    // [kTcBK][S]
  bf16* sQ = sV + kTcBK * S;                    // [2][kTcBQ][S]
  bf16* sO = sQ + 2 * kTcBQ * S;                // [2][kTcBQ][S]: dO
  float* sL = reinterpret_cast<float*>(sO + 2 * kTcBQ * S);  // [2][kTcBQ]
  float* sD = sL + 2 * kTcBQ;                                // [2][kTcBQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTcBK;  // causal: the longest walks first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wk0 = k0 + warp * 16;  // this warp's first kv row
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;

  // causal: q tiles wholly before this kv tile see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < tq ? (tq - q_begin + kTcBQ - 1) / kTcBQ : 0;

  // Q, dO, lse and delta of q tile `it` into stage it % 2
  auto load_q_tile = [&](int it) {
    const int q0 = q_begin + it * kTcBQ, st = it % 2;
    tmt::load_tile_async<D, kTcBQ, kTcThreads>(sQ + st * kTcBQ * S,
                                               q + qbase, q0, tq, tid);
    tmt::load_tile_async<D, kTcBQ, kTcThreads>(sO + st * kTcBQ * S,
                                               dout + qbase, q0, tq, tid);
    if (tid < kTcBQ) {
      const bool valid = q0 + tid < tq;
      const int r = valid ? q0 + tid : 0;
      tmt::cp_async_4(sL + st * kTcBQ + tid, lg + r, valid);
      tmt::cp_async_4(sD + st * kTcBQ + tid, dg + r, valid);
    }
  };

  tmt::load_tile_async<D, kTcBK, kTcThreads>(sK, k + kbase, k0, tk, tid);
  tmt::load_tile_async<D, kTcBK, kTcThreads>(sV, v + kbase, k0, tk, tid);
  if (n_tiles > 0) load_q_tile(0);
  tmt::cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const bf16* sKw = sK + warp * 16 * S;  // this warp's K and V rows
  const bf16* sVw = sV + warp * 16 * S;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kTcBQ;
    tmt::cp_async_wait<0>();  // this q tile (and, first time, K, V) landed
    // ... for every thread, and every warp is done with the last q tile,
    // whose stage the next copy refills while this one is computed on
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_q_tile(it + 1);
      tmt::cp_async_commit();
    }
    const bf16* sQs = sQ + (it % 2) * kTcBQ * S;
    const bf16* sOs = sO + (it % 2) * kTcBQ * S;
    const float* sLs = sL + (it % 2) * kTcBQ;
    const float* sDs = sD + (it % 2) * kTcBQ;

    // causal: a q tile whose rows all precede this warp's keys is skipped
    if (!causal || q0 + kTcBQ - 1 >= wk0) {
      // S^T = K Q^T and dP^T = V dO^T: rows kv, columns q
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        tmt::load_a(ka, sKw, S, kk * 16, lane);
        tmt::load_a(va, sVw, S, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t b[4];
          tmt::load_b_rows(b, sQs, S, np * 16, kk * 16, lane);
          tmt::mma_bf16(st[2 * np], ka, b[0], b[1]);
          tmt::mma_bf16(st[2 * np + 1], ka, b[2], b[3]);
          tmt::load_b_rows(b, sOs, S, np * 16, kk * 16, lane);
          tmt::mma_bf16(dpt[2 * np], va, b[0], b[1]);
          tmt::mma_bf16(dpt[2 * np + 1], va, b[2], b[3]);
        }
      }

      // P^T and dS^T in place; masks only where the tile crosses the
      // diagonal or the end of the queries
      const bool edge = (causal && q0 < wk0 + 15) || q0 + kTcBQ > tq;
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + t4 * 2 + (e & 1);  // q row within the tile
          float p = tmt::exp2_approx(st[n][e] * scale_log2 - sLs[c] * kLog2e);
          if (edge) {
            const int kv = wk0 + g + (e >> 1) * 8;
            if (q0 + c >= tq || (causal && kv > q0 + c)) p = 0.f;
          }
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sDs[c]) * sm_scale;
        }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T (bf16) straight
      // from the accumulators
#pragma unroll
      for (int kk = 0; kk < kTcBQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        tmt::acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        tmt::acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          tmt::load_b_cols(b, sOs, S, kk * 16, dp * 16, lane);
          tmt::mma_bf16(acc_v[2 * dp], pa, b[0], b[1]);
          tmt::mma_bf16(acc_v[2 * dp + 1], pa, b[2], b[3]);
          tmt::load_b_cols(b, sQs, S, kk * 16, dp * 16, lane);
          tmt::mma_bf16(acc_k[2 * dp], da, b[0], b[1]);
          tmt::mma_bf16(acc_k[2 * dp + 1], da, b[2], b[3]);
        }
      }
    }
  }
  tmt::cp_async_wait<0>();  // K and V landed even when no q tile ran

  // dK and dV leave through the warp's own K and V rows (no other warp
  // reads them), 16 bytes a store
  bf16* sdK = sK + warp * 16 * S;
  bf16* sdV = sV + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    tmt::acc_to_smem<D>(sdK, acc_k[n], n * 8, lane);
    tmt::acc_to_smem<D>(sdV, acc_v[n], n * 8, lane);
  }
  __syncwarp();
  tmt::store_tile<D, 16, 32>(dk + kbase, sdK, wk0, tk, lane);
  tmt::store_tile<D, 16, 32>(dv + kbase, sdV, wk0, tk, lane);
}

// -- K3, bf16: the tensor-core kernel -------------------------------------

constexpr int kDqWarps = 4;                // each owns 16 q rows
constexpr int kDqBQ = 16 * kDqWarps;       // q rows per CTA
constexpr int kDqBK = 64;                  // kv rows per tile
constexpr int kDqStages = 2;               // K/V tiles in the ring
constexpr int kDqThreads = 32 * kDqWarps;

template <int D>
constexpr size_t dq_tc_smem_bytes() {  // Q, dO, then the ring of K and V
  return sizeof(bf16) * tmt::Tile<D>::kStride *
         (2 * kDqBQ + 2 * kDqStages * kDqBK);
}

template <int D>
__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int tq, int tk,
                           float sm_scale, float scale_log2, int causal) {
  using tmt::Tile;
  constexpr int S = Tile<D>::kStride;
  constexpr int NK = kDqBK / 8;  // accumulator tiles across a kv tile
  constexpr int ND = D / 8;      // accumulator tiles across D
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);  // [kDqBQ][S]
  bf16* sO = sQ + kDqBQ * S;                    // [kDqBQ][S]: dO
  bf16* sK = sO + kDqBQ * S;                    // [kDqStages][kDqBK][S]
  bf16* sV = sK + kDqStages * kDqBK * S;        // [kDqStages][kDqBK][S]

  const int bh = blockIdx.y;
  // causal: the q tiles with the most kv tiles launch first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kDqBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + warp * 16;  // this warp's first q row
  const bf16* sQw = sQ + warp * 16 * S;
  const bf16* sOw = sO + warp * 16 * S;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const bf16* kg = k + static_cast<size_t>(bh) * tk * D;
  const bf16* vg = v + static_cast<size_t>(bh) * tk * D;

  // lse*log2(e) and delta of rows wq0 + g (index 0) and wq0 + g + 8
  // (index 1); rows past tq get 0, and their Q and dO rows are zeros, so
  // their dS is 0 and they are never stored
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wq0 + g + 8 * i;
    const size_t at = static_cast<size_t>(bh) * tq + r;
    lse2[i] = r < tq ? lse[at] * kLog2e : 0.f;
    dlt[i] = r < tq ? delta[at] : 0.f;
  }

  // causal: kv tiles wholly above the diagonal hold no key these rows see
  const int k_end = causal ? min(tk, q0 + kDqBQ) : tk;
  const int n_tiles = (k_end + kDqBK - 1) / kDqBK;

  // kv tile j into stage j % kDqStages, as one cp.async group (empty
  // past the last tile, so group j always holds tile j)
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kDqStages;
      tmt::load_tile_async<D, kDqBK, kDqThreads>(sK + st * kDqBK * S, kg,
                                                 j * kDqBK, tk, tid);
      tmt::load_tile_async<D, kDqBK, kDqThreads>(sV + st * kDqBK * S, vg,
                                                 j * kDqBK, tk, tid);
    }
    tmt::cp_async_commit();
  };
  tmt::load_tile_async<D, kDqBQ, kDqThreads>(sQ, q + qbase, q0, tq, tid);
  tmt::load_tile_async<D, kDqBQ, kDqThreads>(sO, dout + qbase, q0, tq, tid);
  for (int j = 0; j < kDqStages - 1; ++j) load_kv(j);  // Q, dO join group 0

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kDqBK;
    // tile j (and, first time, Q and dO) has landed, for every thread;
    // and every warp is done with tile j - 1, whose stage the copy
    // started next refills while this tile is computed on
    tmt::cp_async_wait<kDqStages - 2>();
    __syncthreads();
    load_kv(j + kDqStages - 1);
    // causal: a kv tile whose keys all follow this warp's rows is skipped
    if (causal && k0 > wq0 + 15) continue;
    const bf16* sKj = sK + (j % kDqStages) * kDqBK * S;
    const bf16* sVj = sV + (j % kDqStages) * kDqBK * S;

    // S = Q K^T and dP = dO V^T: rows q, columns kv
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      tmt::load_a(qa, sQw, S, kk * 16, lane);
      tmt::load_a(oa, sOw, S, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        tmt::load_b_rows(b, sKj, S, np * 16, kk * 16, lane);
        tmt::mma_bf16(s[2 * np], qa, b[0], b[1]);
        tmt::mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        tmt::load_b_rows(b, sVj, S, np * 16, kk * 16, lane);
        tmt::mma_bf16(dp[2 * np], oa, b[0], b[1]);
        tmt::mma_bf16(dp[2 * np + 1], oa, b[2], b[3]);
      }
    }

    // P and dS in place (dS into dp); masks only where the tile crosses
    // the diagonal or the end of the keys
    const bool edge = (causal && k0 + kDqBK - 1 > wq0) || k0 + kDqBK > tk;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = tmt::exp2_approx(fmaf(s[n][e], scale_log2, -lse2[i]));
        if (edge) {
          const int col = k0 + n * 8 + t4 * 2 + (e & 1);
          const int row = wq0 + g + 8 * i;
          if (col >= tk || (causal && col > row)) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dlt[i]) * sm_scale;
      }

    // dQ += dS K, dS (bf16) straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) {
      uint32_t da[4];
      tmt::acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        tmt::load_b_cols(b, sKj, S, kk * 16, dn * 16, lane);
        tmt::mma_bf16(acc[2 * dn], da, b[0], b[1]);
        tmt::mma_bf16(acc[2 * dn + 1], da, b[2], b[3]);
      }
    }
  }
  tmt::cp_async_wait<0>();  // no copy is left in flight at exit

  // dQ leaves through the warp's own Q rows (no other warp reads them),
  // 16 bytes a store
  bf16* sdQ = sQ + warp * 16 * S;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n) tmt::acc_to_smem<D>(sdQ, acc[n], n * 8, lane);
  __syncwarp();
  tmt::store_tile<D, 16, 32>(dq + qbase, sdQ, wq0, tq, lane);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, tq, tk;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkv_simt(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + kB - 1) / kB, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.tq, a.tk, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + kTcBK - 1) / kTcBK, a.bh);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.tq, a.tk, a.sm_scale, a.sm_scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// A kernel's dynamic shared memory and how many of its CTAs the
// runtime fits on one SM.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem,
                      int* smem_bytes, int* ctas_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                       threads, smem);
}

template <int D>
cudaError_t launch_dq_simt(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kB - 1) / kB, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.tq, a.tk, a.sm_scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  constexpr size_t smem = dq_tc_smem_bytes<D>();
  auto kernel = flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kDqBQ - 1) / kDqBQ, a.bh);
  kernel<<<grid, kDqThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      a.lse, a.delta, static_cast<bf16*>(a.dq), a.tq, a.tk, a.sm_scale,
      a.sm_scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// K2 and K3: bf16 on the tensor cores, f32 on the SIMT kernels
template <bool kDq>
cudaError_t dispatch(const Args& a, int d, int dtype) {
  const bool tc = dtype == tmt::kBF16;
  if (!tc && dtype != tmt::kF32) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return kDq ? (tc ? launch_dq_tc<16>(a) : launch_dq_simt<16>(a))
                 : (tc ? launch_dkv_tc<16>(a) : launch_dkv_simt<16>(a));
    case 32:
      return kDq ? (tc ? launch_dq_tc<32>(a) : launch_dq_simt<32>(a))
                 : (tc ? launch_dkv_tc<32>(a) : launch_dkv_simt<32>(a));
    case 64:
      return kDq ? (tc ? launch_dq_tc<64>(a) : launch_dq_simt<64>(a))
                 : (tc ? launch_dkv_tc<64>(a) : launch_dkv_simt<64>(a));
    case 128:
      return kDq ? (tc ? launch_dq_tc<128>(a) : launch_dq_simt<128>(a))
                 : (tc ? launch_dkv_tc<128>(a) : launch_dkv_simt<128>(a));
    default:
      return cudaErrorInvalidValue;
  }
}

// the tensor-core kernel of K2 (kDq false) or K3 at head dim D
template <bool kDq, int D>
cudaError_t tc_occupancy(int* smem_bytes, int* ctas_per_sm) {
  if constexpr (kDq)
    return occupancy(flash_bwd_dq_tc_kernel<D>, kDqThreads,
                     dq_tc_smem_bytes<D>(), smem_bytes, ctas_per_sm);
  return occupancy(flash_bwd_dkv_tc_kernel<D>, kTcThreads, tc_smem_bytes<D>(),
                   smem_bytes, ctas_per_sm);
}

template <bool kDq>
cudaError_t tc_occupancy_d(int d, int* smem_bytes, int* ctas_per_sm) {
  switch (d) {
    case 16:
      return tc_occupancy<kDq, 16>(smem_bytes, ctas_per_sm);
    case 32:
      return tc_occupancy<kDq, 32>(smem_bytes, ctas_per_sm);
    case 64:
      return tc_occupancy<kDq, 64>(smem_bytes, ctas_per_sm);
    case 128:
      return tc_occupancy<kDq, 128>(smem_bytes, ctas_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dO [bh, tq, d], k/v [bh, tk, d], dk/dv [bh, tk, d] in the dtype
// `dtype` names; lse, delta [bh, tq] f32.  Launches K2 (bf16: the
// tensor-core kernel, f32: the SIMT one); returns its cudaError_t.
extern "C" int tm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int bh, int tq, int tk, int d,
                                float sm_scale, int causal, int dtype,
                                void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, bh, tq,
               tk, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, dtype);
}

// As tm_flash_bwd_dkv, writing dq [bh, tq, d]: launches K3 (bf16: the
// tensor-core kernel, f32: the SIMT one).
extern "C" int tm_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int tq,
                               int tk, int d, float sm_scale, int causal,
                               int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, bh,
               tq, tk, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, dtype);
}

// The K2 tensor-core kernel's dynamic shared memory at head dim d and
// how many of its CTAs fit on one SM.
extern "C" int tm_flash_bwd_dkv_tc_occupancy(int d, int* smem_bytes,
                                             int* ctas_per_sm) {
  return tc_occupancy_d<false>(d, smem_bytes, ctas_per_sm);
}

// The same for the K3 tensor-core kernel.
extern "C" int tm_flash_bwd_dq_tc_occupancy(int d, int* smem_bytes,
                                            int* ctas_per_sm) {
  return tc_occupancy_d<true>(d, smem_bytes, ctas_per_sm);
}
