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
// so the tensor cores bound both: in bf16 their bf16 rate (989 TF/s
// dense), in fp32 three TF32 passes at 495 TF/s (below).
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
// exactly one, both on the tensor cores:
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
// fp32: `flash_bwd_dkv_tf32x3_kernel` (K2) and
// `flash_bwd_dq_tf32x3_kernel` (K3), on the tensor cores through TF32
// in three passes (mma.sync m16n8k8; the split and the fragment
// layouts are in mma_sm90.cuh).  They replace the same TPU kernels in
// fp32.  One TF32 pass keeps about three decimal digits, short of the
// fp32 tolerance of 1e-4; three passes (lo*hi + hi*lo + hi*hi, each
// operand split into hi = tf32(x) and lo = tf32(x - hi), `split_tf32`)
// keep about fp32's.  Their bound is max(bytes / 3.35 TB/s, 3 x
// operations / 495 TF/s), the operations' side at every shape the
// paths give them: at [1, 32, 2047, 128] causal 0.416 ms (K2) and
// 0.312 ms (K3), where the fp32 cores (67 TF/s) would need 1.025 and
// 0.769 ms.  The design is the bf16 kernels' with fp32 tiles:
// - K2: one CTA of kXkWarps warps per (b*h, kv tile), each warp owning
//   16 kv rows as the mma M dimension: S^T = K Q^T and dP^T = V dO^T
//   with K and V (in shared memory for the whole CTA) as A fragments;
//   Q, dO, lse and delta of the next kXkBQ-row q tile arrive by cp.async
//   into a 2-stage ring while this one computes, with one barrier a
//   tile.  P^T and dS^T come out in the accumulator layout and are
//   directly the A operands of dV += P^T dO and dK += dS^T Q, whose B
//   fragments read the dO and Q rows in the k order the accumulator
//   gives (`acc_to_a_tf32x3`): no P or dS tile goes through shared
//   memory.  dK and dV stay in fp32 registers and are stored from them.
// - K3: one CTA of kXqWarps warps per (b*h, q tile), each warp owning
//   16 q rows, causal q tiles launched in reverse; Q and dO arrive once,
//   K and V of each kXqBK-row kv tile through a 2-stage cp.async ring
//   with one barrier a tile; dQ += dS K takes dS from the accumulators
//   the same way, and dQ is stored from fp32 registers.
// The tensor cores round each accumulation toward zero, so a sum
// carried through every tile would drift by about an ulp of itself a
// step, in proportion to T (1.5e-4 at T = 2047): each tile's dV, dK and
// dQ is summed from zero on the tensor cores and added to the running
// sum in fp32, and the error stays near the plain version's.  Every
// operand stays fp32 in shared memory (rows padded by 4 floats, so each
// fragment's scalar reads are free of bank conflicts both along rows
// and down columns) and is split into hi and lo as its fragment is
// read: a split copy would double tiles that at D = 128 already fill
// most of an SM's shared memory (one CTA of 8 warps an SM for each
// kernel).  The split's integer and fp32 instructions, not the tensor
// cores, set the pace.  The tile shape was chosen with kernels/tune.py
// (PERF.md).  Numerics: the TPU kernels take all four products in fp32
// (attention.py:272-284, :320-328); the three passes' operand rounding
// is emulated on the CPU by tests/test_torch_flash_bwd.py, within
// atol = rtol = 1e-4 of the plain version and the Pallas kernels.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

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

// -- K2 and K3, fp32: three TF32 passes on the tensor cores ---------------

constexpr int kXkWarps = 8;           // K2: each warp owns 16 kv rows
constexpr int kXkBK = 16 * kXkWarps;  // kv rows per CTA
constexpr int kXkBQ = 32;             // q rows per tile
constexpr int kXkThreads = 32 * kXkWarps;
static_assert(kXkBQ % 8 == 0 && kXkBQ <= kXkThreads, "K2 fp32 q tile");

template <int D>
constexpr size_t dkv_x3_smem_bytes() {  // K, V; 2 stages of Q, dO, lse, delta
  return sizeof(float) * (tmt::F32Tile<D>::kStride * (2 * kXkBK + 4 * kXkBQ) +
                          4 * kXkBQ);
}

template <int D>
__global__ void __launch_bounds__(kXkThreads)
    flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int tq, int tk, float sm_scale,
                                float scale_log2, int causal) {
  constexpr int S = tmt::F32Tile<D>::kStride;
  constexpr int NQ = kXkBQ / 8;  // accumulator tiles across a q tile
  constexpr int ND = D / 8;      // accumulator tiles across D
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* sK = reinterpret_cast<float*>(tc_smem);  // [kXkBK][S]
  float* sV = sK + kXkBK * S;                     // [kXkBK][S]
  float* sQ = sV + kXkBK * S;                     // [2][kXkBQ][S]
  float* sO = sQ + 2 * kXkBQ * S;                 // [2][kXkBQ][S]: dO
  float* sL = sO + 2 * kXkBQ * S;                 // [2][kXkBQ]
  float* sD = sL + 2 * kXkBQ;                     // [2][kXkBQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kXkBK;  // causal: the longest walks first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wk0 = k0 + warp * 16;  // this warp's first kv row
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;
  const float* lg = lse + static_cast<size_t>(bh) * tq;
  const float* dg = delta + static_cast<size_t>(bh) * tq;

  // causal: q tiles wholly before this kv tile see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < tq ? (tq - q_begin + kXkBQ - 1) / kXkBQ : 0;

  // Q, dO, lse and delta of q tile `it` into stage it % 2
  auto load_q_tile = [&](int it) {
    const int q0 = q_begin + it * kXkBQ, st = it % 2;
    tmt::load_f32_tile_async<D, kXkBQ, kXkThreads>(sQ + st * kXkBQ * S,
                                                   q + qbase, q0, tq, tid);
    tmt::load_f32_tile_async<D, kXkBQ, kXkThreads>(sO + st * kXkBQ * S,
                                                   dout + qbase, q0, tq, tid);
    if (tid < kXkBQ) {
      const bool valid = q0 + tid < tq;
      const int r = valid ? q0 + tid : 0;
      tmt::cp_async_4(sL + st * kXkBQ + tid, lg + r, valid);
      tmt::cp_async_4(sD + st * kXkBQ + tid, dg + r, valid);
    }
  };

  tmt::load_f32_tile_async<D, kXkBK, kXkThreads>(sK, k + kbase, k0, tk, tid);
  tmt::load_f32_tile_async<D, kXkBK, kXkThreads>(sV, v + kbase, k0, tk, tid);
  if (n_tiles > 0) load_q_tile(0);
  tmt::cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float* sKw = sK + warp * 16 * S;  // this warp's K and V rows
  const float* sVw = sV + warp * 16 * S;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kXkBQ;
    tmt::cp_async_wait<0>();  // this q tile (and, first time, K, V) landed
    // ... for every thread, and every warp is done with the last q tile,
    // whose stage the next copy refills while this one is computed on
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_q_tile(it + 1);
      tmt::cp_async_commit();
    }
    const float* sQs = sQ + (it % 2) * kXkBQ * S;
    const float* sOs = sO + (it % 2) * kXkBQ * S;
    const float* sLs = sL + (it % 2) * kXkBQ;
    const float* sDs = sD + (it % 2) * kXkBQ;

    // causal: a q tile whose rows all precede this warp's keys is skipped
    if (!causal || q0 + kXkBQ - 1 >= wk0) {
      // S^T = K Q^T and dP^T = V dO^T: rows kv, columns q
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        tmt::load_a_tf32x3(kh, kl, sKw, S, kk, lane);
        tmt::load_a_tf32x3(vh, vl, sVw, S, kk, lane);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b[4];
          tmt::load_b_rows_tf32x3(b, sQs, S, n * 8, kk, lane);
          tmt::mma_tf32x3(st[n], kh, kl, b);
          tmt::load_b_rows_tf32x3(b, sOs, S, n * 8, kk, lane);
          tmt::mma_tf32x3(dpt[n], vh, vl, b);
        }
      }

      // P^T and dS^T in place; masks only where the tile crosses the
      // diagonal or the end of the queries
      const bool edge = (causal && q0 < wk0 + 15) || q0 + kXkBQ > tq;
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

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T straight from the
      // accumulators; the q tile's sum starts from zero on the tensor
      // cores and is added to dV and dK in fp32
      uint32_t ph[NQ][4], pl[NQ][4], dh[NQ][4], dl[NQ][4];
#pragma unroll
      for (int kq = 0; kq < NQ; ++kq) {
        tmt::acc_to_a_tf32x3(ph[kq], pl[kq], st[kq]);
        tmt::acc_to_a_tf32x3(dh[kq], dl[kq], dpt[kq]);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kq = 0; kq < NQ; ++kq) {
          uint32_t b[4];
          tmt::load_b_cols_tf32x3(b, sOs, S, kq * 8, n * 8, lane);
          tmt::mma_tf32x3(tv, ph[kq], pl[kq], b);
          tmt::load_b_cols_tf32x3(b, sQs, S, kq * 8, n * 8, lane);
          tmt::mma_tf32x3(tk, dh[kq], dl[kq], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_v[n][e] += tv[e];
          acc_k[n][e] += tk[e];
        }
      }
    }
  }
  tmt::cp_async_wait<0>();  // no copy is left in flight at exit

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    tmt::store_acc_f32<D>(dk + kbase, acc_k[n], wk0, n * 8, tk, lane);
    tmt::store_acc_f32<D>(dv + kbase, acc_v[n], wk0, n * 8, tk, lane);
  }
}

constexpr int kXqWarps = 8;           // K3: each warp owns 16 q rows
constexpr int kXqBQ = 16 * kXqWarps;  // q rows per CTA
constexpr int kXqBK = 32;             // kv rows per tile
constexpr int kXqStages = 2;          // K/V tiles in the ring
constexpr int kXqThreads = 32 * kXqWarps;

template <int D>
constexpr size_t dq_x3_smem_bytes() {  // Q, dO, then the ring of K and V
  return sizeof(float) * tmt::F32Tile<D>::kStride *
         (2 * kXqBQ + 2 * kXqStages * kXqBK);
}

template <int D>
__global__ void __launch_bounds__(kXqThreads)
    flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq, int tq, int tk,
                               float sm_scale, float scale_log2, int causal) {
  constexpr int S = tmt::F32Tile<D>::kStride;
  constexpr int NK = kXqBK / 8;  // accumulator tiles across a kv tile
  constexpr int ND = D / 8;      // accumulator tiles across D
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* sQ = reinterpret_cast<float*>(tc_smem);  // [kXqBQ][S]
  float* sO = sQ + kXqBQ * S;                     // [kXqBQ][S]: dO
  float* sK = sO + kXqBQ * S;                     // [kXqStages][kXqBK][S]
  float* sV = sK + kXqStages * kXqBK * S;         // [kXqStages][kXqBK][S]

  const int bh = blockIdx.y;
  // causal: the q tiles with the most kv tiles launch first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kXqBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + warp * 16;  // this warp's first q row
  const float* sQw = sQ + warp * 16 * S;
  const float* sOw = sO + warp * 16 * S;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const float* kg = k + static_cast<size_t>(bh) * tk * D;
  const float* vg = v + static_cast<size_t>(bh) * tk * D;

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
  const int k_end = causal ? min(tk, q0 + kXqBQ) : tk;
  const int n_tiles = (k_end + kXqBK - 1) / kXqBK;

  // kv tile j into stage j % kXqStages, as one cp.async group (empty
  // past the last tile, so group j always holds tile j)
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kXqStages;
      tmt::load_f32_tile_async<D, kXqBK, kXqThreads>(sK + st * kXqBK * S, kg,
                                                     j * kXqBK, tk, tid);
      tmt::load_f32_tile_async<D, kXqBK, kXqThreads>(sV + st * kXqBK * S, vg,
                                                     j * kXqBK, tk, tid);
    }
    tmt::cp_async_commit();
  };
  tmt::load_f32_tile_async<D, kXqBQ, kXqThreads>(sQ, q + qbase, q0, tq, tid);
  tmt::load_f32_tile_async<D, kXqBQ, kXqThreads>(sO, dout + qbase, q0, tq,
                                                 tid);
  for (int j = 0; j < kXqStages - 1; ++j) load_kv(j);  // Q, dO join group 0

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kXqBK;
    // tile j (and, first time, Q and dO) has landed, for every thread;
    // and every warp is done with tile j - 1, whose stage the copy
    // started next refills while this tile is computed on
    tmt::cp_async_wait<kXqStages - 2>();
    __syncthreads();
    load_kv(j + kXqStages - 1);
    // causal: a kv tile whose keys all follow this warp's rows is skipped
    if (causal && k0 > wq0 + 15) continue;
    const float* sKj = sK + (j % kXqStages) * kXqBK * S;
    const float* sVj = sV + (j % kXqStages) * kXqBK * S;

    // S = Q K^T and dP = dO V^T: rows q, columns kv
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      tmt::load_a_tf32x3(qh, ql, sQw, S, kk, lane);
      tmt::load_a_tf32x3(oh, ol, sOw, S, kk, lane);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b[4];
        tmt::load_b_rows_tf32x3(b, sKj, S, n * 8, kk, lane);
        tmt::mma_tf32x3(s[n], qh, ql, b);
        tmt::load_b_rows_tf32x3(b, sVj, S, n * 8, kk, lane);
        tmt::mma_tf32x3(dp[n], oh, ol, b);
      }
    }

    // P and dS in place (dS into dp); masks only where the tile crosses
    // the diagonal or the end of the keys
    const bool edge = (causal && k0 + kXqBK - 1 > wq0) || k0 + kXqBK > tk;
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

    // dQ += dS K, dS straight from the accumulators, one 8-row slice of
    // the kv tile at a time; the tile's sum starts from zero on the
    // tensor cores and is added to dQ in fp32
    float tq[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tq[n][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < NK; ++kq) {
      uint32_t dh[4], dl[4];
      tmt::acc_to_a_tf32x3(dh, dl, dp[kq]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b[4];
        tmt::load_b_cols_tf32x3(b, sKj, S, kq * 8, n * 8, lane);
        tmt::mma_tf32x3(tq[n], dh, dl, b);
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += tq[n][e];
  }
  tmt::cp_async_wait<0>();  // no copy is left in flight at exit

#pragma unroll
  for (int n = 0; n < ND; ++n)
    tmt::store_acc_f32<D>(dq + qbase, acc[n], wq0, n * 8, tq, lane);
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

// `kernel` at `smem` bytes of dynamic shared memory (above the 48 KB
// default: the limit is raised first) over `grid` x `threads`; the
// launch's error
template <typename Kernel, typename... KArgs>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, KArgs... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// K2 at head dim D: bf16 on its tensor-core kernel, fp32 in three TF32
// passes
template <int D>
cudaError_t launch_dkv(const Args& a, bool bf16_in) {
  if (bf16_in)
    return launch(flash_bwd_dkv_tc_kernel<D>,
                  dim3((a.tk + kTcBK - 1) / kTcBK, a.bh), kTcThreads,
                  tc_smem_bytes<D>(), a.stream,
                  static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                  static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), a.lse, a.delta,
                  static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.tq,
                  a.tk, a.sm_scale, a.sm_scale * kLog2e, a.causal);
  return launch(flash_bwd_dkv_tf32x3_kernel<D>,
                dim3((a.tk + kXkBK - 1) / kXkBK, a.bh), kXkThreads,
                dkv_x3_smem_bytes<D>(), a.stream,
                static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout), a.lse, a.delta,
                static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.tq,
                a.tk, a.sm_scale, a.sm_scale * kLog2e, a.causal);
}

// K3 at head dim D, the same way
template <int D>
cudaError_t launch_dq(const Args& a, bool bf16_in) {
  if (bf16_in)
    return launch(flash_bwd_dq_tc_kernel<D>,
                  dim3((a.tq + kDqBQ - 1) / kDqBQ, a.bh), kDqThreads,
                  dq_tc_smem_bytes<D>(), a.stream,
                  static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                  static_cast<const bf16*>(a.v),
                  static_cast<const bf16*>(a.dout), a.lse, a.delta,
                  static_cast<bf16*>(a.dq), a.tq, a.tk, a.sm_scale,
                  a.sm_scale * kLog2e, a.causal);
  return launch(flash_bwd_dq_tf32x3_kernel<D>,
                dim3((a.tq + kXqBQ - 1) / kXqBQ, a.bh), kXqThreads,
                dq_x3_smem_bytes<D>(), a.stream,
                static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                static_cast<const float*>(a.v),
                static_cast<const float*>(a.dout), a.lse, a.delta,
                static_cast<float*>(a.dq), a.tq, a.tk, a.sm_scale,
                a.sm_scale * kLog2e, a.causal);
}

template <bool kDq, int D>
cudaError_t launch_d(const Args& a, bool bf16_in) {
  if constexpr (kDq) return launch_dq<D>(a, bf16_in);
  return launch_dkv<D>(a, bf16_in);
}

// K2 (kDq false) or K3 by dtype and head dim
template <bool kDq>
cudaError_t dispatch(const Args& a, int d, int dtype) {
  const bool bf16_in = dtype == tmt::kBF16;
  if (!bf16_in && dtype != tmt::kF32) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_d<kDq, 16>(a, bf16_in);
    case 32:
      return launch_d<kDq, 32>(a, bf16_in);
    case 64:
      return launch_d<kDq, 64>(a, bf16_in);
    case 128:
      return launch_d<kDq, 128>(a, bf16_in);
    default:
      return cudaErrorInvalidValue;
  }
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

// the kernel of K2 (kDq false) or K3 for bf16 (kBf16) or fp32 at head
// dim D
template <bool kDq, bool kBf16, int D>
cudaError_t kernel_occupancy(int* smem_bytes, int* ctas_per_sm) {
  if constexpr (kDq && kBf16)
    return occupancy(flash_bwd_dq_tc_kernel<D>, kDqThreads,
                     dq_tc_smem_bytes<D>(), smem_bytes, ctas_per_sm);
  if constexpr (kDq && !kBf16)
    return occupancy(flash_bwd_dq_tf32x3_kernel<D>, kXqThreads,
                     dq_x3_smem_bytes<D>(), smem_bytes, ctas_per_sm);
  if constexpr (!kDq && kBf16)
    return occupancy(flash_bwd_dkv_tc_kernel<D>, kTcThreads,
                     tc_smem_bytes<D>(), smem_bytes, ctas_per_sm);
  return occupancy(flash_bwd_dkv_tf32x3_kernel<D>, kXkThreads,
                   dkv_x3_smem_bytes<D>(), smem_bytes, ctas_per_sm);
}

template <bool kDq, bool kBf16>
cudaError_t occupancy_d(int d, int* smem_bytes, int* ctas_per_sm) {
  switch (d) {
    case 16:
      return kernel_occupancy<kDq, kBf16, 16>(smem_bytes, ctas_per_sm);
    case 32:
      return kernel_occupancy<kDq, kBf16, 32>(smem_bytes, ctas_per_sm);
    case 64:
      return kernel_occupancy<kDq, kBf16, 64>(smem_bytes, ctas_per_sm);
    case 128:
      return kernel_occupancy<kDq, kBf16, 128>(smem_bytes, ctas_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dO [bh, tq, d], k/v [bh, tk, d], dk/dv [bh, tk, d] in the dtype
// `dtype` names; lse, delta [bh, tq] f32.  Launches K2 (bf16: the bf16
// tensor-core kernel, f32: three TF32 passes); returns its cudaError_t.
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
// bf16 tensor-core kernel, f32: three TF32 passes).
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

// The K2 bf16 tensor-core kernel's dynamic shared memory at head dim d
// and how many of its CTAs fit on one SM.
extern "C" int tm_flash_bwd_dkv_tc_occupancy(int d, int* smem_bytes,
                                             int* ctas_per_sm) {
  return occupancy_d<false, true>(d, smem_bytes, ctas_per_sm);
}

// The same for the K3 bf16 tensor-core kernel.
extern "C" int tm_flash_bwd_dq_tc_occupancy(int d, int* smem_bytes,
                                            int* ctas_per_sm) {
  return occupancy_d<true, true>(d, smem_bytes, ctas_per_sm);
}

// The same for the fp32 K2 kernel (three TF32 passes).
extern "C" int tm_flash_bwd_dkv_tf32x3_occupancy(int d, int* smem_bytes,
                                                 int* ctas_per_sm) {
  return occupancy_d<false, false>(d, smem_bytes, ctas_per_sm);
}

// The same for the fp32 K3 kernel.
extern "C" int tm_flash_bwd_dq_tf32x3_occupancy(int d, int* smem_bytes,
                                                int* ctas_per_sm) {
  return occupancy_d<true, false>(d, smem_bytes, ctas_per_sm);
}
