// Flash-attention forward (K1) for Hopper.
//
// Replaces the TPU kernel `_flash_kernel` in
// theanompi_tpu/ops/attention.py:146 (launched by `pl.pallas_call` in
// `_flash_fwd_call`, :360): causal or full softmax attention over
// q, k, v [B*H, T, D] with the online-softmax carry (m, l, acc), kv
// tiles above the causal diagonal skipped, O written in the input
// dtype and the per-row logsumexp in f32 (m + log(max(l, 1e-30))).
//
// What bounds it on this card: 4*D operations per live (q, k) pair
// (two products) against reading q, k, v and writing o once, a few
// hundred operations per byte at D = 128 and T in the thousands, so
// the tensor cores bound both routes: bf16 at their bf16 rate (989 TF/s
// dense), fp32 at max(bytes / 3.35 TB/s, 3 x operations / 495 TF/s)
// (three TF32 passes, below): 0.208 ms at [1, 32, 2047, 128] causal,
// where the fp32 cores (67 TF/s) would need 0.513 ms.
//
// Two routes, chosen by dtype in `tm_flash_fwd`, each dtype exactly one,
// both on the tensor cores (building blocks in mma_sm90.cuh):
//
// bf16: `flash_fwd_tc_kernel` (mma.sync m16n8k16, bf16 operands, fp32
// accumulators).  One CTA of 4 warps per (b*h, 64-row q tile), each warp
// owning 16 q rows; the TPU's sequential kv grid axis becomes a loop
// over 64-row kv tiles.  K and V arrive by cp.async into a 2-stage ring
// of bf16 tiles, so the next tile's copy overlaps this tile's products,
// with one barrier per tile; rows are padded by 16 bytes so ldmatrix
// reads them without bank conflicts (85 KB of shared memory at D = 128:
// two CTAs per SM).  Q stays in shared memory and is read by ldmatrix
// for each tile (measured faster than holding it in registers).  S =
// Q K^T accumulates in fp32 registers, and the online softmax runs
// there: row max and sum over the 4 lanes sharing a row,
// sm_scale*log2(e) applied to the row max and folded into one FFMA
// before each ex2.approx, the causal and ragged-edge masks applied only
// on tiles that cross the diagonal or the end of T.  On this card the
// kernel is bound by that per-score arithmetic beside the mma.sync
// stream, not by copies: trimming it was the largest gain, while deeper
// rings and more warps per SM made it slower (PERF.md).  P is rounded
// to bf16 in registers and is directly the A operand of P V (the
// accumulator and A fragment layouts coincide), with V's B fragments
// from ldmatrix.trans: P never touches shared memory.  Rounding P to
// the input dtype before P V is what the TPU kernel does
// (`p.astype(v_blk.dtype)`, attention.py:193); l sums the unrounded P
// in fp32, as there.  Causal q tiles launch longest first.  O leaves
// through the warp's own Q rows in shared memory, 16 bytes a store.
// sm_scale must be positive: the wrapper launches a negative one as -Q
// at -sm_scale and a zero one as Q = 0 at 1 (ops/attention.py).
//
// fp32: `flash_fwd_tf32x3_kernel` (mma.sync m16n8k8 with TF32 operands
// in three passes: each operand split into hi and lo, each product
// lo*hi + hi*lo + hi*hi into fp32, which keeps about fp32's accuracy
// where one pass keeps three digits).  The bf16 kernel's shape with
// fp32 tiles, as the fp32 K3 in flash_bwd.cu: one CTA of 4 warps per
// (b*h, 64-row q tile), each warp owning 16 q rows as the mma M
// dimension, causal q tiles launched longest first; Q arrives once, K
// and V of each 32-row kv tile by cp.async into a 2-stage ring of fp32
// rows padded by 4 floats, one barrier a tile: 101 KB of shared memory
// at D = 128, two CTAs an SM.
//
// The split's instructions, not the tensor cores, set the pace, so
// they are cut where shared memory allows (kernels/tune.py; PERF.md):
// each operand is split as its fragment is read, hi truncated
// and lo = x - hi left for the tensor cores to truncate
// (`split_tf32_trunc`: two instructions, not four), Q's and K's
// fragments by one ldmatrix each (fp32 read as b16 pairs), V's and P's
// by scalar reads free of bank conflicts.  Splitting Q once as it lands
// (its lo beside it), or K and V too, doubles those tiles in shared
// memory, which then holds one CTA an SM, and ran slower.
//
// The scores are scaled by sm_scale*log2(e) one by one before the row
// max (so sm_scale may have either sign), the masks apply only on tiles
// that cross the diagonal or the end of the keys, and the online
// softmax stays in registers (quad max and sum, ex2.approx).  P is
// split from the accumulators into the A operand of P V, whose B
// fragments read V's rows in the same k order (`acc_to_a_tf32x3`): no P
// tile goes through shared memory.  The tensor cores round each
// accumulation toward zero, so a sum carried through every tile would
// drift by about an ulp of itself a tile: each tile's P V is summed
// from zero on the tensor cores and then added in fp32
// (acc = acc*alpha + tile).  O = acc / max(l, 1e-30) is stored from fp32 registers and
// lse from lane 0 of each quad.  Each output row has one owner and no
// atomics, so two launches agree bitwise, and a head's rows do not
// depend on the other heads of the launch.
//
// Rows and columns past T are masked on both routes, so any T runs
// (the TPU's block-divisibility rule does not apply), and Tq may
// differ from Tk for full attention.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

using tmt::kNegInf;

// -- bf16: the tensor-core kernel ---------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;                 // each owns 16 q rows
constexpr int kTcBQ = 16 * kTcWarps;        // q rows per CTA
constexpr int kTcBK = 64;                   // kv rows per tile
constexpr int kTcStages = 2;                // K/V tiles in the ring
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t tc_smem_bytes() {  // Q, then the ring of K and V tiles
  return sizeof(bf16) * tmt::Tile<D>::kStride *
         (kTcBQ + 2 * kTcStages * kTcBK);
}

// max and sum over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int tq, int tk,
                        float scale_log2, int causal) {
  using tmt::Tile;
  constexpr int S = Tile<D>::kStride;
  constexpr int NK = kTcBK / 8;  // accumulator tiles across a kv tile
  constexpr int ND = D / 8;      // accumulator tiles across D
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);  // [kTcBQ][S]
  bf16* sK = sQ + kTcBQ * S;                    // [kTcStages][kTcBK][S]
  bf16* sV = sK + kTcStages * kTcBK * S;        // [kTcStages][kTcBK][S]

  const int bh = blockIdx.y;
  // causal: the q tiles with the most kv tiles launch first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kTcBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + warp * 16;  // this warp's first q row
  const bf16* sQw = sQ + warp * 16 * S;
  const bf16* qg = q + static_cast<size_t>(bh) * tq * D;
  const bf16* kg = k + static_cast<size_t>(bh) * tk * D;
  const bf16* vg = v + static_cast<size_t>(bh) * tk * D;

  // causal: kv tiles wholly above the diagonal fold in nothing
  const int k_end = causal ? min(tk, q0 + kTcBQ) : tk;
  const int n_tiles = (k_end + kTcBK - 1) / kTcBK;

  // kv tile j into stage j % kTcStages, as one cp.async group (empty
  // past the last tile, so group j always holds tile j)
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kTcStages;
      tmt::load_tile_async<D, kTcBK, kTcThreads>(sK + st * kTcBK * S, kg,
                                                 j * kTcBK, tk, tid);
      tmt::load_tile_async<D, kTcBK, kTcThreads>(sV + st * kTcBK * S, vg,
                                                 j * kTcBK, tk, tid);
    }
    tmt::cp_async_commit();
  };
  tmt::load_tile_async<D, kTcBQ, kTcThreads>(sQ, qg, q0, tq, tid);
  for (int j = 0; j < kTcStages - 1; ++j) load_kv(j);  // Q joins group 0

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows wq0 + g (index 0) and wq0 + g + 8 (index 1): the running max
  // in log2 units (scores times sm_scale*log2(e)) and this lane's share
  // of the running sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTcBK;
    // tile j (and, first time, Q) has landed, for every thread; and
    // every warp is done with tile j - 1, whose stage the copy started
    // next refills while this tile is computed on
    tmt::cp_async_wait<kTcStages - 2>();
    __syncthreads();
    load_kv(j + kTcStages - 1);
    const bf16* sKj = sK + (j % kTcStages) * kTcBK * S;
    const bf16* sVj = sV + (j % kTcStages) * kTcBK * S;

    // S = Q K^T
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      tmt::load_a(qa, sQw, S, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        tmt::load_b_rows(b, sKj, S, np * 16, kk * 16, lane);
        tmt::mma_bf16(s[2 * np], qa, b[0], b[1]);
        tmt::mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
      }
    }

    // masks only where the tile crosses the diagonal or the end of the
    // keys
    if ((causal && k0 + kTcBK - 1 > wq0) || k0 + kTcBK > tk) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + t4 * 2 + (e & 1);
          const int row = wq0 + g + (e >> 1) * 8;
          if (col >= tk || (causal && col > row)) s[n][e] = kNegInf;
        }
    }
    // online softmax; sm_scale*log2(e) is applied to the row max and
    // folded into one FFMA before each exp2 (sm_scale > 0)
    float mx[2] = {kNegInf, kNegInf}, alpha[2];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
      alpha[i] = tmt::exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
    // Every row sees key 0 in its first tile, so from then on its max
    // is finite and a masked score (kNegInf) gives exp2 of about -1e29:
    // exactly 0, as the TPU kernel's where(mask, p, 0)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            tmt::exp2_approx(fmaf(s[n][e], scale_log2, -mx[e >> 1]));
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: P (bf16) straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t a[4];
      tmt::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        tmt::load_b_cols(b, sVj, S, kk * 16, dp * 16, lane);
        tmt::mma_bf16(acc[2 * dp], a, b[0], b[1]);
        tmt::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // O leaves through the warp's own Q rows (no other warp reads them),
  // 16 bytes a store
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  bf16* sO = sQ + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float c[4] = {acc[n][0] * inv[0], acc[n][1] * inv[0],
                        acc[n][2] * inv[1], acc[n][3] * inv[1]};
    tmt::acc_to_smem<D>(sO, c, n * 8, lane);
  }
  __syncwarp();
  tmt::store_tile<D, 16, 32>(o + static_cast<size_t>(bh) * tq * D, sO, wq0,
                             tq, lane);
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wq0 + g + 8 * i;
      if (r < tq)
        lse[static_cast<size_t>(bh) * tq + r] =
            m[i] * kLn2 + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

// -- fp32: three TF32 passes on the tensor cores ------------------------

constexpr int kXfWarps = 4;           // each owns 16 q rows
constexpr int kXfBQ = 16 * kXfWarps;  // q rows per CTA
constexpr int kXfBK = 32;             // kv rows per tile
constexpr int kXfStages = 2;          // K/V tiles in the ring
constexpr int kXfThreads = 32 * kXfWarps;

template <int D>
constexpr size_t xf_smem_bytes() {  // Q, then the ring of K and V tiles
  return sizeof(float) * tmt::F32Tile<D>::kStride *
         (kXfBQ + 2 * kXfStages * kXfBK);
}

// (kXfThreads, 1) lets ptxas take the registers it wants (207 at D =
// 128): 8 warps with no minimum took 164 and ran slower (PERF.md)
template <int D>
__global__ void __launch_bounds__(kXfThreads, 1)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int tq, int tk, float scale_log2, int causal) {
  constexpr int S = tmt::F32Tile<D>::kStride;
  constexpr int NK = kXfBK / 8;  // accumulator tiles across a kv tile
  constexpr int ND = D / 8;      // accumulator tiles across D
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* sQ = reinterpret_cast<float*>(tc_smem);  // [kXfBQ][S]
  float* sK = sQ + kXfBQ * S;                     // [kXfStages][kXfBK][S]
  float* sV = sK + kXfStages * kXfBK * S;         // [kXfStages][kXfBK][S]

  const int bh = blockIdx.y;
  // causal: the q tiles with the most kv tiles launch first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kXfBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + warp * 16;  // this warp's first q row
  const float* sQw = sQ + warp * 16 * S;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const float* kg = k + static_cast<size_t>(bh) * tk * D;
  const float* vg = v + static_cast<size_t>(bh) * tk * D;

  // causal: kv tiles wholly above the diagonal fold in nothing
  const int k_end = causal ? min(tk, q0 + kXfBQ) : tk;
  const int n_tiles = (k_end + kXfBK - 1) / kXfBK;

  // kv tile j into stage j % kXfStages, as one cp.async group (empty
  // past the last tile, so group j always holds tile j)
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kXfStages;
      tmt::load_f32_tile_async<D, kXfBK, kXfThreads>(sK + st * kXfBK * S, kg,
                                                     j * kXfBK, tk, tid);
      tmt::load_f32_tile_async<D, kXfBK, kXfThreads>(sV + st * kXfBK * S, vg,
                                                     j * kXfBK, tk, tid);
    }
    tmt::cp_async_commit();
  };
  tmt::load_f32_tile_async<D, kXfBQ, kXfThreads>(sQ, q + qbase, q0, tq, tid);
  for (int j = 0; j < kXfStages - 1; ++j) load_kv(j);  // Q joins group 0

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows wq0 + g (index 0) and wq0 + g + 8 (index 1): the running max
  // of the scores times sm_scale*log2(e), and this lane's share of the
  // running sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kXfBK;
    // tile j (and, first time, Q) has landed, for every thread; and
    // every warp is done with tile j - 1, whose stage the copy started
    // next refills while this tile is computed on
    tmt::cp_async_wait<kXfStages - 2>();
    __syncthreads();
    load_kv(j + kXfStages - 1);
    // rows all past the queries, or all before this tile's keys
    if (wq0 >= tq || (causal && k0 > wq0 + 15)) continue;
    const float* sKj = sK + (j % kXfStages) * kXfBK * S;
    const float* sVj = sV + (j % kXfStages) * kXfBK * S;

    // S = Q K^T, Q's and K's fragments by ldmatrix
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t qh[4], ql[4];
      tmt::ldmatrix_a_tf32x3(qh, ql, sQw, S, kk, lane);
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b0[4], b1[4];
        tmt::ldmatrix_b_rows_tf32x3(b0, b1, sKj, S, np * 16, kk, lane);
        tmt::mma_tf32x3(s[2 * np], qh, ql, b0);
        tmt::mma_tf32x3(s[2 * np + 1], qh, ql, b1);
      }
    }

    // scores in log2 units, each scaled before the max; masks only
    // where the tile crosses the diagonal or the end of the keys
    const bool edge = (causal && k0 + kXfBK - 1 > wq0) || k0 + kXfBK > tk;
    float mx[2] = {kNegInf, kNegInf}, alpha[2];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = k0 + n * 8 + t4 * 2 + (e & 1);
          const int row = wq0 + g + (e >> 1) * 8;
          if (col >= tk || (causal && col > row)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = tmt::exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
    // Every row sees key 0 in its first tile, so its max is finite from
    // then on and a masked score gives exp2 of about -1e30: exactly 0,
    // as the TPU kernel's where(mask, p, 0).  P, split, is the A operand
    // of P V
    uint32_t ph[NK][4], pl[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = tmt::exp2_approx(s[n][e] - mx[e >> 1]);
        l[e >> 1] += s[n][e];
      }
      tmt::acc_to_a_tf32x3<true>(ph[n], pl[n], s[n]);
    }

    // acc = acc*alpha + P V, the tile's P V summed from zero on the
    // tensor cores, one 8-column slice of D at a time
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < NK; ++kq) {
        uint32_t b[4];
        tmt::load_b_cols_tf32x3<true>(b, sVj, S, kq * 8, n * 8, lane);
        tmt::mma_tf32x3(t, ph[kq], pl[kq], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], t[e]);
    }
  }
  tmt::cp_async_wait<0>();  // no copy is left in flight at exit

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float c[4] = {acc[n][0] / den[0], acc[n][1] / den[0],
                        acc[n][2] / den[1], acc[n][3] / den[1]};
    tmt::store_acc_f32<D>(o + qbase, c, wq0, n * 8, tq, lane);
  }
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wq0 + g + 8 * i;
      if (r < tq)
        lse[static_cast<size_t>(bh) * tq + r] = m[i] * kLn2 + logf(den[i]);
    }
  }
}

// -- launch and dispatch -------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
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

// K1 at head dim D: bf16 on its tensor-core kernel, fp32 in three TF32
// passes
template <int D>
cudaError_t launch_d(const Args& a, bool bf16_in) {
  if (bf16_in)
    return launch(flash_fwd_tc_kernel<D>,
                  dim3((a.tq + kTcBQ - 1) / kTcBQ, a.bh), kTcThreads,
                  tc_smem_bytes<D>(), a.stream, static_cast<const bf16*>(a.q),
                  static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                  static_cast<bf16*>(a.o), a.lse, a.tq, a.tk,
                  a.sm_scale * kLog2e, a.causal);
  return launch(flash_fwd_tf32x3_kernel<D>,
                dim3((a.tq + kXfBQ - 1) / kXfBQ, a.bh), kXfThreads,
                xf_smem_bytes<D>(), a.stream, static_cast<const float*>(a.q),
                static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                static_cast<float*>(a.o), a.lse, a.tq, a.tk,
                a.sm_scale * kLog2e, a.causal);
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

// the kernel of K1 for bf16 (kBf16) or fp32 at head dim D
template <bool kBf16, int D>
cudaError_t kernel_occupancy(int* smem_bytes, int* ctas_per_sm) {
  if constexpr (kBf16)
    return occupancy(flash_fwd_tc_kernel<D>, kTcThreads, tc_smem_bytes<D>(),
                     smem_bytes, ctas_per_sm);
  return occupancy(flash_fwd_tf32x3_kernel<D>, kXfThreads,
                   xf_smem_bytes<D>(), smem_bytes, ctas_per_sm);
}

template <bool kBf16>
cudaError_t occupancy_d(int d, int* smem_bytes, int* ctas_per_sm) {
  switch (d) {
    case 16:
      return kernel_occupancy<kBf16, 16>(smem_bytes, ctas_per_sm);
    case 32:
      return kernel_occupancy<kBf16, 32>(smem_bytes, ctas_per_sm);
    case 64:
      return kernel_occupancy<kBf16, 64>(smem_bytes, ctas_per_sm);
    case 128:
      return kernel_occupancy<kBf16, 128>(smem_bytes, ctas_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [bh, tq, d], k/v [bh, tk, d], o [bh, tq, d] in the dtype `dtype`
// names; lse [bh, tq] f32.  bf16 launches the bf16 tensor-core kernel,
// f32 the three-pass TF32 one.  Returns the launch's cudaError_t.
extern "C" int tm_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk,
                            int d, float sm_scale, int causal, int dtype,
                            void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), bh, tq, tk, sm_scale,
               causal, static_cast<cudaStream_t>(stream)};
  const bool bf16_in = dtype == tmt::kBF16;
  if (!bf16_in && dtype != tmt::kF32) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_d<16>(a, bf16_in);
    case 32:
      return launch_d<32>(a, bf16_in);
    case 64:
      return launch_d<64>(a, bf16_in);
    case 128:
      return launch_d<128>(a, bf16_in);
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 tensor-core kernel's dynamic shared memory at head dim d and
// how many of its CTAs the runtime fits on one SM.
extern "C" int tm_flash_fwd_tc_occupancy(int d, int* smem_bytes,
                                         int* ctas_per_sm) {
  return occupancy_d<true>(d, smem_bytes, ctas_per_sm);
}

// The same for the fp32 kernel (three TF32 passes).
extern "C" int tm_flash_fwd_tf32x3_occupancy(int d, int* smem_bytes,
                                             int* ctas_per_sm) {
  return occupancy_d<false>(d, smem_bytes, ctas_per_sm);
}
