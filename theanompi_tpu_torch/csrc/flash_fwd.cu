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
// the tensor cores' bf16 rate (989 TF/s dense) bounds it.
//
// Two routes, chosen by dtype in `tm_flash_fwd`, each dtype exactly one:
//
// bf16: `flash_fwd_tc_kernel`, on the tensor cores (mma.sync m16n8k16,
// bf16 operands, fp32 accumulators; building blocks in mma_sm90.cuh).
// One CTA of 4 warps per (b*h, 64-row q tile), each warp owning 16 q
// rows; the TPU's sequential kv grid axis becomes a loop over 64-row
// kv tiles.  K and V arrive by cp.async into a 2-stage ring of bf16
// tiles, so the next tile's copy overlaps this tile's products, with
// one barrier per tile; rows are padded by 16 bytes so ldmatrix reads
// them without bank conflicts (85 KB of shared memory at D = 128: two
// CTAs per SM).  Q stays in shared memory and is read by ldmatrix for
// each tile (measured faster than holding it in registers).  S = Q K^T
// accumulates in fp32 registers, and the online softmax runs there:
// row max and sum over the 4 lanes sharing a row, sm_scale*log2(e)
// applied to the row max and folded into one FFMA before each
// ex2.approx, the causal and ragged-edge masks applied only on tiles
// that cross the diagonal or the end of T.  On this card the kernel is
// bound by that per-score arithmetic beside the mma.sync stream, not by
// copies: trimming it was the largest gain, while deeper rings and
// more warps per SM made it slower (PERF.md).  P is rounded to bf16 in
// registers and is directly the A operand of P V (the accumulator and
// A fragment layouts coincide), with V's B fragments from
// ldmatrix.trans: P never touches shared memory.  Rounding P to the
// input dtype before P V is what the TPU kernel does
// (`p.astype(v_blk.dtype)`, attention.py:193); l sums the unrounded P
// in fp32, as there.  Causal q tiles launch longest first.  O leaves
// through the warp's own Q rows in shared memory, 16 bytes a store.
// sm_scale must be positive (the wrapper checks).
//
// fp32: `flash_fwd_kernel<float, D>`, on the fp32 CUDA cores.  The
// tensor cores' only fp32 input is TF32 (about three decimal digits),
// which cannot meet the fp32 tolerance of 1e-4 against the plain
// version, so fp32 keeps this kernel: one CTA per (b*h, 64-row q tile),
// K then V staged as fp32 through one shared buffer (rows padded by
// one float), a 16 x 16 thread grid owning 4 rows x D/16 columns each,
// the carry in fp32 (m, l in shared memory, acc in registers).
//
// Rows and columns past T are masked on both routes, so any T runs
// (the TPU's block-divisibility rule does not apply), and Tq may
// differ from Tk for full attention.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

using tmt::from_f;
using tmt::kNegInf;
using tmt::to_f;
using tmt::warp_max;
using tmt::warp_sum;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid, 8 warps
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk,
                     float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kBQ][D+1]
  float* sKV = sQ + kBQ * (D + 1);   // [kBK][D+1]: K, then V
  float* sS = sKV + kBK * (D + 1);   // [kBQ][kBK+1]: scores, then p
  float* sM = sS + kBQ * (kBK + 1);  // [kBQ] running max
  float* sL = sM + kBQ;              // [kBQ] running sum
  float* sA = sL + kBQ;              // [kBQ] this tile's rescale

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * (D + 1) + c] =
        q0 + r < tq ? to_f(q[qbase + static_cast<size_t>(q0 + r) * D + c])
                    : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  constexpr int DC = D / 16;
  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  // causal: kv tiles wholly above the diagonal fold in nothing
  const int k_end = causal ? min(tk, q0 + kBQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // last tile's readers of sKV / sS are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      sKV[r * (D + 1) + c] =
          k0 + r < tk ? to_f(k[kbase + static_cast<size_t>(k0 + r) * D + c])
                      : 0.f;
    }
    __syncthreads();

    // S = Q K^T * scale for rows ty+16a, cols tx+16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = sQ[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = sKV[(tx + 16 * b) * (D + 1) + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        const int qi = q0 + r, kj = k0 + c;
        const bool ok = kj < tk && (!causal || kj <= qi);
        sS[r * (kBK + 1) + c] = ok ? s[a][b] * sm_scale : kNegInf;
      }
    __syncthreads();

    // online softmax: each warp owns kRowsPerWarp rows, lanes own
    // columns lane and lane+32; masked entries contribute exact zeros
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float* row = sS + r * (kBK + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = x0 == kNegInf ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == kNegInf ? 0.f : expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      sKV[r * (D + 1) + c] =
          k0 + r < tk ? to_f(v[kbase + static_cast<size_t>(k0 + r) * D + c])
                      : 0.f;
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty+16a, cols tx+16c
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = sA[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = sS[(ty + 16 * a) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sKV[j * (D + 1) + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(p[a], vv, acc[a][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int qi = q0 + r;
    if (qi < tq) {
      const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        o[qbase + static_cast<size_t>(qi) * D + tx + 16 * c] =
            from_f<T>(acc[a][c] / l);
    }
  }
  if (tid < kBQ && q0 + tid < tq)
    lse[static_cast<size_t>(bh) * tq + q0 + tid] =
        sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

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

template <int D>
cudaError_t launch_simt(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kBQ - 1) / kBQ, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.tq,
      a.tk, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Args& a) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kTcBQ - 1) / kTcBQ, a.bh);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.tq,
      a.tk, a.sm_scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <bool kTc>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16:
      return kTc ? launch_tc<16>(a) : launch_simt<16>(a);
    case 32:
      return kTc ? launch_tc<32>(a) : launch_simt<32>(a);
    case 64:
      return kTc ? launch_tc<64>(a) : launch_simt<64>(a);
    case 128:
      return kTc ? launch_tc<128>(a) : launch_simt<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core kernel's dynamic shared memory at head dim d and how
// many of its CTAs the runtime fits on one SM.
template <int D>
cudaError_t tc_occupancy(int* smem_bytes, int* ctas_per_sm) {
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                       kTcThreads, smem);
}

}  // namespace

// q [bh, tq, d], k/v [bh, tk, d], o [bh, tq, d] in the dtype `dtype`
// names; lse [bh, tq] f32.  bf16 launches the tensor-core kernel, f32
// the SIMT one.  Returns the launch's cudaError_t.
extern "C" int tm_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk,
                            int d, float sm_scale, int causal, int dtype,
                            void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), bh, tq, tk, sm_scale,
               causal, static_cast<cudaStream_t>(stream)};
  if (dtype == tmt::kF32) return dispatch_d<false>(a, d);
  if (dtype == tmt::kBF16) return dispatch_d<true>(a, d);
  return cudaErrorInvalidValue;
}

extern "C" int tm_flash_fwd_tc_occupancy(int d, int* smem_bytes,
                                         int* ctas_per_sm) {
  switch (d) {
    case 16:
      return tc_occupancy<16>(smem_bytes, ctas_per_sm);
    case 32:
      return tc_occupancy<32>(smem_bytes, ctas_per_sm);
    case 64:
      return tc_occupancy<64>(smem_bytes, ctas_per_sm);
    case 128:
      return tc_occupancy<128>(smem_bytes, ctas_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}
