// Flash-attention forward (K1) for Hopper.
//
// Replaces the TPU kernel `_flash_kernel` in
// theanompi_tpu/ops/attention.py:146 (launched by `pl.pallas_call` in
// `_flash_fwd_call`, :360): causal or full softmax attention over
// q, k, v [B*H, T, D] with the online-softmax carry (m, l, acc), kv
// tiles above the causal diagonal skipped, O written in the input
// dtype and the per-row logsumexp in f32.
//
// What bounds it on this card: at the serving prefill shapes
// (T up to 2047, D 128) the work is 4*T^2*D*H/2 operations against
// (q, k, v, o) bytes, a few hundred operations per byte, so the
// tensor-core rate bounds it.  This first version computes both
// products on the fp32 CUDA cores out of shared memory (no wgmma), so
// it is bound by fp32 FMA issue and shared-memory bandwidth, far above
// the tensor-core bound; PERF.md keeps its time beside the bound.
//
// Design against that: one CTA per (b*h, 64-row q tile); the TPU's
// sequential kv grid axis becomes a loop inside the CTA over 64-row kv
// tiles staged in shared memory (K, then V in the same buffer), with
// the carry kept in fp32 (m, l in shared memory, acc in registers: a
// 16x16 thread grid owns 4 rows x D/16 columns each).  Rows and
// columns past T are masked, so any T runs through the kernel (the
// TPU's block-divisibility rule does not apply).  Tile rows are padded
// by one float so the 16 threads of a half-warp read 16 banks.
#include "common.cuh"

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int tq, int tk, float sm_scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, sm_scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* o, float* lse, int bh, int tq, int tk, int d,
                       float sm_scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, bh, tq, tk, sm_scale, causal,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, sm_scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, sm_scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, sm_scale, causal,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [bh, tq, d], k/v [bh, tk, d], o [bh, tq, d] in the dtype `dtype`
// names; lse [bh, tq] f32.  Returns the launch's cudaError_t.
extern "C" int tm_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk,
                            int d, float sm_scale, int causal, int dtype,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  if (dtype == tmt::kF32)
    return dispatch_d<float>(q, k, v, o, l, bh, tq, tk, d, sm_scale, causal,
                             s);
  if (dtype == tmt::kBF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, l, bh, tq, tk, d, sm_scale,
                                     causal, s);
  return cudaErrorInvalidValue;
}
