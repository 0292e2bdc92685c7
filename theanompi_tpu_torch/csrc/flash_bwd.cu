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
// so the tensor-core rate bounds both.  This first version computes
// every product on the fp32 CUDA cores out of shared memory (no wgmma),
// so it is bound by fp32 FMA issue and shared-memory bandwidth, far
// above the tensor-core bound; PERF.md keeps its time beside the bound.
//
// Design against that: no CTA carries anything to another (the TPU's
// sequential grid axis kept the accumulators in VMEM between grid
// steps).  K2 runs one CTA per (b*h, 64-row kv tile) that walks the q
// tiles and keeps dK and dV in registers; K3 one CTA per (b*h, 64-row
// q tile) that walks the kv tiles and keeps dQ in registers.  Each
// output tile has exactly one owner, so there are no atomics and the
// result is the same every run.  Tiles wholly above the causal
// diagonal are skipped (the TPU kernels' `needed`).  Rows past T are
// masked, so any T runs.  The operand tiles (fp32, rows padded by one
// float so a half-warp reads 16 banks) take 166 KB (K2) and 149 KB
// (K3) of shared memory at D = 128, above the 48 KB default, so each
// launch raises the dynamic limit (the card allows 227 KB).  Thread
// layout as in K1: a 16 x 16 grid of 256 threads, each owning 4 rows x
// D/16 columns of its accumulators.
#include "common.cuh"

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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, tq, tk;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + kB - 1) / kB, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.tq, a.tk,
      a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kB - 1) / kB, a.bh);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.tq, a.tk, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T, bool kDkv>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16:
      return kDkv ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32:
      return kDkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64:
      return kDkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128:
      return kDkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDkv>
int dispatch(const Args& a, int d, int dtype) {
  if (dtype == tmt::kF32) return dispatch_d<float, kDkv>(a, d);
  if (dtype == tmt::kBF16) return dispatch_d<__nv_bfloat16, kDkv>(a, d);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dO [bh, tq, d], k/v [bh, tk, d], dk/dv [bh, tk, d] in the dtype
// `dtype` names; lse, delta [bh, tq] f32.  Launches K2; returns its
// cudaError_t.
extern "C" int tm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int bh, int tq, int tk, int d,
                                float sm_scale, int causal, int dtype,
                                void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, bh, tq,
               tk, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, dtype);
}

// As tm_flash_bwd_dkv, writing dq [bh, tq, d]: launches K3.
extern "C" int tm_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int tq,
                               int tk, int d, float sm_scale, int causal,
                               int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, bh,
               tq, tk, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, dtype);
}
