// Paged attention over block tables (K4) for Hopper.
//
// Replaces the TPU kernel `_paged_attend_kernel` in
// theanompi_tpu/serving/paged_attention.py:67 (launched by
// `pl.pallas_call` in `paged_attend`, :161): for each (slot, kv head),
// walk the slot's block table, read each [bs, hd] K/V block straight
// from the pools by its id, score the nq*rep grouped query rows, mask
// positions t > pos, softmax, P.V.  The gathered [S, Hkv, MB*bs, hd]
// window never exists in device memory.
//
// What bounds it on this card: decode reads every K/V byte of the
// slot's window once and does ~2 operations per byte, so memory
// bandwidth bounds it.  The TPU kernel copies the whole window into
// VMEM (2*MB*bs*hd*itemsize, 1 MiB at a 2048-token window in bf16),
// which does not fit a CTA's 227 KB of shared memory.
//
// Design against that: the blocks are STREAMED.  Only the scores stay
// on chip: an exact two-pass softmax keeps the nq*rep score rows of
// the walked window in shared memory (4 rows x 2048 positions x 4 B =
// 32 KB at decode), so the result has the plain version's association
// (max, exp, sum, normalise, then P.V) and differs from it only by
// fp32 summation order.  Pass 1: each warp takes a group of key
// positions, each lane loads hd/32 elements of a K row (coalesced) and
// one warp reduction per query row gives the score.  Pass 2: softmax
// per row in shared memory.  Pass 3: each warp accumulates P.V over
// its positions in registers, and the 8 warp partials are summed
// through shared memory.  The CTA reads its table row itself (the TPU
// kernel's scalar prefetch).  Blocks that start past the slot's
// largest position hold only masked positions whose weight is exactly
// 0, so they are not read; the rest, trash-padded entries included,
// are walked and masked as on the TPU.
//
// Known limit: the grid is S x Hkv CTAs (64 at 8 slots and 8 kv
// heads), fewer than the card's 132 SMs, so decode attention cannot
// reach the bandwidth bound; splitting the window across CTAs
// (flash-decoding) is the first redesign.
#include "common.cuh"

namespace {

using tmt::from_f;
using tmt::kNegInf;
using tmt::to_f;
using tmt::warp_max;
using tmt::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // key rows in flight per warp

size_t smem_bytes(int rows, int t_pad, int hd, int mb, int nq) {
  return sizeof(float) * (static_cast<size_t>(rows) * t_pad +
                          static_cast<size_t>(kWarps) * rows * hd) +
         sizeof(int) * (mb + nq);
}

template <typename T, int HD, int MAXR>
__global__ void __launch_bounds__(kThreads)
    paged_attend_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int nq, int hkv, int rep, int bs, int mb,
                        float scale) {
  constexpr int EPL = HD / 32;  // head elements per lane
  extern __shared__ float smem[];
  const int rows = nq * rep;
  const int s = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // layout: scores [rows][tw] | partials [kWarps][rows][HD] | table | pos
  float* sS = smem;
  float* sRed = sS + static_cast<size_t>(rows) * mb * bs;
  int* sTab = reinterpret_cast<int*>(sRed + kWarps * rows * HD);
  int* sPos = sTab + mb;

  for (int i = tid; i < mb; i += kThreads) sTab[i] = tables[s * mb + i];
  for (int i = tid; i < nq; i += kThreads) sPos[i] = pos[s * nq + i];
  __syncthreads();

  int pmax = 0;
  for (int j = 0; j < nq; ++j) pmax = max(pmax, sPos[j]);
  const int tw = min(mb, pmax / bs + 1) * bs;  // walked window

  // query rows r = qi*rep + ri live in registers, lane owns elements
  // lane + 32*j of each
  float qr[MAXR][EPL];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const size_t base =
        ((((static_cast<size_t>(s) * nq + r / rep) * hkv + h) * rep +
          r % rep) *
         HD);
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      qr[r][j] = r < rows ? to_f(q[base + lane + 32 * j]) : 0.f;
  }

  auto row_ptr = [&](const T* pool, int t) {
    const int bid = sTab[t / bs];
    return pool + ((static_cast<size_t>(bid) * hkv + h) * bs + t % bs) * HD;
  };

  // pass 1: scores
  for (int t0 = warp * kUnroll; t0 < tw; t0 += kWarps * kUnroll) {
    float kv[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const T* kr = t < tw ? row_ptr(kp, t) : nullptr;
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        kv[u][j] = t < tw ? to_f(kr[lane + 32 * j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= rows) break;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) part = fmaf(qr[r][j], kv[u][j], part);
        part = warp_sum(part);
        if (lane == 0 && t < tw)
          sS[r * tw + t] = t <= sPos[r / rep] ? part * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // pass 2: exact softmax per row (masked entries: exp(-1e30 - m) = 0)
  for (int r = warp; r < rows; r += kWarps) {
    float* row = sS + r * tw;
    float mx = kNegInf;
    for (int t = lane; t < tw; t += 32) mx = fmaxf(mx, row[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < tw; t += 32) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < tw; t += 32) row[t] = row[t] / sum;
  }
  __syncthreads();

  // pass 3: P.V partials per warp
  float acc[MAXR][EPL];
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[r][j] = 0.f;
  for (int t0 = warp * kUnroll; t0 < tw; t0 += kWarps * kUnroll) {
    float vv[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const T* vr = t < tw ? row_ptr(vp, t) : nullptr;
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        vv[u][j] = t < tw ? to_f(vr[lane + 32 * j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t >= tw) break;
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= rows) break;
        const float p = sS[r * tw + t];
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[r][j] = fmaf(p, vv[u][j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      sRed[(warp * rows + r) * HD + lane + 32 * j] = acc[r][j];
  }
  __syncthreads();

  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sRed[(w * rows + r) * HD + d];
    out[(((static_cast<size_t>(s) * nq + r / rep) * hkv + h) * rep +
          r % rep) *
            HD +
        d] = from_f<T>(sum);
  }
}

template <typename T, int HD, int MAXR>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* pos, void* out, int s,
                   int nq, int hkv, int rep, int bs, int mb, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(nq * rep, mb * bs, HD, mb, nq);
  auto kernel = paged_attend_kernel<T, HD, MAXR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(s, hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, pos, static_cast<T*>(out), nq, hkv,
      rep, bs, mb, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_rows(const void* q, const void* kp, const void* vp,
                          const int* tables, const int* pos, void* out,
                          int s, int nq, int hkv, int rep, int bs, int mb,
                          float scale, cudaStream_t stream) {
  const int rows = nq * rep;
  if (rows <= 4)
    return launch<T, HD, 4>(q, kp, vp, tables, pos, out, s, nq, hkv, rep,
                            bs, mb, scale, stream);
  if (rows <= 8)
    return launch<T, HD, 8>(q, kp, vp, tables, pos, out, s, nq, hkv, rep,
                            bs, mb, scale, stream);
  if (rows <= 16)
    return launch<T, HD, 16>(q, kp, vp, tables, pos, out, s, nq, hkv, rep,
                             bs, mb, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* kp, const void* vp,
                        const int* tables, const int* pos, void* out, int s,
                        int nq, int hkv, int rep, int hd, int bs, int mb,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return dispatch_rows<T, 32>(q, kp, vp, tables, pos, out, s, nq, hkv,
                                  rep, bs, mb, scale, stream);
    case 64:
      return dispatch_rows<T, 64>(q, kp, vp, tables, pos, out, s, nq, hkv,
                                  rep, bs, mb, scale, stream);
    case 128:
      return dispatch_rows<T, 128>(q, kp, vp, tables, pos, out, s, nq, hkv,
                                   rep, bs, mb, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one launch needs (the wrapper refuses shapes past the
// card's per-block limit before launching).
extern "C" long long tm_paged_attend_smem(int nq, int rep, int hd, int bs,
                                          int mb) {
  return static_cast<long long>(smem_bytes(nq * rep, mb * bs, hd, mb, nq));
}

// q/out [s, nq, hkv, rep, hd]; pools [n_blocks+1, hkv, bs, hd] in the
// dtype `dtype` names; tables [s, mb] and pos [s, nq] int32.  Returns
// the launch's cudaError_t.
extern "C" int tm_paged_attend(const void* q, const void* kp, const void* vp,
                               const void* tables, const void* pos,
                               void* out, int s, int nq, int hkv, int rep,
                               int hd, int bs, int mb, float scale,
                               int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* tab = static_cast<const int*>(tables);
  auto* ps = static_cast<const int*>(pos);
  if (dtype == tmt::kF32)
    return dispatch_hd<float>(q, kp, vp, tab, ps, out, s, nq, hkv, rep, hd,
                              bs, mb, scale, st);
  if (dtype == tmt::kBF16)
    return dispatch_hd<__nv_bfloat16>(q, kp, vp, tab, ps, out, s, nq, hkv,
                                      rep, hd, bs, mb, scale, st);
  return cudaErrorInvalidValue;
}
