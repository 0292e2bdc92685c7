// RMS norm over the last dimension of a [rows, d] matrix, whose result
// for a row depends on that row alone.
//
// Not a TPU kernel: the JAX package normalises with an XLA-fused
// `rms_norm` (theanompi_tpu/models/llama.py:91), whose reduction order
// does not depend on how many rows a call has.  PyTorch's mean on the
// card sums a row in an order that does, so a decode step (8 rows) and
// a speculative verify window (32 rows) rounded the same row apart and
// greedy ids parted.  Here every row is one CTA of kThreads threads:
// thread t sums x^2 in fp32 over columns t, t + kThreads, ... in that
// order, the warps fold their sums with a fixed shuffle tree, and warp
// 0 folds the kWarps warp sums the same way.  Nothing of the order
// depends on the grid, so a row rounds alike whatever the launch.
//
// Rounding as the JAX function's: y = dtype(x * rsqrt(mean(x^2) + eps)),
// then out = dtype(y * w) with w in x's dtype.
//
// Bound: bytes (x read once, w once a row, out written once: 2 bytes an
// element in bf16); a decode step's call (8 x 4096, 8 KiB a row) is
// launch-bound on this card.  The design keeps it simple: one pass over
// the row for the sum, a second (from L1/L2) to write it.  Each thread
// strides over the row, so any width d runs, in the order above.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float row_scale;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* orow = out + base;

  float acc = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float v = tmt::to_f(xr[j]);
    acc = fmaf(v, v, acc);
  }
  acc = tmt::warp_sum(acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? warp_sums[lane] : 0.f;
    s = tmt::warp_sum(s);
    if (lane == 0) row_scale = rsqrtf(s / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float scale = row_scale;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const T y = tmt::from_f<T>(tmt::to_f(xr[j]) * scale);
    orow[j] = tmt::from_f<T>(tmt::to_f(y) * tmt::to_f(w[j]));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  rms_norm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/out [rows, d] and w [d], contiguous, all in the dtype `dtype` names;
// launches one CTA a row on `stream` and returns the launch's
// cudaError_t.
extern "C" int tm_rms_norm(const void* x, const void* w, void* out, int rows,
                           int d, float eps, int dtype, void* stream) {
  if (rows < 0 || d < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == tmt::kF32) return launch<float>(x, w, out, rows, d, eps, s);
  if (dtype == tmt::kBF16)
    return launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  return cudaErrorInvalidValue;
}
