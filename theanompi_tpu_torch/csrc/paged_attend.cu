// Paged attention over block tables (K4) for Hopper: flash-decoding.
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
// slots' windows once and does 2 operations per byte and query row (4
// rows at decode, 16 at a verify shape), so memory bandwidth bounds
// it.  The TPU kernel runs one grid cell per (slot, kv head) with the
// whole window in VMEM; on this card that would be S x Hkv CTAs (64 at
// 8 slots and 8 kv heads) for 132 SMs, and a window does not fit a
// CTA's shared memory.
//
// Design against that: the window is SPLIT across CTAs
// (flash-decoding; the Pallas kernel has no such split).  Grid
// (n_splits, Hkv, S): split j covers positions [j*kSplit, (j+1)*kSplit),
// boundaries fixed by positions alone, never by S, by which slots are
// active or by the SM count, so a slot's arithmetic is the same alone
// and batched.  A CTA reads its slot's positions and exits at once when
// its split starts past the slot's largest position; otherwise it reads
// its split's table entries into shared memory and streams its K and V
// rows by block id through a kStages-deep cp.async ring, 16 bytes a copy
// (rows past the largest position are zero-filled, not read;
// trash-padded entries below it are walked and masked, as on the TPU).
// It runs an online softmax over its positions and writes an fp32
// partial per query row (o unnormalised, the row max m in log2 units,
// the row sum l) to scratch the wrapper allocates.  A second small
// kernel merges the live splits of each (slot, query, kv head, group
// row) in split order, so results are the same every run, and writes
// the output in the input dtype.  Shared memory depends on the tile
// constants only, so any window runs.
//
// Row groups: the nq*rep grouped query rows of one (slot, kv head) are
// cut into groups of kRows = 16, one CTA each (grid y = kv head x group,
// the group fastest), so a verify window of any length runs; each group
// walks the same splits and writes its own rows of the partials, and the
// merge takes one row a CTA as before.  At <= 16 rows there is one group
// and the launch is the single-group one: the same grid, tiles and bits.
//
// bf16: `paged_split_tc_kernel`, on the tensor cores (mma.sync m16n8k16
// as in K1, building blocks in mma_sm90.cuh).  A group's <= 16 query
// rows, zero-padded to 16, are the M dimension;
// each of 4 warps takes 16 positions of each 64-position tile.  S = Q
// K^T (Q's A fragments held in registers for the whole walk), the online
// softmax in the accumulator layout with masked entries' P exactly 0 (a
// row that sees nothing in a split keeps m = -1e30, l = 0 and weighs 0
// in the merge), P rounded to bf16 in registers, as the gather path's
// `probs.to(vg.dtype)` rounds it, and fed straight to O += P V.  The 4
// warps' states are merged through shared memory in warp order.  At a
// 16-row verify shape a K/V byte carries ~16 operations: streaming 3.35
// TB/s on the fp32 CUDA cores would take ~54 of their 67 TF/s, on the
// tensor cores a few percent of theirs.
//
// fp32 (the small test models): `paged_split_simt_kernel` on the CUDA
// cores, with the same splits, ring and partials.  Each position of a
// 32-position tile belongs to a group of 4 lanes that each hold a
// quarter of its K row, so a score costs a 2-step shuffle reduction;
// one warp per row takes the softmax over the tile's scores in shared
// memory, and each thread accumulates P V for one column of D.
//
// Numerics: the split changes the softmax's association (per-split max
// and sum, merged with exp2(m_j - M) weights) and bf16 also rounds P
// before P V; against the gather path evaluated in fp32 the bar is
// atol = rtol = 1e-4 for fp32 and 1e-2 for bf16.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tmt::from_f;
using tmt::kNegInf;

constexpr int kSplit = 256;   // positions per split (one CTA each)
constexpr int kStages = 2;    // K/V tiles in the cp.async ring
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                 // query rows per row group
constexpr int kTcTile = 16 * kWarps;      // bf16: positions per tile
constexpr int kSimtTile = kThreads / 4;   // fp32: one position per 4 lanes
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSplit % kTcTile == 0 && kSplit % kSimtTile == 0,
              "a split is a whole number of tiles");
static_assert(kSimtTile == 32, "the fp32 softmax gives a lane a position");
static_assert(kStages >= 2, "the ring holds the tile computed on and more");

// The largest position any query row of slot s attends, clamped to the
// window [0, tw): the last position a split of this slot reads.
__device__ __forceinline__ int slot_last(const int* pos, int s, int nq,
                                         int tw) {
  int p = 0;
  for (int j = 0; j < nq; ++j) p = max(p, pos[s * nq + j]);
  return min(p, tw - 1);
}

// The rows of the group a CTA works on: rows [r0, r0 + n) of the
// (slot, kv head)'s nq*rep, with grid y = kv head * groups + group.
struct Group {
  int h, r0, n;
};

__device__ __forceinline__ Group row_group(int rows) {
  const int groups = (rows + kRows - 1) / kRows;
  Group gr;
  gr.h = blockIdx.y / groups;
  gr.r0 = (blockIdx.y % groups) * kRows;
  gr.n = min(kRows, rows - gr.r0);
  return gr;
}

// What a split CTA reads before its K/V walk: its positions [t0,
// t_end), the table entries of the blocks holding them (sTab[i] is
// block b0 + i) and each of its group's query rows' last position
// (sPos, padded rows repeating the group's last real row's).  False
// when the split starts past the slot's last position (the CTA then
// writes nothing; the merge reads only the live splits).  A non-null
// `ctas` counts the CTAs launched (ctas[0]) and those that go on past
// this exit (ctas[1]).
struct Split {
  int t0, t_end, b0, pmin;
};

__device__ __forceinline__ bool split_setup(Split& sp, int* sTab, int* sPos,
                                            const int* tables,
                                            const int* pos, int s, int nq,
                                            int rep, int bs, int mb,
                                            const Group& gr, int* ctas) {
  const int tw = mb * bs;
  const int last = slot_last(pos, s, nq, tw);
  sp.t0 = blockIdx.x * kSplit;
  const bool count = ctas != nullptr && threadIdx.x == 0;
  if (count) atomicAdd(ctas, 1);
  if (sp.t0 > last) return false;
  if (count) atomicAdd(ctas + 1, 1);
  sp.t_end = min(sp.t0 + kSplit, last + 1);
  sp.b0 = sp.t0 / bs;
  const int n_blk = (sp.t_end - 1) / bs - sp.b0 + 1;
  for (int i = threadIdx.x; i < n_blk; i += kThreads)
    sTab[i] = tables[static_cast<size_t>(s) * mb + sp.b0 + i];
  sp.pmin = last;
  for (int r = 0; r < kRows; ++r) {
    const int p = min(pos[s * nq + (gr.r0 + min(r, gr.n - 1)) / rep], last);
    if (threadIdx.x == r) sPos[r] = p;
    sp.pmin = min(sp.pmin, p);
  }
  return true;
}

// query row r of (slot s, kv head h) in q / out [S, nq, Hkv, rep, hd]
__device__ __forceinline__ size_t row_offset(int s, int r, int nq, int hkv,
                                             int h, int rep, int hd) {
  return (((static_cast<size_t>(s) * nq + r / rep) * hkv + h) * rep +
          r % rep) * hd;
}

// partial of (slot s, kv head h, split j) in o_part [S, Hkv, n_splits,
// rows, hd] (ml_part alike, with (m, l) for hd)
__device__ __forceinline__ size_t cell(int s, int h, int j, int hkv,
                                       int n_splits) {
  return (static_cast<size_t>(s) * hkv + h) * n_splits + j;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- bf16: the tensor-core split kernel ------------------------------------

template <int HD>
constexpr size_t tc_smem_bytes() {  // Q, then the ring of K and V tiles
  return sizeof(bf16) * tmt::Tile<HD>::kStride *
         (kRows + 2 * kStages * kTcTile);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    paged_split_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ kp,
                          const bf16* __restrict__ vp,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos,
                          float* __restrict__ o_part,
                          float* __restrict__ ml_part,
                          int* __restrict__ ctas, int nq, int hkv, int rep,
                          int bs, int mb, float scale_log2) {
  using tmt::Tile;
  constexpr int S = Tile<HD>::kStride;
  constexpr int ND = HD / 8;  // accumulator tiles across hd
  static_assert(sizeof(float) * (kWarps * kRows * (HD + 2)) <=
                    sizeof(bf16) * 2 * kStages * kTcTile * S,
                "the warps' merge fits in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sTab[kSplit + 1];
  __shared__ int sPos[kRows];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kRows][S]
  bf16* sK = sQ + kRows * S;                 // [kStages][kTcTile][S]
  bf16* sV = sK + kStages * kTcTile * S;     // [kStages][kTcTile][S]

  const int s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rows = nq * rep;
  const Group gr = row_group(rows);
  const int h = gr.h;
  Split sp;
  if (!split_setup(sp, sTab, sPos, tables, pos, s, nq, rep, bs, mb, gr,
                   ctas))
    return;

  // the group's Q rows (zeros past its last) join the first ring group
  for (int i = tid; i < kRows * Tile<HD>::kChunks; i += kThreads) {
    const int r = i / Tile<HD>::kChunks, c = (i % Tile<HD>::kChunks) * 8;
    const bool valid = r < gr.n;
    tmt::cp_async_16(sQ + r * S + c,
                     q + (valid ? row_offset(s, gr.r0 + r, nq, hkv, h, rep,
                                             HD) + c
                                : 0),
                     valid);
  }
  __syncthreads();  // sTab, sPos

  const int n_tiles = (sp.t_end - sp.t0 + kTcTile - 1) / kTcTile;
  const size_t blk = static_cast<size_t>(hkv) * bs * HD;  // block stride
  const bf16* kh = kp + static_cast<size_t>(h) * bs * HD;
  const bf16* vh = vp + static_cast<size_t>(h) * bs * HD;
  // tile j into stage j % kStages, as one cp.async group (empty past the
  // last tile, so group j always holds tile j)
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kStages, t = sp.t0 + j * kTcTile;
      tmt::load_paged_tile_async<bf16, HD, kTcTile, kThreads>(
          sK + st * kTcTile * S, S, kh, blk, sTab, sp.b0, bs, t, sp.t_end,
          tid);
      tmt::load_paged_tile_async<bf16, HD, kTcTile, kThreads>(
          sV + st * kTcTile * S, S, vh, blk, sTab, sp.b0, bs, t, sp.t_end,
          tid);
    }
    tmt::cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  // rows g (index 0) and g + 8 (index 1): last positions, running max
  // in log2 units and this lane's share of the running sum
  const int rpos[2] = {sPos[g], sPos[g + 8]};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  tmt::cp_async_wait<kStages - 2>();  // Q (and tile 0) landed
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    tmt::load_a(qa[kk], sQ, S, kk * 16, lane);

  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed, for every thread; and every warp is done with
    // tile j - 1, whose stage the copy started next refills
    tmt::cp_async_wait<kStages - 2>();
    __syncthreads();
    load_kv(j + kStages - 1);
    const int w0 = sp.t0 + j * kTcTile + warp * 16;  // this warp's first
    if (w0 >= sp.t_end) continue;                    // all masked
    const bf16* sKw = sK + ((j % kStages) * kTcTile + warp * 16) * S;
    const bf16* sVw = sV + ((j % kStages) * kTcTile + warp * 16) * S;

    // S = Q K^T over this warp's 16 positions
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      tmt::load_b_rows(b, sKw, S, 0, kk * 16, lane);
      tmt::mma_bf16(sc[0], qa[kk], b[0], b[1]);
      tmt::mma_bf16(sc[1], qa[kk], b[2], b[3]);
    }

    // online softmax in log2 units; masks only where a position passes
    // some row's last position
    const bool edge = w0 + 15 > sp.pmin;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (edge && w0 + n * 8 + t4 * 2 + (e & 1) > rpos[e >> 1])
          x = kNegInf;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = tmt::exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p =
            x == kNegInf ? 0.f : tmt::exp2_approx(x - mx[e >> 1]);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (bf16) straight from the accumulators
    uint32_t pa[4];
    tmt::acc_to_a(pa, sc[0], sc[1]);
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t b[4];
      tmt::load_b_cols(b, sVw, S, 0, dn * 16, lane);
      tmt::mma_bf16(acc[2 * dn], pa, b[0], b[1]);
      tmt::mma_bf16(acc[2 * dn + 1], pa, b[2], b[3]);
    }
  }
  tmt::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the merge

  float* sAcc = reinterpret_cast<float*>(sK);  // [kWarps][kRows][HD]
  float* sM = sAcc + kWarps * kRows * HD;      // [kWarps][kRows]
  float* sL = sM + kWarps * kRows;             // [kWarps][kRows]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    if (t4 == 0) {
      sM[warp * kRows + g + 8 * i] = m[i];
      sL[warp * kRows + g + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sAcc[(warp * kRows + g + 8 * (e >> 1)) * HD + n * 8 + t4 * 2 +
           (e & 1)] = acc[n][e];
  __syncthreads();

  // the split's partial of the group's rows, the warps merged in warp
  // order
  const size_t c0 = cell(s, h, blockIdx.x, hkv, gridDim.x) * rows + gr.r0;
  for (int i = tid; i < gr.n * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    float mr = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mr = fmaxf(mr, sM[w * kRows + r]);
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      o += exp2f(sM[w * kRows + r] - mr) * sAcc[(w * kRows + r) * HD + c];
    o_part[(c0 + r) * HD + c] = o;
    if (c == 0) {
      float lr = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        lr += exp2f(sM[w * kRows + r] - mr) * sL[w * kRows + r];
      ml_part[(c0 + r) * 2] = mr;
      ml_part[(c0 + r) * 2 + 1] = lr;
    }
  }
}

// -- fp32: the SIMT split kernel -------------------------------------------

// fp32 tile rows are padded by 4 floats: 16-byte aligned for cp.async
constexpr int kSimtPad = 4;

template <int HD>
constexpr size_t simt_smem_bytes() {  // Q, the K/V ring, scores, m, l, alpha
  return sizeof(float) *
         ((kRows + 2 * kStages * kSimtTile) * (HD + kSimtPad) +
          kRows * (kSimtTile + 1) + 3 * kRows);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    paged_split_simt_kernel(const float* __restrict__ q,
                            const float* __restrict__ kp,
                            const float* __restrict__ vp,
                            const int* __restrict__ tables,
                            const int* __restrict__ pos,
                            float* __restrict__ o_part,
                            float* __restrict__ ml_part,
                            int* __restrict__ ctas, int nq, int hkv,
                            int rep, int bs, int mb, float scale_log2) {
  constexpr int FS = HD + kSimtPad;
  constexpr int SS = kSimtTile + 1;       // score row stride
  constexpr int kPerLane = HD / 4;        // K elements per lane of a group
  constexpr int kRowStep = kThreads / HD;  // P V: rows apart per thread
  constexpr int kAccRows = kRows / kRowStep;
  static_assert(kThreads % HD == 0, "P V: whole columns per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sTab[kSplit + 1];
  __shared__ int sPos[kRows];
  float* sQ = reinterpret_cast<float*>(smem);  // [kRows][FS]
  float* sK = sQ + kRows * FS;                 // [kStages][kSimtTile][FS]
  float* sV = sK + kStages * kSimtTile * FS;   // [kStages][kSimtTile][FS]
  float* sS = sV + kStages * kSimtTile * FS;   // [kRows][SS]: scores, P
  float* sM = sS + kRows * SS;                 // [kRows] running max
  float* sL = sM + kRows;                      // [kRows] running sum
  float* sA = sL + kRows;                      // [kRows] tile's rescale

  const int s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Group gr = row_group(nq * rep);
  const int h = gr.h, rows = gr.n;  // this CTA's rows: the group's
  Split sp;
  if (!split_setup(sp, sTab, sPos, tables, pos, s, nq, rep, bs, mb, gr,
                   ctas))
    return;

  for (int i = tid; i < kRows * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    const bool valid = r < rows;
    tmt::cp_async_16(sQ + r * FS + c,
                     q + (valid ? row_offset(s, gr.r0 + r, nq, hkv, h, rep,
                                             HD) + c
                                : 0),
                     valid);
  }
  if (tid < kRows) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  __syncthreads();  // sTab, sPos, sM, sL

  const int n_tiles = (sp.t_end - sp.t0 + kSimtTile - 1) / kSimtTile;
  const size_t blk = static_cast<size_t>(hkv) * bs * HD;
  const float* kh = kp + static_cast<size_t>(h) * bs * HD;
  const float* vh = vp + static_cast<size_t>(h) * bs * HD;
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kStages, t = sp.t0 + j * kSimtTile;
      tmt::load_paged_tile_async<float, HD, kSimtTile, kThreads>(
          sK + st * kSimtTile * FS, FS, kh, blk, sTab, sp.b0, bs, t,
          sp.t_end, tid);
      tmt::load_paged_tile_async<float, HD, kSimtTile, kThreads>(
          sV + st * kSimtTile * FS, FS, vh, blk, sTab, sp.b0, bs, t,
          sp.t_end, tid);
    }
    tmt::cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);  // Q joins group 0

  // P V: this thread owns column c of rows r0 + k * kRowStep
  const int c = tid % HD, r0 = tid / HD;
  float acc[kAccRows];
#pragma unroll
  for (int k = 0; k < kAccRows; ++k) acc[k] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    tmt::cp_async_wait<kStages - 2>();
    __syncthreads();
    load_kv(j + kStages - 1);
    const float* sKj = sK + (j % kStages) * kSimtTile * FS;
    const float* sVj = sV + (j % kStages) * kSimtTile * FS;

    // scores: the 4 lanes of group pg share position t0 + pg, lane li
    // holding elements li + 4x of its K row
    {
      const int pg = tid / 4, li = tid % 4;
      const int t = sp.t0 + j * kSimtTile + pg;
      float kr[kPerLane];
#pragma unroll
      for (int x = 0; x < kPerLane; ++x) kr[x] = sKj[pg * FS + li + 4 * x];
      for (int r = 0; r < rows; ++r) {
        float d = 0.f;
#pragma unroll
        for (int x = 0; x < kPerLane; ++x)
          d = fmaf(sQ[r * FS + li + 4 * x], kr[x], d);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if (li == 0) sS[r * SS + pg] = t <= sPos[r] ? d * scale_log2 : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row, lane = position
    for (int r = warp; r < rows; r += kWarps) {
      const float x = sS[r * SS + lane];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, tmt::warp_max(x));
      const float p = x == kNegInf ? 0.f : exp2f(x - m_new);
      sS[r * SS + lane] = p;
      const float psum = tmt::warp_sum(p);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int k = 0; k < kAccRows; ++k) {
      const int r = r0 + k * kRowStep;
      if (r < rows) {
        float a = acc[k] * sA[r];
#pragma unroll 8
        for (int t = 0; t < kSimtTile; ++t)
          a = fmaf(sS[r * SS + t], sVj[t * FS + c], a);
        acc[k] = a;
      }
    }
  }
  tmt::cp_async_wait<0>();

  const size_t c0 =
      cell(s, h, blockIdx.x, hkv, gridDim.x) * (nq * rep) + gr.r0;
#pragma unroll
  for (int k = 0; k < kAccRows; ++k) {
    const int r = r0 + k * kRowStep;
    if (r < rows) o_part[(c0 + r) * HD + c] = acc[k];
  }
  if (tid < rows) {
    ml_part[(c0 + tid) * 2] = sM[tid];
    ml_part[(c0 + tid) * 2 + 1] = sL[tid];
  }
}

// -- the merge of the splits -----------------------------------------------

// One CTA per (query row, kv head, slot); thread c < hd merges column c
// over the slot's live splits in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* __restrict__ o_part,
                         const float* __restrict__ ml_part,
                         const int* __restrict__ pos, T* __restrict__ out,
                         int nq, int hkv, int rep, int hd, int tw,
                         int n_splits) {
  const int r = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int rows = nq * rep;
  const int live = slot_last(pos, s, nq, tw) / kSplit + 1;
  const size_t c0 = cell(s, h, 0, hkv, n_splits) * rows + r;
  float mr = kNegInf;
  for (int j = 0; j < live; ++j)
    mr = fmaxf(mr, ml_part[(c0 + static_cast<size_t>(j) * rows) * 2]);
  for (int c = threadIdx.x; c < hd; c += kThreads) {
    float o = 0.f, l = 0.f;
    for (int j = 0; j < live; ++j) {
      const size_t at = c0 + static_cast<size_t>(j) * rows;
      const float w = exp2f(ml_part[at * 2] - mr);
      l += w * ml_part[at * 2 + 1];
      o += w * o_part[at * hd + c];
    }
    out[row_offset(s, r, nq, hkv, h, rep, hd) + c] =
        from_f<T>(o / fmaxf(l, 1e-30f));
  }
}

// -- launch and dispatch ---------------------------------------------------

struct Args {
  const void *q, *kp, *vp;
  const int *tables, *pos;
  float *o_part, *ml_part;
  int* ctas;
  void* out;
  int s, nq, hkv, rep, bs, mb;
  float scale;
  cudaStream_t stream;
};

int n_splits(const Args& a) { return (a.mb * a.bs + kSplit - 1) / kSplit; }

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  constexpr bool kTc = sizeof(T) == 2;
  constexpr size_t smem = kTc ? tc_smem_bytes<HD>() : simt_smem_bytes<HD>();
  const int groups = (a.nq * a.rep + kRows - 1) / kRows;
  const dim3 grid(n_splits(a), a.hkv * groups, a.s);
  const float scale_log2 = a.scale * kLog2e;
  cudaError_t err;
  if constexpr (kTc) {
    auto kernel = paged_split_tc_kernel<HD>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kp),
        static_cast<const bf16*>(a.vp), a.tables, a.pos, a.o_part,
        a.ml_part, a.ctas, a.nq, a.hkv, a.rep, a.bs, a.mb, scale_log2);
  } else {
    auto kernel = paged_split_simt_kernel<HD>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.kp),
        static_cast<const float*>(a.vp), a.tables, a.pos, a.o_part,
        a.ml_part, a.ctas, a.nq, a.hkv, a.rep, a.bs, a.mb, scale_log2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<dim3(a.nq * a.rep, a.hkv, a.s), kThreads, 0,
                            a.stream>>>(
      a.o_part, a.ml_part, a.pos, static_cast<T*>(a.out), a.nq, a.hkv,
      a.rep, HD, a.mb * a.bs, n_splits(a));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 32:
      return launch<T, 32>(a);
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Positions per split: the wrapper sizes the partials' scratch with it.
extern "C" int tm_paged_attend_split_len() { return kSplit; }

// q/out [s, nq, hkv, rep, hd]; pools [n_blocks+1, hkv, bs, hd] in the
// dtype `dtype` names (all 16-byte aligned); tables [s, mb] and pos
// [s, nq] int32; scratch o_part [s, hkv, n_splits, nq*rep, hd] and
// ml_part [s, hkv, n_splits, nq*rep, 2] f32, n_splits = ceil(mb*bs /
// split length).  `ctas`: null, or int32 [2] to which the split kernel
// adds the CTAs it launched and those that did not exit early.
// Launches the split kernel, then the merge; returns the first
// cudaError_t that is not success.
extern "C" int tm_paged_attend(const void* q, const void* kp, const void* vp,
                               const void* tables, const void* pos,
                               void* o_part, void* ml_part, void* ctas,
                               void* out, int s,
                               int nq, int hkv, int rep, int hd, int bs,
                               int mb, float scale, int dtype, void* stream) {
  if (nq * rep < 1 || hkv * ((nq * rep + kRows - 1) / kRows) > 65535)
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, static_cast<const int*>(tables),
               static_cast<const int*>(pos), static_cast<float*>(o_part),
               static_cast<float*>(ml_part), static_cast<int*>(ctas), out, s,
               nq, hkv, rep, bs, mb, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == tmt::kF32) return dispatch_hd<float>(a, hd);
  if (dtype == tmt::kBF16) return dispatch_hd<bf16>(a, hd);
  return cudaErrorInvalidValue;
}
