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
// fp32 (the small fp32 serving models and the fp32 tp = 2 sessions):
// `paged_split_tf32x3_kernel`, on the tensor cores in three TF32 passes
// (mma.sync m16n8k8: each operand split into hi, truncated, and lo = x -
// hi, each product lo*hi + hi*lo + hi*hi into fp32, as the fp32 K1 takes
// them).  What bounds it: the bytes, the window's K and V (twice bf16's)
// at 3.35 TB/s; at 16 rows three passes at 165 TF/s of fp32 work take a
// sixth of that time.  On the CUDA cores the 16-row
// verify shape needs ~27 TF/s of fp32 work beside the stream, and a
// score a 4-lane dot product and a shuffle per row, so time grew with
// the rows while the bytes did not; on the tensor cores the group's <=
// 16 rows, zero-padded, are the M dimension of every product and cost
// no more than 4.  Design: the bf16 kernel's walk with fp32 tiles: the
// same splits, groups, partials and merge; kXWarps = 4 warps, each
// taking kXPos = 8 positions (one n8 tile) of every 32-position tile of
// a 3-deep cp.async ring of fp32 rows padded by 4 floats (conflict free
// for ldmatrix and the scalar reads): 110 KB of shared memory at hd =
// 128, two CTAs an SM, 2 tiles (64 KB of K and V) in flight per CTA.
// What set the pace on the card was instruction issue, not the tensor
// cores (kernels/tune.py; PERF.md): a CTA computes each position's pool
// offset once (the copies' block lookup divides by bs), and sums S over
// hd in kXAcc accumulators, so no chain of dependent mma.sync is longer
// than one k pair's six.  S = Q K^T with Q's and K's fragments by
// ldmatrix (fp32 read as b16 pairs, one ldmatrix giving K's fragments of
// two k steps) and split as read; the online softmax in the accumulator
// layout, each score scaled into log2 units before the row max and
// masked entries' P exactly 0; P is not rounded: it is split from the
// accumulators into the A operand of P V (`acc_to_a_tf32x3`), with V's B
// fragments read in the same k order.  The tensor cores round each
// accumulation toward zero, so a sum carried through every tile would
// drift: each tile's P V is summed from zero and then added in fp32
// (acc = acc*alpha + tile), as the fp32 K1-K3 do.  Each output row has
// one owner and no atomics, and a row's products never see another
// row's values, so two launches agree bitwise and a row's bits do not
// depend on the rows, slots or kv heads launched beside it.
//
// Numerics: the split changes the softmax's association (per-split max
// and sum, merged with exp2(m_j - M) weights), bf16 also rounds P
// before P V, and fp32 takes its products in three TF32 passes (about
// 2^-20 of a term); against the gather path evaluated in fp32 the bar
// is atol = rtol = 1e-4 for fp32 and 1e-2 for bf16.
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
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSplit % kTcTile == 0, "a split is a whole number of tiles");
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

template <int kNThreads = kThreads>
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
  for (int i = threadIdx.x; i < n_blk; i += kNThreads)
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

// -- fp32: three TF32 passes on the tensor cores ----------------------------

constexpr int kXWarps = 4;   // fp32: warps per CTA
constexpr int kXPos = 8;     // fp32: positions a warp takes of each tile
constexpr int kXStages = 3;  // fp32: K/V tiles in the ring
// fp32: S = Q K^T summed over hd in this many accumulators (its k steps
// dealt out in turn, two a turn), added in fp32 at the end: shorter
// chains of dependent mma.sync
constexpr int kXAcc = 8;
constexpr int kXThreads = 32 * kXWarps;
constexpr int kXTile = kXPos * kXWarps;  // fp32: positions per tile
static_assert(kSplit % kXTile == 0, "a split is a whole number of tiles");
static_assert(kXPos == 8 || kXPos == 16, "a warp takes 1 or 2 n8 tiles");
static_assert(kXStages >= 2, "the ring holds the tile computed on and more");
static_assert(kXThreads >= kRows, "a thread for each row's last position");

template <int HD>
constexpr size_t xf_smem_bytes() {  // Q, then the K/V ring
  return sizeof(float) * tmt::F32Tile<HD>::kStride *
         (kRows + 2 * kXStages * kXTile);
}

template <int HD>
__global__ void __launch_bounds__(kXThreads)
    paged_split_tf32x3_kernel(const float* __restrict__ q,
                              const float* __restrict__ kp,
                              const float* __restrict__ vp,
                              const int* __restrict__ tables,
                              const int* __restrict__ pos,
                              float* __restrict__ o_part,
                              float* __restrict__ ml_part,
                              int* __restrict__ ctas, int nq, int hkv,
                              int rep, int bs, int mb, float scale_log2) {
  using L = tmt::F32Tile<HD>;
  constexpr int S = L::kStride;
  constexpr int ND = HD / 8;     // accumulator tiles across hd
  constexpr int NP = kXPos / 8;  // accumulator tiles across a warp's share
  static_assert(kXWarps * kRows * (HD + 2) <= 2 * kXStages * kXTile * S,
                "the warps' merge fits in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sTab[kSplit + 1];
  __shared__ int sPos[kRows];
  __shared__ size_t sOff[kSplit];  // a position's offset in a pool head
  float* sQ = reinterpret_cast<float*>(smem);  // [kRows][S]
  float* sK = sQ + kRows * S;                  // [kXStages][kXTile][S]
  float* sV = sK + kXStages * kXTile * S;      // [kXStages][kXTile][S]

  const int s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rows = nq * rep;
  const Group gr = row_group(rows);
  const int h = gr.h;
  Split sp;
  if (!split_setup<kXThreads>(sp, sTab, sPos, tables, pos, s, nq, rep, bs,
                              mb, gr, ctas))
    return;

  // the group's Q rows (zeros past its last) join the first ring group
  for (int i = tid; i < kRows * L::kChunks; i += kXThreads) {
    const int r = i / L::kChunks, c = (i % L::kChunks) * 4;
    const bool valid = r < gr.n;
    tmt::cp_async_16(sQ + r * S + c,
                     q + (valid ? row_offset(s, gr.r0 + r, nq, hkv, h, rep,
                                             HD) + c
                                : 0),
                     valid);
  }
  __syncthreads();  // sTab, sPos

  const int n_tiles = (sp.t_end - sp.t0 + kXTile - 1) / kXTile;
  const size_t blk = static_cast<size_t>(hkv) * bs * HD;  // block stride
  const float* kh = kp + static_cast<size_t>(h) * bs * HD;
  const float* vh = vp + static_cast<size_t>(h) * bs * HD;
  // each position's block looked up once: the copies' address arithmetic
  // (a division by bs each) set the pace otherwise
  for (int i = tid; i < sp.t_end - sp.t0; i += kXThreads) {
    const int t = sp.t0 + i;
    sOff[i] = sTab[t / bs - sp.b0] * blk + static_cast<size_t>(t % bs) * HD;
  }
  __syncthreads();
  // tile j into stage j % kXStages, K and V of a position from one offset,
  // as one cp.async group (empty past the last tile, so group j always
  // holds tile j); rows past t_end are zero-filled
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kXStages, r0 = j * kXTile;
      for (int i = tid; i < kXTile * L::kChunks; i += kXThreads) {
        const int r = i / L::kChunks, c = (i % L::kChunks) * 4;
        const bool valid = sp.t0 + r0 + r < sp.t_end;
        const size_t off = valid ? sOff[r0 + r] + c : 0;
        tmt::cp_async_16(sK + (st * kXTile + r) * S + c, kh + off, valid);
        tmt::cp_async_16(sV + (st * kXTile + r) * S + c, vh + off, valid);
      }
    }
    tmt::cp_async_commit();
  };
  for (int j = 0; j < kXStages - 1; ++j) load_kv(j);

  // rows g (index 0) and g + 8 (index 1): last positions, running max
  // in log2 units and this lane's share of the running sum
  const int rpos[2] = {sPos[g], sPos[g + 8]};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed, for every thread; and every warp is done with
    // tile j - 1, whose stage the copy started next refills
    tmt::cp_async_wait<kXStages - 2>();
    __syncthreads();
    load_kv(j + kXStages - 1);
    const int w0 = sp.t0 + j * kXTile + warp * kXPos;  // this warp's first
    if (w0 >= sp.t_end) continue;                       // all masked
    const float* sKw = sK + ((j % kXStages) * kXTile + warp * kXPos) * S;
    const float* sVw = sV + ((j % kXStages) * kXTile + warp * kXPos) * S;

    // S = Q K^T over this warp's positions: Q's fragments by ldmatrix,
    // split as read (splitting Q once, into shared memory or registers,
    // was no faster), K's of two k steps by one ldmatrix
    float sa[kXAcc][NP][4];
#pragma unroll
    for (int a = 0; a < kXAcc; ++a)
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[a][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; kk += 2) {
      uint32_t qh0[4], ql0[4], qh1[4], ql1[4];
      tmt::ldmatrix_a_tf32x3(qh0, ql0, sQ, S, kk * 8, lane);
      tmt::ldmatrix_a_tf32x3(qh1, ql1, sQ, S, kk * 8 + 8, lane);
      float (&sc)[NP][4] = sa[(kk / 2) % kXAcc];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        uint32_t b0[4], b1[4];
        tmt::ldmatrix_b_rows_k16_tf32x3(b0, b1, sKw, S, n * 8, kk * 8, lane);
        tmt::mma_tf32x3(sc[n], qh0, ql0, b0);
        tmt::mma_tf32x3(sc[n], qh1, ql1, b1);
      }
    }
    float (&sc)[NP][4] = sa[0];
#pragma unroll
    for (int a = 1; a < kXAcc; ++a)
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += sa[a][n][e];

    // online softmax in log2 units, each score scaled before the max;
    // masks only where a position passes some row's last position
    const bool edge = w0 + kXPos - 1 > sp.pmin;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NP; ++n)
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
    // P in fp32 (a masked entry exactly 0), split, is the A operand of
    // P V
    uint32_t ph[NP][4], pl[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p =
            x == kNegInf ? 0.f : tmt::exp2_approx(x - mx[e >> 1]);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
      tmt::acc_to_a_tf32x3<true>(ph[n], pl[n], sc[n]);
    }

    // acc = acc*alpha + P V, the tile's P V summed from zero on the
    // tensor cores, one 8-column slice of hd at a time
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        uint32_t b[4];
        tmt::load_b_cols_tf32x3<true>(b, sVw, S, n * 8, d * 8, lane);
        tmt::mma_tf32x3(t, ph[n], pl[n], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[d][e] = fmaf(acc[d][e], alpha[e >> 1], t[e]);
    }
  }
  tmt::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the merge

  float* sAcc = sK;                        // [kXWarps][kRows][HD]
  float* sM = sAcc + kXWarps * kRows * HD;  // [kXWarps][kRows]
  float* sL = sM + kXWarps * kRows;         // [kXWarps][kRows]
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
  for (int i = tid; i < gr.n * HD; i += kXThreads) {
    const int r = i / HD, c = i % HD;
    float mr = kNegInf;
#pragma unroll
    for (int w = 0; w < kXWarps; ++w) mr = fmaxf(mr, sM[w * kRows + r]);
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kXWarps; ++w)
      o += exp2f(sM[w * kRows + r] - mr) * sAcc[(w * kRows + r) * HD + c];
    o_part[(c0 + r) * HD + c] = o;
    if (c == 0) {
      float lr = 0.f;
#pragma unroll
      for (int w = 0; w < kXWarps; ++w)
        lr += exp2f(sM[w * kRows + r] - mr) * sL[w * kRows + r];
      ml_part[(c0 + r) * 2] = mr;
      ml_part[(c0 + r) * 2 + 1] = lr;
    }
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

// The split kernel of element type T at head dim HD (bf16: tensor
// cores; fp32: tensor cores, three TF32 passes), its threads and its
// dynamic shared memory
template <typename T, int HD>
struct SplitKernel {
  static constexpr bool kTc = sizeof(T) == 2;
  static constexpr int threads = kTc ? kThreads : kXThreads;
  static constexpr size_t smem =
      kTc ? tc_smem_bytes<HD>() : xf_smem_bytes<HD>();
  static auto kernel() {
    if constexpr (kTc)
      return paged_split_tc_kernel<HD>;
    else
      return paged_split_tf32x3_kernel<HD>;
  }
};

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  using K = SplitKernel<T, HD>;
  const int groups = (a.nq * a.rep + kRows - 1) / kRows;
  const dim3 grid(n_splits(a), a.hkv * groups, a.s);
  const auto kernel = K::kernel();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K::smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, K::threads, K::smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.tables, a.pos, a.o_part, a.ml_part,
      a.ctas, a.nq, a.hkv, a.rep, a.bs, a.mb, a.scale * kLog2e);
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

// The split kernel's dynamic shared memory at head dim hd and how many
// of its CTAs the runtime fits on one SM
template <typename T>
cudaError_t occupancy(int hd, int* smem_bytes, int* ctas_per_sm) {
  auto at = [&](auto k) -> cudaError_t {
    const auto kernel = k.kernel();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(k.smem));
    if (err != cudaSuccess) return err;
    *smem_bytes = static_cast<int>(k.smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kernel, k.threads, k.smem);
  };
  switch (hd) {
    case 32:
      return at(SplitKernel<T, 32>{});
    case 64:
      return at(SplitKernel<T, 64>{});
    case 128:
      return at(SplitKernel<T, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The bf16 split kernel's dynamic shared memory at head dim hd and how
// many of its CTAs the runtime fits on one SM.
extern "C" int tm_paged_split_tc_occupancy(int hd, int* smem_bytes,
                                           int* ctas_per_sm) {
  return occupancy<bf16>(hd, smem_bytes, ctas_per_sm);
}

// The same for the fp32 split kernel (three TF32 passes).
extern "C" int tm_paged_split_tf32x3_occupancy(int hd, int* smem_bytes,
                                               int* ctas_per_sm) {
  return occupancy<float>(hd, smem_bytes, ctas_per_sm);
}

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
