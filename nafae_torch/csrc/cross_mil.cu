// Fused cross-similarity and MIL max of the ranking loss, forward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels nafae_tpu/ops/pallas/fused_ground.py::_fwd_kernel
// (K3a, the lane-grouped kernel for R > 32) and ::_rollmax_kernel (K3b, the
// video-tiled roll-max for R <= 32). The TPU splits them only because of its
// VMEM and lane budgets; one kernel here takes any R. Same function as the
// port's plain version, nafae_torch/ops/kernels/cross_mil.py::cross_mil_plain:
//
//   for every video i, word m (all words of all sentences), frame t:
//     s[r]       = w[m] . v[i, t, r],  -1e9 where rm[i, t, r] <= 0
//     a[i, m, t] = max_r s[r]  if fm[i, t] > 0, else 0
//     idx        = the FIRST r that reaches the max (jnp.argmax's ties); a
//                  valid frame with no valid region gives a = -1e9, idx 0
//
// With 16-bit input (bf16 or f16) the products use the 16-bit values and sum
// in f32 (the reference's preferred_element_type=f32; bf16 x bf16 and f16 x
// f16 products are exact in f32). Only a [I, M, T] and idx [I, M, T]
// reach device memory, never the [I, M, T, R] scores: that is the point of
// the TPU kernel, kept here.
//
// Design. Per video the function is a [M, E] x [E, T*R] product with a
// segmented max over each frame's R columns as its epilogue. A block takes one
// video, a tile of words and a run of kCols = 80 columns of the flat (t, r)
// axis: floor(80 / R) whole frames when R <= 80 (4 frames at R = 20: no dead
// region slot is multiplied), else one frame in chunks of 80 regions. The
// block writes its tile of scores (masked regions as -1e9) to shared memory
// and one thread per (word, frame) walks that frame's columns in increasing r,
// keeping the first maximum; across chunks it carries (max, index) in
// registers, so the lowest index wins at any R. Every (word, region) dot is
// summed over E in one order that does not depend on its place in a tile, so
// equal region rows give bitwise-equal scores and exact ties stay ties.
//
// f32 operands (cross_mil_f32): CUDA cores, full f32 (no TF32). 32 words x 80
// columns a block; a thread holds an 8 x 5 register tile (word ty + 4i, column
// tx + 16j): 13 16-byte shared loads feed 160 FMAs, against 5 for 16 before.
// E is walked in stages of 64 columns, copied with cp.async into two buffers
// (rows of 68 floats, so the 8 rows a quarter-warp reads fall in distinct
// banks) while the previous stage is multiplied: 16-byte copies at E a
// multiple of 4, else the widest a row allows (8 bytes at GloVe-50d's E =
// 50, else 4), zero-filled past E, so the kernel takes any E. Two groups of 64 threads
// share a stage: group 0 sums columns 0..31 of it, group 1 columns 32..63, and
// the epilogue adds group 0's sum to group 1's, the same order for every
// output. That doubles the warps that issue FMAs: at config 4 the grid is 5 x
// 4 x 16 = 320 blocks of 4 warps and 72 KB, all resident at once, two or three
// on each of the 132 SMs (without the split the busiest scheduler ran two
// long warps one after the other).
//
// 16-bit operands (cross_mil_mma, a template on bf16 or f16: one code, the
// mma.sync of the type): tensor cores, mma.sync m16n8k16 with f32
// accumulators (16-bit products are exact in f32: the contract of
// as_operand). 64 words x 80 columns a block, 4 warps of 32 words x 40
// columns (2 x 5 MMA tiles). The operands stay 16-bit in shared memory, whole
// rows of E (stride E + 8 elements: conflict-free fragment loads), copied by
// cp.async in four groups of columns so that the first MMAs start when a
// quarter has landed. At config 4: 5 x 2 x 16 = 160 blocks of 97 KB, two an
// SM. Every output element sees the same k loop, so ties stay exact.
//
// Any E (cross_mil_any): the 16-bit kernel above needs E a multiple of 4 up
// to 512. Every other 16-bit shape (GloVe-50d's E = 50; E = 1024) takes a
// general variant with the same blocks, scores tile and epilogue whose
// tensor-core product streams E through a ring of three stages of 64
// columns (see below). At R = 36, E = 1024 its 3.0 GFLOP are bound by the
// 23.6 MB of bf16 v (~7 us).
//
// Bound on an H100 SXM (config4 training shapes I=16, M=B*K=128, T=20, R=20,
// E=256): 2*M*I*T*R*E = 419 MFLOP, ~6.3 us at 67 TFLOP/s f32 on CUDA cores,
// against ~7.0 MB moved (v 6.6 MB, w, masks, a and idx), ~2.1 us at 3.35
// TB/s: bound by operations in f32. In bf16 the same flops on tensor cores
// (989 TFLOP/s) take ~0.4 us and the 3.6 MB take ~1.1 us: bound by bytes
// (f16 the same: the same bytes and tensor-core rate).
// These count every region as live; the function needs the rows and dots of
// live regions only, so chip_smoke.py counts the bound from a batch's masks.
// PERF.md has the measured times of this design and of the one it replaced.

#include <climits>
#include <cstdint>

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

constexpr int kCols = 80;          // columns (frames x regions) of a block
constexpr int kLdSc = kCols + 1;   // score rows in shared memory: odd stride

// f32: two groups of 4 x 16 threads, 8 words x 5 columns a thread
constexpr int kTy = 4, kTx = 16, kWordsPer = 8, kColsPer = 5;
constexpr int kWordsF = kTy * kWordsPer;     // 32 words a block
constexpr int kSplit = 2;                    // groups of warps that share E
constexpr int kGroupF = kTy * kTx;           // 64 threads a group
constexpr int kThreadsF = kSplit * kGroupF;  // 128
constexpr int kBk = 32;                      // columns of E a group takes
constexpr int kLd = kSplit * kBk + 4;        // floats of a staged row
static_assert(kTx * kColsPer == kCols, "the thread tiles cover the columns");

// 16-bit: 2 x 2 warps, 32 words x 40 columns each
constexpr int kWordsH = 64;
constexpr int kThreadsH = 128;
constexpr int kGroups = 4;                   // cp.async groups over E

// The columns a block takes: frames [t0, t0 + nf) whole when R <= kCols, else
// frame t0 alone in chunks of kCols regions.
struct Span {
  int t0, nf, chunks;
  bool multi;
};

__device__ __forceinline__ Span block_span(int T, int R) {
  Span s;
  s.multi = R > kCols;
  const int fb = s.multi ? 1 : kCols / R;
  s.t0 = blockIdx.x * fb;
  s.nf = min(fb, T - s.t0);
  s.chunks = s.multi ? (R + kCols - 1) / kCols : 1;
  return s;
}

// The segmented max of one chunk of scores sc[word][column] (masked already):
// thread p takes (word p / nf, frame p % nf) and walks its `len` columns in
// increasing region order, so the first maximum wins. (best, arg) carry over
// a frame's chunks (one pair a thread then: kWords <= blockDim.x); the last
// chunk writes a and idx.
template <int kWords>
__device__ __forceinline__ void segment_max(
    const float* __restrict__ sc, const float* __restrict__ fm,
    float* __restrict__ a, int* __restrict__ idx, const Span& sp, int len,
    int roff, bool first, bool last, int i, int m0, int mw, int M, int T,
    float& best, int& arg) {
  for (int p = threadIdx.x; p < kWords * sp.nf; p += blockDim.x) {
    const int f = p % sp.nf, word = p / sp.nf;
    if (first) {
      best = -CUDART_INF_F;
      arg = INT_MAX;
    }
    const float* row = sc + word * kLdSc + f * len;
    for (int r = 0; r < len; ++r) {
      const float s = row[r];
      if (s > best) {
        best = s;
        arg = roff + r;
      }
    }
    if (last && word < mw) {
      const int t = sp.t0 + f;
      const size_t o = ((size_t)i * M + m0 + word) * T + t;
      a[o] = fm[(size_t)i * T + t] > 0.f ? best : 0.f;
      idx[o] = arg;
    }
  }
}

__global__ void __launch_bounds__(kThreadsF)
cross_mil_f32(const float* __restrict__ w,    // [M, E]
              const float* __restrict__ v,    // [I, T, R, E]
              const float* __restrict__ fm,   // [I, T]
              const float* __restrict__ rm,   // [I, T, R] or null (all valid)
              float* __restrict__ a,          // [I, M, T]
              int* __restrict__ idx,          // [I, M, T]
              int M, int T, int R, int E) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                           // [2][kWordsF][kLd]
  float* vs = ws + 2 * kWordsF * kLd;         // [2][kCols][kLd]
  float* sc = vs + 2 * kCols * kLd;           // [kWordsF][kLdSc]
  float* live = sc + kWordsF * kLdSc;         // [kCols]

  const Span sp = block_span(T, R);
  const int m0 = blockIdx.y * kWordsF;
  const int i = blockIdx.z;
  const int mw = min(kWordsF, M - m0);
  const int grp = threadIdx.x / kGroupF;       // this group's columns of E
  const int ty = threadIdx.x % kGroupF / kTx, tx = threadIdx.x % kTx;
  const int nk = (E + kSplit * kBk - 1) / (kSplit * kBk);
  const float* wsrc = w + (size_t)m0 * E;
  float best = -CUDART_INF_F;
  int arg = INT_MAX;

  for (int ch = 0; ch < sp.chunks; ++ch) {
    const int c0 = ch * kCols;                // first region of a long frame
    const int nc = sp.multi ? min(kCols, R - c0) : sp.nf * R;
    const size_t col0 = ((size_t)i * T + sp.t0) * R + c0;
    const float* vsrc = v + col0 * E;
    __syncthreads();                          // the last chunk's sc and live
    for (int c = threadIdx.x; c < kCols; c += blockDim.x)
      live[c] = (c < nc && rm) ? rm[col0 + c] : 1.f;

    auto stage = [&](int ks) {       // 16-byte copies at E % 4 == 0
      const int buf = ks & 1;
      stage_tile_any(ws + buf * kWordsF * kLd, wsrc, kWordsF, mw, E,
                     ks * kSplit * kBk, kSplit * kBk, kLd);
      stage_tile_any(vs + buf * kCols * kLd, vsrc, kCols, nc, E,
                     ks * kSplit * kBk, kSplit * kBk, kLd);
      cp_async_commit();
    };

    float d[kWordsPer][kColsPer];
#pragma unroll
    for (int x = 0; x < kWordsPer; ++x)
#pragma unroll
      for (int y = 0; y < kColsPer; ++y) d[x][y] = 0.f;

    stage(0);
    for (int ks = 0; ks < nk; ++ks) {
      if (ks + 1 < nk) {
        stage(ks + 1);                        // the next tile loads meanwhile
        cp_async_wait(1);
      } else {
        cp_async_wait(0);
      }
      __syncthreads();
      const float4* wr = reinterpret_cast<const float4*>(
          ws + (ks & 1) * kWordsF * kLd + ty * kLd + grp * kBk);
      const float4* vr = reinterpret_cast<const float4*>(
          vs + (ks & 1) * kCols * kLd + tx * kLd + grp * kBk);
#pragma unroll
      for (int q = 0; q < kBk / 4; ++q) {
        float4 x[kWordsPer], c[kColsPer];
#pragma unroll
        for (int k = 0; k < kWordsPer; ++k) x[k] = wr[k * kTy * (kLd / 4) + q];
#pragma unroll
        for (int k = 0; k < kColsPer; ++k) c[k] = vr[k * kTx * (kLd / 4) + q];
#pragma unroll
        for (int k = 0; k < kWordsPer; ++k)
#pragma unroll
          for (int j = 0; j < kColsPer; ++j) {
            d[k][j] = fmaf(x[k].x, c[j].x, d[k][j]);
            d[k][j] = fmaf(x[k].y, c[j].y, d[k][j]);
            d[k][j] = fmaf(x[k].z, c[j].z, d[k][j]);
            d[k][j] = fmaf(x[k].w, c[j].w, d[k][j]);
          }
      }
      __syncthreads();                        // before this buffer is refilled
    }

    // the groups' partial sums, added in the order of the groups
    for (int gsum = kSplit - 1; gsum >= 0; --gsum) {
      if (grp == gsum) {
#pragma unroll
        for (int k = 0; k < kWordsPer; ++k)
#pragma unroll
          for (int j = 0; j < kColsPer; ++j) {
            const int col = tx + kTx * j;
            float* o = sc + (ty + kTy * k) * kLdSc + col;
            float s = d[k][j];
            if (gsum < kSplit - 1) s += *o;
            *o = (gsum > 0 || live[col] > 0.f) ? s : kNeg;
          }
      }
      __syncthreads();
    }
    segment_max<kWordsF>(sc, fm, a, idx, sp, sp.multi ? nc : R, c0, ch == 0,
                         ch == sp.chunks - 1, i, m0, mw, M, T, best, arg);
  }
}

// 16-bit: c += the products of a warp's 32 words (rows wm.., two m16 tiles
// of ws) and 40 columns (rows wn.. of vs, five n8 tiles) over the k16 steps
// k0, k0 + kStep, ... below k1 of the staged columns (rows of stride ld), one
// mma.sync of the type T16 a tile and step, k increasing; tiles at or past nc
// columns are skipped (warp-uniform).
template <typename T16, int kStep = 16>
__device__ __forceinline__ void mma_words_cols(
    float (&c)[2][5][4], const T16* __restrict__ ws,
    const T16* __restrict__ vs, int ld, int k0, int k1, int wm, int wn,
    int nc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  for (int k = k0; k < k1; k += kStep) {
    uint32_t x[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const T16* p = ws + (wm + mi * 16 + g) * ld + k + 2 * tig;
      x[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      x[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
      x[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      x[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 5; ++ni) {
      if (wn + ni * 8 >= nc) continue;    // dead columns: warp-uniform
      const T16* p = vs + (wn + ni * 8 + g) * ld + k + 2 * tig;
      const uint32_t y0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t y1 = *reinterpret_cast<const uint32_t*>(p + 8);
      mma16<T16>(c[0][ni], x[0], y0, y1);
      mma16<T16>(c[1][ni], x[1], y0, y1);
    }
  }
}

// 16-bit: c += the raw sums a later group left in the scores tile.
__device__ __forceinline__ void add_scores(float (&c)[2][5][4],
                                           const float* __restrict__ sc,
                                           int wm, int wn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 5; ++ni)
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int row = wm + mi * 16 + g + (z >> 1) * 8;
        const int col = wn + ni * 8 + 2 * tig + (z & 1);
        c[mi][ni][z] += sc[row * kLdSc + col];
      }
}

// 16-bit: a warp's accumulators into the scores tile, -1e9 where a column's
// region is masked.
__device__ __forceinline__ void store_scores(float* __restrict__ sc,
                                             const float (&c)[2][5][4],
                                             const float* __restrict__ live,
                                             int wm, int wn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 5; ++ni)
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int row = wm + mi * 16 + g + (z >> 1) * 8;
        const int col = wn + ni * 8 + 2 * tig + (z & 1);
        sc[row * kLdSc + col] = live[col] > 0.f ? c[mi][ni][z] : kNeg;
      }
}

template <typename T16>
__global__ void __launch_bounds__(kThreadsH)
cross_mil_mma(const T16* __restrict__ w,   // [M, E]
              const T16* __restrict__ v,   // [I, T, R, E]
              const float* __restrict__ fm, const float* __restrict__ rm,
              float* __restrict__ a, int* __restrict__ idx, int M, int T,
              int R, int E) {
  extern __shared__ __align__(16) float smem[];
  const int ep = (E + 15) & ~15;              // E padded to the MMA's depth
  const int ld = ep + 8;                      // elements; rows 16-byte aligned
  T16* ws = reinterpret_cast<T16*>(smem);     // [kWordsH][ld]
  T16* vs = ws + kWordsH * ld;                // [kCols][ld]
  float* sc = reinterpret_cast<float*>(vs + kCols * ld);  // [kWordsH][kLdSc]
  float* live = sc + kWordsH * kLdSc;                     // [kCols]

  const Span sp = block_span(T, R);
  const int m0 = blockIdx.y * kWordsH;
  const int i = blockIdx.z;
  const int mw = min(kWordsH, M - m0);
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 40;
  const int kg = ((ep / 16 + kGroups - 1) / kGroups) * 16;  // columns a group
  const T16* wsrc = w + (size_t)m0 * E;
  float best = -CUDART_INF_F;
  int arg = INT_MAX;

  for (int ch = 0; ch < sp.chunks; ++ch) {
    const int c0 = ch * kCols;
    const int nc = sp.multi ? min(kCols, R - c0) : sp.nf * R;
    const size_t col0 = ((size_t)i * T + sp.t0) * R + c0;
    const T16* vsrc = v + col0 * E;
    __syncthreads();                 // the last chunk's vs, sc and live
    for (int c = threadIdx.x; c < kCols; c += blockDim.x)
      live[c] = (c < nc && rm) ? rm[col0 + c] : 1.f;
    for (int q = 0; q < kGroups; ++q) {
      const int k0 = q * kg, kw = min(kg, ep - k0);
      if (kw > 0) {
        if (E % 8 == 0) {            // 16-byte copies
          if (ch == 0)
            stage_tile_async<8>(ws + k0, wsrc, kWordsH, mw, E, k0, kw, ld);
          stage_tile_async<8>(vs + k0, vsrc, kCols, nc, E, k0, kw, ld);
        } else {                     // rows 8-byte aligned only
          if (ch == 0)
            stage_tile_async<4>(ws + k0, wsrc, kWordsH, mw, E, k0, kw, ld);
          stage_tile_async<4>(vs + k0, vsrc, kCols, nc, E, k0, kw, ld);
        }
      }
      cp_async_commit();
    }

    float c[2][5][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
#pragma unroll
        for (int z = 0; z < 4; ++z) c[x][y][z] = 0.f;

    for (int q = 0; q < kGroups; ++q) {
      cp_async_wait(kGroups - 1 - q);
      __syncthreads();
      mma_words_cols(c, ws, vs, ld, q * kg, min(ep, (q + 1) * kg), wm, wn,
                     nc);
    }
    store_scores(sc, c, live, wm, wn);
    __syncthreads();
    segment_max<kWordsH>(sc, fm, a, idx, sp, sp.multi ? nc : R, c0, ch == 0,
                         ch == sp.chunks - 1, i, m0, mw, M, T, best, arg);
  }
}

// The general variant, for every 16-bit shape outside the kernel above: E not
// a multiple of 4 (rows not 8-byte aligned) or above 512 (whole rows no
// longer fit in shared memory). The same blocks (whole frames, or a long
// frame in chunks), the same scores tile and the same segmented first
// maximum, with E streamed so that shared memory does not grow with it.
// The product is the 16-bit kernel's (64 words x 80 columns, warps of 32
// x 40, mma.sync m16n8k16, f32 accumulators) over E in stages of kChunkH
// columns, a ring of kStagesH stages in shared memory (16-, 8- or 4-byte
// cp.async as the rows allow; plain loads for odd E), each stage copied
// kStagesH - 1 stages ahead of its products; the scores tile then reuses
// the ring, so a block holds 62.5 KB and three share an SM (at R = 36, E =
// 1024 all 320 blocks of I = 16, M = 128, T = 20 are resident at once). Two
// groups of four warps take alternate k16 steps of each stage, and the
// epilogue adds the second group's sums to the first's, in the same order
// for every output: at R = 36, E = 1024 the copies and the products each
// take more than half of the kernel's time on their own, and twice the
// warps overlap them better. A deeper ring or 32-column stages were slower
// there (PERF.md).
//
// Every output's dot adds its products in increasing k, the same for every
// place in a tile, so equal region rows give equal scores and ties still
// resolve to the first region. Bound at R = 36, E = 1024 (I = 16, M = 128,
// T = 20, every region live): 3.0 GFLOP, ~3 us on bf16 tensor cores,
// against 23.6 MB of bf16 v, ~7 us: bound by bytes.
constexpr int kChunkH = 64;                  // columns of E a 16-bit stage
constexpr int kLdH = kChunkH + 8;            // 144-byte rows: conflict-free
constexpr int kStagesH = 3;
constexpr int kStageH = (kWordsH + kCols) * kLdH;   // elements of a stage
constexpr int kSplitH = 2;                   // groups of 4 warps over k16
constexpr int kThreadsG = kThreadsH * kSplitH;

template <typename T16>
__global__ void __launch_bounds__(kThreadsG)
cross_mil_any(const T16* __restrict__ w,   // [M, E]
              const T16* __restrict__ v,   // [I, T, R, E]
              const float* __restrict__ fm, const float* __restrict__ rm,
              float* __restrict__ a, int* __restrict__ idx, int M, int T,
              int R, int E) {
  extern __shared__ __align__(16) float smem[];
  T16* stages = reinterpret_cast<T16*>(smem);
  // the scores tile reuses the stages once the products are done
  float* sc = reinterpret_cast<float*>(stages);   // [kWordsH][kLdSc]
  float* live = reinterpret_cast<float*>(stages + kStagesH * kStageH);
  static_assert(kWordsH * kLdSc * sizeof(float) <=
                kStagesH * kStageH * sizeof(T16),
                "the scores tile fits in the stages");

  const Span sp = block_span(T, R);
  const int m0 = blockIdx.y * kWordsH;
  const int i = blockIdx.z;
  const int mw = min(kWordsH, M - m0);
  const int warp = threadIdx.x >> 5 & 3, grp = threadIdx.x >> 7;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 40;
  const int nk = (E + kChunkH - 1) / kChunkH;
  const T16* wsrc = w + (size_t)m0 * E;
  float best = -CUDART_INF_F;
  int arg = INT_MAX;

  for (int ch = 0; ch < sp.chunks; ++ch) {
    const int c0 = ch * kCols;
    const int nc = sp.multi ? min(kCols, R - c0) : sp.nf * R;
    const size_t col0 = ((size_t)i * T + sp.t0) * R + c0;
    const T16* vsrc = v + col0 * E;
    __syncthreads();               // the last chunk's sc and live
    for (int c = threadIdx.x; c < kCols; c += blockDim.x)
      live[c] = (c < nc && rm) ? rm[col0 + c] : 1.f;
    auto stage = [&](int ks) {     // one group a stage, empty past E
      if (ks < nk) {
        T16* d = stages + (ks % kStagesH) * kStageH;
        stage_tile_any(d, wsrc, kWordsH, mw, E, ks * kChunkH, kChunkH,
                       kLdH);
        stage_tile_any(d + kWordsH * kLdH, vsrc, kCols, nc, E,
                       ks * kChunkH, kChunkH, kLdH);
      }
      cp_async_commit();
    };

    float c[2][5][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
#pragma unroll
        for (int z = 0; z < 4; ++z) c[x][y][z] = 0.f;
    for (int ks = 0; ks < kStagesH - 1; ++ks) stage(ks);
    for (int ks = 0; ks < nk; ++ks) {
      cp_async_wait(kStagesH - 2); // stage ks; the later ones may fly
      __syncthreads();             // ... for every thread; ks - 1 is read
      stage(ks + kStagesH - 1);    // into the slot of stage ks - 1
      const T16* d = stages + (ks % kStagesH) * kStageH;
      mma_words_cols<T16, 16 * kSplitH>(c, d, d + kWordsH * kLdH, kLdH,
                                        16 * grp, kChunkH, wm, wn, nc);
    }
    cp_async_wait(0);              // (empty groups past E)
    __syncthreads();               // every warp's products are done
    for (int gs = kSplitH - 1; gs >= 0; --gs) {
      if (grp == gs) {
        if (gs < kSplitH - 1) add_scores(c, sc, wm, wn);
        store_scores(sc, c, live, wm, wn);
      }
      __syncthreads();
    }
    segment_max<kWordsH>(sc, fm, a, idx, sp, sp.multi ? nc : R, c0,
                         ch == 0, ch == sp.chunks - 1, i, m0, mw, M, T,
                         best, arg);
  }
}

// Whether the two kernels above take these sizes: f32 any E (E is staged
// 64 columns at a time), 16-bit E a multiple of 4 up to 512 (whole rows in
// shared memory, 8- or 16-byte aligned). Every other 16-bit shape takes
// cross_mil_any.
bool in_envelope(bool wide, int E) {
  return wide || (E >= 4 && E % 4 == 0 && E <= 512);
}

// Dynamic shared memory of one block, in bytes: 71,616 B in f32 at any E;
// in 16 bits 97,088 B at E = 256 and 170,816 B at E = 512; 62,528 B in the
// general variant at any E (three blocks an SM).
size_t smem_any_16() {
  return (size_t)kStagesH * kStageH * 2 + (size_t)kCols * sizeof(float);
}
size_t smem_f32() {
  return (size_t)(2 * (kWordsF + kCols) * kLd + kWordsF * kLdSc + kCols) *
         sizeof(float);
}
size_t smem_16(int E) {
  const int ld = ((E + 15) & ~15) + 8;
  return (size_t)(kWordsH + kCols) * ld * 2 +
         (size_t)(kWordsH * kLdSc + kCols) * sizeof(float);
}

// An empty kernel: launched with a real kernel's grid, block and shared
// memory it reads the floor that any kernel of that shape pays.
__global__ void null_kernel() {}

template <typename Tin, typename Kern>
int launch(Kern kern, int words, int threads, size_t smem, const void* w,
           const void* v, const float* fm, const float* rm, float* a, int* idx,
           int I, int M, int T, int R, int E, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int fb = R > kCols ? 1 : kCols / R;
  const dim3 grid((T + fb - 1) / fb, (M + words - 1) / words, I);
  kern<<<grid, threads, smem, stream>>>(static_cast<const Tin*>(w),
                                        static_cast<const Tin*>(v), fm, rm, a,
                                        idx, M, T, R, E);
  return (int)cudaGetLastError();
}

// The kernel of these sizes for operands of type Tin.
template <typename Tin>
int run(const void* w, const void* v, const float* fm, const float* rm,
        float* a, int* idx, int I, int M, int T, int R, int E,
        cudaStream_t s) {
  if constexpr (sizeof(Tin) == 4) {
    return launch<float>(cross_mil_f32, kWordsF, kThreadsF, smem_f32(), w, v,
                         fm, rm, a, idx, I, M, T, R, E, s);
  } else {
    if (!in_envelope(false, E))
      return launch<Tin>(cross_mil_any<Tin>, kWordsH, kThreadsG,
                         smem_any_16(), w, v, fm, rm, a, idx, I, M, T, R, E,
                         s);
    return launch<Tin>(cross_mil_mma<Tin>, kWordsH, kThreadsH, smem_16(E), w,
                       v, fm, rm, a, idx, I, M, T, R, E, s);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// w [M, E] and v [I, T, R, E] are of the type of the dtype code: float* (0),
// __nv_bfloat16* (1) or __half* (2; any other code is refused); fm [I, T]
// and rm [I, T, R] (may be null: every region valid) are f32; a [I, M, T]
// f32 and idx [I, M, T] int32 are written whole. All tensors are
// contiguous; w and v are 16-byte aligned. Shapes in_envelope takes run the
// kernels above, every other the general variant. Limits (the grid's):
// R >= 1, E >= 1, I <= 65535, ceil(M / 32) <= 65535.
int nafae_cross_mil(const void* w, const void* v, int dtype, const float* fm,
                    const float* rm, float* a, int* idx, int I, int M, int T,
                    int R, int E, void* stream) {
  if (R < 1 || E < 1 || I < 0 || I > 65535 || M < 0 || T < 0 ||
      (M + kWordsF - 1) / kWordsF > 65535 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (I == 0 || M == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, (int)cudaErrorInvalidValue, [&](auto tag) {
    return run<decltype(tag)>(w, v, fm, rm, a, idx, I, M, T, R, E, s);
  });
}


// Launches an empty kernel with the grid, block size and dynamic shared
// memory that nafae_cross_mil would use for these sizes (the general
// variant's where it would take it): the launch floor the measured times are
// judged against. Same limits and return value.
int nafae_cross_mil_floor(int dtype, int I, int M, int T, int R, int E,
                          void* stream) {
  if (R < 1 || E < 1 || I < 1 || I > 65535 || M < 1 || T < 1 ||
      (M + kWordsF - 1) / kWordsF > 65535 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const bool wide = dtype == 0;               // f32 operands
  const bool spec = in_envelope(wide, E);
  const int words = wide ? kWordsF : kWordsH;
  const int threads = wide ? kThreadsF : spec ? kThreadsH : kThreadsG;
  const size_t smem = wide ? smem_f32() : spec ? smem_16(E) : smem_any_16();
  cudaError_t err = cudaFuncSetAttribute(
      null_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int fb = R > kCols ? 1 : kCols / R;
  const dim3 grid((T + fb - 1) / fb, (M + words - 1) / words, I);
  null_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
