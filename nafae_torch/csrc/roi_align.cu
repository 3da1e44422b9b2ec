// Separable bilinear RoIAlign for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nafae_tpu/ops/pallas/roi_align.py::_kernel (K5,
// called by roi_align_pallas :74). Same function as the port's plain version,
// nafae_torch/ops/kernels/roi_align.py::roi_align_plain:
//
//   out[n, p, q, c] = sum_h sum_w wy[p, h] * wx[q, w] * feat[f, h, w, c]
//
// for box n = f * R + r of frame f. wy [P, H] and wx [P, W] are the
// reference's _weights (roi_align.py:26-40): the box scaled by spatial_scale,
// extent = max(hi - lo, 1), cell = extent / P, sample points
// lo + (p + (s + 0.5) / sr) * cell clipped to [0, size - 1] after - 0.5, and
// the weight the mean over the sr samples of relu(1 - |pt - h|). They are
// built here in the reference's order of f32 operations (no FMA), and with
// 16-bit features (bf16 or f16) rounded to the features' type as the
// reference rounds them. Sums are f32 and the output is f32 in every dtype,
// [F * R, P, P, C]: a C5 head reads it as channels_last [N, C, P, P]
// without a copy. The kernel is a template on the features' type: f16 runs
// bf16's code, with its weights rounded to f16.
//
// Design: the TPU computes two dense MXU contractions over the whole map; here
// each output cell sums only over its support, at most 2 * sr rows and 2 * sr
// columns, and a frame's boxes share one staged copy of the frame's features.
// A block takes one frame and one slice of kSlice = 32 channels. It finds the
// rows and columns of the map that some box of the frame touches, copies that
// part for its channels into shared memory once (16-byte cp.async; scalar
// loads when C or the pointer is not 16-byte aligned) and computes all R boxes
// from it. Meanwhile one thread for each (box, axis, p) builds that output
// cell's weights sparsely in shared memory: the non-zero entries in increasing
// index, at most 2 * sr (the reference's order of f32 operations, no FMA).
// The work item is one output column (box, q). A team of 8 lanes takes it,
// each lane 4 channels (one 16-byte shared load a tap in f32, 8 bytes in
// 16 bits), with 7 x 4 register accumulators. For each p and each row h of p's
// entries, in increasing h, it forms st = sum_w wx[q, w] * feat[h, w, c] over
// q's entries in increasing w, then acc[p] = fmaf(wy[p, h], st, acc[p]): the
// reference's order (over w, then over h), so the output equals the earlier
// one-block-per-box design's bit for bit. Neighbouring p share rows when a
// box is small; the last two rows' st are kept and reused (the same sum, so
// the same bits). Each (p, q) of a box is one 128-byte store a team.
//
// Which sizes take which way. The touched part of a [40, 40] map (config 5) in
// a slice of 32 channels is at most 204,800 B in f32 and 102,400 B in 16
// bits and is staged whole, beside 10 KB of weights for 20 boxes: one block an SM in
// f32, two in 16 bits. Slices of 16 f32 channels (two blocks an SM, 64-byte
// segments) measured slower, as did 8 channels a lane and 256 or 512 threads;
// 384 threads are 48 teams, so 20 boxes' 140 items take 3 turns (PERF.md has
// the numbers). When the
// frame's touched part does not fit in the block's shared memory (above about
// 1,700 touched cells in f32, 3,400 in 16 bits), it is staged in bands of
// as many rows as fit, the teams carrying their accumulators across bands, once for
// each group of as many items as the block has teams. When the weights of all
// R boxes do not fit beside one row of the map (large sr or R), the boxes are
// taken in groups. A row of more than about 1,700 f32 columns does not fit
// with 32 channels: such maps (W up to kMaxSize) take slices of 16 channels.
//
// Bound on an H100 SXM (config 5: 320 frames of [40, 40, 1024] f32, 20 boxes a
// frame): the output alone is 6,400 x 49 x 1,024 x 4 B = 1.28 GB, 0.38 ms at
// 3.35 TB/s, plus the feature cells some box of a frame reads (at most the
// whole 2.1 GB of maps), each once; the products (16 a cell and channel) are
// far below. Bound by bytes. Behind that bound stands shared memory: every
// tap of every output is one shared load (up to 28 x 28 a box and channel).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ctx_mix_common.cuh"

namespace {

using nafae_ctx::cp_async;
using nafae_ctx::cp_async_commit;
using nafae_ctx::cp_async_wait;

constexpr int kP = 7;             // output grid (the detector's 7 x 7)
constexpr int kThreads = 384;     // 48 teams of 8 lanes: 140 items in 3 turns
constexpr int kMaxSize = 2048;    // largest H and W
constexpr int kMaxSr = 64;        // largest sampling ratio
constexpr int kSlice = 32;        // channels of a block
constexpr int kSliceWide = 16;    // ... for f32 rows too wide for kSlice
constexpr int kMaxDynSmem = 232448 - 1024;   // opt-in limit less the statics

// One axis of a box: the reference's _weights in its f32 order, for
// features of type Tin.
template <typename Tin>
struct Axis {
  float lo, cell, top;
  const float* off;   // [sr] sample offsets (s + 0.5) / sr within a cell
  int sr;

  // sample point s of output cell p, clipped to the map
  __device__ float point(int p, int s) const {
    const float pt =
        __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, off[s]), cell));
    return fminf(fmaxf(__fsub_rn(pt, 0.5f), 0.f), top);
  }
  // the weight of index h for output cell p, rounded to the features' type
  // (as the reference's astype(feat.dtype); identity for f32)
  __device__ float weight(int p, int h) const {
    float acc = 0.f;
    for (int s = 0; s < sr; ++s)
      acc = __fadd_rn(
          acc, fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(point(p, s), (float)h))),
                     0.f));
    const float w = __fdiv_rn(acc, (float)sr);
    return nafae_ctx::as_operand(w, static_cast<const Tin*>(nullptr));
  }
  // the indices that can carry a non-zero weight of cell p: [first, last]
  __device__ int first(int p) const { return (int)point(p, 0); }
  __device__ int last(int p) const {
    return min((int)point(p, sr - 1) + 1, (int)top);
  }
};

template <typename Tin>
__device__ __forceinline__ Axis<Tin> make_axis(float lo, float hi, int size,
                                               int sr, const float* off) {
  Axis<Tin> a;
  a.off = off;
  a.lo = lo;
  a.cell = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.f), (float)kP);
  a.top = (float)(size - 1);
  a.sr = sr;
  return a;
}

// Four consecutive channels of a staged cell as f32.
__device__ __forceinline__ float4 load_ch4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_ch4(const __nv_bfloat16* p) {
  return nafae_ctx::load4(p, 0);
}
__device__ __forceinline__ float4 load_ch4(const __half* p) {
  return nafae_ctx::load4(p, 0);
}

// s = fmaf(w, x, s) on four channels.
__device__ __forceinline__ void fma4(float w, const float4& x, float4& s) {
  s.x = fmaf(w, x.x, s.x);
  s.y = fmaf(w, x.y, s.y);
  s.z = fmaf(w, x.z, s.z);
  s.w = fmaf(w, x.w, s.w);
}

// 32-bit words of the sparse weights of one box: 2 * kP lists of K (index,
// weight) entries and their counts, padded to 16 bytes.
__host__ __device__ constexpr int box_list_ints(int K) {
  return (2 * kP * (2 * K + 1) + 3) & ~3;
}

// kTaps = 4: a list has at most 4 entries (sr <= 2) and the team keeps its
// q's entries in registers; kTaps = 0: any sr, entries read from shared memory.
template <typename Tin, int kCs, int kTaps>
__global__ void __launch_bounds__(kThreads, kCs * sizeof(Tin) <= 64 ? 2 : 1)
roi_align_kernel(const Tin* __restrict__ feat,     // [F, H, W, C]
                 const float* __restrict__ boxes,  // [F, R, 4] xyxy
                 float* __restrict__ out,          // [F * R, P, P, C]
                 int R, int H, int W, int C, float scale, int sr, int K,
                 int group, int tile_bytes, int vec, int slices,
                 long long blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kCell = kCs * (int)sizeof(Tin);    // bytes of a staged cell
  constexpr int kLanes = kCs / 4;                  // lanes of a team
  constexpr int kTeams = kThreads / kLanes;
  const long long bid = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (bid >= blocks) return;
  const size_t f = (size_t)(bid / slices);
  const int cb = (int)(bid % slices) * kCs;        // first channel

  // per box of the group: [2 * kP][K] indices, [2 * kP][K] weights,
  // [2 * kP] counts (lists 0..6 rows of p, 7..13 columns of q); then the tile
  int* lists = reinterpret_cast<int*>(smem_raw);
  const int per_box = box_list_ints(K);
  Tin* tile = reinterpret_cast<Tin*>(
      smem_raw + (((size_t)group * per_box * 4 + 15) & ~(size_t)15));
  __shared__ int reg[4];          // rows [0], [1] and columns [2], [3] staged
  __shared__ float offs[kMaxSr];  // the sample offsets, in the reference's f32
  if (threadIdx.x < sr)
    offs[threadIdx.x] = (float)((threadIdx.x + 0.5) / (double)sr);

  const int team = threadIdx.x / kLanes, tl = threadIdx.x % kLanes;
  const float* fbox = boxes + f * R * 4;
  const Tin* fmap = feat + f * (size_t)H * W * C;

  auto axes = [&](int r, Axis<Tin>& y, Axis<Tin>& x) {
    const float* b = fbox + r * 4;
    y = make_axis<Tin>(__fmul_rn(b[1], scale), __fmul_rn(b[3], scale), H, sr,
                       offs);
    x = make_axis<Tin>(__fmul_rn(b[0], scale), __fmul_rn(b[2], scale), W, sr,
                       offs);
  };
  // the rows and columns boxes [b0, b1) touch, into reg (all threads call)
  auto touched = [&](int b0, int b1) {
    __syncthreads();
    if (threadIdx.x == 0) {
      reg[0] = H; reg[1] = -1; reg[2] = W; reg[3] = -1;
    }
    __syncthreads();
    for (int r = b0 + threadIdx.x; r < b1; r += kThreads) {
      Axis<Tin> y, x;
      axes(r, y, x);
      atomicMin(&reg[0], y.first(0));
      atomicMax(&reg[1], y.last(kP - 1));
      atomicMin(&reg[2], x.first(0));
      atomicMax(&reg[3], x.last(kP - 1));
    }
    __syncthreads();
  };
  // rows [r0, r1] x columns [c0, c1] of the map, channels cb.., into the tile
  auto stage = [&](int r0, int r1, int c0, int c1) {
    const int ncols = c1 - c0 + 1, cells = (r1 - r0 + 1) * ncols;
    if (vec) {
      constexpr int kChunks = kCell / 16, kPer = 16 / (int)sizeof(Tin);
      // thread = (cell, 16-byte chunk of the cell); it walks the cells in
      // steps of kThreads / kChunks, keeping (h, w) without a division
      static_assert(kThreads % kChunks == 0, "whole cells a step");
      constexpr int kStep = kThreads / kChunks;
      const int ck = threadIdx.x % kChunks;
      int cell = threadIdx.x / kChunks;
      int h = r0 + cell / ncols, w = c0 + cell % ncols;
      if (cb + ck * kPer < C)
        for (; cell < cells; cell += kStep) {
          cp_async<16>(reinterpret_cast<unsigned char*>(tile) +
                           ((size_t)cell * kChunks + ck) * 16,
                       fmap + ((size_t)h * W + w) * C + cb + ck * kPer, 16);
          w += kStep;
          while (w > c1) {
            w -= ncols;
            ++h;
          }
        }
    } else {
      for (int i = threadIdx.x; i < cells * kCs; i += kThreads) {
        const int cell = i / kCs, c = cb + i % kCs;
        const int h = r0 + cell / ncols, w = c0 + cell % ncols;
        tile[i] = c < C ? fmap[((size_t)h * W + w) * C + c] : Tin(0.f);
      }
    }
    cp_async_commit();
  };

  touched(0, R);
  const int fr0 = reg[0], fr1 = reg[1], fc0 = reg[2], fc1 = reg[3];
  const bool whole =
      group >= R && (long long)(fr1 - fr0 + 1) * (fc1 - fc0 + 1) * kCell <=
                        (long long)tile_bytes;
  if (whole) stage(fr0, fr1, fc0, fc1);
  bool landed = false;            // the whole-frame copy has been waited for

  for (int g0 = 0; g0 < R; g0 += group) {
    const int nb = min(group, R - g0);
    __syncthreads();              // the last group's lists are read
    // one thread a list: the non-zero weights of (box, axis, p), in order
    for (int i = threadIdx.x; i < nb * 2 * kP; i += kThreads) {
      const int b = i / (2 * kP), l = i % (2 * kP);
      Axis<Tin> y, x;
      axes(g0 + b, y, x);
      const Axis<Tin>& ax = l < kP ? y : x;
      const int p = l < kP ? l : l - kP;
      int* li = lists + b * per_box + l * K;
      float* lw = reinterpret_cast<float*>(lists + b * per_box + 2 * kP * K) +
                  l * K;
      int n = 0;
      const int last = ax.last(p);
      for (int h = ax.first(p); h <= last; ++h) {
        const float wv = ax.weight(p, h);
        if (wv != 0.f && n < K) {
          li[n] = h;
          lw[n] = wv;
          ++n;
        }
      }
      lists[b * per_box + 4 * kP * K + l] = n;
    }
    int r0 = fr0, r1 = fr1, c0 = fc0, c1 = fc1;
    if (!whole) {
      touched(g0, g0 + nb);       // also orders the lists before their readers
      r0 = reg[0], r1 = reg[1], c0 = reg[2], c1 = reg[3];
    } else {
      __syncthreads();
    }
    const int ncols = c1 - c0 + 1;
    const int per = whole ? r1 - r0 + 1 : max(1, tile_bytes / (ncols * kCell));

    for (int it0 = 0; it0 < nb * kP; it0 += kTeams) {
      const int item = it0 + team;          // (box, q)
      const bool active = item < nb * kP;
      const int b = active ? item / kP : 0, q = item % kP;
      const int* bl = lists + b * per_box;
      const float* bw = reinterpret_cast<const float*>(bl + 2 * kP * K);
      const int* bn = bl + 4 * kP * K;
      const int* qi = bl + (kP + q) * K;
      const float* qw = bw + (kP + q) * K;
      const int nq = active ? bn[kP + q] : 0;
      int xo[kTaps ? kTaps : 1];            // q's columns, as tile offsets
      float xw[kTaps ? kTaps : 1];
#pragma unroll
      for (int e = 0; e < kTaps; ++e) {
        xo[e] = e < nq ? qi[e] * kCs : 0;
        xw[e] = e < nq ? qw[e] : 0.f;
      }
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      int ny[kP], ptr[kP];
      float4 acc[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        ny[p] = active ? bn[p] : 0;
        ptr[p] = 0;
        acc[p] = zero;
      }
      // the two rows summed last and their sums over w
      int h_a = -1, h_b = -1;
      float4 st_a = zero, st_b = zero;

      for (int band = r0; band <= r1; band += per) {
        const int band_end = min(band + per - 1, r1);
        if (!whole) {
          __syncthreads();                  // the last band is read
          stage(band, band_end, c0, c1);
          cp_async_wait(0);
          __syncthreads();
        } else if (!landed) {
          cp_async_wait(0);
          __syncthreads();
          landed = true;
        }
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          // one row h of p's entries: its sum over w, then into acc[p]
          auto use = [&](int h, float wy) {
            float4 st;
            if (h == h_a) {
              st = st_a;
            } else if (h == h_b) {
              st = st_b;
            } else {
              st = zero;
              const int row = ((h - band) * ncols - c0) * kCs + 4 * tl;
              if constexpr (kTaps > 0) {
#pragma unroll
                for (int e = 0; e < kTaps; ++e)
                  if (e < nq) fma4(xw[e], load_ch4(tile + (row + xo[e])), st);
              } else {
                for (int e = 0; e < nq; ++e)
                  fma4(qw[e], load_ch4(tile + (row + qi[e] * kCs)), st);
              }
            }
            if (h != h_a) {                 // keep the two latest rows
              h_b = h_a;
              st_b = st_a;
              h_a = h;
              st_a = st;
            }
            fma4(wy, st, acc[p]);
          };
          while (ptr[p] < ny[p]) {
            const int h = bl[p * K + ptr[p]];
            if (h > band_end) break;
            use(h, bw[p * K + ptr[p]]);
            ++ptr[p];
          }
        }
      }

      const int c = cb + 4 * tl;
      if (active && c < C) {
        float* o = out + ((f * R + g0 + b) * (size_t)kP * kP + q) * C + c;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          float* op = o + (size_t)p * kP * C;
          if (C % 4 == 0) {
            __stcs(reinterpret_cast<float4*>(op), acc[p]);
          } else {
            const float v4[4] = {acc[p].x, acc[p].y, acc[p].z, acc[p].w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (c + k < C) op[k] = v4[k];
          }
        }
      }
    }
  }
}

// Bytes of the sparse weights of `group` boxes, rounded to the tile's
// alignment.
size_t list_bytes(int group, int K) {
  return ((size_t)group * box_list_ints(K) * 4 + 15) & ~(size_t)15;
}

template <typename Tin, int kCs>
int launch(const void* feat, const float* boxes, float* out, int F, int R,
           int H, int W, int C, float scale, int sr, cudaStream_t stream) {
  const int K = std::min(2 * sr, std::max(H, W));
  auto kern = K <= 4 ? roi_align_kernel<Tin, kCs, 4>
                     : roi_align_kernel<Tin, kCs, 0>;
  const size_t cell = (size_t)kCs * sizeof(Tin);
  // all R boxes' weights if they leave room for one row of the map, else
  // groups of boxes; then the whole map if it fits
  int group = R;
  while (group > 1 && list_bytes(group, K) + W * cell > (size_t)kMaxDynSmem)
    group = (group + 1) / 2;
  if (list_bytes(group, K) + W * cell > (size_t)kMaxDynSmem)
    return (int)cudaErrorInvalidValue;
  const size_t tile = std::min((size_t)H * W * cell,
                               (size_t)kMaxDynSmem - list_bytes(group, K));
  const size_t smem = list_bytes(group, K) + tile;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (C + kCs - 1) / kCs;
  const long long blocks = (long long)F * slices;
  const unsigned gx = (unsigned)std::min<long long>(blocks, 1LL << 30);
  const unsigned gy = (unsigned)((blocks + gx - 1) / gx);
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                  ((size_t)C * sizeof(Tin)) % 16 == 0;
  kern<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const Tin*>(feat), boxes, out, R, H, W, C, scale, sr, K,
      group, (int)tile, vec, slices, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// feat [F, H, W, C] is of the type of the dtype code: float* (0),
// __nv_bfloat16* (1) or __half* (2; any other code is refused); boxes
// [F, R, 4] f32 in image coordinates; out [F * R, 7, 7, C] f32 is written
// whole. All contiguous.
// Limits: out_size 7, 1 <= sr <= 64, 1 <= H, W <= 2048, C >= 1,
// F * R < 2^31.
int nafae_roi_align(const void* feat, int dtype, const float* boxes,
                    float* out, int F, int R, int H, int W, int C, float scale,
                    int sr, void* stream) {
  if (F < 0 || R < 0 || H < 1 || W < 1 || H > kMaxSize || W > kMaxSize ||
      C < 1 || sr < 1 || sr > kMaxSr || (long long)F * R >= (1LL << 31) ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, kSlice>(feat, boxes, out, F, R, H, W, C, scale,
                                         sr, s);
  if (dtype == 2)
    return launch<__half, kSlice>(feat, boxes, out, F, R, H, W, C, scale, sr,
                                  s);
  // a row of the map must fit beside one team's weights
  const size_t row = (size_t)W * kSlice * sizeof(float);
  if (row + list_bytes(1, std::min(2 * sr, std::max(H, W))) <=
      (size_t)kMaxDynSmem)
    return launch<float, kSlice>(feat, boxes, out, F, R, H, W, C, scale, sr, s);
  return launch<float, kSliceWide>(feat, boxes, out, F, R, H, W, C, scale, sr,
                                   s);
}

}  // extern "C"
