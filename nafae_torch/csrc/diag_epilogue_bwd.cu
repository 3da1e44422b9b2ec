// Diagonal epilogue of the config-4 training step, backward: the gradients of
// diag_epilogue.cu's ctx and clu outputs with respect to the words and the
// regions, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nafae_tpu/ops/pallas/fused_diag.py::_bwd_kernel
// (K4b, via _diag_core_bwd). Same function as the port's plain version,
// nafae_torch/ops/kernels/diag.py::diag_bwd_plain. With the forward's
// residuals d = m ? s - sh : 0 [B, K, T, R], r* and c* [B, K, T] and its
// output f [B, T, K, E], per video b, word k, frame t:
//
//   ds[r]     = (2 dctx[k, t]) d[k, t, r]    (dctx and then ds rounded to bf16
//                                            in bf16 mode, as _bwd_kernel)
//   df        = (2 dclu[k, t]) (f[t, k] - C[c*])      (rounded to bf16 in bf16
//                                            mode; C[c*] too, as the forward)
//   dw[k]     = sum_t sum_r ds[r] v[t, r]
//   dv[t, r]  = sum_k ds[r] w[k] + sum_{k : r*[k, t] = r} df
//
// sh, the centers and both argmaxes are stop-gradients, as in the TPU kernel.
// The TPU kernel re-runs the whole forward (the scores, the selection and the
// cluster sims) to find these; here the forward kept d, r* and c*, so this
// kernel reads 0.2 MB of residuals (config4, f32) instead of re-reading u and
// recomputing 140 MFLOP. dw and dv are f32.
//
// Design: one launch, two kinds of block, grid (T + S, B), 256 threads.
//
//   dv     block (t, b), t < T, writes dv[b, t] whole and reads no v: the
//          video's words (f32), the frame's rounded df rows (f and C[c*]
//          read once) and ds [K, 32 regions], made once from d and dctx, sit
//          in shared memory; each thread takes two regions x 4 columns and
//          sums over the words in order, then adds the df of each word
//          whose r* is that region.
//   dw     block (T + s, b) writes columns [32 s, 32 s + 32) of dw[b] for
//          all K words: the product ds [K, T*R] . v[b] [T*R, E] of one
//          video on one column slice, so v is read once in all (S = E/32
//          slices). ds of 8 words x 512 rows at a time is staged in shared
//          memory (16 independent loads a row in flight); thread (row group
//          g, quad) takes the rows g, g + 32, ... with 8 words x 4 columns
//          of accumulators in registers, and the 32 row groups' sums meet
//          by shuffles within a warp and then across the 8 warps in a
//          fixed order.
//
// 448 blocks at config4 (320 dv + 128 dw), one wave at 4 blocks an SM (64
// registers a thread). No float atomics: every output has one writer and
// one order of summation, so the f32 gradient is the same on every run.
//
// These blocks take 1 <= K <= 32 and E a multiple of 4 up to 512 (the dv
// blocks stage the words and df rows whole, the dw blocks read 4-column
// quads). Every other shape (K > 32: long descriptions; E = 50, GloVe-50d's;
// E > 512) takes a general variant of the same two kinds of block,
// diag_bwd_any below, which reads elements one at a time and takes any K, E
// and R. It is a first, simple kernel; at R = 36, E = 1024 (K = 8) its bound
// is ~0.028 ms f32 and ~0.021 ms bf16.
//
// Bound on an H100 SXM (config4 training shapes B=16, K=8, T=20, R=20,
// E=256, f32): ~13 MB moved (v read and dv written, 6.6 MB each; w, f, d,
// the argmaxes and the cotangents), ~4 us at 3.35 TB/s, against 4*B*K*T*R*E
// = 52 MFLOP, ~0.8 us at 67 TFLOP/s: bound by bytes. These count every
// region as in the ctx mask; v is needed only where ds can be nonzero (the
// mask) and the centers only at c*, so chip_smoke.py counts the bound from a
// batch's masks. What is left above it: the launch and one block's chain
// (the staging loads, then the sums and dv's 20 KB of stores a frame).
// PERF.md has its measured times.

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;       // dv blocks: regions of a chunk
constexpr int kWords = 8;       // dw blocks: words of a pass
constexpr int kQuads = 8;       // dw blocks: 4-column quads of a slice
constexpr int kGroupsRows = kThreads / kQuads;   // dw blocks: 32 row groups
constexpr int kSpan = 512;      // dw blocks: rows (t, r) of ds staged at once

// dv of frame t: block (t, b).
template <typename Tin>
__device__ __forceinline__ void dv_block(
    float* __restrict__ smem, const Tin* __restrict__ w,
    const Tin* __restrict__ v, const float* __restrict__ centers,
    const float* __restrict__ dres, const int* __restrict__ rstar,
    const int* __restrict__ cstar, const float* __restrict__ f,
    const float* __restrict__ dctx, const float* __restrict__ dclu,
    float* __restrict__ dv, int b, int t, int K, int T, int R, int E) {
  const size_t bt = (size_t)b * T + t;
  const int e4 = E >> 2;
  float* ws = smem;                   // [K][E]      words
  float* dfs = ws + K * E;            // [K][E]      the cluster pull df
  float* dsm = dfs + K * E;           // [K][kRows]  ds of a chunk of regions
  float* g = dsm + K * kRows;         // [K]         2 dctx, dctx rounded
  int* rs = reinterpret_cast<int*>(g + K);    // [K] r*
  stage_frame(ws, w + (size_t)b * K * E, K, E, E);
  for (int p = threadIdx.x; p < K * e4; p += kThreads) {
    const int k = p / e4;
    const int q = p - k * e4;
    const size_t o = ((size_t)b * K + k) * T + t;
    const float s2 = 2.f * dclu[o];
    const float4 x = reinterpret_cast<const float4*>(f + (bt * K + k) * E)[q];
    const float4 c =
        reinterpret_cast<const float4*>(centers + (size_t)cstar[o] * E)[q];
    reinterpret_cast<float4*>(dfs + k * E)[q] = make_float4(
        as_operand(s2 * (x.x - as_operand(c.x, v)), v),
        as_operand(s2 * (x.y - as_operand(c.y, v)), v),
        as_operand(s2 * (x.z - as_operand(c.z, v)), v),
        as_operand(s2 * (x.w - as_operand(c.w, v)), v));
  }
  if ((int)threadIdx.x < K) {
    const size_t o = ((size_t)b * K + threadIdx.x) * T + t;
    g[threadIdx.x] = 2.f * as_operand(dctx[o], v);
    rs[threadIdx.x] = rstar[o];
  }
  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int rc = min(kRows, R - r0);
    __syncthreads();                  // g staged; the last chunk's readers done
    for (int p = threadIdx.x; p < K * rc; p += kThreads) {
      const int k = p / rc;
      const int j = p - k * rc;
      dsm[k * kRows + j] = as_operand(
          g[k] * dres[(((size_t)b * K + k) * T + t) * R + r0 + j], v);
    }
    __syncthreads();
    const int pairs = (rc + 1) >> 1;
    for (int p = threadIdx.x; p < pairs * e4; p += kThreads) {
      const int jp = p / e4;
      const int q = p - jp * e4;
      const int j0 = 2 * jp, j1 = j0 + 1;    // j1 < kRows: dsm has the slot
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      for (int k = 0; k < K; ++k) {
        const float4 x = lds4(ws + k * E, q);
        const float d0 = dsm[k * kRows + j0], d1 = dsm[k * kRows + j1];
        a0.x = fmaf(d0, x.x, a0.x);
        a0.y = fmaf(d0, x.y, a0.y);
        a0.z = fmaf(d0, x.z, a0.z);
        a0.w = fmaf(d0, x.w, a0.w);
        a1.x = fmaf(d1, x.x, a1.x);
        a1.y = fmaf(d1, x.y, a1.y);
        a1.z = fmaf(d1, x.z, a1.z);
        a1.w = fmaf(d1, x.w, a1.w);
      }
      for (int k = 0; k < K; ++k) {   // the cluster pull at r*, words in order
        const int hit = rs[k] - r0;
        if (hit == j0 || hit == j1) {
          const float4 df = lds4(dfs + k * E, q);
          if (hit == j0) {
            a0.x += df.x;
            a0.y += df.y;
            a0.z += df.z;
            a0.w += df.w;
          } else {
            a1.x += df.x;
            a1.y += df.y;
            a1.z += df.z;
            a1.w += df.w;
          }
        }
      }
      float4* out = reinterpret_cast<float4*>(dv + (bt * R + r0) * E);
      out[j0 * e4 + q] = a0;
      if (j1 < rc) out[j1 * e4 + q] = a1;
    }
  }
}

// dw of the column slice s (quads [8 s, 8 s + 8)) of video b: block (T + s, b).
template <typename Tin>
__device__ __forceinline__ void dw_block(
    float* __restrict__ smem, const Tin* __restrict__ v,
    const float* __restrict__ dres, const float* __restrict__ dctx,
    float* __restrict__ dw, int b, int s, int K, int T, int R, int E) {
  const int e4 = E >> 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qq = threadIdx.x & (kQuads - 1);
  const int grp = threadIdx.x / kQuads;
  const int q = s * kQuads + qq;
  const bool qok = q < e4;
  const int n_rows = T * R;
  const Tin* vb = v + (size_t)b * n_rows * E;
  float* dsv = smem;                      // [kWords][kSpan]
  float4* red = reinterpret_cast<float4*>(dsv + kWords * kSpan);
  //                                         [kWarps][kWords][kQuads]
  for (int k0 = 0; k0 < K; k0 += kWords) {
    float4 acc[kWords];
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk)
      acc[kk] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n0 = 0; n0 < n_rows; n0 += kSpan) {
      const int nc = min(kSpan, n_rows - n0);
      __syncthreads();                // the last span's readers are done
      // row j = threadIdx.x + 256 i of the span for the 8 words: 16
      // independent loads a row, one division
      for (int j = threadIdx.x; j < nc; j += kThreads) {
        const int n = n0 + j;
        const int tt = n / R;
        float x[kWords];
#pragma unroll
        for (int kk = 0; kk < kWords; ++kk) {
          const size_t bk = (size_t)b * K + min(k0 + kk, K - 1);
          x[kk] = as_operand(2.f * as_operand(dctx[bk * T + tt], v) *
                                 dres[bk * n_rows + n], v);
        }
#pragma unroll
        for (int kk = 0; kk < kWords; ++kk)
          dsv[kk * kSpan + j] = k0 + kk < K ? x[kk] : 0.f;
      }
      __syncthreads();
      if (qok) {
#pragma unroll 4
        for (int j = grp; j < nc; j += kGroupsRows) {
          const float4 x = load4(vb + (size_t)(n0 + j) * E, q);
#pragma unroll
          for (int kk = 0; kk < kWords; ++kk) {
            const float a = dsv[kk * kSpan + j];
            acc[kk].x = fmaf(a, x.x, acc[kk].x);
            acc[kk].y = fmaf(a, x.y, acc[kk].y);
            acc[kk].z = fmaf(a, x.z, acc[kk].z);
            acc[kk].w = fmaf(a, x.w, acc[kk].w);
          }
        }
      }
    }
    // the warp's 4 row groups (lane bits 3 and 4), then the 8 warps in order
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk) {
#pragma unroll
      for (int o = 8; o < 32; o <<= 1) {
        acc[kk].x += __shfl_xor_sync(0xffffffffu, acc[kk].x, o);
        acc[kk].y += __shfl_xor_sync(0xffffffffu, acc[kk].y, o);
        acc[kk].z += __shfl_xor_sync(0xffffffffu, acc[kk].z, o);
        acc[kk].w += __shfl_xor_sync(0xffffffffu, acc[kk].w, o);
      }
      if (lane < kQuads) red[(warp * kWords + kk) * kQuads + lane] = acc[kk];
    }
    __syncthreads();
    if (threadIdx.x < kWords * kQuads) {
      const int kk = threadIdx.x / kQuads;
      const int q2 = s * kQuads + (threadIdx.x & (kQuads - 1));
      float4 sum = red[kk * kQuads + (threadIdx.x & (kQuads - 1))];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) {
        const float4 x = red[(wi * kWords + kk) * kQuads +
                             (threadIdx.x & (kQuads - 1))];
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      if (k0 + kk < K && q2 < e4)
        reinterpret_cast<float4*>(dw + ((size_t)b * K + k0 + kk) * E)[q2] = sum;
    }
    __syncthreads();                  // red is read
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads, 4)
diag_bwd_kernel(const Tin* __restrict__ w,          // [B, K, E]
                const Tin* __restrict__ v,          // [B, T, R, E]
                const float* __restrict__ centers,  // [Kc, E]
                const float* __restrict__ dres,     // [B, K, T, R]
                const int* __restrict__ rstar,      // [B, K, T]
                const int* __restrict__ cstar,      // [B, K, T]
                const float* __restrict__ f,        // [B, T, K, E]
                const float* __restrict__ dctx,     // [B, K, T]
                const float* __restrict__ dclu,     // [B, K, T]
                float* __restrict__ dw,             // [B, K, E]
                float* __restrict__ dv,             // [B, T, R, E]
                int K, int T, int R, int E) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  if ((int)blockIdx.x < T)
    dv_block(smem, w, v, centers, dres, rstar, cstar, f, dctx, dclu, dv, b,
             blockIdx.x, K, T, R, E);
  else
    dw_block(smem, v, dres, dctx, dw, b, blockIdx.x - T, K, T, R, E);
}

// An empty kernel: launched with a real kernel's grid, block and shared
// memory it reads the floor that any kernel of that shape pays.
__global__ void null_kernel() {}

// Dynamic shared memory of one block, in bytes: the larger of the dv
// blocks' (135,424 B at K = 32, E = 512; 17,472 B at config4) and the dw
// blocks' (24,576 B).
size_t smem_bytes(int K, int E) {
  const size_t dv_part =
      (size_t)(2 * K * E + K * kRows + 2 * K) * sizeof(float);
  const size_t dw_part = (size_t)kWords * kSpan * sizeof(float) +
                         (size_t)kWarps * kWords * kQuads * sizeof(float4);
  return dv_part > dw_part ? dv_part : dw_part;
}

dim3 grid_of(int B, int T, int E) {
  return dim3(T + (E / 4 + kQuads - 1) / kQuads, B);
}

template <typename Tin>
int launch(const void* w, const void* v, const float* centers,
           const float* dres, const int* rstar, const int* cstar,
           const float* f, const float* dctx, const float* dclu, float* dw,
           float* dv, int B, int K, int T, int R, int E, cudaStream_t stream) {
  auto kern = diag_bwd_kernel<Tin>;
  const size_t smem = smem_bytes(K, E);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_of(B, T, E), kThreads, smem, stream>>>(
      static_cast<const Tin*>(w), static_cast<const Tin*>(v), centers, dres,
      rstar, cstar, f, dctx, dclu, dw, dv, K, T, R, E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general variant (diag_bwd_any), for every shape outside the kernel's
// envelope (in_envelope: K > 32, E not a multiple of 4, E > 512): the same
// two kinds of block in one launch, grid (T + S, B), 256 threads, elements
// read one at a time (no row needs any alignment) and nothing in shared
// memory that grows with K, E or R.
//
//   dv  block (t, b): regions 32 at a time; for each chunk of 32 words, ds
//       [32 words, 32 regions] is made in shared memory and thread p takes
//       elements (region, column) p, p + 256, ..., adding ds w of the
//       chunk's words in order to the partial sum it left in dv (the same
//       thread each chunk, so the sum over the words is one chain in word
//       order); then the df of each word whose r* is that region, in order.
//   dw  block (T + s, b), s = (word chunk of 8, column slice of 32): lane =
//       column, warp = row group; each thread sums 8 words over its rows
//       (t, r) = g, g + 8, ... of ds [8, 256 rows] staged at a time, and the
//       8 row groups' sums meet in shared memory in a fixed order.
//
// One writer an output, no float atomics, so two launches give the same
// bits.
constexpr int kGenThreads = 256;
constexpr int kGenWarps = kGenThreads / 32;
constexpr int kGenRows = 32;    // dv: regions of a chunk, and words of one
constexpr int kGenWords = 8;    // dw: words of a block
constexpr int kGenCols = 32;    // dw: columns of a block, one a lane
constexpr int kGenSpan = 256;   // dw: rows (t, r) of ds staged at once

template <typename Tin>
__device__ __forceinline__ void dv_any(
    float* __restrict__ smem, const Tin* __restrict__ w,
    const Tin* __restrict__ v, const float* __restrict__ centers,
    const float* __restrict__ dres, const int* __restrict__ rstar,
    const int* __restrict__ cstar, const float* __restrict__ f,
    const float* __restrict__ dctx, const float* __restrict__ dclu,
    float* __restrict__ dv, int b, int t, int K, int T, int R, int E) {
  const size_t bt = (size_t)b * T + t;
  float* dsm = smem;                          // [kGenRows][kGenRows] ds
  float* s2 = dsm + kGenRows * kGenRows;      // [kGenRows] 2 dclu
  int* rs = reinterpret_cast<int*>(s2 + kGenRows);   // [kGenRows] r* - r0
  int* cs = rs + kGenRows;                    // [kGenRows] c*
  for (int r0 = 0; r0 < R; r0 += kGenRows) {
    const int rc = min(kGenRows, R - r0);
    float* out = dv + (bt * R + r0) * E;      // the chunk's rows of dv
    for (int k0 = 0; k0 < K; k0 += kGenRows) {   // sum_k ds w, words in order
      const int kc = min(kGenRows, K - k0);
      __syncthreads();                        // dsm is read
      for (int p = threadIdx.x; p < kc * rc; p += blockDim.x) {
        const int kk = p / rc, j = p - kk * rc;
        const size_t o = ((size_t)b * K + k0 + kk) * T + t;
        dsm[kk * kGenRows + j] =
            as_operand(2.f * as_operand(dctx[o], v) * dres[o * R + r0 + j], v);
      }
      __syncthreads();
      for (int p = threadIdx.x; p < rc * E; p += blockDim.x) {
        const int j = p / E, e = p - j * E;
        float acc = k0 ? out[p] : 0.f;
        for (int kk = 0; kk < kc; ++kk)
          acc = fmaf(dsm[kk * kGenRows + j],
                     load1(w + ((size_t)b * K + k0 + kk) * E + e), acc);
        out[p] = acc;
      }
    }
    for (int k0 = 0; k0 < K; k0 += kGenRows) {   // the cluster pull at r*
      const int kc = min(kGenRows, K - k0);
      __syncthreads();                        // rs, cs and s2 are read
      if ((int)threadIdx.x < kc) {
        const size_t o = ((size_t)b * K + k0 + threadIdx.x) * T + t;
        rs[threadIdx.x] = rstar[o] - r0;
        cs[threadIdx.x] = cstar[o];
        s2[threadIdx.x] = 2.f * dclu[o];
      }
      __syncthreads();
      for (int p = threadIdx.x; p < rc * E; p += blockDim.x) {
        const int j = p / E, e = p - j * E;
        float acc = out[p];
        for (int kk = 0; kk < kc; ++kk)
          if (rs[kk] == j)
            acc += as_operand(
                s2[kk] * (f[(bt * K + k0 + kk) * E + e] -
                          as_operand(centers[(size_t)cs[kk] * E + e], v)),
                v);
        out[p] = acc;
      }
    }
  }
}

template <typename Tin>
__device__ __forceinline__ void dw_any(
    float* __restrict__ smem, const Tin* __restrict__ v,
    const float* __restrict__ dres, const float* __restrict__ dctx,
    float* __restrict__ dw, int b, int s, int K, int T, int R, int E) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slices = (E + kGenCols - 1) / kGenCols;
  const int k0 = s / slices * kGenWords;
  const int kw = min(kGenWords, K - k0);
  const int e = (s % slices) * kGenCols + lane;
  const int n_rows = T * R;
  const Tin* vb = v + (size_t)b * n_rows * E;
  float* dsv = smem;                          // [kGenWords][kGenSpan]
  float* red = dsv + kGenWords * kGenSpan;    // [kGenWarps][kGenWords][32]
  float acc[kGenWords];
#pragma unroll
  for (int kk = 0; kk < kGenWords; ++kk) acc[kk] = 0.f;
  for (int n0 = 0; n0 < n_rows; n0 += kGenSpan) {
    const int nc = min(kGenSpan, n_rows - n0);
    __syncthreads();                          // the last span is read
    for (int j = threadIdx.x; j < nc; j += blockDim.x) {
      const int n = n0 + j, tt = n / R;
#pragma unroll
      for (int kk = 0; kk < kGenWords; ++kk) {
        const size_t bk = (size_t)b * K + k0 + min(kk, kw - 1);
        dsv[kk * kGenSpan + j] =
            kk < kw ? as_operand(2.f * as_operand(dctx[bk * T + tt], v) *
                                     dres[bk * n_rows + n], v)
                    : 0.f;
      }
    }
    __syncthreads();
    if (e < E) {
      for (int j = warp; j < nc; j += kGenWarps) {
        const float x = load1(vb + (size_t)(n0 + j) * E + e);
#pragma unroll
        for (int kk = 0; kk < kGenWords; ++kk)
          acc[kk] = fmaf(dsv[kk * kGenSpan + j], x, acc[kk]);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < kGenWords; ++kk)
    red[(warp * kGenWords + kk) * 32 + lane] = acc[kk];
  __syncthreads();
  const int kk = threadIdx.x >> 5;            // word kk, column lane
  if (kk < kw && e < E) {
    float sum = red[kk * 32 + lane];
#pragma unroll
    for (int g = 1; g < kGenWarps; ++g)
      sum += red[(g * kGenWords + kk) * 32 + lane];
    dw[((size_t)b * K + k0 + kk) * E + e] = sum;
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kGenThreads)
diag_bwd_any(const Tin* __restrict__ w, const Tin* __restrict__ v,
             const float* __restrict__ centers,
             const float* __restrict__ dres, const int* __restrict__ rstar,
             const int* __restrict__ cstar, const float* __restrict__ f,
             const float* __restrict__ dctx, const float* __restrict__ dclu,
             float* __restrict__ dw, float* __restrict__ dv, int K, int T,
             int R, int E) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  if ((int)blockIdx.x < T)
    dv_any(smem, w, v, centers, dres, rstar, cstar, f, dctx, dclu, dv, b,
           blockIdx.x, K, T, R, E);
  else
    dw_any(smem, v, dres, dctx, dw, b, blockIdx.x - T, K, T, R, E);
}

// Whether diag_bwd_kernel takes these sizes; every other takes diag_bwd_any.
bool in_envelope(int K, int E) {
  return K <= 32 && E >= 4 && E % 4 == 0 && E <= 512;
}

// The general variant's shared memory (the larger of its blocks', the dw
// blocks': 16,384 B) and grid.
size_t smem_any() {
  const size_t dv_part = (size_t)(kGenRows * kGenRows + 3 * kGenRows) * 4;
  const size_t dw_part =
      (size_t)(kGenWords * kGenSpan + kGenWarps * kGenWords * 32) * 4;
  return dv_part > dw_part ? dv_part : dw_part;
}

dim3 grid_any(int B, int K, int T, int E) {
  return dim3(T + (K + kGenWords - 1) / kGenWords *
                      ((E + kGenCols - 1) / kGenCols),
              B);
}

template <typename Tin>
int launch_any(const void* w, const void* v, const float* centers,
               const float* dres, const int* rstar, const int* cstar,
               const float* f, const float* dctx, const float* dclu,
               float* dw, float* dv, int B, int K, int T, int R, int E,
               cudaStream_t stream) {
  auto kern = diag_bwd_any<Tin>;
  const size_t smem = smem_any();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_any(B, K, T, E), kGenThreads, smem, stream>>>(
      static_cast<const Tin*>(w), static_cast<const Tin*>(v), centers, dres,
      rstar, cstar, f, dctx, dclu, dw, dv, K, T, R, E);
  return (int)cudaGetLastError();
}

// Limits: the grid's (B <= 65535) and sizes of at least 1.
bool bad_sizes(int B, int K, int T, int R, int E) {
  return K < 1 || R < 1 || E < 1 || B < 0 || B > 65535 || T < 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// w [B, K, E] and v [B, T, R, E] are float* when is_bf16 == 0 and
// __nv_bfloat16* otherwise; centers [Kc, E], dres [B, K, T, R], f
// [B, T, K, E], dctx and dclu [B, K, T] are f32, rstar and cstar [B, K, T]
// int32 (the forward's). Written whole: dw [B, K, E] and dv [B, T, R, E],
// f32. All tensors are contiguous; w, v, centers, f, dw and dv are 16-byte
// aligned. Shapes in_envelope takes run the kernel above, every other the
// general variant. Limits: K, R, E >= 1, B <= 65535.
int nafae_diag_bwd(const void* w, const void* v, int is_bf16,
                   const float* centers, const float* dres, const int* rstar,
                   const int* cstar, const float* f, const float* dctx,
                   const float* dclu, float* dw, float* dv, int B, int K,
                   int T, int R, int E, void* stream) {
  if (bad_sizes(B, K, T, R, E)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_envelope(K, E))
    return is_bf16
        ? launch_any<__nv_bfloat16>(w, v, centers, dres, rstar, cstar, f,
                                    dctx, dclu, dw, dv, B, K, T, R, E, s)
        : launch_any<float>(w, v, centers, dres, rstar, cstar, f, dctx, dclu,
                            dw, dv, B, K, T, R, E, s);
  return is_bf16
      ? launch<__nv_bfloat16>(w, v, centers, dres, rstar, cstar, f, dctx,
                              dclu, dw, dv, B, K, T, R, E, s)
      : launch<float>(w, v, centers, dres, rstar, cstar, f, dctx, dclu, dw,
                      dv, B, K, T, R, E, s);
}

// Launches an empty kernel with the grid, block size and dynamic shared
// memory that nafae_diag_bwd would use for these sizes (the general
// variant's where it would take it): the launch floor the measured times are
// judged against. Same limits and return value.
int nafae_diag_bwd_floor(int is_bf16, int B, int K, int T, int R, int E,
                         void* stream) {
  (void)is_bf16;
  if (bad_sizes(B, K, T, R, E) || B < 1) return (int)cudaErrorInvalidValue;
  const bool spec = in_envelope(K, E);
  const size_t smem = spec ? smem_bytes(K, E) : smem_any();
  cudaError_t err = cudaFuncSetAttribute(
      null_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  null_kernel<<<spec ? grid_of(B, T, E) : grid_any(B, K, T, E),
                spec ? kThreads : kGenThreads, smem,
                static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
