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
//   ds[r]     = (2 dctx[k, t]) d[k, t, r]    (dctx and then ds rounded to the
//                                            16-bit type in bf16 or f16 mode,
//                                            as _bwd_kernel; f16 subnormals
//                                            kept, no flush to zero)
//   df        = (2 dclu[k, t]) (f[t, k] - C[c*])      (rounded the same way;
//                                            C[c*] too, as the forward)
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
// diag_bwd_any below, which takes any K, E and R: rows of any alignment
// staged by cp.async in 64-column stages, dv written once from registers,
// and v read once, only at the ctx mask's rows, by clusters of dw blocks.
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
// envelope (in_envelope: K > 32, E not a multiple of 4, E > 512): one
// launch of two kinds of block, 256 threads, a 1-D grid of the dw blocks
// first (the longer ones, dispatched first), then the dv blocks. Rows of
// any alignment are staged by cp.async in stages of 64 columns (the widest
// copy a row allows, as stage_tile_any); every output has one writer and
// one order of sums (no float atomics), so two launches give the same bits.
//
//   dw  block (64-column slice, video b, part of its rows), up to 64 words
//       a pass (K = 40 in one): v[b] is read once a pass, and only at the
//       rows (t, r) where some word's d is nonzero (d is zero off the ctx
//       mask, so ds is, and such a row adds nothing). A thread a row scans
//       d, up to 1024 rows before a stream; a ballot and a prefix list the
//       live rows, and ds of the pass's words is made once for each
//       (rounded where the reference rounds it) into shared memory. The
//       listed rows of v stream through a ring of kDwStages stages of 32
//       rows. Thread (quad, word octet, row group) sums 8 words x 4 columns
//       over its rows on CUDA cores, in 16 bits too (2 B K T R E = 94 MFLOP at
//       R = 36, E = 1024: 1.4 us at the f32 rate), and the row groups' sums
//       meet in shared memory in a fixed order. Where the grid would have
//       fewer than kDwBlocksMin dw blocks (E = 50: 16), P = 2, 4 or 8 blocks
//       split each video's rows, one thread block cluster; each sends its
//       sums into block 0's shared memory, which adds them in order of part.
//   dv  block (frame (b, t), 256 columns; 64 past 64 words): ds [words, 16
//       RPT regions] is made once into shared memory; the rows of w[b],
//       f[b, t] and C[c*] of the pass's words stream through a ring of
//       64-column stages. Thread (quad, region group) keeps RPT regions x 4
//       columns in registers over the words (in order), adds the df of each
//       word whose r* is one of its regions (in order), and stores the tile
//       once with the widest store the row allows: dv is written once and
//       never read. Past 64 words the block's one stage carries the
//       registers from pass to pass; past 64 regions, tiles in turn.
//
// Bound at R = 36, E = 1024 (B = 16, K = 8, T = 20, the first batch's
// masks): ~0.025 ms f32, ~0.021 ms bf16 (dv written whole, 47.2 MB f32; f
// read whole, 10.5 MB; v at the ctx mask; chip_smoke.py counts it). What is
// left above it: most of a dv block's time goes to its stores (its stages
// are short bursts between set-ups), the dw blocks' chains of scans and
// streams hold slots the dv blocks could use, and at K = 40 the dv blocks'
// sums are bound by instructions. PERF.md has the measured times.
constexpr int kGenThreads = 256;
constexpr int kGenCols = 64;      // columns of a stage: 16 quads
constexpr int kGenWords = 64;     // words of a pass
constexpr int kDvSlice = 256;     // dv: columns of a block, up to 64 words
constexpr int kDwRows = 32;       // dw: rows of v a stage
constexpr int kDwStages = 3;      // dw: the ring
constexpr int kScan = kGenThreads;   // dw: rows scanned at once, one a thread
constexpr int kDwBlocksMin = 64;     // dw: blocks wanted, parts of a video's
constexpr int kDwPartsMax = 8;       // ... rows (a cluster) to reach them
constexpr int kDwRecv = 16384;       // dw: bytes of the parts' sums, at most

// Thread block clusters (Hopper): this block's rank in its cluster, a
// barrier of all the cluster's threads (their writes to shared memory
// visible to all of them after it), and a store into another block's
// shared memory.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void st_cluster(float* p, unsigned rank, float x) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(r), "f"(x)
               : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Rows [0, rows) of kGenCols columns from col0 of the E-element rows row(i)
// into shared rows of stride ld, zero past E: stage_tile_any for rows that
// are not one array's (the rows' bases are as aligned as E allows, the
// array's base 16 bytes). Block-uniform; the caller commits and waits.
template <typename T, typename RowOf>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, int rows,
                                           int E, int col0, int ld,
                                           RowOf row) {
  constexpr int kSz = (int)sizeof(T);
  const int row_bytes = E * kSz;
  const int vec = row_bytes % 16 == 0 ? 16 / kSz
                  : row_bytes % 8 == 0 ? 8 / kSz
                  : row_bytes % 4 == 0 ? 4 / kSz : 0;
  if (vec == 0) {                                // plain loads (bf16, odd E)
    for (int p = threadIdx.x; p < rows * kGenCols; p += blockDim.x) {
      const int r = p / kGenCols, k = p - r * kGenCols;
      store_as(dst + r * ld + k,
               col0 + k < E ? load1(row(r) + col0 + k) : 0.f);
    }
    return;
  }
  const int sh = __ffs(kGenCols / vec) - 1;      // chunks a row: 2^sh
  for (int p = threadIdx.x; p < rows << sh; p += blockDim.x) {
    const int r = p >> sh, k = (p & ((1 << sh) - 1)) * vec;
    const bool ok = col0 + k < E;
    const T* src = row(r) + (ok ? col0 + k : 0);
    T* d = dst + r * ld + k;
    if (vec * kSz == 16) cp_async<16>(d, src, ok ? 16 : 0);
    else if (vec * kSz == 8) cp_async<8>(d, src, ok ? 8 : 0);
    else cp_async<4>(d, src, ok ? 4 : 0);
  }
}

// Columns e.. e + 3 of an f32 row of E (those below E), with the widest
// store the row allows (rows are 16-byte aligned at E % 4 == 0, 8-byte at
// E % 2 == 0; e is a multiple of 4), marked streaming (evict first: dv is
// written once, and at R = 36, E = 1024 it nearly fills L2).
__device__ __forceinline__ void store_quad(float* __restrict__ row, int e,
                                           int E, float4 a) {
  if (E % 4 == 0) {
    if (e < E) __stcs(reinterpret_cast<float4*>(row + e), a);
  } else if (E % 2 == 0) {
    if (e < E)
      __stcs(reinterpret_cast<float2*>(row + e), make_float2(a.x, a.y));
    if (e + 2 < E)
      __stcs(reinterpret_cast<float2*>(row + e + 2), make_float2(a.z, a.w));
  } else {
    if (e < E) __stcs(row + e, a.x);
    if (e + 1 < E) __stcs(row + e + 1, a.y);
    if (e + 2 < E) __stcs(row + e + 2, a.z);
    if (e + 3 < E) __stcs(row + e + 3, a.w);
  }
}

// The dv blocks' ring: its stages and the bytes of a stage of kp words (the
// rows of w in the input's type, of f and C[c*] in f32, 64 columns each,
// unpadded: the whole block reads one row at a time).
__host__ __device__ constexpr int dv_stages(int kp) { return kp <= 16 ? 3 : 2; }

template <typename Tin>
__host__ __device__ constexpr int dv_stage_bytes(int kp) {
  return kp * kGenCols * ((int)sizeof(Tin) + 2 * (int)sizeof(float));
}

// Rows of v a dw block scans before it streams the live ones (ds of at most
// 32 KB up to 32 words a pass): 1024 for a pass of up to 8 words, 512 of
// 16, else 256.
__host__ __device__ constexpr int dw_chunk(int kp8) {
  return kp8 <= 8 ? 4 * kScan : kp8 <= 16 ? 2 * kScan : kScan;
}

// The dw blocks' shared memory of a pass of kp8 words: ds of the scanned
// rows, the list of the live ones, the ring (and, over them, the row
// groups' sums, at most 32 KB).
template <typename Tin>
__host__ __device__ constexpr int dw_bytes(int kp8) {
  return dw_chunk(kp8) * (kp8 + 1) * (int)sizeof(float) +
         kDwStages * kDwRows * stage_ld<Tin>(kGenCols) * (int)sizeof(Tin);
}

// Where block 0 of a cluster receives the parts' sums [P][kp][64]: past
// what any pass of K words uses otherwise.
template <typename Tin>
__host__ __device__ constexpr int dw_recv_at(int K) {
  return dw_bytes<Tin>(((K < kGenWords ? K : kGenWords) + 7) & ~7) > 32768
             ? dw_bytes<Tin>(((K < kGenWords ? K : kGenWords) + 7) & ~7)
             : 32768;
}

// dv of frame bt = (b, t), columns [c_begin, c_begin + slice): RPT regions
// of each 16 a thread (a tile of 16 RPT regions).
template <typename Tin, int RPT>
__device__ __forceinline__ void dv_any(
    unsigned char* __restrict__ smem, const Tin* __restrict__ w,
    const float* __restrict__ centers, const float* __restrict__ dres,
    const int* __restrict__ rstar, const int* __restrict__ cstar,
    const float* __restrict__ f, const float* __restrict__ dctx,
    const float* __restrict__ dclu, float* __restrict__ dv, size_t bt,
    int c_begin, int slice, int K, int T, int R, int E) {
  constexpr int RT = 16 * RPT;                   // regions of a tile
  const Tin* tag = nullptr;                      // picks as_operand's dtype
  const int b = (int)(bt / T), t = (int)(bt - (size_t)b * T);
  const int nst = (min(slice, E - c_begin) + kGenCols - 1) / kGenCols;
  const int q = threadIdx.x & 15, g = threadIdx.x >> 4;
  float4 acc[RPT];
  for (int r0 = 0; r0 < R; r0 += RT) {
    const int rc = min(RT, R - r0);
    for (int k0 = 0; k0 < K; k0 += kGenWords) {  // past 64 words nst == 1
      const int kp = min(kGenWords, K - k0);
      const int S = dv_stages(kp);
      const int sbytes = dv_stage_bytes<Tin>(kp);
      float* ds_s = reinterpret_cast<float*>(smem + S * sbytes);  // [kp][RT]
      int* rs_s = reinterpret_cast<int*>(ds_s + kp * RT);          // r* - r0
      int* cs_s = rs_s + kp;                                       // c*
      float* s2_s = reinterpret_cast<float*>(cs_s + kp);           // 2 dclu
      __syncthreads();                  // the last tile's or pass's reads
      for (int kk = threadIdx.x; kk < kp; kk += blockDim.x) {
        const size_t o = ((size_t)b * K + k0 + kk) * T + t;
        rs_s[kk] = rstar[o] - r0;
        cs_s[kk] = cstar[o];
        s2_s[kk] = 2.f * dclu[o];
      }
      __syncthreads();
      const Tin* wk = w + ((size_t)b * K + k0) * E;
      const float* fk = f + (bt * K + k0) * E;
      auto stage = [&](int ks) {                 // one group a stage
        if (ks < nst) {
          unsigned char* d = smem + (ks % S) * sbytes;
          float* F = reinterpret_cast<float*>(d + kp * kGenCols * sizeof(Tin));
          const int col = c_begin + ks * kGenCols;
          stage_tile_any(reinterpret_cast<Tin*>(d), wk, kp, kp, E, col,
                         kGenCols, kGenCols);
          stage_tile_any(F, fk, kp, kp, E, col, kGenCols, kGenCols);
          stage_rows(F + kp * kGenCols, kp, E, col, kGenCols, [&](int i) {
            return centers + (size_t)cs_s[i] * E;
          });
        }
        cp_async_commit();
      };
      for (int ks = 0; ks < S - 1; ++ks) stage(ks);
      // ds while the first stages fly
      for (int p = threadIdx.x; p < kp * RT; p += blockDim.x) {
        const int kk = p / RT, j = p - kk * RT;
        const size_t o = ((size_t)b * K + k0 + kk) * T + t;
        ds_s[p] = j < rc ? as_operand(2.f * as_operand(dctx[o], tag) *
                                          dres[o * R + r0 + j], tag)
                         : 0.f;
      }
      for (int ks = 0; ks < nst; ++ks) {
        cp_async_wait(S - 2);                    // stage ks; later ones fly
        __syncthreads();                         // ... for all; ks - 1 read
        stage(ks + S - 1);                       // into the slot of ks - 1
        const unsigned char* d = smem + (ks % S) * sbytes;
        const Tin* W = reinterpret_cast<const Tin*>(d);
        const float* F =
            reinterpret_cast<const float*>(d + kp * kGenCols * sizeof(Tin));
        const float* C = F + kp * kGenCols;
        if (k0 == 0) {
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        for (int kk = 0; kk < kp; ++kk) {        // sum_k ds w, words in order
          const float4 x = lds4(W + kk * kGenCols, q);
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            fma4(acc[i], ds_s[kk * RT + g + 16 * i], x);
        }
        for (int kk = 0; kk < kp; ++kk) {        // the cluster pull at r*
          const int j = rs_s[kk];
          if ((unsigned)j >= (unsigned)RT || (j & 15) != g) continue;
          const float4 fx = lds4(F + kk * kGenCols, q);
          const float4 cx = lds4(C + kk * kGenCols, q);
          const float s2 = s2_s[kk];
          const float4 df = make_float4(
              as_operand(s2 * (fx.x - as_operand(cx.x, tag)), tag),
              as_operand(s2 * (fx.y - as_operand(cx.y, tag)), tag),
              as_operand(s2 * (fx.z - as_operand(cx.z, tag)), tag),
              as_operand(s2 * (fx.w - as_operand(cx.w, tag)), tag));
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            if (j == g + 16 * i) {
              acc[i].x += df.x;
              acc[i].y += df.y;
              acc[i].z += df.z;
              acc[i].w += df.w;
            }
        }
        if (k0 + kGenWords >= K) {               // the last pass: store
          const int e = c_begin + ks * kGenCols + 4 * q;
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int j = g + 16 * i;
            if (j < rc) store_quad(dv + (bt * R + r0 + j) * E, e, E, acc[i]);
          }
        }
      }
    }
  }
}

// dw of the 64-column slice s of video b, part `part` of P of its rows (wcnt:
// [4][8] ints). The P parts are one cluster; their sums meet in the end.
template <typename Tin>
__device__ __forceinline__ void dw_any(
    unsigned char* __restrict__ smem, int* __restrict__ wcnt,
    const Tin* __restrict__ v, const float* __restrict__ dres,
    const float* __restrict__ dctx, float* __restrict__ dw, int b, int s,
    int part, int P, int K, int T, int R, int E) {
  constexpr int ldv = stage_ld<Tin>(kGenCols);
  constexpr int kWarps = kGenThreads / 32;
  const Tin* tag = nullptr;
  const int col0 = s * kGenCols;
  const int N = T * R;                           // rows (t, r) of the video
  const int per = (N + P - 1) / P;               // rows of a part
  const int n_lo = min(N, part * per), n_hi = min(N, n_lo + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = threadIdx.x & 15, rest = threadIdx.x >> 4;
  const Tin* vb = v + (size_t)b * N * E;
  float* recv = reinterpret_cast<float*>(smem + dw_recv_at<Tin>(K));
  for (int k0 = 0; k0 < K; k0 += kGenWords) {
    const int kp = min(kGenWords, K - k0);
    const int oct = (kp + 7) >> 3, kp8 = oct * 8;
    const int nrg = 16 / oct;                    // row groups
    const int oc = rest % oct, rg = rest / oct;  // word octet, row group
    const bool on = rg < nrg;
    const int ch = dw_chunk(kp8), nsub = ch / kScan;
    float* dsl = reinterpret_cast<float*>(smem);       // [ch][kp8] ds
    int* list = reinterpret_cast<int*>(dsl + ch * kp8);  // [ch] live rows
    Tin* ring = reinterpret_cast<Tin*>(list + ch);     // [stages][32][ldv]
    const float* dk = dres + ((size_t)b * K + k0) * N;   // the pass's d
    const float* gk = dctx + ((size_t)b * K + k0) * T;
    float4 acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n0 = n_lo; n0 < n_hi; n0 += ch) {
      __syncthreads();                 // the last chunk's or pass's reads
      // scan rows n0 + i, i = sub 256 + thread: ds of the pass's words
      // (each row's at i), and whether any d is nonzero
      unsigned bal[4];
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        bal[sub] = 0u;
        if (sub >= nsub) continue;               // block-uniform
        const int i = sub * kScan + threadIdx.x;
        const int n = n0 + i;
        bool live = false;
        if (n < n_hi) {
          const int t = n / R;
          float* row = dsl + i * kp8;
#pragma unroll 2
          for (int o8 = 0; o8 < kp8; o8 += 8) {
            float x[8];
#pragma unroll
            for (int z = 0; z < 8; ++z) {
              const int kk = o8 + z;
              const float dd = kk < kp ? dk[(size_t)kk * N + n] : 0.f;
              const float g2 = kk < kp ? gk[(size_t)kk * T + t] : 0.f;
              live |= dd != 0.f;
              x[z] = as_operand(2.f * as_operand(g2, tag) * dd, tag);
            }
            *reinterpret_cast<float4*>(row + o8) =
                make_float4(x[0], x[1], x[2], x[3]);
            *reinterpret_cast<float4*>(row + o8 + 4) =
                make_float4(x[4], x[5], x[6], x[7]);
          }
        }
        bal[sub] = __ballot_sync(0xffffffffu, live);
        if (lane == 0) wcnt[sub * kWarps + warp] = __popc(bal[sub]);
      }
      __syncthreads();
      // the list of the live rows, in order of row
      int nl = 0;
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        if (sub >= nsub) continue;
        int slot = nl + __popc(bal[sub] & ((1u << lane) - 1u));
#pragma unroll
        for (int i = 0; i < kWarps; ++i) {
          if (i < warp) slot += wcnt[sub * kWarps + i];
          nl += wcnt[sub * kWarps + i];
        }
        if ((bal[sub] >> lane) & 1u) list[slot] = sub * kScan + threadIdx.x;
      }
      __syncthreads();                           // the list is written
      // the listed rows of v, 32 a stage
      const int nst = (nl + kDwRows - 1) / kDwRows;
      auto stage = [&](int ks) {                 // one group a stage
        if (ks < nst) {
          const int* at = list + ks * kDwRows;
          stage_rows(ring + (ks % kDwStages) * kDwRows * ldv,
                     min(kDwRows, nl - ks * kDwRows), E, col0, ldv,
                     [&](int i) { return vb + (size_t)(n0 + at[i]) * E; });
        }
        cp_async_commit();
      };
      for (int ks = 0; ks < kDwStages - 1; ++ks) stage(ks);
      for (int ks = 0; ks < nst; ++ks) {
        cp_async_wait(kDwStages - 2);            // stage ks; later ones fly
        __syncthreads();                         // ... for all; ks - 1 read
        stage(ks + kDwStages - 1);               // into the slot of ks - 1
        if (!on) continue;
        const Tin* V = ring + (ks % kDwStages) * kDwRows * ldv;
        const int* at = list + ks * kDwRows;
        const int rows = min(kDwRows, nl - ks * kDwRows);
        for (int j = rg; j < rows; j += nrg) {
          const float4 x = lds4(V + j * ldv, q);
          const float* a = dsl + at[j] * kp8 + oc * 8;
          const float4 a0 = *reinterpret_cast<const float4*>(a);
          const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
          fma4(acc[0], a0.x, x);
          fma4(acc[1], a0.y, x);
          fma4(acc[2], a0.z, x);
          fma4(acc[3], a0.w, x);
          fma4(acc[4], a1.x, x);
          fma4(acc[5], a1.y, x);
          fma4(acc[6], a1.z, x);
          fma4(acc[7], a1.w, x);
        }
      }
    }
    // the row groups' sums [nrg][kp8][64], added in order of group into
    // group 0's (each output by one thread); then the parts' in order of
    // part, each output by one block of the cluster
    __syncthreads();                             // the ring and ds are read
    float* red = reinterpret_cast<float*>(smem);
    if (on) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(
            red + (rg * kp8 + oc * 8 + i) * kGenCols + 4 * q) = acc[i];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kp * kGenCols; p += blockDim.x) {
      const int kk = p / kGenCols, c = p - kk * kGenCols;
      float sum = red[kk * kGenCols + c];
      for (int r2 = 1; r2 < nrg; ++r2)
        sum += red[(r2 * kp8 + kk) * kGenCols + c];
      if (P == 1) {
        if (col0 + c < E) dw[((size_t)b * K + k0 + kk) * E + col0 + c] = sum;
      } else {                                   // into block 0's slot
        st_cluster(recv + part * kp * kGenCols + p, 0, sum);
      }
    }
    if (P > 1) {
      cluster_sync();                            // every part's sums are in
      if (part == 0) {
        for (int p = threadIdx.x; p < kp * kGenCols; p += blockDim.x) {
          const int kk = p / kGenCols, c = p - kk * kGenCols;
          if (col0 + c >= E) continue;
          float sum = recv[p];
          for (int r2 = 1; r2 < P; ++r2) sum += recv[r2 * kp * kGenCols + p];
          dw[((size_t)b * K + k0 + kk) * E + col0 + c] = sum;
        }
      }
      if (k0 + kGenWords < K) cluster_sync();    // read before the next pass
    }
    __syncthreads();                             // the sums are read
  }
}

// Columns of a dv block, the blocks of each kind, and the regions of each 16
// a dv thread takes (a tile of up to 64).
__host__ __device__ inline int dv_slice(int K) {
  return K > kGenWords ? kGenCols : kDvSlice;
}
__host__ __device__ inline long long dw_blocks(int B, int E) {
  return (long long)B * ((E + kGenCols - 1) / kGenCols);
}
__host__ __device__ inline long long dv_blocks(int B, int K, int T, int E) {
  return (long long)B * T * ((E + dv_slice(K) - 1) / dv_slice(K));
}
inline int dv_rpt(int R) { return R > 48 ? 4 : (R + 15) / 16; }

// Parts of each (video, column slice)'s rows, P a cluster of dw blocks: the
// least power of 2 (up to 8) that gives kDwBlocksMin dw blocks, while block
// 0's slots for the parts' sums of min(K, 64) words fit in kDwRecv bytes.
inline int dw_parts(int B, int K, int E) {
  const int kp = K < kGenWords ? K : kGenWords;
  int P = 1;
  while (P < kDwPartsMax && dw_blocks(B, E) * P < kDwBlocksMin &&
         2 * P * kp * kGenCols * (int)sizeof(float) <= kDwRecv)
    P *= 2;
  return P;
}

// Three blocks an SM (at most 85 registers a thread).
template <typename Tin, int RPT>
__global__ void __launch_bounds__(kGenThreads, 3)
diag_bwd_any(const Tin* __restrict__ w, const Tin* __restrict__ v,
             const float* __restrict__ centers,
             const float* __restrict__ dres, const int* __restrict__ rstar,
             const int* __restrict__ cstar, const float* __restrict__ f,
             const float* __restrict__ dctx, const float* __restrict__ dclu,
             float* __restrict__ dw, float* __restrict__ dv, int B, int K,
             int T, int R, int E, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wcnt[4 * kGenThreads / 32];     // dw: live rows a warp
  const long long id = blockIdx.x;
  const long long n_dw = dw_blocks(B, E) * P;
  const int s_dw = (E + kGenCols - 1) / kGenCols;
  if (id < n_dw) {                               // part id % P, its cluster
    const long long vs = id / P;                 // rank (P | n_dw)
    dw_any(smem_raw, wcnt, v, dres, dctx, dw, (int)(vs / s_dw),
           (int)(vs % s_dw), P > 1 ? (int)cluster_rank() : 0, P, K, T, R,
           E);
    return;
  }
  const int slice = dv_slice(K);
  const int s_dv = (E + slice - 1) / slice;
  const long long j = id - n_dw;
  if (j >= dv_blocks(B, K, T, E)) return;        // the grid's padding
  dv_any<Tin, RPT>(smem_raw, w, centers, dres, rstar, cstar, f, dctx, dclu,
                   dv, (size_t)(j / s_dv), (int)(j % s_dv) * slice, slice, K,
                   T, R, E);
}

// Whether diag_bwd_kernel takes these sizes; every other takes diag_bwd_any.
bool in_envelope(int K, int E) {
  return K <= 32 && E >= 4 && E % 4 == 0 && E <= 512;
}

// The general variant's dynamic shared memory, the larger of its blocks'
// (f32: 20,064 B for dv and 62,976 B for dw at R = 36, E = 1024, K = 8;
// 67,040 and 68,096 at K = 40; 115,456 B at most, dv at K >= 64, R > 48):
// that of the first pass of min(K, 64) words, which no later pass exceeds,
// at least the dw blocks' sums, and block 0's slots for the parts' sums.
template <typename Tin>
size_t smem_any(int B, int K, int R, int E) {
  const int kp = K < kGenWords ? K : kGenWords;
  const int P = dw_parts(B, K, E);
  const size_t dv_part = (size_t)dv_stages(kp) * dv_stage_bytes<Tin>(kp) +
                         (size_t)kp * (16 * dv_rpt(R) + 3) * sizeof(float);
  const size_t dw_part =
      (size_t)dw_recv_at<Tin>(K) +
      (P > 1 ? (size_t)P * kp * kGenCols * sizeof(float) : 0);
  return dv_part > dw_part ? dv_part : dw_part;
}

// The dw blocks (P a video's slice), then the dv blocks, padded to a whole
// number of clusters.
dim3 grid_any(int B, int K, int T, int E) {
  const int P = dw_parts(B, K, E);
  const long long n = dw_blocks(B, E) * P + dv_blocks(B, K, T, E);
  return dim3((unsigned)((n + P - 1) / P * P));
}

// A launch with the general variant's shared memory and, where P > 1,
// clusters of P blocks.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kern)(KArgs...), dim3 grid, size_t smem, int P,
                    cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kGenThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = P > 1 ? &attr : nullptr;
  cfg.numAttrs = P > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<KArgs>(args)...);
}

template <typename Tin>
int launch_any(const void* w, const void* v, const float* centers,
               const float* dres, const int* rstar, const int* cstar,
               const float* f, const float* dctx, const float* dclu,
               float* dw, float* dv, int B, int K, int T, int R, int E,
               cudaStream_t stream) {
  const int rpt = dv_rpt(R);                     // a dv tile of 16 RPT
  auto kern = rpt == 1   ? diag_bwd_any<Tin, 1>  // regions
              : rpt == 2 ? diag_bwd_any<Tin, 2>
              : rpt == 3 ? diag_bwd_any<Tin, 3>
                         : diag_bwd_any<Tin, 4>;
  const int P = dw_parts(B, K, E);
  const int err = launch_clusters(
      kern, grid_any(B, K, T, E), smem_any<Tin>(B, K, R, E), P, stream,
      static_cast<const Tin*>(w), static_cast<const Tin*>(v), centers, dres,
      rstar, cstar, f, dctx, dclu, dw, dv, B, K, T, R, E, P);
  return err != 0 ? err : (int)cudaGetLastError();
}

// Limits: the grids' (B <= 65535; the general variant's at most
// B (T + 9) ceil(E / 64) blocks and T R rows a video below 2^31) and sizes
// of at least 1.
bool bad_sizes(int B, int K, int T, int R, int E) {
  return K < 1 || R < 1 || E < 1 || B < 0 || B > 65535 || T < 0 ||
         (long long)T * R > 0x7fffffffLL ||
         (long long)B * (T + 9) * ((E + kGenCols - 1) / kGenCols) >
             0x7fffffffLL;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// w [B, K, E] and v [B, T, R, E] are of the type of the dtype code: float*
// (0), __nv_bfloat16* (1) or __half* (2; any other code is refused);
// centers [Kc, E], dres [B, K, T, R], f [B, T, K, E], dctx and dclu
// [B, K, T] are f32, rstar and cstar [B, K, T] int32 (the forward's).
// Written whole: dw [B, K, E] and dv [B, T, R, E], f32. All tensors are
// contiguous; w, v, centers, f, dw and dv are 16-byte aligned. Shapes
// in_envelope takes run the kernel above, every other the general variant.
// Limits: K, R, E >= 1, B <= 65535, T R < 2^31 and
// B (T + 9) ceil(E / 64) < 2^31.
int nafae_diag_bwd(const void* w, const void* v, int dtype,
                   const float* centers, const float* dres, const int* rstar,
                   const int* cstar, const float* f, const float* dctx,
                   const float* dclu, float* dw, float* dv, int B, int K,
                   int T, int R, int E, void* stream) {
  if (bad_sizes(B, K, T, R, E)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool spec = in_envelope(K, E);
  return by_dtype(dtype, (int)cudaErrorInvalidValue, [&](auto tag) {
    using Tin = decltype(tag);
    return spec ? launch<Tin>(w, v, centers, dres, rstar, cstar, f, dctx,
                              dclu, dw, dv, B, K, T, R, E, s)
                : launch_any<Tin>(w, v, centers, dres, rstar, cstar, f, dctx,
                                  dclu, dw, dv, B, K, T, R, E, s);
  });
}

// Launches an empty kernel with the grid, block size and dynamic shared
// memory that nafae_diag_bwd would use for these sizes (the general
// variant's where it would take it): the launch floor the measured times are
// judged against. Same limits and return value.
int nafae_diag_bwd_floor(int dtype, int B, int K, int T, int R, int E,
                         void* stream) {
  if (bad_sizes(B, K, T, R, E) || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, (int)cudaErrorInvalidValue, [&](auto tag) {
    using Tin = decltype(tag);
    if (!in_envelope(K, E)) {
      const int err = launch_clusters(null_kernel, grid_any(B, K, T, E),
                                      smem_any<Tin>(B, K, R, E),
                                      dw_parts(B, K, E), s);
      return err != 0 ? err : (int)cudaGetLastError();
    }
    cudaError_t err = cudaFuncSetAttribute(
        null_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(K, E));
    if (err != cudaSuccess) return (int)err;
    null_kernel<<<grid_of(B, T, E), kThreads, smem_bytes(K, E), s>>>();
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
