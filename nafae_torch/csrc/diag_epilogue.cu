// Diagonal epilogue of the config-4 training step, forward: the context-loss
// partial sums, the top-region selection and the cluster distances, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nafae_tpu/ops/pallas/fused_diag.py::_fwd_kernel
// (K4f, via _diag_core_fwd). Same function as the port's plain version,
// nafae_torch/ops/kernels/diag.py::diag_fwd_plain. Per video b, word k,
// frame t:
//
//   s[r]  = w[k] . v[t, r],   sh[r] = w[k] . u[t, r]     (u: stop-gradient)
//   live  = rm[t, r] > 0;     m[r] = live && fm[t] > 0 && hc[t] > 0
//   ctx   = sum_r m ? (s - sh)^2 : 0     (each term rounded to bf16 in bf16
//                                          mode, as fused_ctx.py::_sel_dot)
//   r*    = first argmax_r of (live ? s : -1e9)  (frame validity ignored; an
//           all-masked frame picks region 0)
//   f     = v[t, r*]                                     (exact, f32)
//   c*    = first argmax_c of f . ch[c],  ch[c] = C[c] / sqrt(|C[c]|^2 + 1e-8)
//           (ch rounded to bf16 in bf16 mode)
//   clu   = |f - C[c*]|^2     (C[c*] rounded to bf16 in bf16 mode)
//
// Outputs ctx, clu [B, K, T] f32 and f [B, T, K, E] f32, and the residuals
// that the backward (diag_epilogue_bwd.cu) reads instead of re-running this
// kernel: d = m ? s - sh : 0 [B, K, T, R] f32, r* and c* [B, K, T] int32.
//
// Design: one block per (frame, video). The block's words and, 16 at a time,
// the frame's regions of v and u (then the normalised centers) sit in shared
// memory as f32 rows of stride E+4. One thread per (word, region) pair
// computes s and sh over E in one fixed order; then one thread per word walks
// the regions in order, so its sum is ordered and its argmax keeps the first
// maximum. The same for the centers: one thread per (word, center) dot, one
// thread per word for the argmax, one warp per word for |f - C[c*]|^2. Any R
// and any Kc fit; shared memory grows with K and E only.
//
// Bound on an H100 SXM (config4 training shapes B=16, K=8, T=20, R=20,
// E=256, Kc=67, f32): 2*2*B*K*T*R*E + 2*B*K*T*Kc*E = 140 MFLOP (~2.1 us at
// 67 TFLOP/s) against ~15.8 MB moved (v and u 6.6 MB each, f 1.3 MB, the
// residuals, w, centers, masks), ~4.7 us at 3.35 TB/s: bound by bytes. In
// bf16, v and u are half the bytes: ~2.7 us. These count every region as
// live and the residuals as needed; the function needs only ctx, clu and f
// written, v at live regions (region 0 of an all-masked frame) and u at the
// ctx mask, so chip_smoke.py counts the bound from a batch's masks, without
// the residuals. This version re-reads the
// centers in every block (from L2) and leaves threads idle in the per-word
// walks; PERF.md has its measured times.

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

constexpr int kThreads = 256;
constexpr int kChunk = 16;      // regions (or centers) staged at once

// Dot of two shared f32 rows over E, float4 by float4, in one fixed order.
__device__ __forceinline__ float row_dot(const float* __restrict__ x,
                                         const float* __restrict__ y, int e4) {
  const float4* a = reinterpret_cast<const float4*>(x);
  const float4* b = reinterpret_cast<const float4*>(y);
  float d = 0.f;
  for (int q = 0; q < e4; ++q) {
    const float4 p = a[q], c = b[q];
    d = fmaf(p.x, c.x, d);
    d = fmaf(p.y, c.y, d);
    d = fmaf(p.z, c.z, d);
    d = fmaf(p.w, c.w, d);
  }
  return d;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
diag_fwd_kernel(const Tin* __restrict__ w,          // [B, K, E]
                const Tin* __restrict__ v,          // [B, T, R, E]
                const Tin* __restrict__ u,          // [B, T, R, E]
                const float* __restrict__ centers,  // [Kc, E]
                const float* __restrict__ fm,       // [B, T]
                const float* __restrict__ hc,       // [B, T]
                const float* __restrict__ rm,       // [B, T, R] or null
                float* __restrict__ ctx,            // [B, K, T]
                float* __restrict__ clu,            // [B, K, T]
                float* __restrict__ f,              // [B, T, K, E]
                float* __restrict__ dres,           // [B, K, T, R]
                int* __restrict__ rstar,            // [B, K, T]
                int* __restrict__ cstar,            // [B, K, T]
                int K, int T, int R, int E, int Kc) {
  extern __shared__ __align__(16) float smem[];
  const int ld = E + 4;
  const int e4 = E >> 2;
  float* ws = smem;                   // [K][ld]      words
  float* fs = ws + K * ld;            // [K][ld]      selected regions f
  float* xs = fs + K * ld;            // [kChunk][ld] regions of v, then centers
  float* ys = xs + kChunk * ld;       // [kChunk][ld] regions of u
  float* sc = ys + kChunk * ld;       // [K][kChunk]  masked s, then sims
  float* sq = sc + K * kChunk;        // [K][kChunk]  ctx terms
  float* best = sq + K * kChunk;      // [K]
  float* acc = best + K;              // [K]          ctx sums
  float* live = acc + K;              // [kChunk]
  int* arg = reinterpret_cast<int*>(live + kChunk);   // [K]

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const size_t bt = (size_t)b * T + t;
  const Tin* vt = v + bt * R * E;
  const Tin* ut = u + bt * R * E;
  const bool on = fm[bt] > 0.f && hc[bt] > 0.f;     // the ctx mask's frame part
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  stage_frame(ws, w + (size_t)b * K * E, K, E, ld);
  if (threadIdx.x < K) {
    best[threadIdx.x] = -CUDART_INF_F;
    acc[threadIdx.x] = 0.f;
    arg[threadIdx.x] = 0;
  }

  // s, sh, the ctx terms, the residual and the first-max region
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int rc = min(kChunk, R - r0);
    __syncthreads();                  // the last chunk's readers are done
    stage_frame(xs, vt + (size_t)r0 * E, rc, E, ld);
    stage_frame(ys, ut + (size_t)r0 * E, rc, E, ld);
    if (threadIdx.x < rc)
      live[threadIdx.x] = rm ? rm[bt * R + r0 + threadIdx.x] : 1.f;
    __syncthreads();
    for (int p = threadIdx.x; p < K * rc; p += blockDim.x) {
      const int k = p / rc;
      const int j = p - k * rc;
      const float s = row_dot(ws + k * ld, xs + j * ld, e4);
      const float sh = row_dot(ws + k * ld, ys + j * ld, e4);
      const bool lv = live[j] > 0.f;
      const bool m = lv && on;
      const float diff = s - sh;
      dres[(((size_t)b * K + k) * T + t) * R + r0 + j] = m ? diff : 0.f;
      sq[k * kChunk + j] = m ? as_operand(diff * diff, v) : 0.f;
      sc[k * kChunk + j] = lv ? s : kNeg;
    }
    __syncthreads();
    if (threadIdx.x < K) {            // regions in order: ordered sum, first max
      const int k = threadIdx.x;
      for (int j = 0; j < rc; ++j) {
        acc[k] += sq[k * kChunk + j];
        if (sc[k * kChunk + j] > best[k]) {
          best[k] = sc[k * kChunk + j];
          arg[k] = r0 + j;
        }
      }
    }
  }
  __syncthreads();

  // f = v[t, r*]: to shared memory and to f
  for (int p = threadIdx.x; p < K * e4; p += blockDim.x) {
    const int k = p / e4;
    const int q = p - k * e4;
    const float4 x = load4(vt + (size_t)arg[k] * E, q);
    reinterpret_cast<float4*>(fs + k * ld)[q] = x;
    reinterpret_cast<float4*>(f + (bt * K + k) * E)[q] = x;
  }
  if (threadIdx.x < K) {
    const size_t o = ((size_t)b * K + threadIdx.x) * T + t;
    ctx[o] = acc[threadIdx.x];
    rstar[o] = arg[threadIdx.x];
  }
  __syncthreads();                    // arg is read; reuse best/arg for c*
  if (threadIdx.x < K) {
    best[threadIdx.x] = -CUDART_INF_F;
    arg[threadIdx.x] = 0;
  }

  // c* = first argmax of f . ch over the centers, 16 at a time
  for (int c0 = 0; c0 < Kc; c0 += kChunk) {
    const int cc = min(kChunk, Kc - c0);
    __syncthreads();
    for (int row = warp; row < cc; row += nwarps) {    // one warp per center
      const float* src = centers + (size_t)(c0 + row) * E;
      float ss = 0.f;
      for (int e = lane; e < E; e += 32) ss = fmaf(src[e], src[e], ss);
      const float inv = 1.f / sqrtf(warp_sum(ss) + 1e-8f);
      for (int e = lane; e < E; e += 32)
        xs[row * ld + e] = as_operand(src[e] * inv, v);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < K * cc; p += blockDim.x) {
      const int k = p / cc;
      const int j = p - k * cc;
      sc[k * kChunk + j] = row_dot(fs + k * ld, xs + j * ld, e4);
    }
    __syncthreads();
    if (threadIdx.x < K) {
      const int k = threadIdx.x;
      for (int j = 0; j < cc; ++j)
        if (sc[k * kChunk + j] > best[k]) {
          best[k] = sc[k * kChunk + j];
          arg[k] = c0 + j;
        }
    }
  }
  __syncthreads();

  // clu = |f - C[c*]|^2, one warp per word
  for (int k = warp; k < K; k += nwarps) {
    const float* tgt = centers + (size_t)arg[k] * E;
    float ss = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = fs[k * ld + e] - as_operand(tgt[e], v);
      ss = fmaf(d, d, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) {
      const size_t o = ((size_t)b * K + k) * T + t;
      clu[o] = ss;
      cstar[o] = arg[k];
    }
  }
}

// Dynamic shared memory of one block, in bytes: 202,688 B at K = 32,
// E = 512, within the 227 KB a Hopper block can opt into.
size_t smem_bytes(int K, int E) {
  return (size_t)(2 * K * (E + 4) + 2 * kChunk * (E + 4) + 2 * K * kChunk +
                  3 * K + kChunk) * sizeof(float);
}

template <typename Tin>
int launch(const void* w, const void* v, const void* u, const float* centers,
           const float* fm, const float* hc, const float* rm, float* ctx,
           float* clu, float* f, float* dres, int* rstar, int* cstar, int B,
           int K, int T, int R, int E, int Kc, cudaStream_t stream) {
  auto kern = diag_fwd_kernel<Tin>;
  const size_t smem = smem_bytes(K, E);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(T, B), kThreads, smem, stream>>>(
      static_cast<const Tin*>(w), static_cast<const Tin*>(v),
      static_cast<const Tin*>(u), centers, fm, hc, rm, ctx, clu, f, dres,
      rstar, cstar, K, T, R, E, Kc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// w [B, K, E], v and u [B, T, R, E] are float* when is_bf16 == 0 and
// __nv_bfloat16* otherwise; centers [Kc, E], fm and hc [B, T] and rm
// [B, T, R] (may be null: every region valid) are f32. Written whole: ctx,
// clu [B, K, T] f32, f [B, T, K, E] f32, dres [B, K, T, R] f32, rstar and
// cstar [B, K, T] int32. All tensors are contiguous; w, v, u, centers and f
// are 16-byte aligned. Limits: 1 <= K <= 32, R >= 1, Kc >= 1, E a multiple
// of 4 with 4 <= E <= 512, B <= 65535.
int nafae_diag_fwd(const void* w, const void* v, const void* u, int is_bf16,
                   const float* centers, const float* fm, const float* hc,
                   const float* rm, float* ctx, float* clu, float* f,
                   float* dres, int* rstar, int* cstar, int B, int K, int T,
                   int R, int E, int Kc, void* stream) {
  if (K < 1 || K > 32 || R < 1 || Kc < 1 || E < 4 || E % 4 != 0 || E > 512 ||
      B < 0 || B > 65535 || T < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(w, v, u, centers, fm, hc, rm, ctx, clu, f, dres,
                              rstar, cstar, B, K, T, R, E, Kc, s)
      : launch<float>(w, v, u, centers, fm, hc, rm, ctx, clu, f, dres, rstar,
                      cstar, B, K, T, R, E, Kc, s);
}

}  // extern "C"
