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
// Design: one launch, two kinds of block, grid (T + K, B). Block (t, b) with
// t < T writes dv[b, t] whole: the video's words and the rounded df rows of
// the frame sit in shared memory, and each thread sums, for its (region,
// 4 columns), over the words in order. Block (T + k, b) writes dw[b, k]:
// thread (g, q) sums the rows n = g, g + G, ... of the video's T*R regions
// for 4 columns q, and the G partial sums are added in a fixed order. No
// float atomics: every output has one writer and one order of summation, so
// the f32 gradient is the same on every run.
//
// Bound on an H100 SXM (config4 training shapes B=16, K=8, T=20, R=20,
// E=256, f32): ~13 MB moved (v read and dv written, 6.6 MB each; w, f, d,
// the argmaxes and the cotangents), ~4 us at 3.35 TB/s, against 4*B*K*T*R*E
// = 52 MFLOP, ~0.8 us at 67 TFLOP/s: bound by bytes. These count every
// region as in the ctx mask; v is needed only where ds can be nonzero (the
// mask) and the centers only at c*, so chip_smoke.py counts the bound from a
// batch's masks. PERF.md has its measured times.

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

constexpr int kThreads = 256;

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
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
  const int e4 = E >> 2;

  if ((int)blockIdx.x < T) {          // dv of frame t
    const int t = blockIdx.x;
    const size_t bt = (size_t)b * T + t;
    const int ld = E + 4;
    float* ws = smem;                 // [K][ld] words
    float* dfs = ws + K * ld;         // [K][ld] rounded cluster pull df
    float* g = dfs + K * ld;          // [K]     2 dctx, dctx rounded
    int* rs = reinterpret_cast<int*>(g + K);   // [K] r*
    stage_frame(ws, w + (size_t)b * K * E, K, E, ld);
    if ((int)threadIdx.x < K) {
      const size_t o = ((size_t)b * K + threadIdx.x) * T + t;
      g[threadIdx.x] = 2.f * as_operand(dctx[o], v);
      rs[threadIdx.x] = rstar[o];
    }
    for (int p = threadIdx.x; p < K * e4; p += blockDim.x) {
      const int k = p / e4;
      const int q = p - k * e4;
      const size_t o = ((size_t)b * K + k) * T + t;
      const float s2 = 2.f * dclu[o];
      const float4 x = reinterpret_cast<const float4*>(f + (bt * K + k) * E)[q];
      const float4 c =
          reinterpret_cast<const float4*>(centers + (size_t)cstar[o] * E)[q];
      reinterpret_cast<float4*>(dfs + k * ld)[q] = make_float4(
          as_operand(s2 * (x.x - as_operand(c.x, v)), v),
          as_operand(s2 * (x.y - as_operand(c.y, v)), v),
          as_operand(s2 * (x.z - as_operand(c.z, v)), v),
          as_operand(s2 * (x.w - as_operand(c.w, v)), v));
    }
    __syncthreads();
    for (int p = threadIdx.x; p < R * e4; p += blockDim.x) {
      const int r = p / e4;
      const int q = p - r * e4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < K; ++k) {
        const float a = as_operand(
            g[k] * dres[(((size_t)b * K + k) * T + t) * R + r], v);
        const float4 x = reinterpret_cast<const float4*>(ws + k * ld)[q];
        acc.x = fmaf(a, x.x, acc.x);
        acc.y = fmaf(a, x.y, acc.y);
        acc.z = fmaf(a, x.z, acc.z);
        acc.w = fmaf(a, x.w, acc.w);
      }
      for (int k = 0; k < K; ++k)
        if (rs[k] == r) {
          const float4 x = reinterpret_cast<const float4*>(dfs + k * ld)[q];
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
      reinterpret_cast<float4*>(dv + (bt * R + r) * E)[q] = acc;
    }
  } else {                            // dw of word k
    const int k = blockIdx.x - T;
    const int groups = blockDim.x / e4;
    const int gi = threadIdx.x / e4;
    const int q = threadIdx.x - gi * e4;
    float4* part = reinterpret_cast<float4*>(smem);   // [groups][e4]
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi < groups) {
      const size_t bk = (size_t)b * K + k;
      for (int n = gi; n < T * R; n += groups) {
        const int t = n / R;
        const float gt = 2.f * as_operand(dctx[bk * T + t], v);
        const float a = as_operand(gt * dres[bk * T * R + n], v);
        const float4 x = load4(v + ((size_t)b * T * R + n) * E, q);
        acc.x = fmaf(a, x.x, acc.x);
        acc.y = fmaf(a, x.y, acc.y);
        acc.z = fmaf(a, x.z, acc.z);
        acc.w = fmaf(a, x.w, acc.w);
      }
      part[gi * e4 + q] = acc;
    }
    __syncthreads();
    if (gi == 0) {                    // the partial sums in a fixed order
      for (int j = 1; j < groups; ++j) {
        const float4 x = part[j * e4 + q];
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      reinterpret_cast<float4*>(dw + ((size_t)b * K + k) * E)[q] = acc;
    }
  }
}

// Dynamic shared memory of one block, in bytes: the larger of the dv
// blocks' (132,352 B at K = 32, E = 512) and the dw blocks' (4 KB).
size_t smem_bytes(int K, int E) {
  const size_t dv_part = (size_t)(2 * K * (E + 4) + 2 * K) * sizeof(float);
  const size_t dw_part = (size_t)kThreads * sizeof(float4);
  return dv_part > dw_part ? dv_part : dw_part;
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
  kern<<<dim3(T + K, B), kThreads, smem, stream>>>(
      static_cast<const Tin*>(w), static_cast<const Tin*>(v), centers, dres,
      rstar, cstar, f, dctx, dclu, dw, dv, K, T, R, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// w [B, K, E] and v [B, T, R, E] are float* when is_bf16 == 0 and
// __nv_bfloat16* otherwise; centers [Kc, E], dres [B, K, T, R], f
// [B, T, K, E], dctx and dclu [B, K, T] are f32, rstar and cstar [B, K, T]
// int32 (the forward's). Written whole: dw [B, K, E] and dv [B, T, R, E],
// f32. All tensors are contiguous; w, v, centers, f, dw and dv are 16-byte
// aligned. Limits: 1 <= K <= 32, R >= 1, E a multiple of 4 with
// 4 <= E <= 512, B <= 65535.
int nafae_diag_bwd(const void* w, const void* v, int is_bf16,
                   const float* centers, const float* dres, const int* rstar,
                   const int* cstar, const float* f, const float* dctx,
                   const float* dclu, float* dw, float* dv, int B, int K,
                   int T, int R, int E, void* stream) {
  if (K < 1 || K > 32 || R < 1 || E < 4 || E % 4 != 0 || E > 512 || B < 0 ||
      B > 65535 || T < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(w, v, centers, dres, rstar, cstar, f, dctx,
                              dclu, dw, dv, B, K, T, R, E, s)
      : launch<float>(w, v, centers, dres, rstar, cstar, f, dctx, dclu, dw,
                      dv, B, K, T, R, E, s);
}

}  // extern "C"
