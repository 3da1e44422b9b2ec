// Context mixing, backward: the gradient of ctx_mix.cu's forward with
// respect to the halo-extended region embeddings, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels nafae_tpu/ops/pallas/fused_ctx.py::_bwd_kernel
// (K1b, alpha recomputed from the scores) and ::_bwd_kernel_res (K1br, alpha
// read from the forward's residual). One kernel template serves both; the
// two C entry points below pick it. Math, per video b, centre frame t and
// offset o with nv_o = fm[t+o] * fm[t] = 1 (masks hold 0 or 1), and
// scale_t = fm[t] / max(sum_o nv_o, 1), as fused_ctx.py::_row_scale folds it:
//
//   du_n[r]      = scale_t * du[t, r]
//   da[r, s]     = du_n[r] . v[t+o, s]
//   ds[r, s]     = alpha[r, s] (da[r, s] - sum_s' alpha[r, s'] da[r, s']) / temp
//                  (0 for a uniform-fallback group: no valid region in t+o)
//   dv[t+o, s]  += sum_r alpha[r, s] du_n[r] + sum_r ds[r, s] v[t, r]
//   dv[t, r]    += sum_s ds[r, s] v[t+o, s]
//
// In bf16 mode du_n, ds and the alpha of the products are rounded to bf16
// and every product sums in f32, as the TPU kernel does; the residual route
// reads alpha as stored (bf16), the recompute route recomputes it in f32.
// dv_ext is f32 [B, T+2w, R, E], halo frames included.
//
// Design: one block per (video, extended frame f), which gathers every
// contribution to dv[f]: as the neighbour of each centre t = f - o, and as a
// centre itself. Each (t, o) group lives in frames t and t+o alone, so the
// block rebuilds alpha from those two frames (or reads it) and needs nothing
// from other blocks: no atomics, no second pass, and the f32 result is the
// same on every run. The cost is that each live (t, o) pair computes da and
// ds twice, once in the block of t+o and once in the block of t. Frames sit
// in shared memory as f32 rows (stride E+4); the R x R products use the
// forward's 8-lane 4 x 4 tiles; each thread keeps 4 columns of a quarter of
// the rows of dv[f] in registers across all (t, o) pairs.
//
// Bound on an H100 SXM (config4 training shapes B=16, T=20, R=20, E=256,
// w=3, f32, every frame valid: 1,920 live (t, o) pairs): the least work is
// 8 R^2 E flops a pair for K1br (da, alpha^T du_n, ds^T v_t, ds v_t+o) and
// 10 R^2 E for K1b (plus the scores): 1.57 / 1.97 GFLOP, ~23 / ~29 us at
// 67 TFLOP/s f32; the bytes (v_ext 8.5 MB, du 6.6 MB, alpha 3.1 MB, dv_ext
// 8.5 MB) take ~8 us. So it is bound by operations. This first version does
// 10 (K1br) and 14 (K1b) R^2 E a pair, walks the pairs in sequence behind
// five barriers each, and is far from that bound; PERF.md has its times.

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

// RB: R rounded up to a multiple of 8 (4 row groups of RB/4 rows each).
template <typename Tin, int RB, bool kResidual>
__global__ void __launch_bounds__(kMaxThreads)
ctx_mix_bwd_kernel(const Tin* __restrict__ v_ext,   // [B, T+2w, R, E]
                   const float* __restrict__ fm_ext,  // [B, T+2w]
                   const float* __restrict__ rm_ext,  // [B, T+2w, R] or null
                   const Tin* __restrict__ alpha,     // [B, T, 2w, R, R] (K1br)
                   const float* __restrict__ du,      // [B, T, R, E]
                   float* __restrict__ dv,            // [B, T+2w, R, E]
                   int T, int R, int E, int w, float temp) {
  extern __shared__ __align__(16) float smem[];
  const int ld = E + 4;
  float* vown = smem;            // [R][ld]  this block's frame f
  float* voth = vown + R * ld;   // [R][ld]  the other frame of the pair
  float* dus = voth + R * ld;    // [R][ld]  du_n of the pair's centre frame
  float* A = dus + R * ld;       // [RB][RB] alpha (row r, col s)
  float* G = A + RB * RB;        // [RB][RB] scores, then da, then ds
  float* live = G + RB * RB;     // [R]      region mask of the neighbour frame

  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const size_t frame = (size_t)R * E;
  const size_t rr = (size_t)R * R;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  float* dvb = dv + ((size_t)b * t_ext + f) * frame;

  if (fm[f] == 0.f) {             // every pair through f has nv_o = 0
    for (int i = threadIdx.x; i < (int)frame; i += blockDim.x) dvb[i] = 0.f;
    return;
  }
  stage_frame(vown, vb + (size_t)f * frame, R, E, ld);
  // rows and columns R..RB-1 of A and G stay zero: the sums below read them
  for (int i = threadIdx.x; i < 2 * RB * RB; i += blockDim.x) A[i] = 0.f;

  constexpr int RPT = RB / 4;           // rows per thread
  const int ncg = E >> 2;
  const bool active = threadIdx.x < E;  // blockDim rounds E up to 32
  const int cg = threadIdx.x % ncg;
  const int rg = threadIdx.x / ncg;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // pairs 0..2w-1: f is the neighbour t+o of centre c = f - o;
  // pairs 2w..4w-1: f is the centre of neighbour n = f + o
  for (int job = 0; job < 4 * w; ++job) {
    const bool as_centre = job >= 2 * w;           // block-uniform
    const int oi = as_centre ? job - 2 * w : job;
    const int o = oi < w ? oi - w : oi - w + 1;
    const int c = as_centre ? f : f - o;           // extended centre frame
    const int n = c + o;                           // extended neighbour frame
    if (c < w || c >= w + T) continue;
    if (fm[c] * fm[n] == 0.f) continue;
    float cnt = 0.f;
    for (int q = 0; q < 2 * w; ++q) cnt += fm[c + (q < w ? q - w : q - w + 1)];
    const float scale = 1.f / fmaxf(cnt, 1.f);     // fm[c] is 1 here
    const int t = c - w;

    __syncthreads();              // the previous pair's readers are done
    stage_frame(voth, vb + (size_t)(as_centre ? n : c) * frame, R, E, ld);
    {
      const float* src = du + ((size_t)b * T + t) * frame;
      const int n4 = (R * E) >> 2;
      for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        const int flat = i << 2;
        const int r = flat / E;
        const float4 x = reinterpret_cast<const float4*>(src)[i];
        *reinterpret_cast<float4*>(dus + r * ld + (flat - r * E)) =
            make_float4(as_operand(x.x * scale, v_ext),
                        as_operand(x.y * scale, v_ext),
                        as_operand(x.z * scale, v_ext),
                        as_operand(x.w * scale, v_ext));
      }
    }
    if (threadIdx.x < R)
      live[threadIdx.x] =
          rm_ext ? rm_ext[((size_t)b * t_ext + n) * R + threadIdx.x] : 1.f;
    if (kResidual) {
      const Tin* ap = alpha + (((size_t)b * T + t) * 2 * w + oi) * rr;
      for (int i = threadIdx.x; i < (int)rr; i += blockDim.x) {
        const int r = i / R;
        A[r * RB + (i - r * R)] = load1(ap + i);
      }
    }
    __syncthreads();

    const float* C = as_centre ? vown : voth;      // centre frame t
    const float* N = as_centre ? voth : vown;      // neighbour frame t+o
    bool group_live = false;      // any valid region in t+o (same every row)
    for (int s = 0; s < R; ++s) group_live |= live[s] > 0.f;

    if (!kResidual) {             // K1b: alpha from the scores, in f32
      tile_products(C, N, R, E, ld, [&](int r, int s, float d) {
        G[r * RB + s] = live[s] > 0.f ? d / temp : kNeg;
      });
      __syncthreads();
      row_softmax(G, RB, R, [&](int r, int s, float p) { A[r * RB + s] = p; });
      __syncthreads();
    }
    tile_products(dus, N, R, E, ld,
                  [&](int r, int s, float d) { G[r * RB + s] = d; });
    __syncthreads();

    // ds in place of da: 8 lanes per row, the row sum by shuffles
    {
      const int j = threadIdx.x & 7;
      for (int base = 0; base < R; base += blockDim.x >> 3) {
        const int r = base + (threadIdx.x >> 3);
        float a[4], g[4];
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = j + 8 * k;
          const bool ok = r < R && s < R;
          a[k] = ok ? A[r * RB + s] : 0.f;
          g[k] = ok ? G[r * RB + s] : 0.f;
          sum += a[k] * g[k];
        }
#pragma unroll
        for (int k = 4; k > 0; k >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, k);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = j + 8 * k;
          if (r < R && s < R)
            G[r * RB + s] = group_live
                ? as_operand((a[k] * g[k] - a[k] * sum) / temp, v_ext)
                : 0.f;
        }
      }
    }
    __syncthreads();

    // Accumulate into this thread's rows of dv[f]. A warp shares rg, so the
    // A and G reads are broadcasts and the frame-row reads 512 contiguous
    // bytes.
    if (active) {
      if (!as_centre) {           // rows are s: alpha^T du_n + ds^T v_t
        for (int r = 0; r < R; ++r) {
          const float4 x = reinterpret_cast<const float4*>(dus + r * ld)[cg];
          const float4 y = reinterpret_cast<const float4*>(C + r * ld)[cg];
          const float* ap = A + r * RB + rg * RPT;
          const float* gp = G + r * RB + rg * RPT;
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float a = as_operand(ap[i], v_ext);
            const float g = gp[i];
            acc[i][0] = fmaf(g, y.x, fmaf(a, x.x, acc[i][0]));
            acc[i][1] = fmaf(g, y.y, fmaf(a, x.y, acc[i][1]));
            acc[i][2] = fmaf(g, y.z, fmaf(a, x.z, acc[i][2]));
            acc[i][3] = fmaf(g, y.w, fmaf(a, x.w, acc[i][3]));
          }
        }
      } else {                    // rows are r: ds v_t+o
        for (int s = 0; s < R; ++s) {
          const float4 y = reinterpret_cast<const float4*>(N + s * ld)[cg];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float g = G[(rg * RPT + i) * RB + s];
            acc[i][0] = fmaf(g, y.x, acc[i][0]);
            acc[i][1] = fmaf(g, y.y, acc[i][1]);
            acc[i][2] = fmaf(g, y.z, acc[i][2]);
            acc[i][3] = fmaf(g, y.w, acc[i][3]);
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      if (r < R)
        reinterpret_cast<float4*>(dvb + (size_t)r * E)[cg] =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <typename Tin, int RB, bool kResidual>
int launch(const void* v_ext, const float* fm_ext, const float* rm_ext,
           const void* alpha, const float* du, float* dv, int B, int T, int R,
           int E, int w, float temp, size_t smem, cudaStream_t stream) {
  auto kern = ctx_mix_bwd_kernel<Tin, RB, kResidual>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((E + 31) / 32) * 32;
  kern<<<dim3(T + 2 * w, B), threads, smem, stream>>>(
      static_cast<const Tin*>(v_ext), fm_ext, rm_ext,
      static_cast<const Tin*>(alpha), du, dv, T, R, E, w, temp);
  return (int)cudaGetLastError();
}

template <typename Tin, bool kResidual>
int dispatch(const void* v_ext, const float* fm_ext, const float* rm_ext,
             const void* alpha, const float* du, float* dv, int B, int T,
             int R, int E, int w, float temp, size_t smem,
             cudaStream_t stream) {
  switch ((R + 7) / 8) {
    case 1: return launch<Tin, 8, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, B, T, R, E, w, temp, smem, stream);
    case 2: return launch<Tin, 16, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, B, T, R, E, w, temp, smem, stream);
    case 3: return launch<Tin, 24, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, B, T, R, E, w, temp, smem, stream);
    default: return launch<Tin, 32, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, B, T, R, E, w, temp, smem, stream);
  }
}

// Dynamic shared memory of one block, in bytes: at most 206,464 B (R = 32,
// E = 512), within the 227 KB a Hopper block can opt into.
size_t smem_bytes(int R, int E) {
  const int rb = ((R + 7) / 8) * 8;
  return (size_t)(3 * R * (E + 4) + 2 * rb * rb + R) * sizeof(float);
}

template <bool kResidual>
int run(const void* v_ext, int v_is_bf16, const float* fm_ext,
        const float* rm_ext, const void* alpha, const float* du, float* dv,
        int B, int T, int R, int E, int w, float temp, void* stream) {
  if (R < 1 || R > 32 || E < 4 || E % 4 != 0 || E > kMaxThreads || w < 1 ||
      B < 0 || B > 65535 || T < 0 || (kResidual && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(R, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_is_bf16
      ? dispatch<__nv_bfloat16, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, B, T, R, E, w, temp, smem, s)
      : dispatch<float, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, B, T, R, E, w, temp, smem, s);
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the cudaError_t of the launch (0 = ok).
// v_ext is float* when v_is_bf16 == 0, __nv_bfloat16* otherwise, and alpha
// (K1br only) has v_ext's type; rm_ext may be null; du is f32 [B, T, R, E];
// dv is written whole, f32 [B, T+2w, R, E]. All tensors are contiguous and
// v_ext, du and dv 16-byte aligned. Limits as the forward's.

// K1b: alpha recomputed from the scores.
int nafae_ctx_mix_bwd(const void* v_ext, int v_is_bf16, const float* fm_ext,
                      const float* rm_ext, const float* du, float* dv, int B,
                      int T, int R, int E, int w, float temp, void* stream) {
  return run<false>(v_ext, v_is_bf16, fm_ext, rm_ext, nullptr, du, dv, B, T,
                    R, E, w, temp, stream);
}

// K1br: alpha read from the forward's residual [B, T, 2w, R, R].
int nafae_ctx_mix_bwd_res(const void* v_ext, int v_is_bf16,
                          const float* fm_ext, const float* rm_ext,
                          const void* alpha, const float* du, float* dv,
                          int B, int T, int R, int E, int w, float temp,
                          void* stream) {
  return run<true>(v_ext, v_is_bf16, fm_ext, rm_ext, alpha, du, dv, B, T, R,
                   E, w, temp, stream);
}

}  // extern "C"
