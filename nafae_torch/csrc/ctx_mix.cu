// Context mixing, forward: the frame-banded affinity softmax and mix of the
// context-pooled grounding model, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels nafae_tpu/ops/pallas/fused_ctx.py::_fwd_kernel
// (the forward of ctx_mix_pallas, K1f) and ::_fwd_kernel_res (K1fr, the same
// forward storing alpha as the backward's residual). Same function as the
// port's plain version, nafae_torch/ops/kernels/ctx_mix.py::context_mix_plain:
//
//   for every video b, centre frame t, offset o in {-w..-1, 1..w}:
//     nv_o      = fm[t+o] * fm[t]                        (halo frames: fm=0)
//     S[r, s]   = v[t, r] . v[t+o, s] / temp,  -1e9 where rm[t+o, s] <= 0
//     alpha     = softmax_s(S) * nv_o                    (row max subtracted;
//                 an all-masked row gives the uniform 1/R over its R regions)
//   u[t, r]     = sum_o sum_s alpha[r, s] v[t+o, s] / max(sum_o nv_o, 1)
//
// With bf16 input the products use the bf16 values and sum in f32, and alpha
// is rounded to bf16 before the mix, as the reference's bf16 mode does
// (preferred_element_type=f32 with bf16 operands). u is always f32.
//
// K1fr: with a non-null `alpha` the kernel also stores alpha (softmax * nv_o,
// in the input dtype, exactly the values the mix used) as [B, T, 2w, R, R],
// zeros for offsets whose nv_o is 0 and for invalid centre frames. This is
// the port's own compact layout, not the TPU's tile-padded slab: 3.1 MB at
// config4 in f32, one extra write of ~1 us at 3.35 TB/s.
//
// Design: one block per (video, centre frame), looping over the 2w offsets.
// The centre frame [R, E] and, in turn, each valid neighbour frame are
// staged in shared memory as f32 (rows padded to E+4 floats, so float4 reads
// of distinct rows fall in distinct banks); vector loads need v_ext 16-byte
// aligned. Scores: groups of 8 lanes compute 4 x 4 (r, s) tiles, splitting E
// and summing by shuffles. Softmax: 8 lanes per row, all rows at once. Mix:
// each thread owns 4 embedding columns of a quarter of the rows and keeps
// those accumulators in registers across the offsets. Shared memory does not
// grow with T, so long clips need no special path. Offsets whose nv_o is 0,
// and invalid centre frames, are skipped: their contribution is exactly 0.
//
// Bound on an H100 SXM (config4 serving shapes B=16, T=20, R=20, E=256,
// w=3, f32, every frame valid): it reads 8.5 MB of v_ext and writes 6.6 MB
// of u (~4.5 us at 3.35 TB/s) and does 4*R*R*E flops per (b, t, o):
// 0.79 GFLOP (~12 us at 67 TFLOP/s f32 on CUDA cores). So it is bound by
// operations; f32 parity keeps it off the tensor cores (TF32 keeps ~3
// digits). With bf16 input it reads 4.3 MB of v_ext and writes the same
// 6.6 MB of u (~3.2 us), and the same flops on bf16 tensor cores at ~989
// TFLOP/s take ~0.8 us: bound by bytes, at ~3.2 us. This version is far from that bound: each block walks the
// offsets in sequence (stage, scores, softmax, mix, four barriers each) with
// 2 blocks per SM (128 registers a thread), so latency, not the FMA units,
// sets its time. PERF.md has its measured times.

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

// RB: R rounded up to a multiple of 8 (4 row groups of RB/4 rows each).
template <typename Tin, int RB>
__global__ void __launch_bounds__(kMaxThreads)
ctx_mix_fwd_kernel(const Tin* __restrict__ v_ext,   // [B, T+2w, R, E]
                   const float* __restrict__ fm_ext,  // [B, T+2w]
                   const float* __restrict__ rm_ext,  // [B, T+2w, R] or null
                   float* __restrict__ u,             // [B, T, R, E]
                   Tin* __restrict__ alpha,           // [B, T, 2w, R, R] or null
                   int T, int R, int E, int w, float temp) {
  extern __shared__ __align__(16) float smem[];
  const int ld = E + 4;
  float* vc = smem;             // [R][ld]  centre frame
  float* vo = vc + R * ld;      // [R][ld]  neighbour frame
  float* sc = vo + R * ld;      // [R][RB]  scores (row r, col s)
  float* at = sc + R * RB;      // [R][RB]  alpha * nv transposed (row s, col r)
  float* live = at + R * RB;    // [R]      region mask of the neighbour frame

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const size_t frame = (size_t)R * E;
  const size_t rr = (size_t)R * R;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  float* ub = u + ((size_t)b * T + t) * frame;
  Tin* ab = alpha ? alpha + ((size_t)b * T + t) * 2 * w * rr : nullptr;

  const float fm_c = fm[t + w];
  if (fm_c == 0.f) {              // every nv_o is 0: the row is zero
    for (int i = threadIdx.x; i < (int)frame; i += blockDim.x) ub[i] = 0.f;
    if (ab)
      for (int i = threadIdx.x; i < 2 * w * (int)rr; i += blockDim.x)
        store_as(ab + i, 0.f);
    return;
  }
  stage_frame(vc, vb + (size_t)(t + w) * frame, R, E, ld);
  // columns R..RB-1 of the transposed alpha stay zero: the mix reads them
  for (int i = threadIdx.x; i < R * RB; i += blockDim.x) at[i] = 0.f;

  // the mix's thread layout: E/4 column groups x 4 row groups
  constexpr int RPT = RB / 4;           // rows per thread
  const int ncg = E >> 2;
  const bool active = threadIdx.x < E;  // blockDim rounds E up to 32
  const int cg = threadIdx.x % ncg;
  const int rg = threadIdx.x / ncg;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float cnt = 0.f;

  for (int oi = 0; oi < 2 * w; ++oi) {
    const int tf = t + (oi < w ? oi : oi + 1);   // extended neighbour frame
    const float nv = fm[tf] * fm_c;
    cnt += nv;
    if (nv == 0.f) {              // block-uniform
      if (ab)
        for (int i = threadIdx.x; i < (int)rr; i += blockDim.x)
          store_as(ab + oi * rr + i, 0.f);
      continue;
    }
    __syncthreads();              // the previous offset's readers are done
    stage_frame(vo, vb + (size_t)tf * frame, R, E, ld);
    if (threadIdx.x < R)
      live[threadIdx.x] =
          rm_ext ? rm_ext[((size_t)b * t_ext + tf) * R + threadIdx.x] : 1.f;
    __syncthreads();

    tile_products(vc, vo, R, E, ld, [&](int r, int s, float d) {
      sc[r * RB + s] = live[s] > 0.f ? d / temp : kNeg;
    });
    __syncthreads();

    row_softmax(sc, RB, R, [&](int r, int s, float p) {
      at[s * RB + r] = as_operand(p * nv, v_ext);
    });
    __syncthreads();

    if (ab)                       // K1fr: the residual, row-major (r, s)
      for (int i = threadIdx.x; i < (int)rr; i += blockDim.x) {
        const int r = i / R;
        store_as(ab + oi * rr + i, at[(i - r * R) * RB + r]);
      }

    // Mix: thread (cg, rg) owns columns 4cg..4cg+3 and rows rg*RB/4 ..
    // (rg+1)*RB/4 - 1. A warp shares rg, so its alpha reads are broadcasts
    // and its neighbour-row reads are 512 contiguous bytes.
    if (active) {
      for (int s = 0; s < R; ++s) {
        const float4 x = reinterpret_cast<const float4*>(vo + s * ld)[cg];
        const float* ap = at + s * RB + rg * RPT;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = ap[i];
          acc[i][0] = fmaf(a, x.x, acc[i][0]);
          acc[i][1] = fmaf(a, x.y, acc[i][1]);
          acc[i][2] = fmaf(a, x.z, acc[i][2]);
          acc[i][3] = fmaf(a, x.w, acc[i][3]);
        }
      }
    }
  }

  if (active) {
    const float den = fmaxf(cnt, 1.f);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      if (r < R)
        reinterpret_cast<float4*>(ub + (size_t)r * E)[cg] = make_float4(
            acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
    }
  }
}

template <typename Tin, int RB>
int launch(const void* v_ext, const float* fm_ext, const float* rm_ext,
           float* u, void* alpha, int B, int T, int R, int E, int w,
           float temp, size_t smem, cudaStream_t stream) {
  auto kern = ctx_mix_fwd_kernel<Tin, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((E + 31) / 32) * 32;
  kern<<<dim3(T, B), threads, smem, stream>>>(
      static_cast<const Tin*>(v_ext), fm_ext, rm_ext, u,
      static_cast<Tin*>(alpha), T, R, E, w, temp);
  return (int)cudaGetLastError();
}

template <typename Tin>
int dispatch(const void* v_ext, const float* fm_ext, const float* rm_ext,
             float* u, void* alpha, int B, int T, int R, int E, int w,
             float temp, size_t smem, cudaStream_t stream) {
  switch ((R + 7) / 8) {
    case 1: return launch<Tin, 8>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp, smem, stream);
    case 2: return launch<Tin, 16>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp, smem, stream);
    case 3: return launch<Tin, 24>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp, smem, stream);
    default: return launch<Tin, 32>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp, smem, stream);
  }
}

// Dynamic shared memory of one block, in bytes: at most 140,416 B (R = 32,
// E = 512), within the 227 KB a Hopper block can opt into.
size_t smem_bytes(int R, int E) {
  const int rb = ((R + 7) / 8) * 8;
  return (size_t)(2 * R * (E + 4) + 2 * R * rb + R) * sizeof(float);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// v_ext is float* when v_is_bf16 == 0, __nv_bfloat16* otherwise; rm_ext may
// be null; alpha, of v_ext's type, is null for K1f and the [B, T, 2w, R, R]
// residual for K1fr. All tensors are contiguous; v_ext is 16-byte aligned.
// Limits: 1 <= R <= 32, E a multiple of 4 with 4 <= E <= 512, w >= 1,
// B <= 65535.
int nafae_ctx_mix_fwd(const void* v_ext, int v_is_bf16, const float* fm_ext,
                      const float* rm_ext, float* u, void* alpha, int B,
                      int T, int R, int E, int w, float temp, void* stream) {
  if (R < 1 || R > 32 || E < 4 || E % 4 != 0 || E > kMaxThreads || w < 1 ||
      B < 0 || B > 65535 || T < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const size_t smem = smem_bytes(R, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_is_bf16
      ? dispatch<__nv_bfloat16>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp, smem, s)
      : dispatch<float>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp, smem, s);
}

}  // extern "C"
