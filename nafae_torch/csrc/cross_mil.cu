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
// With bf16 input the products use the bf16 values and sum in f32 (the
// reference's preferred_element_type=f32). Only a [I, M, T] and idx [I, M, T]
// reach device memory, never the [I, M, T, R] scores: that is the point of
// the TPU kernel, kept here.
//
// Design: one block per (video, tile of 32 words, group of 4 frames). The
// word tile sits in shared memory as f32 rows (stride E+4, so float4 reads of
// 8 distinct rows fall in distinct banks); each frame's regions are staged 32
// at a time, so any R fits. 8 lanes share a word: lane j takes regions j,
// j+8, j+16, j+24 of the chunk, sums each dot over E in one fixed order (so
// equal region rows give bitwise-equal scores, and exact ties stay ties),
// keeps its first maximum, and the 8 lanes merge (max, lowest index) by
// shuffles. The 4 frames of a block reuse the staged word tile.
//
// Bound on an H100 SXM (config4 training shapes I=16, M=B*K=128, T=20, R=20,
// E=256): 2*M*I*T*R*E = 419 MFLOP, ~6.3 us at 67 TFLOP/s f32 on CUDA cores,
// against ~7.0 MB moved (v 6.6 MB, w, masks, a and idx), ~2.1 us at 3.35
// TB/s: bound by operations in f32. In bf16 the same flops on tensor cores
// (989 TFLOP/s) take ~0.4 us and the 3.6 MB take ~1.1 us: bound by bytes.
// These count every region as live; the function needs the rows and dots of
// live regions only, so chip_smoke.py counts the bound from a batch's masks.
// This version runs the f32 dots on CUDA cores in both modes, from shared
// memory (5 16-byte loads feed 16 FMAs); PERF.md has its measured times.

#include <climits>

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

constexpr int kWords = 32;      // words of a block
constexpr int kRegions = 32;    // regions staged at once
constexpr int kFrames = 4;      // frames of a block
constexpr int kLanes = 8;       // lanes that share a word
constexpr int kThreads = kWords * kLanes;
constexpr int kPerLane = kRegions / kLanes;

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
cross_mil_kernel(const Tin* __restrict__ w,     // [M, E]
                 const Tin* __restrict__ v,     // [I, T, R, E]
                 const float* __restrict__ fm,  // [I, T]
                 const float* __restrict__ rm,  // [I, T, R] or null (all valid)
                 float* __restrict__ a,         // [I, M, T]
                 int* __restrict__ idx,         // [I, M, T]
                 int M, int T, int R, int E) {
  extern __shared__ __align__(16) float smem[];
  const int ld = E + 4;
  float* ws = smem;                   // [kWords][ld]   word tile
  float* vs = ws + kWords * ld;       // [kRegions][ld] region chunk
  float* live = vs + kRegions * ld;   // [kRegions]     region mask of the chunk

  const int t0 = blockIdx.x * kFrames;
  const int m0 = blockIdx.y * kWords;
  const int i = blockIdx.z;
  const int mw = min(kWords, M - m0);
  const int ml = threadIdx.x / kLanes;       // this thread's word in the tile
  const int lane = threadIdx.x % kLanes;
  const int e4 = E >> 2;

  stage_frame(ws, w + (size_t)m0 * E, mw, E, ld);
  const float4* wrow = reinterpret_cast<const float4*>(ws + min(ml, mw - 1) * ld);

  for (int t = t0; t < min(t0 + kFrames, T); ++t) {
    const size_t it = (size_t)i * T + t;
    const Tin* vt = v + it * R * E;
    float best = -CUDART_INF_F;
    int arg = INT_MAX;
    for (int r0 = 0; r0 < R; r0 += kRegions) {
      const int rc = min(kRegions, R - r0);
      __syncthreads();              // the word tile is staged; the last chunk read
      stage_frame(vs, vt + (size_t)r0 * E, rc, E, ld);
      if (threadIdx.x < rc)
        live[threadIdx.x] = rm ? rm[it * R + r0 + threadIdx.x] : 1.f;
      __syncthreads();

      const float4* vr[kPerLane];
      float d[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        vr[j] = reinterpret_cast<const float4*>(vs + min(lane + kLanes * j, rc - 1) * ld);
        d[j] = 0.f;
      }
      for (int q = 0; q < e4; ++q) {
        const float4 x = wrow[q];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const float4 c = vr[j][q];
          d[j] = fmaf(x.x, c.x, d[j]);
          d[j] = fmaf(x.y, c.y, d[j]);
          d[j] = fmaf(x.z, c.z, d[j]);
          d[j] = fmaf(x.w, c.w, d[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {   // regions in increasing order
        const int rl = lane + kLanes * j;
        if (rl < rc) {
          const float s = live[rl] > 0.f ? d[j] : kNeg;
          if (s > best) {
            best = s;
            arg = r0 + rl;
          }
        }
      }
    }
    // merge the 8 lanes of the word: the larger score, the lower index on ties
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (lane == 0 && ml < mw) {
      const size_t o = ((size_t)i * M + m0 + ml) * T + t;
      a[o] = fm[it] > 0.f ? best : 0.f;
      idx[o] = arg;
    }
  }
}

// Dynamic shared memory of one block, in bytes: 133,248 B at E = 512.
size_t smem_bytes(int E) {
  return (size_t)((kWords + kRegions) * (E + 4) + kRegions) * sizeof(float);
}

template <typename Tin>
int launch(const void* w, const void* v, const float* fm, const float* rm,
           float* a, int* idx, int I, int M, int T, int R, int E,
           cudaStream_t stream) {
  auto kern = cross_mil_kernel<Tin>;
  const size_t smem = smem_bytes(E);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kFrames - 1) / kFrames, (M + kWords - 1) / kWords, I);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const Tin*>(w),
                                         static_cast<const Tin*>(v), fm, rm, a,
                                         idx, M, T, R, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// w [M, E] and v [I, T, R, E] are float* when is_bf16 == 0 and
// __nv_bfloat16* otherwise; fm [I, T] and rm [I, T, R] (may be null: every
// region valid) are f32; a [I, M, T] f32 and idx [I, M, T] int32 are written
// whole. All tensors are contiguous; w and v are 16-byte aligned.
// Limits: R >= 1, E a multiple of 4 with 4 <= E <= 512, I <= 65535.
int nafae_cross_mil(const void* w, const void* v, int is_bf16, const float* fm,
                    const float* rm, float* a, int* idx, int I, int M, int T,
                    int R, int E, void* stream) {
  if (R < 1 || E < 4 || E % 4 != 0 || E > 512 || I < 0 || I > 65535 ||
      M < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  if (I == 0 || M == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(w, v, fm, rm, a, idx, I, M, T, R, E, s)
      : launch<float>(w, v, fm, rm, a, idx, I, M, T, R, E, s);
}

}  // extern "C"
