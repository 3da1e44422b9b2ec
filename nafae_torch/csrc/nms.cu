// Batched greedy NMS for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nafae_tpu/ops/pallas/nms.py::_kernel (K2, called by
// nms_pallas_planes :98 and nms_pallas :149). Same function as the port's
// plain version, nafae_torch/ops/nms.py::nms_planes, and the same survivors
// exactly:
//
//   for every row b, starting with every box live (masked score m = score):
//     num_keep times:  best  = the first index of max_j m[j]
//                      valid = m[best] > -1e9
//                      emit (best, valid); if !valid the row is exhausted and
//                      emits (0, 0) from then on
//                      kill best and every box with iou(best, j) > thresh,
//                      where a killed box reads m = -1e9
//
// Exactness: the IoU is written with __fsub_rn / __fadd_rn / __fmul_rn /
// __fdiv_rn so that nvcc contracts nothing into an FMA, in the reference's
// order (union = area_j + area_best - inter, then inter / max(union, 1e-12),
// 0 where union <= 0), with f32 constants and the threshold passed as f32.
//
// Design: one block per row, 512 threads, each thread walking boxes j = tid,
// tid + 512, ... The masked scores of the row live in shared memory (4 bytes a
// box, up to kSmemBoxes boxes; a longer row keeps them in a scratch row in
// device memory instead), so liveness costs no global traffic. Each step is a
// block-wide (max, first index) reduction (warp shuffles, then one warp over
// the 16 warp results) and one pass that reads the four coordinates of every
// still-live box and kills the overlaps. The coordinates are re-read from
// device memory (or L2) at every step: a row of 24,000 boxes takes 480 KB in
// its five planes, more than one SM's 227 KB of shared memory.
//
// Bound on an H100 SXM (config 5: 320 rows x N = 24,000 anchors, num_keep 20):
// the function reads the five f32 planes once, 154 MB, 0.046 ms at 3.35 TB/s;
// its operations (num_keep x N IoUs a row, ~20 flops each, 3 GFLOP) take
// 0.046 ms at 67 TFLOP/s. This design re-reads the coordinates of the live
// boxes at each of the num_keep steps (up to 20 x 123 MB), so it is bound by
// those bytes, about 20x above the function's bound; keeping the row's
// coordinates on chip (a cluster of blocks sharing their shared memory) is
// the way down.
//
// Limits: N >= 1 and N < 2^31; any number of rows and any num_keep.

#include <cuda_runtime.h>

#include <math_constants.h>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e9f;
constexpr int kSmemBoxes = 50 * 1024;       // 200 KB of masked scores

// (value, index) merge: the larger value, the lower index on ties
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
           const float* __restrict__ x2, const float* __restrict__ y2,
           const float* __restrict__ scores, float* __restrict__ scratch,
           int* __restrict__ idx_out, float* __restrict__ valid_out, int N,
           int num_keep, float thresh, int in_smem) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float win[5];        // winner's x1, y1, x2, y2, area
  __shared__ int win_i;
  __shared__ int win_ok;

  const size_t row = blockIdx.x;
  const size_t base = row * (size_t)N;
  float* m = in_smem ? smem : scratch + base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int j = tid; j < N; j += kThreads) m[j] = scores[base + j];
  __syncthreads();

  int it = 0;
  for (; it < num_keep; ++it) {
    // (max, first index) of the masked scores
    float bv = tid < N ? m[tid] : -CUDART_INF_F;
    int bi = tid < N ? tid : INT_MAX;
    for (int j = tid + kThreads; j < N; j += kThreads) {
      const float v = m[j];
      if (v > bv) {        // j increases: the first index of a tie stays
        bv = v;
        bi = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
            __shfl_xor_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -CUDART_INF_F;
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
              __shfl_xor_sync(0xffffffffu, bi, off));
      if (lane == 0) {
        const int ok = bv > kNeg;
        idx_out[row * num_keep + it] = bi;
        valid_out[row * num_keep + it] = ok ? 1.f : 0.f;
        win_ok = ok;
        win_i = bi;
        if (ok) {
          const float bx1 = x1[base + bi], by1 = y1[base + bi];
          const float bx2 = x2[base + bi], by2 = y2[base + bi];
          win[0] = bx1;
          win[1] = by1;
          win[2] = bx2;
          win[3] = by2;
          win[4] = __fmul_rn(fmaxf(__fsub_rn(bx2, bx1), 0.f),
                             fmaxf(__fsub_rn(by2, by1), 0.f));
        }
      }
    }
    __syncthreads();
    if (!win_ok) break;                       // exhausted: (0, 0) from here on

    const float bx1 = win[0], by1 = win[1], bx2 = win[2], by2 = win[3];
    const float barea = win[4];
    const int best = win_i;
    for (int j = tid; j < N; j += kThreads) {
      if (m[j] == kNeg) continue;             // already dead (or reads as such)
      const float ax1 = x1[base + j], ay1 = y1[base + j];
      const float ax2 = x2[base + j], ay2 = y2[base + j];
      const float area = __fmul_rn(fmaxf(__fsub_rn(ax2, ax1), 0.f),
                                   fmaxf(__fsub_rn(ay2, ay1), 0.f));
      const float ix = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.f);
      const float iy = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.f);
      const float inter = __fmul_rn(ix, iy);
      const float uni = __fsub_rn(__fadd_rn(area, barea), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
      if (iou > thresh || j == best) m[j] = kNeg;
    }
    __syncthreads();
  }
  for (int k = it + 1 + tid; k < num_keep; k += kThreads) {
    idx_out[row * num_keep + k] = 0;
    valid_out[row * num_keep + k] = 0.f;
  }
  // the exhausted step itself emits (0, 0) when every box is dead; a row
  // whose live boxes all score at or below -1e9 emits the reference's argmax
  // there, which the reduction above already wrote
}

}  // namespace

extern "C" {

// Largest N whose masked scores the kernel keeps in shared memory; a longer
// row needs `scratch` (B x N f32 in device memory), else scratch may be null.
int nafae_nms_smem_boxes() { return kSmemBoxes; }

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// x1, y1, x2, y2, scores: [B, N] f32, contiguous; idx [B, num_keep] int32 and
// valid [B, num_keep] f32 are written whole.
int nafae_nms(const float* x1, const float* y1, const float* x2,
              const float* y2, const float* scores, float* scratch,
              int* idx, float* valid, int B, int N, int num_keep,
              float thresh, void* stream) {
  if (B < 0 || N < 1 || num_keep < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || num_keep == 0) return 0;
  const int in_smem = N <= kSmemBoxes;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? (size_t)N * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, x2, y2, scores, scratch, idx, valid, N, num_keep, thresh,
      in_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
