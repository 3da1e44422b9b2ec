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
// bf16 features rounded to bf16 as the reference rounds them. Sums are f32
// and the output is f32 in both dtypes, [F * R, P, P, C]: a C5 head reads it
// as channels_last [N, C, P, P] without a copy.
//
// Design: the TPU computes two dense MXU contractions over the whole map; here
// each output cell sums only over its support, at most 2 * sr rows and 2 * sr
// columns. One block per box; the block builds wy and wx densely in shared
// memory, then each thread takes channels c = tid, tid + 256, ... and walks
// the rows some p touches: for such a row h it forms st[q] = sum_w wx[q, w] *
// feat[h, w, c] over q's non-zero columns, then adds wy[p, h] * st[q] into its
// 49 register accumulators (the reference's order: over w, then over h).
// Neighbouring threads read neighbouring channels, so every load of a warp is
// one 128-byte line (f32) of the frame's map, which the frame's boxes share in
// L2. Any H, W (each up to kMaxSize), any C, the all-zero boxes of dead NMS
// slots (extent clamped to 1), boxes off the map or smaller than a cell.
//
// Bound on an H100 SXM (config 5: 320 frames of [40, 40, 1024] f32, 20 boxes a
// frame): the output alone is 6,400 x 49 x 1,024 x 4 B = 1.28 GB, 0.38 ms at
// 3.35 TB/s, plus the feature cells some box of a frame reads (at most the
// whole 2.1 GB of maps); the products (16 a cell and channel) are far below.
// Bound by bytes. This design reads each feature cell a box touches once per
// box and channel, from L2 when the frame's boxes overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 7;             // output grid (the detector's 7 x 7)
constexpr int kThreads = 256;
constexpr int kMaxSize = 2048;    // largest H and W

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// wt[p * size + h] for one axis: the reference's _weights, then rounded to
// the feature's dtype when it is bf16
__device__ void axis_weights(float* wt, float lo, float hi, int size, int sr,
                             bool bf16) {
  const float extent = fmaxf(__fsub_rn(hi, lo), 1.f);
  const float cell = __fdiv_rn(extent, (float)kP);
  const float top = (float)(size - 1);
  for (int k = threadIdx.x; k < kP * size; k += blockDim.x) {
    const int p = k / size, h = k % size;
    float acc = 0.f;
    for (int s = 0; s < sr; ++s) {
      const float off = (float)((s + 0.5) / (double)sr);
      float pt = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, off), cell));
      pt = fminf(fmaxf(__fsub_rn(pt, 0.5f), 0.f), top);
      acc = __fadd_rn(acc,
                      fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(pt, (float)h))), 0.f));
    }
    float w = __fdiv_rn(acc, (float)sr);
    if (bf16) w = __bfloat162float(__float2bfloat16_rn(w));
    wt[k] = w;
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const Tin* __restrict__ feat,     // [F, H, W, C]
                 const float* __restrict__ boxes,  // [F, R, 4] xyxy
                 float* __restrict__ out,          // [F * R, P, P, C]
                 int R, int H, int W, int C, float scale, int sr) {
  extern __shared__ float smem[];
  float* wy = smem;                    // [P][H]
  float* wx = wy + kP * H;             // [P][W]
  __shared__ int xlo[kP], xhi[kP];     // non-zero columns of each q
  __shared__ int hlo, hhi;             // rows some p touches

  const size_t n = blockIdx.x;
  const size_t f = n / R;
  const float* b = boxes + n * 4;
  const float x1 = __fmul_rn(b[0], scale), y1 = __fmul_rn(b[1], scale);
  const float x2 = __fmul_rn(b[2], scale), y2 = __fmul_rn(b[3], scale);
  constexpr bool bf16 = sizeof(Tin) == 2;
  axis_weights(wy, y1, y2, H, sr, bf16);
  axis_weights(wx, x1, x2, W, sr, bf16);
  __syncthreads();
  if (threadIdx.x < kP) {
    const int q = threadIdx.x;
    int lo = W, hi = -1;
    for (int w = 0; w < W; ++w)
      if (wx[q * W + w] != 0.f) {
        lo = min(lo, w);
        hi = w;
      }
    xlo[q] = lo;
    xhi[q] = hi;
  } else if (threadIdx.x == kP) {
    int lo = H, hi = -1;
    for (int p = 0; p < kP; ++p)
      for (int h = 0; h < H; ++h)
        if (wy[p * H + h] != 0.f) {
          lo = min(lo, h);
          hi = max(hi, h);
        }
    hlo = lo;
    hhi = hi;
  }
  __syncthreads();

  const Tin* fm = feat + f * (size_t)H * W * C;
  float* o = out + n * (size_t)kP * kP * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc[kP][kP];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int q = 0; q < kP; ++q) acc[p][q] = 0.f;
    for (int h = hlo; h <= hhi; ++h) {
      bool used = false;
#pragma unroll
      for (int p = 0; p < kP; ++p) used |= wy[p * H + h] != 0.f;
      if (!used) continue;
      const Tin* row = fm + (size_t)h * W * C + c;
      float st[kP];
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        float s = 0.f;
        for (int w = xlo[q]; w <= xhi[q]; ++w) {
          const float wv = wx[q * W + w];
          if (wv != 0.f) s = fmaf(wv, load1(row + (size_t)w * C), s);
        }
        st[q] = s;
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float wv = wy[p * H + h];
        if (wv != 0.f) {
#pragma unroll
          for (int q = 0; q < kP; ++q) acc[p][q] = fmaf(wv, st[q], acc[p][q]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int q = 0; q < kP; ++q) o[(size_t)(p * kP + q) * C + c] = acc[p][q];
  }
}

template <typename Tin>
int launch(const void* feat, const float* boxes, float* out, int F, int R,
           int H, int W, int C, float scale, int sr, cudaStream_t stream) {
  auto kern = roi_align_kernel<Tin>;
  const size_t smem = (size_t)kP * (H + W) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)((size_t)F * R), kThreads, smem, stream>>>(
      static_cast<const Tin*>(feat), boxes, out, R, H, W, C, scale, sr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// feat [F, H, W, C] is float* when is_bf16 == 0 and __nv_bfloat16* otherwise;
// boxes [F, R, 4] f32 in image coordinates; out [F * R, 7, 7, C] f32 is
// written whole. All contiguous.
// Limits: out_size 7, 1 <= sr <= 64, 1 <= H, W <= 2048, C >= 1,
// F * R < 2^31.
int nafae_roi_align(const void* feat, int is_bf16, const float* boxes,
                    float* out, int F, int R, int H, int W, int C, float scale,
                    int sr, void* stream) {
  if (F < 0 || R < 0 || H < 1 || W < 1 || H > kMaxSize || W > kMaxSize ||
      C < 1 || sr < 1 || sr > 64 || (long long)F * R >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (F == 0 || R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(feat, boxes, out, F, R, H, W, C, scale, sr, s)
      : launch<float>(feat, boxes, out, F, R, H, W, C, scale, sr, s);
}

}  // extern "C"
