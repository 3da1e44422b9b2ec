// Device helpers shared by the port's kernels (the context mix, ctx_mix.cu and
// ctx_mix_bwd.cu, the fused cross-MIL and diag epilogue, cross_mil.cu and
// diag_epilogue*.cu, and the asynchronous copies of cross_mil.cu and
// roi_align.cu), for NVIDIA Hopper (sm_90a).
//
// Frames [R, E] are staged in shared memory as f32 rows of stride ld = E + 4
// (float4 reads of distinct rows fall in distinct banks). Every helper is
// called by all threads of the block (blockDim.x a multiple of 32, at least
// R): the shuffles below name the full warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace nafae_ctx {

constexpr float kNeg = -1e9f;    // the reference's masked-logit fill (NEG)
constexpr int kMaxThreads = 512;

// x rounded to the compute dtype's precision, kept as f32 (identity for f32):
// bf16 x bf16 products are exact in f32, so rounding the operands and
// summing in f32 is the reference's preferred_element_type=f32 contract.
__device__ __forceinline__ float as_operand(float x, const float*) {
  return x;
}
__device__ __forceinline__ float as_operand(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Four consecutive elements as f32 (16-byte f32 or 8-byte bf16 loads).
__device__ __forceinline__ float4 load4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int i) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

// One frame [R, E] from global memory into shared rows of stride ld, as f32.
// Unrolled so that several loads are in flight before the first store.
template <typename Tin>
__device__ __forceinline__ void stage_frame(float* __restrict__ dst,
                                            const Tin* __restrict__ src,
                                            int R, int E, int ld) {
  const int n4 = (R * E) >> 2;
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const int flat = i << 2;
    const int r = flat / E;
    *reinterpret_cast<float4*>(dst + r * ld + (flat - r * E)) = load4(src, i);
  }
}

// One asynchronous copy of kBytes (8 or 16) from global to shared memory
// (cp.async); only the first src_bytes are read, the rest is zero-filled, so
// src_bytes = 0 writes zeros. Both addresses are kBytes-aligned.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(kBytes == 8 || kBytes == 16, "cp.async of 8 or 16 bytes");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

// Closes the group of the copies issued so far by this thread.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` (0..3) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// The asynchronous sibling of stage_frame, in the input's own type: columns
// [k0, k0 + kw) of `rows` rows of a row-major [., E] array into shared rows
// of stride ld elements, kVec elements (8 or 16 bytes) a copy. Rows at or
// beyond live_rows and columns at or beyond E are zero-filled. kw, k0, E and
// ld are multiples of kVec; the caller commits and waits.
template <int kVec, typename T>
__device__ __forceinline__ void stage_tile_async(T* __restrict__ dst,
                                                 const T* __restrict__ src,
                                                 int rows, int live_rows, int E,
                                                 int k0, int kw, int ld) {
  constexpr int kBytes = kVec * (int)sizeof(T);
  const int per_row = kw / kVec;
  for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int k = (c - r * per_row) * kVec;
    const bool ok = r < live_rows && k0 + k < E;
    cp_async<kBytes>(dst + r * ld + k,
                     ok ? src + (size_t)r * E + k0 + k : src, ok ? kBytes : 0);
  }
}

// All R x R row dots X[r] . Y[s] of two staged frames; epi(r, s, dot) is
// called once for each r, s < R. Groups of 8 lanes compute 4 x 4 (r, s)
// tiles: lane j takes float4 columns j, j+8, ... (the 8 lanes read 128
// contiguous bytes, conflict-free) and the group sums by shuffles. Eight
// 16-byte shared loads feed 64 FMAs.
template <typename Epi>
__device__ __forceinline__ void tile_products(const float* __restrict__ X,
                                              const float* __restrict__ Y,
                                              int R, int E, int ld, Epi epi) {
  const int j = threadIdx.x & 7;
  const int tiles_1d = (R + 3) >> 2;
  const int n_tiles = tiles_1d * tiles_1d;
  const int e4 = E >> 2;
  for (int base = 0; base < n_tiles; base += blockDim.x >> 3) {
    const int tile = base + (threadIdx.x >> 3);
    const int r0 = (tile / tiles_1d) * 4;
    const int s0 = (tile % tiles_1d) * 4;
    float d[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) d[i][k] = 0.f;
    if (tile < n_tiles) {         // uniform across the 8 lanes of a group
      const float4* x[4];
      const float4* y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = reinterpret_cast<const float4*>(X + min(r0 + i, R - 1) * ld);
        y[i] = reinterpret_cast<const float4*>(Y + min(s0 + i, R - 1) * ld);
      }
      for (int q = j; q < e4; q += 8) {
        float4 a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = x[i][q];
          c[i] = y[i][q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            d[i][k] = fmaf(a[i].x, c[k].x, d[i][k]);
            d[i][k] = fmaf(a[i].y, c[k].y, d[i][k]);
            d[i][k] = fmaf(a[i].z, c[k].z, d[i][k]);
            d[i][k] = fmaf(a[i].w, c[k].w, d[i][k]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 4; m > 0; m >>= 1)
          d[i][k] += __shfl_xor_sync(0xffffffffu, d[i][k], m);
    if (j == 0 && tile < n_tiles) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (r0 + i < R && s0 + k < R) epi(r0 + i, s0 + k, d[i][k]);
    }
  }
}

// Softmax over s of every row r < R of the logits sc[r * lds + s] (row max
// subtracted); epi(r, s, p) is called once for each r, s < R. 8 lanes per
// row (lane j takes s = j, j+8, j+16, j+24), up to blockDim/8 rows at once;
// the row max and sum reduce by shuffles within the 8 lanes. An all-kNeg
// row gives the uniform 1/R, as the reference's softmax does.
template <typename Epi>
__device__ __forceinline__ void row_softmax(const float* __restrict__ sc,
                                            int lds, int R, Epi epi) {
  const int j = threadIdx.x & 7;
  for (int base = 0; base < R; base += blockDim.x >> 3) {
    const int r = base + (threadIdx.x >> 3);
    float x[4];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = j + 8 * k;
      x[k] = (r < R && s < R) ? sc[r * lds + s] : -CUDART_INF_F;
      m = fmaxf(m, x[k]);
    }
#pragma unroll
    for (int k = 4; k > 0; k >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, k));
    float ex[4];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ex[k] = (r < R && j + 8 * k < R) ? expf(x[k] - m) : 0.f;
      sum += ex[k];
    }
#pragma unroll
    for (int k = 4; k > 0; k >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, k);
    if (r < R) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j + 8 * k < R) epi(r, j + 8 * k, ex[k] / sum);
    }
  }
}

}  // namespace nafae_ctx
