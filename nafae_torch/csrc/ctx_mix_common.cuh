// Device helpers shared by the port's kernels (the context mix, ctx_mix.cu and
// ctx_mix_bwd.cu, the fused cross-MIL and diag epilogue, cross_mil.cu and
// diag_epilogue*.cu, and the asynchronous copies of cross_mil.cu and
// roi_align.cu), for NVIDIA Hopper (sm_90a).
//
// Frames [R, E] are staged in shared memory as f32 rows of stride ld = E + 4
// (float4 reads of distinct rows fall in distinct banks), or, for the 16-bit
// tensor-core products (bf16 or f16: the context mix's kernels are templates
// on the type, every 16-bit helper below takes both), as 32 rows of the
// padded E + 8 in the input's type. Every helper is
// called by all threads of the block (blockDim.x a multiple of 32, at least
// R): the shuffles below name the full warp.
//
// Both directions of the context mix split their work the same way: a pairs
// kernel with one block per (video, frame pair) computes the R x R products
// of the two frames (pair_products, or pair_products_mma in 16 bits) and the
// masked softmax (row_softmax), and a second kernel with one block per frame
// (the backward: and slice of kSlice columns) sums the pairs' matrices
// times the neighbours' frames, streamed ahead of the sums.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace nafae_ctx {

constexpr float kNeg = -1e9f;    // the reference's masked-logit fill (NEG)
constexpr int kMaxThreads = 512;
constexpr int kPairThreads = 256;   // a pairs block: 8 warps
constexpr int kSlice = 64;          // columns of a per-frame block
constexpr int kMmaLd = kSlice + 8;  // 16-bit slice rows: 144 bytes
constexpr int kMatLd = 32 + 8;      // 16-bit R x R matrix rows: 80 bytes

// Offset index i in [0, 2w) -> offset o in {-w..-1, 1..w}.
__device__ __forceinline__ int offset_of(int i, int w) {
  return i < w ? i - w : i - w + 1;
}

// x rounded to the compute dtype's precision, kept as f32 (identity for f32):
// bf16 x bf16 and f16 x f16 products are exact in f32, so rounding the
// operands and summing in f32 is the reference's preferred_element_type=f32
// contract.
__device__ __forceinline__ float as_operand(float x, const float*) {
  return x;
}
__device__ __forceinline__ float as_operand(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// f16 rounds to nearest, subnormals kept (no flush: the build has no
// --use_fast_math, and du_n at gradient scale lies below f16's normals)
__device__ __forceinline__ float as_operand(float x, const __half*) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_as(__half* p, float x) {
  *p = __float2half_rn(x);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const __half* p) {
  return __half2float(*p);
}

// Four consecutive elements as f32 (16-byte f32 or 8-byte 16-bit loads).
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
__device__ __forceinline__ float4 load4(const __half* p, int i) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 c = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

// v_ext's type by the C entry points' dtype code (0: f32, 1: bf16, 2: f16):
// f(T{}) for that type T, `bad` for any other code.
template <typename R, typename F>
R by_dtype(int code, R bad, F f) {
  switch (code) {
    case 0: return f(float{});
    case 1: return f(__nv_bfloat16{});
    case 2: return f(__half{});
    default: return bad;
  }
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

// One asynchronous copy of kBytes (4, 8 or 16) from global to shared memory
// (cp.async); only the first src_bytes are read, the rest is zero-filled, so
// src_bytes = 0 writes zeros. Both addresses are kBytes-aligned.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16,
                "cp.async of 4, 8 or 16 bytes");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
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
  if (per_row <= 0) return;
  // chunk c = threadIdx.x + i blockDim.x is (row r, chunk q of the row);
  // both advance by a fixed step, with no division a chunk
  const int step_r = blockDim.x / per_row;
  const int step_q = blockDim.x - step_r * per_row;
  int r = threadIdx.x / per_row;
  int q = threadIdx.x - r * per_row;
  for (; r < rows; r += step_r) {
    const int k = q * kVec;
    const bool ok = r < live_rows && k0 + k < E;
    cp_async<kBytes>(dst + r * ld + k,
                     ok ? src + (size_t)r * E + k0 + k : src, ok ? kBytes : 0);
    q += step_q;
    if (q >= per_row) {
      q -= per_row;
      ++r;
    }
  }
}

// stage_tile_async for rows of any alignment: the widest copy (16, 8 or 4
// bytes) that a row of E elements allows, the rows' base being 16-byte
// aligned; where a row is not even 4-byte aligned (16-bit at odd E), plain
// loads and stores, which are complete at the caller's next barrier. kw, k0
// and ld are multiples of 16 bytes' worth of elements. Block-uniform.
template <typename T>
__device__ __forceinline__ void stage_tile_any(T* __restrict__ dst,
                                               const T* __restrict__ src,
                                               int rows, int live_rows, int E,
                                               int k0, int kw, int ld) {
  constexpr int kSz = (int)sizeof(T);
  const int row_bytes = E * kSz;
  if (row_bytes % 16 == 0) {
    stage_tile_async<16 / kSz>(dst, src, rows, live_rows, E, k0, kw, ld);
  } else if (row_bytes % 8 == 0) {
    stage_tile_async<8 / kSz>(dst, src, rows, live_rows, E, k0, kw, ld);
  } else if (row_bytes % 4 == 0) {
    stage_tile_async<4 / kSz>(dst, src, rows, live_rows, E, k0, kw, ld);
  } else {
    for (int i = threadIdx.x; i < rows * kw; i += blockDim.x) {
      const int r = i / kw, k = i - r * kw;
      store_as(dst + r * ld + k, r < live_rows && k0 + k < E
                                     ? load1(src + (size_t)r * E + k0 + k)
                                     : 0.f);
    }
  }
}

// Four consecutive elements of a shared row as f32.
__device__ __forceinline__ float4 lds4(const float* p, int q) {
  return reinterpret_cast<const float4*>(p)[q];
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p, int q) {
  return load4(p, q);
}
__device__ __forceinline__ float4 lds4(const __half* p, int q) {
  return load4(p, q);
}

// All R x R row dots U[r] . N[s] (and, with kScores, C[r] . N[s]) of staged
// frames of stride ld; epi(r, s, dot_u, dot_c) once for each r, s < R.
// Groups of 8 lanes compute 4 x 4 (r, s) tiles: lane j takes 4-column
// groups j, j+8, ... (the 8 lanes read 128 contiguous bytes of f32,
// conflict-free) and the group sums by shuffles; the neighbour's loads are
// shared by the two products.
template <bool kScores, typename Tin, typename Epi>
__device__ __forceinline__ void pair_products(const Tin* __restrict__ U,
                                              const Tin* __restrict__ C,
                                              const Tin* __restrict__ N,
                                              int R, int E, int ld, Epi epi) {
  const int j = threadIdx.x & 7;
  const int tiles_1d = (R + 3) >> 2;
  const int n_tiles = tiles_1d * tiles_1d;
  const int e4 = E >> 2;
  for (int base = 0; base < n_tiles; base += blockDim.x >> 3) {
    const int tile = base + (threadIdx.x >> 3);
    const int r0 = (tile / tiles_1d) * 4;
    const int s0 = (tile % tiles_1d) * 4;
    float d[4][4], c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) d[i][k] = c[i][k] = 0.f;
    if (tile < n_tiles) {         // uniform across the 8 lanes of a group
      for (int q = j; q < e4; q += 8) {
        float4 u[4], y[4], x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          u[i] = lds4(U + min(r0 + i, R - 1) * ld, q);
          y[i] = lds4(N + min(s0 + i, R - 1) * ld, q);
          if (kScores) x[i] = lds4(C + min(r0 + i, R - 1) * ld, q);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            d[i][k] = fmaf(u[i].x, y[k].x, d[i][k]);
            d[i][k] = fmaf(u[i].y, y[k].y, d[i][k]);
            d[i][k] = fmaf(u[i].z, y[k].z, d[i][k]);
            d[i][k] = fmaf(u[i].w, y[k].w, d[i][k]);
            if (kScores) {
              c[i][k] = fmaf(x[i].x, y[k].x, c[i][k]);
              c[i][k] = fmaf(x[i].y, y[k].y, c[i][k]);
              c[i][k] = fmaf(x[i].z, y[k].z, c[i][k]);
              c[i][k] = fmaf(x[i].w, y[k].w, c[i][k]);
            }
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 4; m > 0; m >>= 1) {
          d[i][k] += __shfl_xor_sync(0xffffffffu, d[i][k], m);
          if (kScores) c[i][k] += __shfl_xor_sync(0xffffffffu, c[i][k], m);
        }
    // every lane of the group holds the same sums (the butterfly adds the
    // same pairs in each lane); lane j passes on entries j and j + 8 of the
    // tile, picked by selects, so the epilogue runs twice a warp, not 16
    // times
    if (tile < n_tiles) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int e = j + 8 * m;
        float vd = 0.f, vc = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (i * 4 + k == e) {
              vd = d[i][k];
              vc = c[i][k];
            }
        const int r = r0 + (e >> 2), s = s0 + (e & 3);
        if (r < R && s < R) epi(r, s, vd, vc);
      }
    }
  }
}

// D += X Y on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulators (x: the A fragment, y0 and y1: the B fragment).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&x)[4],
                                         uint32_t y0, uint32_t y1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y0), "r"(y1));
}

// The same with f16 operands: the same fragment layout and rate, three more
// mantissa bits, and f16 subnormals taken as they are.
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&x)[4],
                                        uint32_t y0, uint32_t y1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y0), "r"(y1));
}

// mma_bf16 or mma_f16 by the operands' type T16.
template <typename T16>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&x)[4],
                                      uint32_t y0, uint32_t y1) {
  static_assert(sizeof(T16) == 2, "16-bit operands");
  if constexpr (std::is_same_v<T16, __half>)
    mma_f16(c, x, y0, y1);
  else
    mma_bf16(c, x, y0, y1);
}

// Two consecutive 16-bit elements (bf16 or f16) as one register.
template <typename T16>
__device__ __forceinline__ uint32_t lds32(const T16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment (16 x 16 at row m0, column k) of a row-major 16-bit tile.
template <typename T16>
__device__ __forceinline__ void frag_a(uint32_t (&x)[4], const T16* p, int ld,
                                       int m0, int k) {
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  const T16* q = p + (m0 + g) * ld + k + 2 * tig;
  x[0] = lds32(q);
  x[1] = lds32(q + 8 * ld);
  x[2] = lds32(q + 8);
  x[3] = lds32(q + 8 * ld + 8);
}

// The B fragments of two n8 tiles (16 rows k0.., 16 columns n0..) of a
// row-major 16-bit tile of stride ld, by ldmatrix.trans: y[0], y[1] for
// columns n0..n0+7, y[2], y[3] for n0+8..n0+15.
template <typename T16>
__device__ __forceinline__ void frag_b2_trans(uint32_t (&y)[4], const T16* p,
                                             int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const T16* q = p + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(q);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(y[0]), "=r"(y[1]), "=r"(y[2]), "=r"(y[3])
      : "r"(addr));
}

// 16-bit (tensor cores): the row dots U[r] . N[s] (and, with kScores,
// C[r] . N[s]) for r, s < 32 of frames staged as 32 rows of stride ld, zero
// beyond R and E; epi(r, s, dot_u, dot_c) once for each r, s < 32 (rows and
// columns beyond R hold zeros). Eight warps, one m16 x n8 tile each of the
// 32 x 32 outputs, f32 accumulators over the padded E (ep, a multiple of 16).
template <bool kScores, typename T16, typename Epi>
__device__ __forceinline__ void pair_products_mma(const T16* __restrict__ U,
                                                  const T16* __restrict__ C,
                                                  const T16* __restrict__ N,
                                                  int ep, int ld, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;
  float d[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < ep; k += 16) {
    const T16* q = N + (n0 + g) * ld + k + 2 * tig;
    const uint32_t y0 = lds32(q), y1 = lds32(q + 8);
    uint32_t x[4];
    frag_a(x, U, ld, m0, k);
    mma16<T16>(d, x, y0, y1);
    if (kScores) {
      frag_a(x, C, ld, m0, k);
      mma16<T16>(c, x, y0, y1);
    }
  }
#pragma unroll
  for (int z = 0; z < 4; ++z)
    epi(m0 + g + (z >> 1) * 8, n0 + 2 * tig + (z & 1), d[z], c[z]);
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

// ---------------------------------------------------------------------------
// The general variant of the context mix's backward (ctx_mix_bwd.cu takes
// it for every shape outside its specialised kernels' envelope: R > 32, E
// not a multiple of 4 or above 512, w > 16), and the forward's wide kernels
// (ctx_mix.cu, past R = 64 or w = 512): any R, any E, any w. Their blocks
// of kAnyThreads threads walk 32 regions (rows) at a time and the embedding
// in slices of 64 columns, staged as f32 through shared memory by scalar
// loads, so no row needs any alignment and nothing grows with R, E or w.

constexpr int kAnyThreads = 256;
constexpr int kAnyRows = 32;              // regions of a tile
constexpr int kAnyCols = 64;              // embedding columns of a slice
constexpr int kAnyLd = kAnyCols + 4;      // slice rows for 16-byte reads
constexpr int kAnyMatLd = kAnyRows + 4;   // [32][32] matrix rows, the same

// The slices of the row dots: X's and Y's 32 rows of 64 columns.
struct AnyDotSmem {
  float x[kAnyRows * kAnyLd];
  float y[kAnyRows * kAnyLd];
};

__device__ __forceinline__ float any_warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// The butterfly adds the same pairs in every lane, so every lane holds the
// same sum.
__device__ __forceinline__ float any_warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// Row dots of a 32 x 32 tile of two [R, E] frames: thread (ty =
// threadIdx.x / 32, tx = lane) sums X[r0 + ty + 8k] . Y[s0 + tx] (k < 4)
// over all E columns into acc[k], the columns in order (one fmaf each), a
// 64-column slice at a time through sm; rows at or past R and columns past
// E are zeros, which add nothing. fx(x) maps each element of X (the
// backward's du_n). Called by all kAnyThreads threads.
template <typename TX, typename TY, typename FX>
__device__ __forceinline__ void any_tile_dots(float (&acc)[4],
                                              const TX* __restrict__ X,
                                              const TY* __restrict__ Y,
                                              int R, int r0, int s0, int E,
                                              AnyDotSmem& sm, FX fx) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = 0.f;
  for (int e0 = 0; e0 < E; e0 += kAnyCols) {
    __syncthreads();                      // the last slice is read
    for (int i = threadIdx.x; i < kAnyRows * kAnyCols; i += blockDim.x) {
      const int row = i / kAnyCols, col = i - row * kAnyCols;
      const int e = e0 + col;
      const int r = r0 + row, s = s0 + row;
      sm.x[row * kAnyLd + col] =
          r < R && e < E ? fx(load1(X + (size_t)r * E + e)) : 0.f;
      sm.y[row * kAnyLd + col] =
          s < R && e < E ? load1(Y + (size_t)s * E + e) : 0.f;
    }
    __syncthreads();
    const float* xr = sm.x + ty * kAnyLd;
    const float* yr = sm.y + tx * kAnyLd;
#pragma unroll 4
    for (int c = 0; c < kAnyCols; c += 4) {
      const float4 y = *reinterpret_cast<const float4*>(yr + c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 x =
            *reinterpret_cast<const float4*>(xr + 8 * k * kAnyLd + c);
        acc[k] = fmaf(x.x, y.x, acc[k]);
        acc[k] = fmaf(x.y, y.y, acc[k]);
        acc[k] = fmaf(x.z, y.z, acc[k]);
        acc[k] = fmaf(x.w, y.w, acc[k]);
      }
    }
  }
}

// The masked softmax over s < R of rows r0 + ty + 8k (k < 4) of the scores
// vc[r] . vn[s] / temp (kNeg where live(s) is false), any R: a first pass
// over tiles of 32 columns keeps each row's running max and sum (the sum
// rescaled when the max rises), a second recomputes each tile's scores, by
// the same instructions, and calls epi(r, s, p) for r, s < R. An all-masked
// row gives the uniform 1/R, as the reference's softmax does.
template <typename Tin, typename Live, typename Epi>
__device__ __forceinline__ void any_row_softmax(const Tin* __restrict__ vc,
                                                const Tin* __restrict__ vn,
                                                int R, int E, int r0,
                                                float temp, Live live,
                                                AnyDotSmem& sm, Epi epi) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  auto same = [](float x) { return x; };
  float m[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = -CUDART_INF_F;
    l[k] = 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    for (int s0 = 0; s0 < R; s0 += kAnyRows) {
      float acc[4];
      any_tile_dots(acc, vc, vn, R, r0, s0, E, sm, same);
      const int s = s0 + tx;
      const bool on = s < R, lv = on && live(s);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float x = on ? (lv ? acc[k] / temp : kNeg) : -CUDART_INF_F;
        if (pass == 0) {                  // block-uniform
          const float mn = fmaxf(m[k], any_warp_max(x));
          l[k] = l[k] * expf(m[k] - mn) +
                 any_warp_sum(on ? expf(x - mn) : 0.f);
          m[k] = mn;
        } else {
          const int r = r0 + ty + 8 * k;
          if (on && r < R) epi(r, s, expf(x - m[k]) / l[k]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The staged general kernels (ctx_mix.cu's forward and ctx_mix_bwd.cu's
// backward up to R = 64): a pairs kernel, then a per-frame kernel launched
// as its programmatic dependent.

// Programmatic dependent launch (Hopper): the per-frame kernel is launched
// while the pairs kernel still runs, so its blocks start, read the masks and
// copy their first frames as the pairs kernel's blocks retire; before its
// first read of what the pairs kernel writes it waits for the pairs grid to
// complete (a no-op in a launch without the attribute). Each pairs block
// lets the dependent grid launch once it has started.
__device__ __forceinline__ void wait_for_pairs() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_mix_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Rows of the staged kernels' shared tiles, in elements: 16-byte multiples,
// and strides that keep a warp's reads conflict-free.
template <typename Tin>
__host__ __device__ constexpr int stage_ld(int cols) {
  return cols + (sizeof(Tin) == 2 ? 8 : 4);
}

// The softmax of one row (or column) of the stored scores, one warp: x(j)
// gives element j < R (kNeg where masked), put(j, p) stores p. An all-kNeg
// line gives the uniform 1/R.
template <int kPer, typename X, typename Put>
__device__ __forceinline__ void warp_softmax(int R, X x, Put put) {
  const int lane = threadIdx.x & 31;
  float v[kPer];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < R ? x(j) : -CUDART_INF_F;
    m = fmaxf(m, v[k]);
  }
  m = any_warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = lane + 32 * k < R ? expf(v[k] - m) : 0.f;
    sum += v[k];
  }
  sum = any_warp_sum(sum);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (lane + 32 * k < R) put(lane + 32 * k, v[k] / sum);
}

}  // namespace nafae_ctx
