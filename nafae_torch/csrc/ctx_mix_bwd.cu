// Context mixing, backward: the gradient of ctx_mix.cu's forward with
// respect to the halo-extended region embeddings, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels nafae_tpu/ops/pallas/fused_ctx.py::_bwd_kernel
// (K1b, alpha recomputed from the scores) and ::_bwd_kernel_res (K1br, alpha
// read from the forward's residual). One pair of kernel templates serves
// both; the two C entry points below pick them. Math, per video b, centre
// frame t and offset o with nv_o = fm[t+o] * fm[t] = 1 (masks hold 0 or 1),
// and scale_t = fm[t] / max(sum_o nv_o, 1), as fused_ctx.py::_row_scale
// folds it:
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
// Design: two kernels, one call.
//
//   pairs  one block per live pair (offset o, centre frame t, video b)
//          computes da (and, for K1b, the scores and their softmax) once,
//          then ds, and writes ds and alpha (and, in f32, ds transposed) to
//          a scratch [B, T, 2w, R, RS] each in v's dtype (rows padded to RS
//          = R rounded up to 8). 1,920 independent blocks at config4, so
//          no block walks the pairs in sequence.
//   gather one block per (video, extended frame f, slice of 64 columns)
//          sums dv[f]'s slice over its valid neighbours g = f +- 1..w. Both
//          terms that multiply v[g] (ds of pair (g, f-g), transposed, and
//          ds of pair (f, g-f)) are added into one R x R matrix before the
//          product, so a pair costs 2 R^2 columns of FMAs instead of 3. A
//          pair exists only where its first frame is a centre frame: a
//          valid halo frame (a neighbouring shard's, under frame
//          parallelism) gathers from the centre frames within w of it the
//          terms of their pairs, and a centre frame from a valid halo
//          neighbour only the term of its own pair; the missing terms are
//          zeros. A block decides once whether any of its pairs is missing
//          and checks each pair only then: on one device no halo frame is
//          valid, and no block checks.
//          The slices of du[g] and v[g] and the pair matrices stream
//          through a cp.async double buffer, a neighbour ahead of the sums;
//          each thread keeps 4 columns of a quarter of the rows in
//          registers across the neighbours.
//
// f32 runs on CUDA cores (full f32, no TF32, as the port holds f32 to the
// reference's HIGHEST precision). bf16 runs its products on tensor cores,
// mma.sync m16n8k16 with f32 accumulators and R padded to 32 with zeros: the
// pairs kernel's da and scores, and the gather as one [32 x 96] x [96 x 64]
// product a neighbour whose operands are bf16 values already (alpha, ds and
// du_n, which the pairs kernel also writes out in bf16), so no extra
// rounding enters.
//
// No atomics: every output element is summed by one thread in a fixed
// order, so the f32 dv is the same on every run. The scratch (ds, alpha and
// ds^T, 3.7 MB each at config4 in f32) is written once and read back from
// L2.
//
// Bound on an H100 SXM (config4 training shapes B=16, T=20, R=20, E=256,
// w=3, f32, every frame valid: 1,920 live (t, o) pairs): the least work is
// 8 R^2 E flops a pair for K1br (da, alpha^T du_n, ds^T v_t, ds v_t+o) and
// 10 R^2 E for K1b (plus the scores): 1.57 / 1.97 GFLOP, ~23 / ~29 us at
// 67 TFLOP/s f32; the bytes (v_ext 8.5 MB, du 6.6 MB, alpha 3.1 MB, dv_ext
// 8.5 MB) take ~8 us. So it is bound by operations. This design does 8
// (K1br) and 10 (K1b) R^2 E a pair less the shared v[g] product (6 and 8);
// the gather re-reads each frame's slice once for each of its 2w
// neighbours, from L2. PERF.md has its times.
//
// Shapes. The kernels above take R <= 32, E a multiple of 4 in [4, 512],
// w <= 16 (a frame's 2w neighbours in a list of 32) and T <= 65535 (the
// pairs grid's y); every other shape takes the general variant below, any
// R, E and w, through a scratch of two f32 [B, T, 2w, R, R] arrays. Its
// bound at R = 36, E = 1024, w = 3 (B=16, T=20, every frame valid, 1,728
// live pairs): K1br 18.3 GFLOP (~274 us at 67 TFLOP/s f32), K1b 22.9
// (~342 us), bound by operations in f32; in bf16 by bytes (~42 us).

#include <cstdint>

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

constexpr int kGatherThreads = kSlice;      // 16 column groups x 4 row groups

// Shared-memory layout of the pairs kernel, in bytes from the start.
struct PairsSmem {
  int ld, frame_bytes;
  size_t u, c, n, a, g, live, total;
};

template <typename Tin>
__host__ __device__ inline PairsSmem pairs_smem(int R, int E, bool scores) {
  constexpr bool kBf16 = sizeof(Tin) == 2;
  PairsSmem p;
  // f32: R rows of E + 4; bf16 (tensor cores): 32 rows of E padded to the
  // MMA's depth, + 8, zero beyond R and E
  p.ld = kBf16 ? ((E + 15) & ~15) + 8 : E + 4;
  p.frame_bytes = ((kBf16 ? 32 : R) * p.ld * (int)sizeof(Tin) + 15) / 16 * 16;
  p.u = 0;
  p.c = p.u + p.frame_bytes;
  p.n = p.c + (scores ? p.frame_bytes : 0);
  p.a = p.n + p.frame_bytes;
  const size_t mat = 32 * 32 * sizeof(float);
  p.g = p.a + mat;
  p.live = p.g + (scores ? 2 : 1) * mat;
  p.total = p.live + 32 * sizeof(float);
  return p;
}

// ds (and, for K1b, alpha) of one (t, o) pair: block (offset oi, centre t,
// video b).
template <typename Tin, bool kResidual>
__global__ void __launch_bounds__(kPairThreads)
ctx_mix_bwd_pairs(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                  const float* __restrict__ fm_ext,  // [B, T+2w]
                  const float* __restrict__ rm_ext,  // [B, T+2w, R] or null
                  const Tin* __restrict__ alpha,     // [B, T, 2w, R, R] (K1br)
                  const float* __restrict__ du,      // [B, T, R, E]
                  Tin* __restrict__ ds_out,          // [B, T, 2w, R, RS]
                  Tin* __restrict__ alpha_out,       // [B, T, 2w, R, RS]
                  Tin* __restrict__ dst_out,         // ds^T, as ds (f32)
                  Tin* __restrict__ dun_out,         // [B, T, R, E] (bf16)
                  int T, int R, int E, int w, float temp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kScores = !kResidual;
  constexpr bool kBf16 = sizeof(Tin) == 2;
  constexpr int kVec = 4;                        // 16 bytes f32, 8 bytes bf16
  const PairsSmem L = pairs_smem<Tin>(R, E, kScores);
  Tin* U = reinterpret_cast<Tin*>(smem_raw + L.u);       // du_n of frame t
  Tin* C = reinterpret_cast<Tin*>(smem_raw + L.c);       // v_t (K1b)
  Tin* N = reinterpret_cast<Tin*>(smem_raw + L.n);       // v_t+o
  float* A = reinterpret_cast<float*>(smem_raw + L.a);   // [R][32] alpha
  float* G = reinterpret_cast<float*>(smem_raw + L.g);   // [R][32] da
  float* S = G + 32 * 32;                                // [R][32] scores
  float* live = reinterpret_cast<float*>(smem_raw + L.live);
  const int ld = L.ld;
  const int ep = (E + 15) & ~15;
  const int rows = kBf16 ? 32 : R;               // staged rows (zero past R)
  const int cols = kBf16 ? ep : E;               // staged columns (zero past E)

  const int oi = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int t_ext = T + 2 * w;
  const int c = t + w;                           // extended centre frame
  const int n = c + offset_of(oi, w);            // extended neighbour frame
  const size_t frame = (size_t)R * E;
  const size_t rr = (size_t)R * R;
  const size_t pair_id = ((size_t)b * T + t) * 2 * w + oi;
  const int RS = (R + 7) & ~7;                   // the scratch's row length
  Tin* ds_p = ds_out + pair_id * R * RS;
  Tin* alpha_p = alpha_out + pair_id * R * RS;
  Tin* dst_p = kBf16 ? nullptr : dst_out + pair_id * R * RS;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  if (fm[c] == 0.f || fm[n] == 0.f) return;      // nv_o = 0: nothing read

  float cnt = 0.f;
  int first = -1;                                // the first live offset
  for (int i = 0; i < 2 * w; ++i) {
    const float f = fm[c + offset_of(i, w)];
    cnt += f;
    if (f != 0.f && first < 0) first = i;
  }
  const float scale = 1.f / fmaxf(cnt, 1.f);    // fm[c] is 1 here

  if (kScores)
    stage_tile_async<kVec>(C, vb + (size_t)c * frame, rows, R, E, 0, cols,
                           ld);
  stage_tile_async<kVec>(N, vb + (size_t)n * frame, rows, R, E, 0, cols, ld);
  const float* du_t = du + ((size_t)b * T + t) * frame;
  if constexpr (kBf16) {
    // du_n rounded to bf16 before its products, as the reference does;
    // the first live pair's block also writes it out for the gather
    Tin* dun = oi == first ? dun_out + ((size_t)b * T + t) * frame : nullptr;
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const int r = i / c4;
      const int e = (i - r * c4) << 2;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < R && e < E) {
        x = reinterpret_cast<const float4*>(du_t + (size_t)r * E + e)[0];
        x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      }
      Tin* d = U + r * ld + e;
      store_as(d, x.x);
      store_as(d + 1, x.y);
      store_as(d + 2, x.z);
      store_as(d + 3, x.w);
      if (dun != nullptr && r < R && e < E) {
        Tin* o = dun + (size_t)r * E + e;
        store_as(o, x.x);
        store_as(o + 1, x.y);
        store_as(o + 2, x.z);
        store_as(o + 3, x.w);
      }
    }
  } else {
    // f32: du as stored, by cp.async with the frames; the scale goes on da
    stage_tile_async<kVec>(U, du_t, R, R, E, 0, E, ld);
  }
  cp_async_commit();
  if (threadIdx.x < R)
    live[threadIdx.x] =
        rm_ext ? rm_ext[((size_t)b * t_ext + n) * R + threadIdx.x] : 1.f;
  if (kResidual)
    for (int i = threadIdx.x; i < (int)rr; i += blockDim.x) {
      const int r = i / R;
      A[r * 32 + (i - r * R)] = load1(alpha + pair_id * rr + i);
    }
  cp_async_wait(0);
  __syncthreads();

  if constexpr (kBf16)          // du_n is scaled already; r, s < 32
    pair_products_mma<kScores>(U, C, N, ep, ld,
                               [&](int r, int s, float da, float sc) {
                                 G[r * 32 + s] = da;
                                 if (kScores)
                                   S[r * 32 + s] =
                                       live[s] > 0.f ? sc / temp : kNeg;
                               });
  else
    pair_products<kScores>(U, C, N, R, E, ld,
                           [&](int r, int s, float da, float sc) {
                             G[r * 32 + s] = da * scale;
                             if (kScores)
                               S[r * 32 + s] =
                                   live[s] > 0.f ? sc / temp : kNeg;
                           });
  __syncthreads();
  if (kScores) {                 // K1b: alpha from the scores, in f32
    row_softmax(S, 32, R,
                [&](int r, int s, float p) { A[r * 32 + s] = p; });
    __syncthreads();
  }
  bool group_live = false;       // any valid region in t+o (same every row)
  for (int s = 0; s < R; ++s) group_live |= live[s] > 0.f;

  // ds, and alpha for the gather: 8 lanes per row, the row sum by
  // shuffles; rows padded to RS with zeros
  const int j = threadIdx.x & 7;
  for (int base = 0; base < R; base += blockDim.x >> 3) {
    const int r = base + (threadIdx.x >> 3);
    float a[4], g[4];
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = j + 8 * q;
      const bool ok = r < R && s < R;
      a[q] = ok ? A[r * 32 + s] : 0.f;
      g[q] = ok ? G[r * 32 + s] : 0.f;
      sum += a[q] * g[q];
    }
#pragma unroll
    for (int m = 4; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = j + 8 * q;
      if (r < R && s < RS) {
        const float d = group_live && s < R
                            ? (a[q] * g[q] - a[q] * sum) / temp : 0.f;
        store_as(ds_p + r * RS + s, d);
        store_as(alpha_p + r * RS + s, a[q]);
        if (!kBf16 && s < R) store_as(dst_p + s * RS + r, d);
      }
    }
  }
}

// Whether extended frame f is a centre frame (not a halo frame).
__device__ __forceinline__ bool is_centre(int f, int T, int w) {
  return f >= w && f < w + T;
}

// The valid neighbours g of extended frame f, in order (block-uniform): the
// valid frames within w of f that share a pair with it, so at least one of
// the two is a centre frame; none if f is not valid. Returns their number.
// Without kHalo (touches_halo is false) only centre frames have any.
template <bool kHalo>
__device__ __forceinline__ int neighbours(int (&src)[32], const float* fm,
                                          int f, int T, int w) {
  int n = 0;
  const bool fc = is_centre(f, T, w);
  if ((kHalo || fc) && fm[f] != 0.f)
    for (int d = -w; d <= w; ++d) {
      const int g = f + d;
      const bool pair = kHalo ? g >= 0 && g < T + 2 * w &&
                                    (fc || is_centre(g, T, w))
                              : is_centre(g, T, w);
      if (d != 0 && pair && fm[g] != 0.f && n < 32) src[n++] = g;
    }
  return n;
}

// The pair matrices that join f and its neighbour g, as stored in the
// scratch (rows of RS = R rounded up to 8): (g, f - g), whose neighbour is
// f, and (f, g - f), whose neighbour is g. Each is meaningful only when its
// first frame is a centre frame.
__device__ __forceinline__ void pair_offsets(size_t& p_gf, size_t& p_fg,
                                             int b, int f, int g, int T,
                                             int R, int RS, int w) {
  const int i_gf = f - g < 0 ? f - g + w : f - g + w - 1;
  const int i_fg = g - f < 0 ? g - f + w : g - f + w - 1;
  p_gf = (((size_t)b * T + g - w) * 2 * w + i_gf) * R * RS;
  p_fg = (((size_t)b * T + f - w) * 2 * w + i_fg) * R * RS;
}

// Whether a pair of extended frame f's is missing, so that its terms are
// zeros: f is valid and so is a halo frame within w of it, or f itself.
// Block-uniform: each gather decides it once and runs its sums without the
// per-pair checks when it is false, as every block does on one device,
// where the halo frames are not valid.
__device__ __forceinline__ bool touches_halo(const float* fm, int f, int T,
                                             int w) {
  if ((f >= 2 * w && f < T) || fm[f] == 0.f) return false;
  for (int g = max(f - w, 0); g <= min(f + w, T + 2 * w - 1); ++g)
    if (!is_centre(g, T, w) && fm[g] != 0.f) return true;
  return false;
}

constexpr int kGatherLd = kSlice + 4;       // the f32 gather's slice rows

// f32: dv[f] for columns [64 y, 64 y + 64) from the valid neighbours of f.
// du[g]'s and v[g]'s slices arrive by cp.async a neighbour ahead; the pair
// matrices of the next neighbour are loaded into registers while this one
// is summed, and stored to shared memory after it. ds of pair (f, g - f) is
// read from its transposed copy, so that every matrix load is coalesced.
// kHalo: check each pair for a halo frame (touches_halo).
template <int RB, bool kHalo>
__device__ __forceinline__ void gather_sums(
    const float* __restrict__ v_ext, const float* __restrict__ fm,
    const float* __restrict__ alpha, const float* __restrict__ ds,
    const float* __restrict__ dst, const float* __restrict__ du,
    float* __restrict__ dv, int f, int b, int col0, int T, int R, int E,
    int w, float (*dus)[RB * kGatherLd],
    float (*vs)[RB * kGatherLd], float* A, float* D) {
  constexpr int kLd = kGatherLd;
  constexpr int RPT = RB / 4;                     // rows per thread
  constexpr int kPer = RB * RB / kGatherThreads;  // matrix entries a thread
  const int t_ext = T + 2 * w;
  const size_t frame = (size_t)R * E;
  const int cg = threadIdx.x & 15;
  const int rg = threadIdx.x >> 4;
  const int col = col0 + 4 * cg;

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int src[32];
  const int n_src = neighbours<kHalo>(src, fm, f, T, w);
  const bool fc = !kHalo || is_centre(f, T, w);
  auto fetch = [&](int k) {                      // the slices, asynchronously
    const int g = src[k];
    const bool gc = !kHalo || is_centre(g, T, w);  // else du[g] is zeros
    stage_tile_async<4>(dus[k & 1],
                        gc ? du + ((size_t)b * T + g - w) * frame : du, R,
                        gc ? R : 0, E, col0, kSlice, kLd);
    stage_tile_async<4>(vs[k & 1], v_ext + ((size_t)b * t_ext + g) * frame,
                        R, R, E, col0, kSlice, kLd);
    cp_async_commit();
  };
  // entry e of this thread: element i = threadIdx.x + 64 e of [R][RB], row
  // b = i / RB (source), column a (output): alpha_gf[b][a], ds_gf[b][a]
  // and ds_fg[a][b]
  float m_a[kPer], m_g[kPer], m_f[kPer];
  auto load_mats = [&](int k) {
    size_t p_gf, p_fg;
    pair_offsets(p_gf, p_fg, b, f, src[k], T, R, RB, w);
    const bool gc = !kHalo || is_centre(src[k], T, w);  // (g, f - g) exists
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + kGatherThreads * e;
      const int r = i / RB;
      const int a = i - r * RB;
      const bool ok = r < R;
      m_a[e] = ok && gc ? alpha[p_gf + i] : 0.f;
      m_g[e] = ok && gc ? ds[p_gf + i] : 0.f;
      m_f[e] = ok && fc && a < R ? dst[p_fg + i] : 0.f;
    }
  };
  auto store_mats = [&]() {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + kGatherThreads * e;
      A[i] = m_a[e];
      D[i] = m_g[e] + m_f[e];
    }
  };
  if (n_src > 0) {
    fetch(0);
    load_mats(0);
    store_mats();
  }

  for (int k = 0; k < n_src; ++k) {
    const int g = src[k];
    if (k + 1 < n_src) fetch(k + 1);
    float cnt = 0.f;                             // scale of centre frame g
    if (!kHalo || is_centre(g, T, w))
      for (int q = 0; q < 2 * w; ++q) cnt += fm[g + offset_of(q, w)];
    const float scale = 1.f / fmaxf(cnt, 1.f);
    if (k + 1 < n_src) cp_async_wait(1); else cp_async_wait(0);
    __syncthreads();
    if (k + 1 < n_src) load_mats(k + 1);        // in flight during the sums

    const float* X = dus[k & 1];
    const float* Y = vs[k & 1];
    for (int r = 0; r < R; ++r) {
      const float4 xr = reinterpret_cast<const float4*>(X + r * kLd)[cg];
      const float4 x = make_float4(xr.x * scale, xr.y * scale, xr.z * scale,
                                   xr.w * scale);
      const float4 y = reinterpret_cast<const float4*>(Y + r * kLd)[cg];
      const float2* ap =
          reinterpret_cast<const float2*>(A + r * RB + rg * RPT);
      const float2* dp =
          reinterpret_cast<const float2*>(D + r * RB + rg * RPT);
#pragma unroll
      for (int h = 0; h < RPT / 2; ++h) {
        const float2 a2 = ap[h];
        const float2 d2 = dp[h];
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          const float a = z ? a2.y : a2.x;
          const float d = z ? d2.y : d2.x;
          float* o = acc[2 * h + z];
          o[0] = fmaf(d, y.x, fmaf(a, x.x, o[0]));
          o[1] = fmaf(d, y.y, fmaf(a, x.y, o[1]));
          o[2] = fmaf(d, y.z, fmaf(a, x.z, o[2]));
          o[3] = fmaf(d, y.w, fmaf(a, x.w, o[3]));
        }
      }
    }
    __syncthreads();             // A, D and this neighbour's slices are free
    if (k + 1 < n_src) store_mats();
  }

  float* dvb = dv + ((size_t)b * t_ext + f) * frame;
  if (col < E) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      if (r < R)
        *reinterpret_cast<float4*>(dvb + (size_t)r * E + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int RB>
__global__ void __launch_bounds__(kGatherThreads)
ctx_mix_bwd_gather(const float* __restrict__ v_ext,   // [B, T+2w, R, E]
                   const float* __restrict__ fm_ext,  // [B, T+2w]
                   const float* __restrict__ alpha,   // [B, T, 2w, R, RB]
                   const float* __restrict__ ds,      // [B, T, 2w, R, RB]
                   const float* __restrict__ dst,     // ds^T, as ds
                   const float* __restrict__ du,      // [B, T, R, E]
                   float* __restrict__ dv,            // [B, T+2w, R, E]
                   int T, int R, int E, int w) {
  __shared__ __align__(16) float dus[2][RB * kGatherLd];  // du[g] slice, raw
  __shared__ __align__(16) float vs[2][RB * kGatherLd];   // v[g] slice
  __shared__ __align__(16) float A[RB * RB];    // alpha of pair (g, f-g)
  __shared__ __align__(16) float D[RB * RB];    // the v[g] matrix, [b][a]

  const int f = blockIdx.x;
  const int b = blockIdx.z;
  const float* fm = fm_ext + (size_t)b * (T + 2 * w);
  if (touches_halo(fm, f, T, w))
    gather_sums<RB, true>(v_ext, fm, alpha, ds, dst, du, dv, f, b,
                          blockIdx.y * kSlice, T, R, E, w, dus, vs, A, D);
  else
    gather_sums<RB, false>(v_ext, fm, alpha, ds, dst, du, dv, f, b,
                           blockIdx.y * kSlice, T, R, E, w, dus, vs, A, D);
}

// bf16 (tensor cores): dv[f] for columns [64 y, 64 y + 64) as one product a
// neighbour: [alpha_gf^T | ds_gf^T | ds_fg] (32 x 96, R padded to 32 with
// zeros) times [du_n[g]; v[g]; v[g]] (96 x 64), mma.sync m16n8k16 with f32
// accumulators. Four warps, 16 columns each; the B fragments come from the
// row-major slices through ldmatrix.trans. du_n[g] is the pairs kernel's.
// The slices and matrices of a neighbour arrive by cp.async one neighbour
// ahead; ds_fg lands where the MMA reads it, the two transposed matrices
// are built from their copies. kHalo: as gather_sums'.
template <bool kHalo>
__device__ __forceinline__ void gather_mma_sums(
    const __nv_bfloat16* __restrict__ v_ext, const float* __restrict__ fm,
    const __nv_bfloat16* __restrict__ alpha,
    const __nv_bfloat16* __restrict__ ds,
    const __nv_bfloat16* __restrict__ dun, float* __restrict__ dv, int f,
    int b, int col0, int T, int R, int E, int w,
    __nv_bfloat16 (*xs)[32 * kMmaLd],
    __nv_bfloat16 (*ys)[32 * kMmaLd], __nv_bfloat16 (*raw)[2][32 * 32],
    __nv_bfloat16 (*fg)[32 * kMatLd], __nv_bfloat16 (*am)[32 * kMatLd]) {
  const int t_ext = T + 2 * w;
  const int RS = (R + 7) & ~7;                   // the scratch's row length
  const size_t frame = (size_t)R * E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, tig = lane & 3;
  const int mt = R > 16 ? 2 : 1;                 // m16 tiles of rows a
  const int ks = R > 16 ? 2 : 1;                 // k16 steps of rows b

  int src[32];
  const int n_src = neighbours<kHalo>(src, fm, f, T, w);
  const bool fc = !kHalo || is_centre(f, T, w);
  auto fetch = [&](int k) {                      // a missing pair: zeros
    const int g = src[k];
    const int q = k & 1;
    const bool gc = !kHalo || is_centre(g, T, w);
    stage_tile_async<4>(xs[q],
                        gc ? dun + ((size_t)b * T + g - w) * frame : dun, 32,
                        gc ? R : 0, E, col0, kSlice, kMmaLd);
    stage_tile_async<4>(ys[q], v_ext + ((size_t)b * t_ext + g) * frame, 32,
                        R, E, col0, kSlice, kMmaLd);
    size_t p_gf, p_fg;
    pair_offsets(p_gf, p_fg, b, f, g, T, R, RS, w);
    stage_tile_async<8>(raw[q][0], gc ? alpha + p_gf : alpha, R, gc ? R : 0,
                        RS, 0, RS, 32);
    stage_tile_async<8>(raw[q][1], gc ? ds + p_gf : ds, R, gc ? R : 0, RS, 0,
                        RS, 32);
    stage_tile_async<8>(fg[q], fc ? ds + p_fg : ds, 32, fc ? R : 0, RS, 0, 32,
                        kMatLd);
    cp_async_commit();
  };
  if (n_src > 0) fetch(0);

  float acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[mi][ni][z] = 0.f;

  for (int k = 0; k < n_src; ++k) {
    const int q = k & 1;
    if (k + 1 < n_src) fetch(k + 1);
    if (k + 1 < n_src) cp_async_wait(1); else cp_async_wait(0);
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += blockDim.x) {
      const int r = i / R;
      const int s = i - r * R;                   // element (r, s) of R x R
      am[0][s * kMatLd + r] = raw[q][0][r * 32 + s];   // alpha_gf^T
      am[1][s * kMatLd + r] = raw[q][1][r * 32 + s];   // ds_gf^T
    }
    __syncthreads();

#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
      const __nv_bfloat16* bsrc = blk == 0 ? xs[q] : ys[q];
      const __nv_bfloat16* asrc = blk == 2 ? fg[q] : am[blk];
      for (int kk = 0; kk < ks; ++kk) {
        // B fragments of the two n8 tiles of this warp's 16 columns
        uint32_t y[4];
        frag_b2_trans(y, bsrc, kMmaLd, kk * 16, warp * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi >= mt) continue;                // block-uniform
          uint32_t x[4];
          frag_a(x, asrc, kMatLd, mi * 16, kk * 16);
          mma_bf16(acc[mi][0], x, y[0], y[1]);
          mma_bf16(acc[mi][1], x, y[2], y[3]);
        }
      }
    }
    __syncthreads();             // the matrices and this neighbour's buffers
  }

  float* dvb = dv + ((size_t)b * t_ext + f) * frame;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mi * 16 + g4 + h * 8;
        const int col = col0 + warp * 16 + ni * 8 + 2 * tig;
        if (row < R && col < E)
          *reinterpret_cast<float2*>(dvb + (size_t)row * E + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

__global__ void __launch_bounds__(128)
ctx_mix_bwd_gather_mma(const __nv_bfloat16* __restrict__ v_ext,
                       const float* __restrict__ fm_ext,
                       const __nv_bfloat16* __restrict__ alpha,  // padded
                       const __nv_bfloat16* __restrict__ ds,     // padded
                       const __nv_bfloat16* __restrict__ dun,    // [B,T,R,E]
                       float* __restrict__ dv, int T, int R, int E, int w) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][32 * kMmaLd];  // du_n[g]
  __shared__ __align__(16) __nv_bfloat16 ys[2][32 * kMmaLd];  // v[g]
  __shared__ __align__(16) __nv_bfloat16 raw[2][2][32 * 32];  // alpha, ds_gf
  __shared__ __align__(16) __nv_bfloat16 fg[2][32 * kMatLd];  // ds_fg [a][b]
  __shared__ __align__(16) __nv_bfloat16 am[2][32 * kMatLd];  // their ^T

  const int f = blockIdx.x;
  const int b = blockIdx.z;
  const float* fm = fm_ext + (size_t)b * (T + 2 * w);
  // rows and columns past R stay zero in the transposed matrices
  for (int i = threadIdx.x; i < 2 * 32 * kMatLd; i += blockDim.x)
    (&am[0][0])[i] = __float2bfloat16_rn(0.f);

  if (touches_halo(fm, f, T, w))
    gather_mma_sums<true>(v_ext, fm, alpha, ds, dun, dv, f, b,
                          blockIdx.y * kSlice, T, R, E, w, xs, ys, raw, fg,
                          am);
  else
    gather_mma_sums<false>(v_ext, fm, alpha, ds, dun, dv, f, b,
                           blockIdx.y * kSlice, T, R, E, w, xs, ys, raw, fg,
                           am);
}

template <int RB>
int launch_gather(const float* v_ext, const float* fm_ext,
                  const float* alpha, const float* ds, const float* dst,
                  const float* du, float* dv, int B, int T, int R, int E,
                  int w, cudaStream_t stream) {
  const dim3 grid(T + 2 * w, (E + kSlice - 1) / kSlice, B);
  ctx_mix_bwd_gather<RB><<<grid, kGatherThreads, 0, stream>>>(
      v_ext, fm_ext, alpha, ds, dst, du, dv, T, R, E, w);
  return (int)cudaGetLastError();
}

// The scratch, in elements of v_ext's type: ds and alpha as [B, T, 2w, R,
// RS] (rows padded to RS = R rounded up to 8, so every row of every pair is
// 16-byte aligned for the gather's copies), then, for f32, ds transposed in
// the same layout, for bf16 du_n [B, T, R, E] at a 16-byte boundary.
size_t mats_elems(int B, int T, int R, int w) {
  return (size_t)B * T * 2 * w * R * ((R + 7) & ~7);
}

size_t scratch_elems(int B, int T, int R, int E, int w, bool bf16) {
  const size_t mats = mats_elems(B, T, R, w);
  return bf16 ? (2 * mats + 7) / 8 * 8 + (size_t)B * T * R * E : 3 * mats;
}

template <typename Tin, bool kResidual>
int run_typed(const void* v_ext, const float* fm_ext, const float* rm_ext,
              const void* alpha, const float* du, float* dv, void* scratch,
              int B, int T, int R, int E, int w, float temp,
              cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const size_t mats = mats_elems(B, T, R, w);
  Tin* ds = static_cast<Tin*>(scratch);
  Tin* alpha_s = ds + mats;
  Tin* dst = kBf16 ? nullptr : ds + 2 * mats;
  Tin* dun = kBf16 ? ds + (2 * mats + 7) / 8 * 8 : nullptr;
  const size_t smem = pairs_smem<Tin>(R, E, !kResidual).total;
  auto pairs = ctx_mix_bwd_pairs<Tin, kResidual>;
  cudaError_t err = cudaFuncSetAttribute(
      pairs, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairs<<<dim3(2 * w, T, B), kPairThreads, smem, stream>>>(
      static_cast<const Tin*>(v_ext), fm_ext, rm_ext,
      static_cast<const Tin*>(alpha), du, ds, alpha_s, dst, dun, T, R, E, w,
      temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kBf16) {
    const dim3 grid(T + 2 * w, (E + kSlice - 1) / kSlice, B);
    ctx_mix_bwd_gather_mma<<<grid, 128, 0, stream>>>(
        static_cast<const Tin*>(v_ext), fm_ext, alpha_s, ds, dun, dv, T, R,
        E, w);
    return (int)cudaGetLastError();
  } else {
    const float* v = static_cast<const float*>(v_ext);
    switch ((R + 7) / 8) {
      case 1: return launch_gather<8>(v, fm_ext, alpha_s, ds, dst, du, dv, B, T, R, E, w, stream);
      case 2: return launch_gather<16>(v, fm_ext, alpha_s, ds, dst, du, dv, B, T, R, E, w, stream);
      case 3: return launch_gather<24>(v, fm_ext, alpha_s, ds, dst, du, dv, B, T, R, E, w, stream);
      default: return launch_gather<32>(v, fm_ext, alpha_s, ds, dst, du, dv, B, T, R, E, w, stream);
    }
  }
}

// ------------------------------------------------- the general variant
//
// Any R, E and w (ctx_mix_common.cuh's kAny* tiles), for the shapes the
// kernels above do not take. The same two steps, through a scratch of two
// f32 arrays [B, T, 2w, R, R], A (alpha) and D (da, then ds in place):
//
//   pairs  one block per (32-row tile, offset, centre frame t; video b) of
//          a live pair: its rows of alpha (K1br: the residual, as stored;
//          K1b: any_row_softmax of the scores), then of da = du_n . v_t+o,
//          32 columns at a time, then, a warp a row, ds. In bf16 ds is
//          rounded to bf16 where the kernels above round it.
//   gather one block per (64-column slice, 32-row tile, extended frame f;
//          video b) sums dv[f]'s tile over f's neighbours g in offset
//          order, 32 source regions at a time: alpha_gf^T du_n[g] +
//          (ds_gf^T + ds_fg) v[g], the pair matrices' terms zero where the
//          pair does not exist (its first frame is a halo frame). du_n[g] is
//          formed from du as it is staged (bf16: rounded), and alpha is
//          rounded to bf16 there, so the products take the operands the
//          kernels above take.

template <typename Tin, bool kResidual>
__global__ void __launch_bounds__(kAnyThreads)
ctx_mix_bwd_pairs_any(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                      const float* __restrict__ fm_ext,  // [B, T+2w]
                      const float* __restrict__ rm_ext,  // [B, T+2w, R] / null
                      const Tin* __restrict__ alpha,     // [B, T, 2w, R, R]
                      const float* __restrict__ du,      // [B, T, R, E]
                      float* __restrict__ A,             // [B, T, 2w, R, R]
                      float* __restrict__ D,             // [B, T, 2w, R, R]
                      int T, int R, int E, int w, float temp) {
  __shared__ __align__(16) AnyDotSmem sm;
  const int tiles = (R + kAnyRows - 1) / kAnyRows;
  const int rt = (int)(blockIdx.x % tiles);
  const int pair = (int)(blockIdx.x / tiles);    // t * 2w + offset index
  const int oi = pair % (2 * w), t = pair / (2 * w);
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const int c = t + w, n = c + offset_of(oi, w);
  const size_t frame = (size_t)R * E;
  const float* fm = fm_ext + (size_t)b * t_ext;
  if (fm[c] == 0.f || fm[n] == 0.f) return;      // nv_o = 0: nothing read
  float cnt = 0.f;
  for (int i = 0; i < 2 * w; ++i) cnt += fm[c + offset_of(i, w)];
  const float scale = 1.f / fmaxf(cnt, 1.f);     // fm[c] is 1 here
  const size_t p = (((size_t)b * T + t) * 2 * w + oi) * R * R;
  const int r0 = rt * kAnyRows, r_hi = min(R, r0 + kAnyRows);
  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  const Tin* vn = vb + n * frame;
  const float* rm = rm_ext ? rm_ext + ((size_t)b * t_ext + n) * R : nullptr;
  auto live = [&](int s) { return rm == nullptr || rm[s] > 0.f; };

  if (kResidual) {
    for (size_t i = (size_t)r0 * R + threadIdx.x; i < (size_t)r_hi * R;
         i += blockDim.x)
      A[p + i] = load1(alpha + p + i);
  } else {                                       // K1b: alpha in f32
    any_row_softmax(vb + c * frame, vn, R, E, r0, temp, live, sm,
                    [&](int r, int s, float x) {
                      A[p + (size_t)r * R + s] = x;
                    });
  }
  // da: du_n (bf16: rounded, as the kernels above round it) . v_t+o
  const float* du_t = du + ((size_t)b * T + t) * frame;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int s0 = 0; s0 < R; s0 += kAnyRows) {
    float acc[4];
    any_tile_dots(acc, du_t, vn, R, r0, s0, E, sm, [&](float x) {
      return as_operand(x * scale, static_cast<const Tin*>(nullptr));
    });
    const int s = s0 + tx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + ty + 8 * k;
      if (r < R && s < R) D[p + (size_t)r * R + s] = acc[k];
    }
  }
  // a group with no valid region took the uniform alpha: ds = 0
  int lv = 0;
  for (int s = threadIdx.x; s < R; s += blockDim.x) lv |= live(s);
  const bool group_live = __syncthreads_or(lv);  // A and D are written, too
  for (int r = r0 + ty; r < r_hi; r += kAnyThreads / 32) {
    const float* a = A + p + (size_t)r * R;
    float* d = D + p + (size_t)r * R;
    float sum = 0.f;
    for (int s = tx; s < R; s += 32) sum += a[s] * d[s];
    sum = any_warp_sum(sum);
    for (int s = tx; s < R; s += 32) {
      const float x = group_live ? (a[s] * d[s] - a[s] * sum) / temp : 0.f;
      d[s] = as_operand(x, static_cast<const Tin*>(nullptr));
    }
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kAnyThreads)
ctx_mix_bwd_gather_any(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                       const float* __restrict__ fm_ext,  // [B, T+2w]
                       const float* __restrict__ A,       // [B, T, 2w, R, R]
                       const float* __restrict__ D,       // ds, as A
                       const float* __restrict__ du,      // [B, T, R, E]
                       float* __restrict__ dv,            // [B, T+2w, R, E]
                       int T, int R, int E, int w) {
  // [output row r][source row s] of alpha_gf^T and of ds_gf^T + ds_fg
  __shared__ __align__(16) float M1[kAnyRows * kAnyMatLd];
  __shared__ __align__(16) float M2[kAnyRows * kAnyMatLd];
  __shared__ __align__(16) float X[kAnyRows * kAnyCols];   // [s][e] du_n[g]
  __shared__ __align__(16) float Y[kAnyRows * kAnyCols];   // [s][e] v[g]
  const int tiles = (R + kAnyRows - 1) / kAnyRows;
  const int slices = (E + kAnyCols - 1) / kAnyCols;
  const int e0 = (int)(blockIdx.x % slices) * kAnyCols;
  const int rest = (int)(blockIdx.x / slices);
  const int r0 = (rest % tiles) * kAnyRows;
  const int f = rest / tiles;
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const size_t frame = (size_t)R * E;
  const size_t rr = (size_t)R * R;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const int tx = threadIdx.x % kAnyCols;         // this thread's column
  const int ty = threadIdx.x / kAnyCols;         // ... and rows 8 ty + k
  const bool fc = is_centre(f, T, w);
  const Tin* no_tin = nullptr;                   // picks as_operand's dtype

  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int d = -w; d <= w && fm[f] != 0.f; ++d) {
    const int g = f + d;                         // block-uniform tests
    if (d == 0 || g < 0 || g >= t_ext || fm[g] == 0.f) continue;
    const bool gc = is_centre(g, T, w);
    if (!fc && !gc) continue;                    // no pair joins them
    float cnt = 0.f;                             // scale of centre frame g
    if (gc)
      for (int q = 0; q < 2 * w; ++q) cnt += fm[g + offset_of(q, w)];
    const float scale = 1.f / fmaxf(cnt, 1.f);
    // (g, f - g), whose neighbour is f, and (f, g - f), whose neighbour is g
    const int i_gf = -d < 0 ? -d + w : -d + w - 1;
    const int i_fg = d < 0 ? d + w : d + w - 1;
    const size_t p_gf = gc ? (((size_t)b * T + g - w) * 2 * w + i_gf) * rr : 0;
    const size_t p_fg = fc ? (((size_t)b * T + f - w) * 2 * w + i_fg) * rr : 0;
    const float* du_g = du + ((size_t)b * T + (gc ? g - w : 0)) * frame;
    const Tin* v_g = v_ext + ((size_t)b * t_ext + g) * frame;
    for (int k0 = 0; k0 < R; k0 += kAnyRows) {
      __syncthreads();                           // the last tiles are read
      for (int j = threadIdx.x; j < kAnyRows * kAnyRows; j += blockDim.x) {
        const int s = j / kAnyRows, i = j - s * kAnyRows;
        const int r = r0 + i, sr = k0 + s;
        const bool on = r < R && sr < R;
        M1[i * kAnyMatLd + s] =
            on && gc ? as_operand(A[p_gf + (size_t)sr * R + r], no_tin) : 0.f;
        M2[i * kAnyMatLd + s] =
            on ? (gc ? D[p_gf + (size_t)sr * R + r] : 0.f) +
                     (fc ? D[p_fg + (size_t)r * R + sr] : 0.f)
               : 0.f;
      }
      for (int j = threadIdx.x; j < kAnyRows * kAnyCols; j += blockDim.x) {
        const int s = j / kAnyCols, col = j - s * kAnyCols;
        const bool on = k0 + s < R && e0 + col < E;
        const size_t at = (size_t)(k0 + s) * E + e0 + col;
        X[j] = on && gc ? as_operand(du_g[at] * scale, no_tin) : 0.f;
        Y[j] = on ? load1(v_g + at) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int s = 0; s < kAnyRows; s += 4) {
        float x[4], y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[q] = X[(s + q) * kAnyCols + tx];
          y[q] = Y[(s + q) * kAnyCols + tx];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(
              M1 + (8 * ty + k) * kAnyMatLd + s);
          const float4 m = *reinterpret_cast<const float4*>(
              M2 + (8 * ty + k) * kAnyMatLd + s);
          acc[k] = fmaf(m.x, y[0], fmaf(a.x, x[0], acc[k]));
          acc[k] = fmaf(m.y, y[1], fmaf(a.y, x[1], acc[k]));
          acc[k] = fmaf(m.z, y[2], fmaf(a.z, x[2], acc[k]));
          acc[k] = fmaf(m.w, y[3], fmaf(a.w, x[3], acc[k]));
        }
      }
    }
  }

  float* dvb = dv + ((size_t)b * t_ext + f) * frame;
  if (e0 + tx < E) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = r0 + 8 * ty + k;
      if (r < R) dvb[(size_t)r * E + e0 + tx] = acc[k];
    }
  }
}

// Whether the specialised kernels above take this shape; the general
// variant takes every other.
bool in_envelope(int T, int R, int E, int w) {
  return R <= 32 && E % 4 == 0 && E >= 4 && E <= kMaxThreads && w <= 16 &&
         T <= 65535;
}

// The general variant's scratch: A and D, f32 [B, T, 2w, R, R] each.
size_t any_mats(int B, int T, int R, int w) {
  return (size_t)B * T * 2 * w * R * R;
}

template <typename Tin, bool kResidual>
int run_any(const void* v_ext, const float* fm_ext, const float* rm_ext,
            const void* alpha, const float* du, float* dv, void* scratch,
            int B, int T, int R, int E, int w, float temp,
            cudaStream_t stream) {
  const size_t tiles = (R + kAnyRows - 1) / kAnyRows;
  const size_t slices = (E + kAnyCols - 1) / kAnyCols;
  const size_t pairs_x = (size_t)T * 2 * w * tiles;
  const size_t gather_x = (size_t)(T + 2 * w) * tiles * slices;
  if (pairs_x > 0x7fffffff || gather_x > 0x7fffffff)   // the grid's x limit
    return (int)cudaErrorInvalidValue;
  float* A = static_cast<float*>(scratch);
  float* D = A + any_mats(B, T, R, w);
  ctx_mix_bwd_pairs_any<Tin, kResidual>
      <<<dim3((unsigned)pairs_x, B), kAnyThreads, 0, stream>>>(
          static_cast<const Tin*>(v_ext), fm_ext, rm_ext,
          static_cast<const Tin*>(alpha), du, A, D, T, R, E, w, temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctx_mix_bwd_gather_any<Tin>
      <<<dim3((unsigned)gather_x, B), kAnyThreads, 0, stream>>>(
          static_cast<const Tin*>(v_ext), fm_ext, A, D, du, dv, T, R, E, w);
  return (int)cudaGetLastError();
}

template <bool kResidual>
int run(const void* v_ext, int v_is_bf16, const float* fm_ext,
        const float* rm_ext, const void* alpha, const float* du, float* dv,
        void* scratch, int B, int T, int R, int E, int w, float temp,
        void* stream) {
  if (R < 1 || E < 1 || w < 1 || B < 0 || B > 65535 || T < 1 ||
      scratch == nullptr || (kResidual && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_envelope(T, R, E, w))
    return v_is_bf16
        ? run_any<__nv_bfloat16, kResidual>(v_ext, fm_ext, rm_ext, alpha, du,
                                            dv, scratch, B, T, R, E, w, temp,
                                            s)
        : run_any<float, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv,
                                    scratch, B, T, R, E, w, temp, s);
  return v_is_bf16
      ? run_typed<__nv_bfloat16, kResidual>(v_ext, fm_ext, rm_ext, alpha, du,
                                            dv, scratch, B, T, R, E, w, temp,
                                            s)
      : run_typed<float, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv,
                                    scratch, B, T, R, E, w, temp, s);
}

}  // namespace

extern "C" {

// Elements of v_ext's type that the scratch of one call must hold.
size_t nafae_ctx_mix_bwd_scratch(int B, int T, int R, int E, int w,
                                 int v_is_bf16) {
  if (!in_envelope(T, R, E, w))                  // two f32 arrays
    return 2 * any_mats(B, T, R, w) * (v_is_bf16 ? 2 : 1);
  return scratch_elems(B, T, R, E, w, v_is_bf16 != 0);
}

// Both launch the two kernels on `stream` and return the cudaError_t of the
// launches (0 = ok). v_ext is float* when v_is_bf16 == 0, __nv_bfloat16*
// otherwise, and alpha (K1br only) has v_ext's type; rm_ext may be null; du
// is f32 [B, T, R, E]; dv is written whole, f32 [B, T+2w, R, E]. scratch
// holds nafae_ctx_mix_bwd_scratch(...) elements of v_ext's type, 16-byte
// aligned. All tensors are contiguous and v_ext, du and dv 16-byte aligned.
// Shapes with R <= 32, E a multiple of 4 in [4, 512], w <= 16 and T <=
// 65535 take the kernels above, every other the general variant. Limits:
// B <= 65535 (the grid's y), and, in the general variant, T 2w ceil(R/32)
// and (T + 2w) ceil(R/32) ceil(E/64) below 2^31 (its x); R, E, w, T >= 1.

// K1b: alpha recomputed from the scores.
int nafae_ctx_mix_bwd(const void* v_ext, int v_is_bf16, const float* fm_ext,
                      const float* rm_ext, const float* du, float* dv,
                      void* scratch, int B, int T, int R, int E, int w,
                      float temp, void* stream) {
  return run<false>(v_ext, v_is_bf16, fm_ext, rm_ext, nullptr, du, dv,
                    scratch, B, T, R, E, w, temp, stream);
}

// K1br: alpha read from the forward's residual [B, T, 2w, R, R].
int nafae_ctx_mix_bwd_res(const void* v_ext, int v_is_bf16,
                          const float* fm_ext, const float* rm_ext,
                          const void* alpha, const float* du, float* dv,
                          void* scratch, int B, int T, int R, int E, int w,
                          float temp, void* stream) {
  return run<true>(v_ext, v_is_bf16, fm_ext, rm_ext, alpha, du, dv, scratch,
                   B, T, R, E, w, temp, stream);
}

}  // extern "C"
