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
// f16 (model.dtype=float16 in training) the same in f16, subnormals kept:
// du_n at gradient scale lies below f16's normals. Every kernel is a
// template on the input's type; bf16 and f16 are one code, on mma.sync's
// bf16 or f16 form (bf16 below: either 16-bit type).
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
// R, E and w: up to R = 64 and w = 512 its staged kernels (a block a pair
// of frames, both directions from one stream of E), past them its wide
// ones. Its bound at R = 36, E = 1024, w = 3 (B=16, T=20, every frame
// valid, 1,728 live pairs): K1br 18.3 GFLOP (~274 us at 67 TFLOP/s f32),
// K1b 22.9 (~342 us), bound by operations in f32; in bf16 by bytes (~42
// us). chip_smoke.py counts the bound from a batch's masks (live regions
// and pairs only), lower still.

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
  constexpr bool k16 = sizeof(Tin) == 2;
  PairsSmem p;
  // f32: R rows of E + 4; bf16 (tensor cores): 32 rows of E padded to the
  // MMA's depth, + 8, zero beyond R and E
  p.ld = k16 ? ((E + 15) & ~15) + 8 : E + 4;
  p.frame_bytes = ((k16 ? 32 : R) * p.ld * (int)sizeof(Tin) + 15) / 16 * 16;
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
  constexpr bool k16 = sizeof(Tin) == 2;
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
  const int rows = k16 ? 32 : R;                 // staged rows (zero past R)
  const int cols = k16 ? ep : E;                 // staged columns (zero past E)

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
  Tin* dst_p = k16 ? nullptr : dst_out + pair_id * R * RS;
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
  if constexpr (k16) {
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

  if constexpr (k16)            // du_n is scaled already; r, s < 32
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
        if (!k16 && s < R) store_as(dst_p + s * RS + r, d);
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

// 16-bit (tensor cores): dv[f] for columns [64 y, 64 y + 64) as one product a
// neighbour: [alpha_gf^T | ds_gf^T | ds_fg] (32 x 96, R padded to 32 with
// zeros) times [du_n[g]; v[g]; v[g]] (96 x 64), mma.sync m16n8k16 with f32
// accumulators. Four warps, 16 columns each; the B fragments come from the
// row-major slices through ldmatrix.trans. du_n[g] is the pairs kernel's.
// The slices and matrices of a neighbour arrive by cp.async one neighbour
// ahead; ds_fg lands where the MMA reads it, the two transposed matrices
// are built from their copies. kHalo: as gather_sums'.
template <typename T16, bool kHalo>
__device__ __forceinline__ void gather_mma_sums(
    const T16* __restrict__ v_ext, const float* __restrict__ fm,
    const T16* __restrict__ alpha, const T16* __restrict__ ds,
    const T16* __restrict__ dun, float* __restrict__ dv, int f, int b,
    int col0, int T, int R, int E, int w, T16 (*xs)[32 * kMmaLd],
    T16 (*ys)[32 * kMmaLd], T16 (*raw)[2][32 * 32], T16 (*fg)[32 * kMatLd],
    T16 (*am)[32 * kMatLd]) {
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
      const T16* bsrc = blk == 0 ? xs[q] : ys[q];
      const T16* asrc = blk == 2 ? fg[q] : am[blk];
      for (int kk = 0; kk < ks; ++kk) {
        // B fragments of the two n8 tiles of this warp's 16 columns
        uint32_t y[4];
        frag_b2_trans(y, bsrc, kMmaLd, kk * 16, warp * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi >= mt) continue;                // block-uniform
          uint32_t x[4];
          frag_a(x, asrc, kMatLd, mi * 16, kk * 16);
          mma16<T16>(acc[mi][0], x, y[0], y[1]);
          mma16<T16>(acc[mi][1], x, y[2], y[3]);
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

template <typename T16>
__global__ void __launch_bounds__(128)
ctx_mix_bwd_gather_mma(const T16* __restrict__ v_ext,
                       const float* __restrict__ fm_ext,
                       const T16* __restrict__ alpha,  // padded
                       const T16* __restrict__ ds,     // padded
                       const T16* __restrict__ dun,    // [B,T,R,E]
                       float* __restrict__ dv, int T, int R, int E, int w) {
  __shared__ __align__(16) T16 xs[2][32 * kMmaLd];  // du_n[g]
  __shared__ __align__(16) T16 ys[2][32 * kMmaLd];  // v[g]
  __shared__ __align__(16) T16 raw[2][2][32 * 32];  // alpha, ds_gf
  __shared__ __align__(16) T16 fg[2][32 * kMatLd];  // ds_fg [a][b]
  __shared__ __align__(16) T16 am[2][32 * kMatLd];  // their ^T

  const int f = blockIdx.x;
  const int b = blockIdx.z;
  const float* fm = fm_ext + (size_t)b * (T + 2 * w);
  // rows and columns past R stay zero in the transposed matrices
  for (int i = threadIdx.x; i < 2 * 32 * kMatLd; i += blockDim.x)
    store_as(&am[0][0] + i, 0.f);

  if (touches_halo(fm, f, T, w))
    gather_mma_sums<T16, true>(v_ext, fm, alpha, ds, dun, dv, f, b,
                               blockIdx.y * kSlice, T, R, E, w, xs, ys, raw,
                               fg, am);
  else
    gather_mma_sums<T16, false>(v_ext, fm, alpha, ds, dun, dv, f, b,
                                blockIdx.y * kSlice, T, R, E, w, xs, ys, raw,
                                fg, am);
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
// the same layout, for 16-bit du_n [B, T, R, E] at a 16-byte boundary.
size_t mats_elems(int B, int T, int R, int w) {
  return (size_t)B * T * 2 * w * R * ((R + 7) & ~7);
}

template <typename Tin>
size_t scratch_elems(int B, int T, int R, int E, int w) {
  const size_t mats = mats_elems(B, T, R, w);
  return sizeof(Tin) == 2 ? (2 * mats + 7) / 8 * 8 + (size_t)B * T * R * E
                          : 3 * mats;
}

template <typename Tin, bool kResidual>
int run_typed(const void* v_ext, const float* fm_ext, const float* rm_ext,
              const void* alpha, const float* du, float* dv, void* scratch,
              int B, int T, int R, int E, int w, float temp,
              cudaStream_t stream) {
  constexpr bool k16 = sizeof(Tin) == 2;
  const size_t mats = mats_elems(B, T, R, w);
  Tin* ds = static_cast<Tin*>(scratch);
  Tin* alpha_s = ds + mats;
  Tin* dst = k16 ? nullptr : ds + 2 * mats;
  Tin* dun = k16 ? ds + (2 * mats + 7) / 8 * 8 : nullptr;
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
  if constexpr (k16) {
    const dim3 grid(T + 2 * w, (E + kSlice - 1) / kSlice, B);
    ctx_mix_bwd_gather_mma<Tin><<<grid, 128, 0, stream>>>(
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
// Any R, E and w, for the shapes the kernels above do not take. Up to R =
// kTileRows (64) regions and 2w = kTileOffsets (1024), R padded to RP, a
// multiple of 16 (48 at R = 36), two kernels as the forward's general
// variant (ctx_mix.cu), through a scratch of slots: for extended frame f and
// each neighbour g = f + d, the pair matrices that multiply g's rows in dv[f],
// each [RP][RP] row-major, zero past R and where a pair does not exist (its
// centre is a halo frame):
//
//   pairs   one block per unordered pair {c = t + w, n = c + o} of extended
//           frames (t = -w..T-1, o = 1..w; video b), the forward's grid: the
//           pair of centre c, offset +o, and the pair of centre n, offset -o,
//           each where its centre is a centre frame. It streams E through a
//           ring of kStages stages of kStageK columns of v_c, v_n, du_c and
//           du_n, and forms from the same stages the RP x RP products of
//           both directions, da_cn = du_n(c) v_n^T and da_nc^T = v_c
//           du_n(n)^T (K1b also the scores v_c v_n^T): f32 on CUDA cores,
//           16 x 16 threads with an MT x MT register tile each; bf16 on
//           mma.sync, a warp an n8 tile of columns (see below). Then, in
//           shared memory: alpha of both
//           directions (K1br: the residual; K1b: the softmax of the scores'
//           rows and columns, as the forward), ds of each (a warp a row or a
//           column; 0 for a group with no valid region), and the slots of c
//           (neighbour n) and of n (neighbour c): alpha_gf^T and the v[g]
//           terms ds_fg and ds_gf^T, so the gather reads every matrix row by
//           row. f32 folds scale_g into alpha_gf^T (the gather multiplies du
//           as stored) and keeps the two ds terms as their f32 sum; bf16
//           keeps them apart (each rounded to bf16 where the kernels above
//           round ds), and the block of a centre frame's first live pair
//           writes its du_n = bf16(scale du) for the gather.
//   gather  one block per (extended frame f, slice of kGatherCols columns,
//           video b), all RP rows, launched as a programmatic dependent of
//           the pairs kernel: f's valid neighbours g in offset order, each
//           step's slot and slices of du[g] (bf16: du_n[g]) and v[g] landing
//           by cp.async in a ring of kGatherSlots steps ahead of the sums.
//           f32 on register tiles (a lane 8 columns of up to MT groups of 8
//           rows: alpha_gf^T du[g] + (ds_fg + ds_gf^T) v[g]); bf16 as
//           [alpha_gf^T | ds_fg | ds_gf^T] x [du_n[g]; v[g]; v[g]] on
//           mma.sync (a warp 16 columns), its operands bf16 values already,
//           f32 accumulators.
//
// In bf16, da (and K1b's scores) is summed by mma.sync. Its sums truncate,
// so a few ds round to the neighbouring bf16 value where the plain
// version's IEEE sums do not; the forward's general variant sums its scores
// on CUDA cores for that reason (alpha feeds u, held to 1e-4), but dv is
// held to 2e-2 (chip_smoke.py's GRAD_TOL), and at every phase-17 case the
// mma.sync sums stay within it as closely as the CUDA cores' (PERF.md).
//
// Bound at R = 36, E = 1024, w = 3: as above (K1br bound by operations in
// f32, by bytes in bf16). Padding 36 regions to 48 adds 1.3x to the pairs'
// products (the padding rows are skipped, not the columns) and 1.1x to the
// gather's rows; the gather copies each frame from L2 once a neighbour.
//
// Past R = 64 (or w = 512) the wide kernels below take it, through a
// scratch of two f32 arrays [B, T, 2w, R, R], A (alpha) and D (da, then ds
// in place):
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

constexpr int kTileRows = 64;       // the largest R the staged kernels take
constexpr int kTileOffsets = 1024;  // ... and 2w (a frame's slots)
constexpr int kStageK = 64;         // E columns a pairs stage
constexpr int kStages = 2;          // ... in a ring of this many
constexpr int kGatherCols = 128;    // E columns a gather block
constexpr int kGatherSlots = 2;     // ... steps of its ring: two bf16
                                    // blocks share an SM, and one f32
                                    // block's fits at RP = 64 (64 columns
                                    // or a third step were slower: PERF.md)

// Matrices of a slot: f32 alpha_gf^T scale_g and ds_fg + ds_gf^T; bf16
// alpha_gf^T, ds_fg and ds_gf^T.
template <typename Tin>
__host__ __device__ constexpr int slot_mats() {
  return sizeof(Tin) == 2 ? 3 : 2;
}

// Slot of extended frame f and offset index i (offset_of(i, w)), video b.
__host__ __device__ __forceinline__ size_t slot_of(int b, int f, int i, int T,
                                                   int w) {
  return ((size_t)b * (T + 2 * w) + f) * 2 * w + i;
}

// Offset o in {-w..-1, 1..w} -> its index (offset_of's inverse).
__device__ __forceinline__ int index_of(int o, int w) {
  return o < 0 ? o + w : o + w - 1;
}

// acc + x . y, the four columns in order.
__device__ __forceinline__ float fma4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

template <typename Tin, int MT, bool kResidual>
__global__ void __launch_bounds__(kPairThreads)
ctx_mix_bwd_pairs_any(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                      const float* __restrict__ fm_ext,  // [B, T+2w]
                      const float* __restrict__ rm_ext,  // [B, T+2w, R] / null
                      const Tin* __restrict__ alpha,     // [B, T, 2w, R, R]
                      const float* __restrict__ du,      // [B, T, R, E]
                      Tin* __restrict__ mats,            // the slots
                      Tin* __restrict__ dun,             // [B, T, R, E] bf16
                      int T, int R, int E, int w, float temp) {
  constexpr bool k16 = sizeof(Tin) == 2;
  constexpr bool kScores = !kResidual;
  constexpr int RP = 16 * MT;                    // R padded
  constexpr int ld = stage_ld<Tin>(kStageK);
  constexpr int kTile = RP * ld;                 // a staged matrix
  constexpr int kStage = 4 * kTile;              // v_c, v_n, du_c, du_n
  constexpr int lds = RP + 1;                    // rows of the f32 tiles
  constexpr int kMat = RP * RP;
  constexpr int kPer = (RP + 31) / 32;
  static_assert(kStages == 2, "stage ks + 1 in flight during stage ks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* ring = reinterpret_cast<Tin*>(smem_raw);  // [kStages][kStage]
  __shared__ float live_c[RP], live_n[RP];       // region masks of c and n
  __shared__ float cnt_s[2];                     // valid neighbours of c, n
  __shared__ int first_s[2];                     // ... the first one's index
  const Tin* tag = nullptr;                      // picks as_operand's dtype

  let_mix_launch();
  const int t = (int)blockIdx.x - w;             // < 0: a left halo frame
  const int o = 1 + blockIdx.y;
  const int b = blockIdx.z;
  const int t_ext = T + 2 * w;
  const int c = t + w, n = c + o;                // extended frames
  const bool fw = t >= 0;                        // c is a centre frame
  const bool bw = t + o >= 0 && t + o < T;       // n is one
  if (!fw && !bw) return;                        // two halo frames
  const float* fm = fm_ext + (size_t)b * t_ext;
  if (fm[c] == 0.f || fm[n] == 0.f) return;      // nv = 0: nothing read
  const size_t frame = (size_t)R * E;
  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  const Tin* Vc = vb + (size_t)c * frame;
  const Tin* Vn = vb + (size_t)n * frame;
  const float* Uc = fw ? du + ((size_t)b * T + t) * frame : du;
  const float* Un = bw ? du + ((size_t)b * T + t + o) * frame : du;
  const int nk = (E + kStageK - 1) / kStageK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // bf16: du_n = bf16(scale du), a stage ahead of the products: each
  // thread copies its chunks of the next stage's du_c and du_n into an f32
  // buffer (cp.async, with the stage's group) and, once its own copies have
  // landed, rounds them into that stage's tiles, so no barrier guards the
  // buffer; the block of a centre frame's first live pair also writes them
  // out for the gather
  float* dubuf = reinterpret_cast<float*>(ring + kStages * kStage);
  const int vec = E % 4 == 0 ? 4 : E % 2 == 0 ? 2 : 1;   // floats a copy
  const int per_row = kStageK / vec;
  auto copy_du = [&](int ks) {
    for (int p = threadIdx.x; p < 2 * RP * per_row; p += kPairThreads) {
      const bool m = p >= RP * per_row;          // du_n (else du_c)
      const int rem = m ? p - RP * per_row : p;
      const int r = rem / per_row, col = (rem - r * per_row) * vec;
      const int e = ks * kStageK + col;          // a whole copy is in or out
      const bool ok = (m ? bw : fw) && r < R && e < E;
      const float* src = ok ? (m ? Un : Uc) + (size_t)r * E + e : du;
      float* d = dubuf + ((m ? RP : 0) + r) * kStageK + col;
      if (vec == 4) cp_async<16>(d, src, ok ? 16 : 0);
      else if (vec == 2) cp_async<8>(d, src, ok ? 8 : 0);
      else cp_async<4>(d, src, ok ? 4 : 0);
    }
  };
  auto stage = [&](int ks) {                     // one group a stage
    if (ks < nk) {
      Tin* d = ring + (ks % kStages) * kStage;
      const int k0 = ks * kStageK;
      stage_tile_any(d, Vc, RP, R, E, k0, kStageK, ld);
      stage_tile_any(d + kTile, Vn, RP, R, E, k0, kStageK, ld);
      if constexpr (k16) {
        copy_du(ks);                             // into the f32 buffer
      } else {                                   // f32: du as stored
        stage_tile_any(d + 2 * kTile, Uc, RP, fw ? R : 0, E, k0, kStageK, ld);
        stage_tile_any(d + 3 * kTile, Un, RP, bw ? R : 0, E, k0, kStageK, ld);
      }
    }
    cp_async_commit();
  };
  stage(0);                                      // in flight with the masks

  for (int i = threadIdx.x; i < 2 * RP; i += blockDim.x) {
    const int r = i % RP, f = i < RP ? c : n;
    (i < RP ? live_c : live_n)[r] = r >= R ? 0.f
        : rm_ext ? rm_ext[((size_t)b * t_ext + f) * R + r] : 1.f;
  }
  if (warp < 2) {                                // warp 0: c, warp 1: n
    const int f = warp == 0 ? c : n;
    float cnt = 1.f;                             // (a halo frame: unused)
    int first = 0;
    if (warp == 0 ? fw : bw) {                   // a sum of 0s and 1s
      cnt = 0.f;
      first = 2 * w;
      for (int i = lane; i < 2 * w; i += 32) {
        const float x = fm[f + offset_of(i, w)];
        cnt += x;
        if (x != 0.f) first = min(first, i);
      }
      cnt = any_warp_sum(cnt);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        first = min(first, __shfl_xor_sync(0xffffffffu, first, m));
    }
    if (lane == 0) {
      cnt_s[warp] = cnt;
      first_s[warp] = first;
    }
  }
  __syncthreads();
  const float scale_c = 1.f / fmaxf(cnt_s[0], 1.f);   // fm[c] is 1 here
  const float scale_n = 1.f / fmaxf(cnt_s[1], 1.f);

  const bool wr_c = k16 && fw && offset_of(first_s[0], w) == o;
  const bool wr_n = k16 && bw && offset_of(first_s[1], w) == -o;
  auto round_du = [&](int ks) {                  // this thread's copies
    Tin* d = ring + (ks % kStages) * kStage + 2 * kTile;
    for (int p = threadIdx.x; p < 2 * RP * per_row; p += kPairThreads) {
      const bool m = p >= RP * per_row;
      const int rem = m ? p - RP * per_row : p;
      const int r = rem / per_row, col = (rem - r * per_row) * vec;
      const int e = ks * kStageK + col;
      const bool wr = (m ? wr_n : wr_c) && r < R && e < E;
      for (int j = 0; j < vec; ++j) {
        const float x = as_operand(
            dubuf[((m ? RP : 0) + r) * kStageK + col + j] *
                (m ? scale_n : scale_c), tag);
        store_as(d + (m ? kTile : 0) + r * ld + col + j, x);
        if (wr)
          store_as(dun + (((size_t)b * T + (m ? t + o : t)) * R + r) * E + e +
                       j, x);
      }
    }
  };

  if constexpr (k16) {
    cp_async_wait(0);
    round_du(0);
  }

  // f32: thread (ty, tx) sums rows ty + 16 i (c's regions) and columns
  // tx + 16 j (n's), i, j < MT, on CUDA cores; padding rows skipped
  // (warp-uniform), padding columns zero. bf16: mma.sync m16n8k16 with f32
  // accumulators, warp w < 2 MT the n8 tile of columns 8 w.. and all MT m16
  // tiles of rows (padding tiles skipped, block-uniform)
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int g4 = lane >> 2, tig = lane & 3;
  constexpr int M3 = kScores ? MT : 1;
  constexpr int MF = k16 ? 1 : MT;               // the f32 register tile
  constexpr int MB = k16 ? MT : 1;               // the bf16 m16 tiles
  float a1[MF][MF], a2[MF][MF], a3[kScores ? MF : 1][kScores ? MF : 1];
  float m1[MB][4], m2[MB][4], m3[kScores ? MB : 1][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < MF; ++j) a1[i][j] = a2[i][j] = 0.f;
  for (auto& x : a3) for (float& y : x) y = 0.f;
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int z = 0; z < 4; ++z) m1[i][z] = m2[i][z] = 0.f;
  for (auto& x : m3) for (float& y : x) y = 0.f;

  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait(0);                            // stage ks
    __syncthreads();                             // ... for all; ks - 1 read
    stage(ks + 1);                               // into the slot of ks - 1
    const Tin* sVc = ring + (ks % kStages) * kStage;
    const Tin* sVn = sVc + kTile;
    const Tin* sUc = sVc + 2 * kTile;
    const Tin* sUn = sVc + 3 * kTile;
    if constexpr (k16) {
      if (warp < 2 * MT) {                       // warp-uniform
#pragma unroll
        for (int k = 0; k < kStageK; k += 16) {
          const Tin* qv = sVn + (8 * warp + g4) * ld + k + 2 * tig;
          const Tin* qu = sUn + (8 * warp + g4) * ld + k + 2 * tig;
          const uint32_t v0 = lds32(qv), v1 = lds32(qv + 8);
          const uint32_t u0 = lds32(qu), u1 = lds32(qu + 8);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            if (mi * 16 >= R) continue;          // padding rows
            uint32_t x[4];
            frag_a(x, sUc, ld, mi * 16, k);
            mma16<Tin>(m1[mi], x, v0, v1);       // da_cn
            frag_a(x, sVc, ld, mi * 16, k);
            mma16<Tin>(m2[mi], x, u0, u1);       // da_nc^T
            if constexpr (kScores) mma16<Tin>(m3[mi], x, v0, v1);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int q = 0; q < kStageK / 4; ++q) {
        float4 yv[MF], yu[MF];
#pragma unroll
        for (int j = 0; j < MF; ++j) {
          yv[j] = lds4(sVn + (tx + 16 * j) * ld, q);
          yu[j] = lds4(sUn + (tx + 16 * j) * ld, q);
        }
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if (ty + 16 * i >= R) continue;        // padding rows: warp-uniform
          const float4 xv = lds4(sVc + (ty + 16 * i) * ld, q);
          const float4 xu = lds4(sUc + (ty + 16 * i) * ld, q);
#pragma unroll
          for (int j = 0; j < MF; ++j) {
            a1[i][j] = fma4(xu, yv[j], a1[i][j]);
            a2[i][j] = fma4(xv, yu[j], a2[i][j]);
            if constexpr (kScores) a3[i][j] = fma4(xv, yv[j], a3[i][j]);
          }
        }
      }
    }
    if constexpr (k16) {                         // the slot of ks - 1 is read
      if (ks + 1 < nk) {
        cp_async_wait(0);
        round_du(ks + 1);
      }
    }
  }
  __syncthreads();                               // the ring is read

  // the tiles, in the ring's bytes: [r of c][s of n] each
  float* G1 = reinterpret_cast<float*>(smem_raw);  // da_cn, then ds of (c, +o)
  float* G2 = G1 + RP * lds;     // da_nc^T, then ds of (n, -o), transposed
  float* A1 = G2 + RP * lds;     // alpha of (c, +o)
  float* A2 = A1 + RP * lds;     // alpha of (n, -o), transposed
  float* S = A2 + RP * lds;      // the scores (K1b)
  for (int i = threadIdx.x; i < RP * lds; i += blockDim.x) A1[i] = A2[i] = 0.f;
  if constexpr (k16) {
    if (warp < 2 * MT)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int at = (mi * 16 + g4 + (z >> 1) * 8) * lds + 8 * warp +
                         2 * tig + (z & 1);
          G1[at] = m1[mi][z];
          G2[at] = m2[mi][z];
          if constexpr (kScores) S[at] = m3[mi][z];
        }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int at = (ty + 16 * i) * lds + tx + 16 * j;
        G1[at] = a1[i][j] * scale_c;             // f32: du_n's scale here
        G2[at] = a2[i][j] * scale_n;
        if constexpr (kScores) S[at] = a3[i][j];
      }
  }
  __syncthreads();
  if constexpr (kResidual) {                     // alpha as stored
    const size_t rr = (size_t)R * R;
    const Tin* a_fw = alpha + ((size_t)b * T + t) * 2 * w * rr +
                      (size_t)index_of(o, w) * rr;
    const Tin* a_bw = alpha + ((size_t)b * T + t + o) * 2 * w * rr +
                      (size_t)index_of(-o, w) * rr;
    for (int i = threadIdx.x; i < (int)rr; i += blockDim.x) {
      const int r = i / R, s = i - r * R;
      if (fw) A1[r * lds + s] = load1(a_fw + i);
      if (bw) A2[s * lds + r] = load1(a_bw + i);
    }
  } else {                                       // K1b: alpha in f32
    if (fw)
      for (int r = warp; r < R; r += kPairThreads / 32)
        warp_softmax<kPer>(
            R,
            [&](int s) {
              return live_n[s] > 0.f ? S[r * lds + s] / temp : kNeg;
            },
            [&](int s, float p) { A1[r * lds + s] = p; });
    if (bw)
      for (int s = warp; s < R; s += kPairThreads / 32)
        warp_softmax<kPer>(
            R,
            [&](int r) {
              return live_c[r] > 0.f ? S[r * lds + s] / temp : kNeg;
            },
            [&](int r, float p) { A2[r * lds + s] = p; });
  }
  // a group with no valid region took the uniform alpha: its ds is 0
  bool any_c = false, any_n = false;
  for (int r = 0; r < R; ++r) {
    any_c |= live_c[r] > 0.f;
    any_n |= live_n[r] > 0.f;
  }
  __syncthreads();
  // ds in place, a warp a row of (c, +o) and a column of (n, -o)^T
  if (fw)
    for (int r = warp; r < R; r += kPairThreads / 32) {
      float a[kPer], g[kPer], sum = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int s = lane + 32 * k;
        a[k] = s < R ? A1[r * lds + s] : 0.f;
        g[k] = s < R ? G1[r * lds + s] : 0.f;
        sum += a[k] * g[k];
      }
      sum = any_warp_sum(sum);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (lane + 32 * k < R)
          G1[r * lds + lane + 32 * k] = as_operand(
              any_n ? (a[k] * g[k] - a[k] * sum) / temp : 0.f, tag);
    }
  if (bw)
    for (int s = warp; s < R; s += kPairThreads / 32) {
      float a[kPer], g[kPer], sum = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int r = lane + 32 * k;
        a[k] = r < R ? A2[r * lds + s] : 0.f;
        g[k] = r < R ? G2[r * lds + s] : 0.f;
        sum += a[k] * g[k];
      }
      sum = any_warp_sum(sum);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (lane + 32 * k < R)
          G2[(lane + 32 * k) * lds + s] = as_operand(
              any_c ? (a[k] * g[k] - a[k] * sum) / temp : 0.f, tag);
    }
  __syncthreads();

  // the slots of c (neighbour n: rows c, columns n) and of n (neighbour c)
  Tin* Pc = mats + slot_of(b, c, index_of(o, w), T, w) * slot_mats<Tin>() *
                       kMat;
  Tin* Pn = mats + slot_of(b, n, index_of(-o, w), T, w) * slot_mats<Tin>() *
                       kMat;
  for (int i = threadIdx.x; i < kMat; i += blockDim.x) {
    const int r = i / RP, s = i - r * RP;
    const int rs = r * lds + s, sr = s * lds + r;
    if constexpr (k16) {
      store_as(Pc + i, A2[rs]);                  // alpha_nc^T
      store_as(Pc + kMat + i, G1[rs]);           // ds_cn
      store_as(Pc + 2 * kMat + i, G2[rs]);       // ds_nc^T
      store_as(Pn + i, A1[sr]);                  // alpha_cn^T
      store_as(Pn + kMat + i, G2[sr]);           // ds_nc
      store_as(Pn + 2 * kMat + i, G1[sr]);       // ds_cn^T
    } else {
      Pc[i] = A2[rs] * scale_n;
      Pc[kMat + i] = G1[rs] + G2[rs];
      Pn[i] = A1[sr] * scale_c;
      Pn[kMat + i] = G1[sr] + G2[sr];
    }
  }
}

template <typename Tin, int MT>
__global__ void __launch_bounds__(kPairThreads)
ctx_mix_bwd_gather_any(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                       const float* __restrict__ fm_ext,  // [B, T+2w]
                       const Tin* __restrict__ mats,      // the pairs' slots
                       const float* __restrict__ du,      // [B, T, R, E]
                       const Tin* __restrict__ dun,       // bf16 du_n, as du
                       float* __restrict__ dv,            // [B, T+2w, R, E]
                       int T, int R, int E, int w) {
  constexpr bool k16 = sizeof(Tin) == 2;
  constexpr int RP = 16 * MT;
  constexpr int kCols = kGatherCols;
  constexpr int lda = stage_ld<Tin>(RP);         // the matrices' rows
  constexpr int ldy = stage_ld<Tin>(kCols);      // the slices' rows
  constexpr int kMats = slot_mats<Tin>();
  constexpr int kX = kMats * RP * lda;           // du[g]'s (du_n[g]'s) slice
  constexpr int kY = kX + RP * ldy;              // v[g]'s slice
  constexpr int kSlot = kY + RP * ldy;
  constexpr int kSlots = kGatherSlots;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* slots = reinterpret_cast<Tin*>(smem_raw);   // [kSlots][kSlot]
  int* nbr = reinterpret_cast<int*>(slots + kSlots * kSlot);  // [2w]
  int* idx = nbr + 2 * w;                        // [2w] their slot indices
  __shared__ int steps_s;

  const int slices = (E + kCols - 1) / kCols;
  const int e0 = (int)(blockIdx.x % slices) * kCols;
  const int f = (int)(blockIdx.x / slices);
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const size_t frame = (size_t)R * E;
  const float* fm = fm_ext + (size_t)b * t_ext;

  // f's valid neighbours in offset order: a valid frame within w that shares
  // a pair with f (one of the two is a centre frame); none if f is invalid.
  // Warp 0 tests 32 offsets at a time and packs them by a ballot.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool fc = is_centre(f, T, w), fv = fm[f] != 0.f;
    int k = 0;
    for (int i0 = 0; i0 < 2 * w; i0 += 32) {
      const int i = i0 + lane, g = f + offset_of(i, w);
      const bool ok = fv && i < 2 * w && g >= 0 && g < t_ext &&
                      fm[g] != 0.f && (fc || is_centre(g, T, w));
      const unsigned got = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int at = k + __popc(got & ((1u << lane) - 1u));
        nbr[at] = g;
        idx[at] = i;
      }
      k += __popc(got);
    }
    if (lane == 0) steps_s = k;
  }
  __syncthreads();
  const int steps = steps_s;
  auto stage_y = [&](int j) {                    // inputs: no wait needed
    if (j < steps) {
      Tin* s = slots + (j % kSlots) * kSlot;
      const int g = nbr[j];
      stage_tile_any(s + kY, v_ext + ((size_t)b * t_ext + g) * frame, RP, R,
                     E, e0, kCols, ldy);
      if constexpr (!k16) {                      // du[g]: zeros past a halo
        const bool gc = is_centre(g, T, w);
        stage_tile_any(s + kX, gc ? du + ((size_t)b * T + g - w) * frame : du,
                       RP, gc ? R : 0, E, e0, kCols, ldy);
      }
    }
  };
  auto stage_a = [&](int j) {                    // what the pairs kernel wrote
    if (j < steps) {
      Tin* s = slots + (j % kSlots) * kSlot;
      stage_tile_any(s, mats + slot_of(b, f, idx[j], T, w) * kMats * RP * RP,
                     kMats * RP, kMats * RP, RP, 0, RP, lda);
      if constexpr (k16) {
        const int g = nbr[j];
        const bool gc = is_centre(g, T, w);
        stage_tile_any(s + kX,
                       gc ? dun + ((size_t)b * T + g - w) * frame : dun, RP,
                       gc ? R : 0, E, e0, kCols, ldy);
      }
    }
  };

  // steps 0 .. kSlots - 2 in two groups each (their inputs, then what the
  // pairs wrote), then one group a step; each step's group lands while the
  // kSlots - 1 before it are summed
  for (int j = 0; j < kSlots - 1; ++j) {
    stage_y(j);
    cp_async_commit();
  }
  wait_for_pairs();
  for (int j = 0; j < kSlots - 1; ++j) {
    stage_a(j);
    cp_async_commit();
  }
  float* dvb = dv + ((size_t)b * t_ext + f) * frame;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if constexpr (k16) {
    const int g4 = lane >> 2, tig = lane & 3;
    const int n0 = warp * 16;                    // this warp's columns
    float acc[MT][2][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[mi][ni][z] = 0.f;
    for (int j = 0; j < steps; ++j) {
      cp_async_wait(kSlots - 2);     // step j's groups; later ones may fly
      __syncthreads();               // ... for every thread; j - 1 is read
      stage_y(j + kSlots - 1);       // into the slot of step j - 1
      stage_a(j + kSlots - 1);
      cp_async_commit();
      const Tin* M = slots + (j % kSlots) * kSlot;
      const Tin* X = M + kX;
      const Tin* Y = M + kY;
      if (e0 + n0 < E) {             // warp-uniform
#pragma unroll
        for (int k = 0; k < RP; k += 16) {
          uint32_t yx[4], yv[4];     // B fragments of two n8 tiles
          frag_b2_trans(yx, X, ldy, k, n0);
          frag_b2_trans(yv, Y, ldy, k, n0);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            if (mi * 16 >= R) continue;          // block-uniform
            uint32_t x[4];
            frag_a(x, M, lda, mi * 16, k);                  // alpha_gf^T
            mma16<Tin>(acc[mi][0], x, yx[0], yx[1]);
            mma16<Tin>(acc[mi][1], x, yx[2], yx[3]);
            frag_a(x, M + RP * lda, lda, mi * 16, k);       // ds_fg
            mma16<Tin>(acc[mi][0], x, yv[0], yv[1]);
            mma16<Tin>(acc[mi][1], x, yv[2], yv[3]);
            frag_a(x, M + 2 * RP * lda, lda, mi * 16, k);   // ds_gf^T
            mma16<Tin>(acc[mi][0], x, yv[0], yv[1]);
            mma16<Tin>(acc[mi][1], x, yv[2], yv[3]);
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int row = mi * 16 + g4 + (z >> 1) * 8;
          const int col = e0 + n0 + ni * 8 + 2 * tig + (z & 1);
          if (row < R && col < E) dvb[(size_t)row * E + col] = acc[mi][ni][z];
        }
  } else {
    // warp w: columns 32 (w % CG).. of the slice (CG groups of 32) and, of
    // the 2 MT groups of 8 rows, groups w / CG + (8 / CG) k; lane (rg, cg):
    // rows rg + 8 (group), columns 8 cg.. (two float4). Four source rows a
    // step: a 16-byte read of each matrix a row (eight rows a warp,
    // distinct banks: lda / 4 is odd) and two of each slice's rows feed 64
    // FMAs a row group
    constexpr int CG = kCols / 32, KS = 8 / CG;
    constexpr int KR = (2 * MT + KS - 1) / KS;
    const int rg = lane >> 2, q0 = (warp % CG) * 8 + 2 * (lane & 3);
    const int k0 = warp / CG;                    // row groups k0 + KS k
    float acc[KR][8];
#pragma unroll
    for (int k = 0; k < KR; ++k)
#pragma unroll
      for (int z = 0; z < 8; ++z) acc[k][z] = 0.f;
    for (int j = 0; j < steps; ++j) {
      cp_async_wait(kSlots - 2);
      __syncthreads();
      stage_y(j + kSlots - 1);
      stage_a(j + kSlots - 1);
      cp_async_commit();
      const float* A = slots + (j % kSlots) * kSlot;   // alpha_gf^T
      const float* D = A + RP * lda;             // ds_fg + ds_gf^T
      const float* X = A + kX;
      const float* Y = A + kY;
      if (e0 + 32 * (warp % CG) < E) {           // warp-uniform
        for (int s = 0; s < R; s += 4) {         // rows past R are zeros
          float4 x[4][2], y[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[q][0] = lds4(X + (s + q) * ldy, q0);
            x[q][1] = lds4(X + (s + q) * ldy, q0 + 1);
            y[q][0] = lds4(Y + (s + q) * ldy, q0);
            y[q][1] = lds4(Y + (s + q) * ldy, q0 + 1);
          }
#pragma unroll
          for (int k = 0; k < KR; ++k) {
            const int row = rg + 8 * (k0 + KS * k);
            if (8 * (k0 + KS * k) >= R) continue;   // padding rows: uniform
            const float4 a4 = lds4(A + row * lda, s / 4);
            const float4 d4 = lds4(D + row * lda, s / 4);
            const float as[4] = {a4.x, a4.y, a4.z, a4.w};
            const float ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float xs[8] = {x[q][0].x, x[q][0].y, x[q][0].z, x[q][0].w,
                                   x[q][1].x, x[q][1].y, x[q][1].z, x[q][1].w};
              const float ys[8] = {y[q][0].x, y[q][0].y, y[q][0].z, y[q][0].w,
                                   y[q][1].x, y[q][1].y, y[q][1].z, y[q][1].w};
#pragma unroll
              for (int z = 0; z < 8; ++z)
                acc[k][z] = fmaf(ds[q], ys[z], fmaf(as[q], xs[z], acc[k][z]));
            }
          }
        }
      }
    }
    const int col = e0 + 4 * q0;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int r = rg + 8 * (k0 + KS * k);
      if (r >= R) continue;
      float* out = dvb + (size_t)r * E + col;
      if (E % 4 == 0 && col + 8 <= E) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        *reinterpret_cast<float4*>(out + 4) =
            make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
      } else {
#pragma unroll
        for (int z = 0; z < 8; ++z)
          if (col + z < E) out[z] = acc[k][z];
      }
    }
  }
}

template <typename Tin, bool kResidual>
__global__ void __launch_bounds__(kAnyThreads)
ctx_mix_bwd_pairs_wide(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
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
ctx_mix_bwd_gather_wide(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
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

// Whether the general variant's staged kernels take it (else the wide ones).
bool staged(int R, int w) {
  return R <= kTileRows && 2 * w <= kTileOffsets;
}

// The staged variant's scratch, in elements of Tin: the slots, [B, T+2w,
// 2w] of slot_mats [RP][RP] matrices each, then (bf16) du_n [B, T, R, E] at
// a 16-byte boundary.
template <typename Tin>
size_t staged_mats(int B, int T, int R, int w) {
  const size_t rp = (R + 15) & ~15;
  return (size_t)B * (T + 2 * w) * 2 * w * slot_mats<Tin>() * rp * rp;
}

template <typename Tin>
size_t staged_scratch(int B, int T, int R, int E, int w) {
  if (sizeof(Tin) == 4) return staged_mats<Tin>(B, T, R, w);
  return (staged_mats<Tin>(B, T, R, w) + 7) / 8 * 8 + (size_t)B * T * R * E;
}

// Dynamic shared memory: the pairs kernel's ring and, in bf16, its f32
// buffer of du (its f32 tiles take the same bytes after the stream), the
// gather's ring and neighbour lists.
template <typename Tin>
size_t pairs_staged_smem(int rp) {
  const size_t ring =
      (size_t)kStages * 4 * rp * stage_ld<Tin>(kStageK) * sizeof(Tin) +
      (sizeof(Tin) == 2 ? (size_t)2 * rp * kStageK * sizeof(float) : 0);
  const size_t tiles = (size_t)5 * rp * (rp + 1) * sizeof(float);
  return ring > tiles ? ring : tiles;
}

template <typename Tin>
size_t gather_staged_smem(int rp, int w) {
  return (size_t)kGatherSlots * rp *
             (slot_mats<Tin>() * stage_ld<Tin>(rp) +
              2 * stage_ld<Tin>(kGatherCols)) * sizeof(Tin) +
         4 * (size_t)w * sizeof(int);
}

// Sets a kernel's dynamic shared memory limit and launches it; `after`: as
// a programmatic dependent of the kernel launched before it on the stream.
template <typename... KArgs, typename... Args>
int launch_dyn(void (*kern)(KArgs...), dim3 grid, int threads, size_t smem,
               cudaStream_t stream, bool after, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = after ? &attr : nullptr;
  cfg.numAttrs = after ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<KArgs>(args)...);
}

template <typename Tin, int MT, bool kResidual>
int run_staged(const void* v_ext, const float* fm_ext, const float* rm_ext,
               const void* alpha, const float* du, float* dv, void* scratch,
               int B, int T, int R, int E, int w, float temp,
               cudaStream_t stream) {
  const size_t gather_x =
      (size_t)(T + 2 * w) * ((E + kGatherCols - 1) / kGatherCols);
  if ((size_t)T + w > 0x7fffffff || gather_x > 0x7fffffff)  // the grids' x
    return (int)cudaErrorInvalidValue;
  Tin* mats = static_cast<Tin*>(scratch);
  Tin* dun = sizeof(Tin) == 2
      ? mats + (staged_mats<Tin>(B, T, R, w) + 7) / 8 * 8 : nullptr;
  const int err = launch_dyn(
      ctx_mix_bwd_pairs_any<Tin, MT, kResidual>, dim3(T + w, w, B),
      kPairThreads, pairs_staged_smem<Tin>(16 * MT), stream, false,
      static_cast<const Tin*>(v_ext), fm_ext, rm_ext,
      static_cast<const Tin*>(alpha), du, mats, dun, T, R, E, w, temp);
  if (err != 0) return err;
  return launch_dyn(ctx_mix_bwd_gather_any<Tin, MT>,
                    dim3((unsigned)gather_x, B), kPairThreads,
                    gather_staged_smem<Tin>(16 * MT, w), stream, true,
                    static_cast<const Tin*>(v_ext), fm_ext,
                    static_cast<const Tin*>(mats), du,
                    static_cast<const Tin*>(dun), dv, T, R, E, w);
}

// The wide kernels' scratch: A and D, f32 [B, T, 2w, R, R] each.
size_t wide_mats(int B, int T, int R, int w) {
  return (size_t)B * T * 2 * w * R * R;
}

template <typename Tin, bool kResidual>
int run_wide(const void* v_ext, const float* fm_ext, const float* rm_ext,
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
  float* D = A + wide_mats(B, T, R, w);
  ctx_mix_bwd_pairs_wide<Tin, kResidual>
      <<<dim3((unsigned)pairs_x, B), kAnyThreads, 0, stream>>>(
          static_cast<const Tin*>(v_ext), fm_ext, rm_ext,
          static_cast<const Tin*>(alpha), du, A, D, T, R, E, w, temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctx_mix_bwd_gather_wide<Tin>
      <<<dim3((unsigned)gather_x, B), kAnyThreads, 0, stream>>>(
          static_cast<const Tin*>(v_ext), fm_ext, A, D, du, dv, T, R, E, w);
  return (int)cudaGetLastError();
}

template <typename Tin, bool kResidual>
int run_any(const void* v_ext, const float* fm_ext, const float* rm_ext,
            const void* alpha, const float* du, float* dv, void* scratch,
            int B, int T, int R, int E, int w, float temp,
            cudaStream_t stream) {
  static_assert(kTileRows == 4 * 16, "MT <= 4 below");
  if (!staged(R, w))
    return run_wide<Tin, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv,
                                    scratch, B, T, R, E, w, temp, stream);
  switch ((R + 15) / 16) {       // MT: R padded to 16 MT rows
    case 1: return run_staged<Tin, 1, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, scratch, B, T, R, E, w, temp, stream);
    case 2: return run_staged<Tin, 2, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, scratch, B, T, R, E, w, temp, stream);
    case 3: return run_staged<Tin, 3, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, scratch, B, T, R, E, w, temp, stream);
    default: return run_staged<Tin, 4, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv, scratch, B, T, R, E, w, temp, stream);
  }
}

template <bool kResidual>
int run(const void* v_ext, int dtype, const float* fm_ext,
        const float* rm_ext, const void* alpha, const float* du, float* dv,
        void* scratch, int B, int T, int R, int E, int w, float temp,
        void* stream) {
  if (R < 1 || E < 1 || w < 1 || B < 0 || B > 65535 || T < 1 ||
      scratch == nullptr || (kResidual && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool special = in_envelope(T, R, E, w);
  return by_dtype(dtype, (int)cudaErrorInvalidValue, [&](auto x) {
    using Tin = decltype(x);
    return special
        ? run_typed<Tin, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv,
                                    scratch, B, T, R, E, w, temp, s)
        : run_any<Tin, kResidual>(v_ext, fm_ext, rm_ext, alpha, du, dv,
                                  scratch, B, T, R, E, w, temp, s);
  });
}

// An empty kernel: launched with a real kernel's grid, block and shared
// memory it reads the floor that any kernel of that shape pays.
__global__ void null_kernel() {}

template <typename Tin>
int floor_staged(int B, int T, int R, int E, int w, cudaStream_t stream) {
  const int rp = 16 * ((R + 15) / 16);
  const size_t gather_x =
      (size_t)(T + 2 * w) * ((E + kGatherCols - 1) / kGatherCols);
  const int err = launch_dyn(null_kernel, dim3(T + w, w, B), kPairThreads,
                             pairs_staged_smem<Tin>(rp), stream, false);
  if (err != 0) return err;
  return launch_dyn(null_kernel, dim3((unsigned)gather_x, B), kPairThreads,
                    gather_staged_smem<Tin>(rp, w), stream, true);
}

}  // namespace

extern "C" {

// Launches two empty kernels with the grids, block sizes and dynamic shared
// memory that the general variant of nafae_ctx_mix_bwd and _res (the same
// for both) would use for these sizes, the second as the first's
// programmatic dependent up to R = 64 and w = 512 (in stream order past
// them): the launch floor its measured times are judged against. Returns
// cudaErrorInvalidValue for shapes the specialised kernels take.
int nafae_ctx_mix_bwd_floor(int dtype, int B, int T, int R, int E, int w,
                            void* stream) {
  if (R < 1 || E < 1 || w < 1 || B < 1 || B > 65535 || T < 1 ||
      in_envelope(T, R, E, w))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged(R, w))
    return by_dtype(dtype, (int)cudaErrorInvalidValue, [&](auto x) {
      return floor_staged<decltype(x)>(B, T, R, E, w, s);
    });
  const size_t tiles = (R + kAnyRows - 1) / kAnyRows;
  const size_t slices = (E + kAnyCols - 1) / kAnyCols;
  null_kernel<<<dim3((unsigned)(T * 2 * w * tiles), B), kAnyThreads, 0,
                s>>>();
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  null_kernel<<<dim3((unsigned)((T + 2 * w) * tiles * slices), B),
                kAnyThreads, 0, s>>>();
  return (int)cudaGetLastError();
}

// Elements of v_ext's type that the scratch of one call must hold (0 for
// an unknown dtype code).
size_t nafae_ctx_mix_bwd_scratch(int B, int T, int R, int E, int w,
                                 int dtype) {
  return by_dtype(dtype, (size_t)0, [&](auto x) {
    using Tin = decltype(x);
    if (in_envelope(T, R, E, w)) return scratch_elems<Tin>(B, T, R, E, w);
    if (staged(R, w)) return staged_scratch<Tin>(B, T, R, E, w);
    // two f32 arrays
    return 2 * wide_mats(B, T, R, w) * (sizeof(float) / sizeof(Tin));
  });
}

// Both launch the two kernels on `stream` and return the cudaError_t of the
// launches (0 = ok). v_ext is float* when dtype == 0, __nv_bfloat16* when
// it is 1, __half* when it is 2 (any other code: cudaErrorInvalidValue), and
// alpha (K1br only) has v_ext's type; rm_ext may be null; du
// is f32 [B, T, R, E]; dv is written whole, f32 [B, T+2w, R, E]. scratch
// holds nafae_ctx_mix_bwd_scratch(...) elements of v_ext's type, 16-byte
// aligned. All tensors are contiguous and v_ext, du and dv 16-byte aligned.
// Shapes with R <= 32, E a multiple of 4 in [4, 512], w <= 16 and T <=
// 65535 take the kernels above, every other the general variant. Limits:
// B <= 65535 (the grids' z or y), and, in the general variant, T + w and
// (T + 2w) ceil(E/64) (f32) or ceil(E/128) (16-bit) below 2^31 up to R = 64
// and w = 512, T 2w ceil(R/32) and (T + 2w) ceil(R/32) ceil(E/64) past them
// (the grids' x); R, E, w, T >= 1.

// K1b: alpha recomputed from the scores.
int nafae_ctx_mix_bwd(const void* v_ext, int dtype, const float* fm_ext,
                      const float* rm_ext, const float* du, float* dv,
                      void* scratch, int B, int T, int R, int E, int w,
                      float temp, void* stream) {
  return run<false>(v_ext, dtype, fm_ext, rm_ext, nullptr, du, dv,
                    scratch, B, T, R, E, w, temp, stream);
}

// K1br: alpha read from the forward's residual [B, T, 2w, R, R].
int nafae_ctx_mix_bwd_res(const void* v_ext, int dtype, const float* fm_ext,
                          const float* rm_ext, const void* alpha,
                          const float* du, float* dv, void* scratch, int B,
                          int T, int R, int E, int w, float temp,
                          void* stream) {
  return run<true>(v_ext, dtype, fm_ext, rm_ext, alpha, du, dv, scratch,
                   B, T, R, E, w, temp, stream);
}

}  // extern "C"
