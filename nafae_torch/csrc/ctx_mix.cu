// Context mixing, forward: the frame-banded affinity softmax and mix of the
// context-pooled grounding model, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels nafae_tpu/ops/pallas/fused_ctx.py::_fwd_kernel
// (the forward of ctx_mix_pallas, K1f) and ::_fwd_kernel_res (K1fr, the same
// forward storing alpha as the backward's residual). Same function as the
// port's plain version, nafae_torch/ops/kernels/ctx_mix.py::context_mix_plain:
//
//   for every video b, centre frame t, offset o in {-w..-1, 1..w}:
//     nv_o      = fm[t+o] * fm[t]   (halo frames: zero padding on one
//                 device, fm = 0; a neighbouring shard's frames under frame
//                 parallelism, valid or not as their own masks say)
//     S[r, s]   = v[t, r] . v[t+o, s] / temp,  -1e9 where rm[t+o, s] <= 0
//     alpha     = softmax_s(S) * nv_o                    (row max subtracted;
//                 an all-masked row gives the uniform 1/R over its R regions)
//   u[t, r]     = sum_o sum_s alpha[r, s] v[t+o, s] / max(sum_o nv_o, 1)
//
// With bf16 input the products use the bf16 values and sum in f32, and alpha
// is rounded to bf16 before the mix, as the reference's bf16 mode does
// (preferred_element_type=f32 with bf16 operands). u is always f32.
//
// Design: two kernels, one call, with alpha [B, T, 2w, R, R] in v's dtype
// as the hand-off between them. K1fr keeps that alpha as the backward's
// residual (zeros for offsets whose nv_o is 0 and for invalid centre
// frames); K1f passes a scratch of the same shape (3.1 MB at config4 in
// f32, written once and read back from L2).
//
//   pairs  one block per (frame t = -w..T-1, offset o = 1..w, video b)
//          stages v[t] and v[t+o] by cp.async and computes their R x R
//          products once for both directions of the pair (f32: CUDA cores,
//          groups of 8 lanes on 4 x 4 tiles; bf16: mma.sync m16n8k16 with R
//          padded to 32): alpha of (t, +o), when t is a centre frame, is
//          the masked softmax of its rows, alpha of (t+o, -o), when t+o is
//          one, that of its columns. The w left halo frames start blocks
//          too, so that a centre frame's pair with a valid left halo frame
//          is computed. 1,104 independent blocks at config4.
//   mix    one block per (centre frame t, video b) walks t's valid offsets
//          in order; each step's neighbour frame (cp.async) and alpha
//          (through registers) land in a ring of three shared-memory slots
//          two steps ahead of the sums. f32: 4 groups of rows x E/4 column
//          quads, each thread's accumulators in registers; bf16: one warp
//          per 64 columns, alpha (already rounded to bf16 by the pairs
//          kernel, so no extra rounding enters) times the frame on
//          mma.sync. Then u = sums / max(cnt, 1). It is launched as a
//          programmatic dependent of the pairs kernel: its blocks start,
//          read the masks and copy their first frames while the pairs
//          kernel's last blocks run, and wait for the pairs grid before the
//          first read of alpha.
//
// f32 runs in full f32 (no TF32: the port holds f32 to the reference's
// HIGHEST precision), and sums in the order of the earlier one-block-per-
// frame design, so its f32 u and alpha are bit for bit that design's. No
// atomics: every output element is summed by one thread in a fixed order,
// so the f32 u is the same on every run. Shared memory does not grow with T.
//
// Bound on an H100 SXM (config4 serving shapes B=16, T=20, R=20, E=256,
// w=3, f32, every frame valid): it reads 8.5 MB of v_ext and writes 6.6 MB
// of u (~4.5 us at 3.35 TB/s) and does 4*R*R*E flops per (b, t, o):
// 0.79 GFLOP (~12 us at 67 TFLOP/s f32 on CUDA cores). So it is bound by
// operations. With bf16 input it reads 4.3 MB of v_ext and writes the same
// 6.6 MB of u (~3.2 us), and the same flops on bf16 tensor cores at ~989
// TFLOP/s take ~0.8 us: bound by bytes. This design adds alpha's round trip
// and copies each frame into shared memory 2w times for the pairs and 2w
// times for the mix (~80 MB from L2 at config4 in f32, every frame valid);
// those copies and the f32 products' shared-memory reads (8 16-byte loads
// for 64 FMAs) are what hold it. PERF.md has its measured times.
//
// Shapes. The two kernels above take R <= 32 (one register accumulator and
// one 32 x 32 score tile per region), E a multiple of 4 in [4, 512] (a
// pairs block stages two whole frames) and w <= 16 (a frame's offsets as
// bits of a warp's mask). Every other shape takes the general variant
// below: the same function and the same two steps, with E streamed in
// stages so that any E and w fit; up to R = 64 the whole score tile stays
// in shared memory (R padded to a multiple of 16) and the products run in
// register tiles (f32) or on mma.sync (bf16), past it wide kernels walk 32
// regions at a time. The shapes above keep the kernels above, unchanged.

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

// A frame's rows [0, rows) and columns [0, cols) into shared rows of stride
// ld (zero beyond R and E), by cp.async: 16-byte copies, or for bf16 rows
// that are not 16-byte aligned (E % 8 != 0) 8-byte copies.
template <typename Tin>
__device__ __forceinline__ void stage_frame_async(Tin* dst, const Tin* src,
                                                  int rows, int R, int E,
                                                  int k0, int cols, int ld) {
  if (sizeof(Tin) == 4 || E % 8 == 0)
    stage_tile_async<(int)(16 / sizeof(Tin))>(dst, src, rows, R, E, k0, cols,
                                              ld);
  else
    stage_tile_async<4>(dst, src, rows, R, E, k0, cols, ld);
}

// Shared memory of a pairs block: the two staged frames (f32: R rows of
// E + 4; bf16: 32 rows of E padded to 16, + 8, zero beyond R and E), the
// scores of both directions [2][32][32] and the two region masks [2][32].
template <typename Tin>
__host__ __device__ inline int pairs_frame_bytes(int R, int E) {
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const int ld = kBf16 ? ((E + 15) & ~15) + 8 : E + 4;
  return ((kBf16 ? 32 : R) * ld * (int)sizeof(Tin) + 15) / 16 * 16;
}

template <typename Tin>
size_t pairs_smem(int R, int E) {
  return 2 * (size_t)pairs_frame_bytes<Tin>(R, E) + (2 * 32 * 32 + 64) * 4;
}

// Pairs: block (frame t = blockIdx.x - w, offset o = 1 + blockIdx.y, video
// b) takes extended frames c = t + w and n = c + o. Their products G[r][s]
// = v_c[r] . v_n[s] serve both directions: alpha of (t, +o), the softmax of
// G's rows over s, when t >= 0 is a centre frame, and alpha of (t + o, -o),
// the softmax of its columns over r, when t + o < T is one (the same dots:
// fmaf is symmetric in its factors, so the f32 scores are those a block of
// (t + o, -o) would sum). Every slot of alpha is written by exactly one
// block: (t, +o) by block t, (t, -o) by block t - o, a left halo frame's
// when t - o < 0.
template <typename Tin>
__global__ void __launch_bounds__(kPairThreads)
ctx_mix_fwd_pairs(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                  const float* __restrict__ fm_ext,  // [B, T+2w]
                  const float* __restrict__ rm_ext,  // [B, T+2w, R] or null
                  Tin* __restrict__ alpha,           // [B, T, 2w, R, R]
                  int T, int R, int E, int w, float temp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = sizeof(Tin) == 2;
  const int ep = (E + 15) & ~15;
  const int ld = kBf16 ? ep + 8 : E + 4;
  const int rows = kBf16 ? 32 : R;               // staged rows (zero past R)
  const int cols = kBf16 ? ep : E;               // staged columns (zero past E)
  const int fb = pairs_frame_bytes<Tin>(R, E);
  Tin* C = reinterpret_cast<Tin*>(smem_raw);             // v_c
  Tin* N = reinterpret_cast<Tin*>(smem_raw + fb);        // v_n
  float* S = reinterpret_cast<float*>(smem_raw + 2 * fb);  // [r][s] of (t, +o)
  float* S2 = S + 32 * 32;                       // [s][r] of (t + o, -o)
  float* live_n = S2 + 32 * 32;                  // region masks of n and c
  float* live_c = live_n + 32;

  let_mix_launch();
  const int t = (int)blockIdx.x - w;             // < 0: a left halo frame
  const int o = 1 + blockIdx.y;
  const int b = blockIdx.z;
  const int t_ext = T + 2 * w;
  const int c = t + w;                           // extended frames
  const int n = c + o;
  const size_t frame = (size_t)R * E;
  const int rr = R * R;
  const size_t pairs_t = 2 * (size_t)w * rr;     // alpha of one centre frame
  Tin* a_fw = t >= 0
      ? alpha + ((size_t)b * T + t) * pairs_t + (size_t)(o + w - 1) * rr
      : nullptr;
  Tin* a_bw = t + o >= 0 && t + o < T
      ? alpha + ((size_t)b * T + t + o) * pairs_t + (size_t)(w - o) * rr
      : nullptr;
  if (a_fw == nullptr && a_bw == nullptr) return;  // two halo frames
  const float* fm = fm_ext + (size_t)b * t_ext;
  const float nv = fm[n] * fm[c];                // the same both ways
  if (nv == 0.f) {                               // dead pair: alpha is zero
    for (int i = threadIdx.x; i < rr; i += blockDim.x) {
      if (a_fw) store_as(a_fw + i, 0.f);
      if (a_bw) store_as(a_bw + i, 0.f);
    }
    return;
  }

  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  stage_frame_async(C, vb + (size_t)c * frame, rows, R, E, 0, cols, ld);
  stage_frame_async(N, vb + (size_t)n * frame, rows, R, E, 0, cols, ld);
  cp_async_commit();
  if (threadIdx.x < 64) {
    const int i = threadIdx.x & 31;
    const int f = threadIdx.x < 32 ? n : c;
    live_n[threadIdx.x] =
        i >= R ? 0.f
        : rm_ext ? rm_ext[((size_t)b * t_ext + f) * R + i] : 1.f;
  }
  cp_async_wait(0);
  __syncthreads();

  auto score = [&](int r, int s, float d, float) {
    S[r * 32 + s] = live_n[s] > 0.f ? d / temp : kNeg;
    S2[s * 32 + r] = live_c[r] > 0.f ? d / temp : kNeg;
  };
  if constexpr (kBf16)
    pair_products_mma<false>(C, C, N, ep, ld, score);
  else
    pair_products<false>(C, C, N, R, E, ld, score);
  __syncthreads();
  // the values the mix multiplies by, in v's dtype
  if (a_fw)
    row_softmax(S, 32, R, [&](int r, int s, float p) {
      store_as(a_fw + r * R + s, p * nv);
    });
  if (a_bw)
    row_softmax(S2, 32, R, [&](int s, int r, float p) {
      store_as(a_bw + s * R + r, p * nv);
    });
}

// A mix block owns one centre frame t and walks its valid offsets in order
// (steps j = 0, 1, ...), with the neighbour frame and alpha of each step in
// one of kSlots ring slots of shared memory: step j + 2's frame is copied
// (cp.async) and its alpha loaded (through registers) while step j sums, so
// each copy has two steps to land.
constexpr int kSlots = 3;
constexpr int kMixMinThreads = 128;
constexpr int kMatPer = 32 * 32 / kMixMinThreads;  // alpha entries a thread

// The valid offsets of centre frame c as bits of a mask (bit i: offset index
// i, block-uniform), and sum_o nv_o in offset order; none if c is not
// valid. Lane i of each warp reads offset i's frame mask, so the 2w reads
// are one round trip, not 2w.
__device__ __forceinline__ unsigned live_offsets(float& cnt, const float* fm,
                                                 int c, int w) {
  const int lane = threadIdx.x & 31;
  const float fm_c = fm[c];
  const float nv = lane < 2 * w ? fm[c + offset_of(lane, w)] * fm_c : 0.f;
  const unsigned mask = __ballot_sync(0xffffffffu, nv != 0.f);
  cnt = 0.f;
  for (int i = 0; i < 2 * w; ++i) cnt += __shfl_sync(0xffffffffu, nv, i);
  return mask;
}

// The offset index of step j (the j-th set bit of mask), or -1.
__device__ __forceinline__ int nth_offset(unsigned mask, int j) {
  for (int i = 0; i < j && mask; ++i) mask &= mask - 1u;
  return mask ? __ffs(mask) - 1 : -1;
}

// Row-major R x R alpha_o into registers (entries i = threadIdx.x + blockDim.x
// e), then into shared memory at put(r, s); (r, s) advance without a
// division.
template <typename T>
struct MatLoader {
  T m[kMatPer];
  int r_first, s_first, step_r, step_s;
  __device__ __forceinline__ MatLoader(int R) {
    r_first = threadIdx.x / R;
    s_first = threadIdx.x - r_first * R;
    step_r = blockDim.x / R;
    step_s = blockDim.x - step_r * R;
  }
  __device__ __forceinline__ void load(const T* a, int rr) {
#pragma unroll
    for (int e = 0; e < kMatPer; ++e) {
      const int i = threadIdx.x + blockDim.x * e;
      if (i < rr) m[e] = a[i];
    }
  }
  template <typename Put>
  __device__ __forceinline__ void store(int R, Put put) const {
    int r = r_first, s = s_first;
#pragma unroll
    for (int e = 0; e < kMatPer; ++e) {
      if (r < R) put(r, s, m[e]);
      r += step_r;
      s += step_s;
      if (s >= R) {
        s -= R;
        ++r;
      }
    }
  }
};

// f32: u[t] from block t. Thread (h, q) owns columns 4q..4q+3 of rows
// h*RH .. h*RH + RH - 1 (kRowGroups RH >= R), so each x it reads from a
// staged frame feeds 4 RH FMAs; alpha_o sits transposed in its slot,
// [s][h][RH4] (zero where r >= R), read as RH4 / 4 16-byte broadcasts a
// source row s. Four row groups, not two: on the serving batch, where many
// offsets are dead, the extra warps hide more latency than the extra
// shared-memory reads of x cost; on the training batch two are faster
// (PERF.md has the times of both).
constexpr int kRowGroups = 4;

template <int RH>
__global__ void __launch_bounds__(512)
ctx_mix_fwd_mix(const float* __restrict__ v_ext,   // [B, T+2w, R, E]
                const float* __restrict__ fm_ext,  // [B, T+2w]
                const float* __restrict__ alpha,   // [B, T, 2w, R, R]
                float* __restrict__ u,             // [B, T, R, E]
                int T, int R, int E, int w) {
  constexpr int RH4 = (RH + 3) & ~3;
  extern __shared__ __align__(16) float smem[];
  const int ld = E + 4;
  const int frame_f = R * ld;                     // floats of a staged frame
  const int mat_f = R * kRowGroups * RH4;         // floats of an alpha^T
  const int slot_f = frame_f + mat_f;

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const int c = t + w;
  const size_t frame = (size_t)R * E;
  const int rr = R * R;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const float* ab = alpha + ((size_t)b * T + t) * 2 * w * rr;
  const int nq = blockDim.x / kRowGroups;         // column quads of a group
  const int h = threadIdx.x / nq;
  const int q = threadIdx.x - h * nq;

  for (int i = threadIdx.x; i < kSlots * mat_f / 4; i += blockDim.x) {
    const int k = i / (mat_f / 4);                // alpha^T rows r >= R
    float4* zero = reinterpret_cast<float4*>(smem + k * slot_f + frame_f);
    zero[i - k * (mat_f / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float cnt;
  const unsigned live = live_offsets(cnt, fm, c, w);
  MatLoader<float> mat(R), mat1(R);
  auto stage = [&](int j) {                       // step j's frame
    const int oi = nth_offset(live, j);
    if (oi >= 0)
      stage_tile_async<4>(
          smem + (j % kSlots) * slot_f,
          v_ext + ((size_t)b * t_ext + c + offset_of(oi, w)) * frame, R, R, E,
          0, E, ld);
    cp_async_commit();                            // one group a step
  };
  auto load_mat = [&](int j, MatLoader<float>& m) {   // step j's alpha
    const int oi = nth_offset(live, j);
    if (oi >= 0) m.load(ab + (size_t)oi * rr, rr);
  };
  auto put_mat = [&](int j, const MatLoader<float>& m) {
    if (nth_offset(live, j) < 0) return;
    float* A = smem + (j % kSlots) * slot_f + frame_f;
    m.store(R, [&](int r, int s, float x) {
      A[s * kRowGroups * RH4 + (r / RH) * RH4 + r % RH] = x;
    });
  };

  float acc[RH][4];
#pragma unroll
  for (int i = 0; i < RH; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  __syncthreads();               // the zeroed slots
  stage(0);                      // v does not depend on the pairs kernel
  stage(1);
  wait_for_pairs();              // alpha does
  load_mat(0, mat);              // both steps' loads in flight at once
  load_mat(1, mat1);
  put_mat(0, mat);
  put_mat(1, mat1);
  const int steps = __popc(live);
  for (int j = 0; j < steps; ++j) {
    cp_async_wait(1);            // step j's group; j + 1's may be in flight
    __syncthreads();             // ... for every thread; step j - 1 is read
    stage(j + 2);                // into the slot of step j - 1
    load_mat(j + 2, mat);
    const float* X = smem + (j % kSlots) * slot_f;
    const float* A = X + frame_f + h * RH4;
    if (4 * q < E) {
#pragma unroll 2
      for (int s = 0; s < R; ++s) {
        const float4 x = reinterpret_cast<const float4*>(X + s * ld)[q];
        float a[RH4];
#pragma unroll
        for (int i = 0; i < RH4; i += 4) {
          const float4 a4 =
              reinterpret_cast<const float4*>(A + s * kRowGroups * RH4 + i)[0];
          a[i] = a4.x; a[i + 1] = a4.y; a[i + 2] = a4.z; a[i + 3] = a4.w;
        }
#pragma unroll
        for (int i = 0; i < RH; ++i) {
          acc[i][0] = fmaf(a[i], x.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], x.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], x.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], x.w, acc[i][3]);
        }
      }
    }
    put_mat(j + 2, mat);
  }

  if (4 * q < E) {
    const float den = fmaxf(cnt, 1.f);
    float* ub = u + ((size_t)b * T + t) * frame;
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      const int r = h * RH + i;
      if (r < R)
        *reinterpret_cast<float4*>(ub + (size_t)r * E + 4 * q) = make_float4(
            acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
    }
  }
}

// Threads and dynamic shared memory of the f32 mix: kRowGroups groups of
// max(64, E/4 rounded up to 32) column quads.
int mix_threads_f32(int E) {
  return kRowGroups * max(64, ((E / 4 + 31) / 32) * 32);
}
size_t mix_smem_f32(int R, int E, int rh) {
  const int rh4 = (rh + 3) & ~3;
  return (size_t)kSlots * (R * (E + 4) + R * kRowGroups * rh4) * 4;
}

// bf16 (tensor cores): u[t] from block t, one warp per 64 columns (at least
// four warps): each step one product alpha_o (32 x 32, R padded with
// zeros) times the neighbour frame's 64 columns (32 x 64), mma.sync
// m16n8k16 with f32 accumulators; the B fragments come from the staged
// row-major frame through ldmatrix.trans.
__global__ void __launch_bounds__(256)
ctx_mix_fwd_mix_mma(const __nv_bfloat16* __restrict__ v_ext,
                    const float* __restrict__ fm_ext,
                    const __nv_bfloat16* __restrict__ alpha,  // [B,T,2w,R,R]
                    float* __restrict__ u, int T, int R, int E, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int cols = (E + kSlice - 1) / kSlice * kSlice;
  const int ld = cols + 8;                        // 16-byte rows, skewed
  const int frame_h = 32 * ld;                    // bf16 of a staged frame
  const int slot_h = frame_h + 32 * kMatLd;

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const int c = t + w;
  const size_t frame = (size_t)R * E;
  const int rr = R * R;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const __nv_bfloat16* ab = alpha + ((size_t)b * T + t) * 2 * w * rr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, tig = lane & 3;
  const int col0 = warp * kSlice;                 // this warp's columns
  const int mt = R > 16 ? 2 : 1;                  // m16 tiles of rows r
  const int ks = R > 16 ? 2 : 1;                  // k16 steps of rows s

  // zero once: each slot's frame rows R..31 (the copies write rows < R)
  // and alpha beyond R, 16 bytes a store
  const int zero_h = (32 - R) * ld + 32 * kMatLd;
  for (int i = threadIdx.x; i < kSlots * zero_h / 8; i += blockDim.x) {
    const int k = i / (zero_h / 8);
    reinterpret_cast<uint4*>(smem + k * slot_h + R * ld)[i - k * (zero_h / 8)] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  float cnt;
  const unsigned live = live_offsets(cnt, fm, c, w);
  MatLoader<__nv_bfloat16> mat(R), mat1(R);
  auto stage = [&](int j) {
    const int oi = nth_offset(live, j);
    if (oi >= 0)
      stage_frame_async(
          smem + (j % kSlots) * slot_h,
          v_ext + ((size_t)b * t_ext + c + offset_of(oi, w)) * frame, R, R, E,
          0, cols, ld);
    cp_async_commit();
  };
  auto load_mat = [&](int j, MatLoader<__nv_bfloat16>& m) {
    const int oi = nth_offset(live, j);
    if (oi >= 0) m.load(ab + (size_t)oi * rr, rr);
  };
  auto put_mat = [&](int j, const MatLoader<__nv_bfloat16>& m) {
    if (nth_offset(live, j) < 0) return;
    __nv_bfloat16* A = smem + (j % kSlots) * slot_h + frame_h;
    m.store(R, [&](int r, int s, __nv_bfloat16 x) { A[r * kMatLd + s] = x; });
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[mi][ni][z] = 0.f;
  __syncthreads();
  stage(0);                      // v does not depend on the pairs kernel
  stage(1);
  wait_for_pairs();              // alpha does
  load_mat(0, mat);              // both steps' loads in flight at once
  load_mat(1, mat1);
  put_mat(0, mat);
  put_mat(1, mat1);
  const int steps = __popc(live);
  for (int j = 0; j < steps; ++j) {
    cp_async_wait(1);
    __syncthreads();
    stage(j + 2);
    load_mat(j + 2, mat);
    const __nv_bfloat16* Y = smem + (j % kSlots) * slot_h;
    const __nv_bfloat16* A = Y + frame_h;
    if (col0 < E) {              // warp-uniform
      for (int kk = 0; kk < ks; ++kk) {
        uint32_t x[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (mi < mt) frag_a(x[mi], A, kMatLd, mi * 16, kk * 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t y[4];         // B fragments of two n8 tiles
          frag_b2_trans(y, Y, ld, kk * 16, col0 + nt * 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (mi >= mt) continue;              // block-uniform
            mma_bf16(acc[mi][2 * nt], x[mi], y[0], y[1]);
            mma_bf16(acc[mi][2 * nt + 1], x[mi], y[2], y[3]);
          }
        }
      }
    }
    put_mat(j + 2, mat);
  }

  const float den = fmaxf(cnt, 1.f);
  float* ub = u + ((size_t)b * T + t) * frame;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mi * 16 + g4 + hh * 8;
        const int col = col0 + ni * 8 + 2 * tig;
        if (row < R && col < E)
          *reinterpret_cast<float2*>(ub + (size_t)row * E + col) = make_float2(
              acc[mi][ni][2 * hh] / den, acc[mi][ni][2 * hh + 1] / den);
      }
}

int mix_threads_bf16(int E) {
  return 32 * max(4, (E + kSlice - 1) / kSlice);
}
size_t mix_smem_bf16(int E) {
  const int cols = (E + kSlice - 1) / kSlice * kSlice;
  return (size_t)kSlots * (32 * (cols + 8) + 32 * kMatLd) * 2;
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

template <int RH>
int launch_mix(const float* v_ext, const float* fm_ext, const float* alpha,
               float* u, int B, int T, int R, int E, int w,
               cudaStream_t stream) {
  return launch_dyn(ctx_mix_fwd_mix<RH>, dim3(T, B), mix_threads_f32(E),
                    mix_smem_f32(R, E, RH), stream, true, v_ext, fm_ext,
                    alpha, u, T, R, E, w);
}

int launch_mix_f32(const float* v, const float* fm_ext, const float* a,
                   float* u, int B, int T, int R, int E, int w,
                   cudaStream_t stream) {
  switch ((R + 3) / 4) {         // RH = rows of a group
    case 1: return launch_mix<1>(v, fm_ext, a, u, B, T, R, E, w, stream);
    case 2: return launch_mix<2>(v, fm_ext, a, u, B, T, R, E, w, stream);
    case 3: return launch_mix<3>(v, fm_ext, a, u, B, T, R, E, w, stream);
    case 4: return launch_mix<4>(v, fm_ext, a, u, B, T, R, E, w, stream);
    case 5: return launch_mix<5>(v, fm_ext, a, u, B, T, R, E, w, stream);
    case 6: return launch_mix<6>(v, fm_ext, a, u, B, T, R, E, w, stream);
    case 7: return launch_mix<7>(v, fm_ext, a, u, B, T, R, E, w, stream);
    default: return launch_mix<8>(v, fm_ext, a, u, B, T, R, E, w, stream);
  }
}

// ------------------------------------------------- the general variant
//
// Any R, E and w, for the shapes the kernels above do not take. The same two
// steps, each pair's alpha through the alpha buffer. Up to R = kTileRows
// (64) regions, R padded to RP, a multiple of 16 (48 at R = 36):
//
//   pairs  one block per (frame t = -w..T-1, offset o = 1..w, video b), as
//          the pairs kernel above: it streams E through a ring of
//          kPairStages stages of kPairK columns of both frames (cp.async
//          as wide as the rows allow; plain loads for odd bf16 E) and
//          forms the RP x RP products once for both directions (16 x 16
//          threads, an MT x MT register tile each, f32 FMAs in both
//          dtypes: see below), keeps the whole score tile in shared
//          memory, and writes alpha of (t, +o) from its rows' softmax and
//          of (t + o, -o) from its columns', one warp a row or column in
//          one pass. A dead pair (nv = 0) only writes its zeros; at E =
//          50, w = 20 most pairs are dead, and blocks that took a group of
//          ceil(w/4) offsets in turn were slower there (PERF.md).
//   mix    one block per (centre frame t, slice of kMixCols columns, video
//          b), all RP rows: its live offsets in order, each step's alpha
//          and neighbour slice landing by cp.async in a ring of kMixSlots,
//          two steps ahead of the sums (f32: 8 warps of 32 columns and
//          half the rows, a thread MT rows x 8 columns, four source rows a
//          step; bf16: alpha, already rounded to bf16 by the pairs kernel,
//          times the slice on mma.sync, a warp 16 columns); then u = sums
//          / max(cnt, 1). It is launched as a programmatic dependent of
//          the pairs kernel, as the mix above.
//
// The scores are summed on CUDA cores in bf16 too, as the pairs kernel
// above does in f32 and the plain version does: products of bf16 values are
// exact in f32, and their IEEE sums round alpha to bf16 as the plain
// version does. Summed by mma.sync instead (which truncates its sums), a
// few entries of alpha rounded to the neighbouring bf16 value, which moved
// K1fr's u by 1.26e-4 at E = 50, past the bf16 tolerance of chip_smoke.py's
// phase 17 (PERF.md). The mix keeps mma.sync: its operands are already
// bf16 and its sums feed u alone.
//
// Past R = 64 (or w = 512) the wide kernels below take it: the same steps
// over tiles of 32 regions and 64 columns, the softmax in two passes over
// the scores (running max and sum, then the scores again), so nothing grows
// with R or w.
//
// Bound at R = 36, E = 1024, w = 3 (B = 16, T = 20, every frame valid,
// 1,728 live pairs): 9.2 GFLOP (~137 us at 67 TFLOP/s f32) against 109 MB
// (~32 us): bound by operations in f32; in bf16 78 MB (~23 us), bound by
// bytes. Padding 36 regions to 48 adds 1.5x to the pairs' products (the
// padding rows are skipped, not the columns) and 1.1x (f32) or 1.3x (bf16)
// to the mix's; each frame is copied from L2 once a pair and once a centre
// frame that reads it, ~0.6 GB at these shapes in f32.

constexpr int kTileRows = 64;        // the largest R the staged kernels take
constexpr int kTileOffsets = 1024;   // ... and 2w (the mix lists them)
constexpr int kPairK = 64;           // E columns a pairs stage
constexpr int kPairStages = 2;       // ... in a ring of this many
constexpr int kMixCols = 128;        // E columns a mix block
constexpr int kMixSlots = 3;         // ... a ring of this many steps

template <typename Tin>
size_t pairs_any_smem(int rp) {
  return kPairStages * 2 * (size_t)rp * stage_ld<Tin>(kPairK) * sizeof(Tin) +
         ((size_t)rp * (rp + 1) + 2 * rp) * sizeof(float);
}

template <typename Tin>
size_t mix_any_smem(int rp, int w) {
  return kMixSlots * (size_t)rp *
             (stage_ld<Tin>(rp) + stage_ld<Tin>(kMixCols)) * sizeof(Tin) +
         2 * (size_t)w * (sizeof(float) + sizeof(int));
}

template <typename Tin, int MT>
__global__ void __launch_bounds__(kPairThreads)
ctx_mix_fwd_pairs_any(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                      const float* __restrict__ fm_ext,  // [B, T+2w]
                      const float* __restrict__ rm_ext,  // [B, T+2w, R] / null
                      Tin* __restrict__ alpha,           // [B, T, 2w, R, R]
                      int T, int R, int E, int w, float temp) {
  constexpr int RP = 16 * MT;                    // R padded
  constexpr int ld = stage_ld<Tin>(kPairK);
  constexpr int kStage = 2 * RP * ld;            // C's rows, then N's
  constexpr int lds = RP + 1;                    // score rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* stages = reinterpret_cast<Tin*>(smem_raw);    // [kPairStages][kStage]
  float* S = reinterpret_cast<float*>(stages + kPairStages * kStage);
  float* live_c = S + RP * lds;                  // region masks of c and n
  float* live_n = live_c + RP;

  let_mix_launch();
  const int t = (int)blockIdx.x - w;             // < 0: a left halo frame
  const int b = blockIdx.z;
  const int t_ext = T + 2 * w;
  const int c = t + w;                           // extended frames
  const size_t frame = (size_t)R * E;
  const int rr = R * R;
  const size_t pairs_t = 2 * (size_t)w * rr;     // alpha of one centre frame
  const float* fm = fm_ext + (size_t)b * t_ext;
  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  const int nk = (E + kPairK - 1) / kPairK;
  const int warp = threadIdx.x >> 5;
  const int o = 1 + blockIdx.y;
  const int n = c + o;
  Tin* a_fw = t >= 0
      ? alpha + ((size_t)b * T + t) * pairs_t + (size_t)(o + w - 1) * rr
      : nullptr;
  Tin* a_bw = t + o >= 0 && t + o < T
      ? alpha + ((size_t)b * T + t + o) * pairs_t + (size_t)(w - o) * rr
      : nullptr;
  if (a_fw == nullptr && a_bw == nullptr) return;  // two halo frames
  const float nv = fm[n] * fm[c];                // the same both ways
  if (nv == 0.f) {                               // dead pair: alpha is zero
    for (int i = threadIdx.x; i < rr; i += blockDim.x) {
      if (a_fw) store_as(a_fw + i, 0.f);
      if (a_bw) store_as(a_bw + i, 0.f);
    }
    return;
  }
  const Tin* C = vb + (size_t)c * frame;
  const Tin* N = vb + (size_t)n * frame;
  auto stage = [&](int ks) {                     // one group a stage
    if (ks < nk) {
      Tin* d = stages + (ks % kPairStages) * kStage;
      stage_tile_any(d, C, RP, R, E, ks * kPairK, kPairK, ld);
      stage_tile_any(d + RP * ld, N, RP, R, E, ks * kPairK, kPairK, ld);
    }
    cp_async_commit();
  };
  for (int ks = 0; ks < kPairStages - 1; ++ks)
    stage(ks);                                   // in flight with the masks
  for (int i = threadIdx.x; i < 2 * RP; i += blockDim.x) {
    const int r = i % RP, f = i < RP ? c : n;
    live_c[i] = r >= R ? 0.f
        : rm_ext ? rm_ext[((size_t)b * t_ext + f) * R + r] : 1.f;
  }

  // thread (ty, tx): rows ty + 16 i, columns tx + 16 j (i, j < MT), on
  // CUDA cores in both dtypes (bf16 x bf16 products are exact in f32)
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait(kPairStages - 2);              // stage ks; later ones fly
    __syncthreads();                             // ... for all; ks - 1 read
    stage(ks + kPairStages - 1);                 // into the slot of ks - 1
    const Tin* Cs = stages + (ks % kPairStages) * kStage;
    const Tin* Ns = Cs + RP * ld;
#pragma unroll 4
    for (int q = 0; q < kPairK / 4; ++q) {
      float4 y[MT];
#pragma unroll
      for (int j = 0; j < MT; ++j) y[j] = lds4(Ns + (tx + 16 * j) * ld, q);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (ty + 16 * i >= R) continue;          // padding rows: warp-uniform
        const float4 x = lds4(Cs + (ty + 16 * i) * ld, q);
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
          acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
          acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
      S[(ty + 16 * i) * lds + tx + 16 * j] = acc[i][j];
  __syncthreads();
  // the values the mix multiplies by, in v's dtype: rows over s for
  // (t, +o), columns over r for (t + o, -o)
  constexpr int kPer = (RP + 31) / 32;
  if (a_fw)
    for (int r = warp; r < R; r += kPairThreads / 32)
      warp_softmax<kPer>(
          R,
          [&](int s) {
            return live_n[s] > 0.f ? S[r * lds + s] / temp : kNeg;
          },
          [&](int s, float p) { store_as(a_fw + r * R + s, p * nv); });
  if (a_bw)
    for (int s = warp; s < R; s += kPairThreads / 32)
      warp_softmax<kPer>(
          R,
          [&](int r) {
            return live_c[r] > 0.f ? S[r * lds + s] / temp : kNeg;
          },
          [&](int r, float p) { store_as(a_bw + s * R + r, p * nv); });
}

template <typename Tin, int MT>
__global__ void __launch_bounds__(kPairThreads)
ctx_mix_fwd_mix_any(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                    const float* __restrict__ fm_ext,  // [B, T+2w]
                    const Tin* __restrict__ alpha,     // [B, T, 2w, R, R]
                    float* __restrict__ u,             // [B, T, R, E]
                    int T, int R, int E, int w) {
  constexpr bool kBf16 = sizeof(Tin) == 2;
  constexpr int RP = 16 * MT;
  constexpr int lda = stage_ld<Tin>(RP);         // alpha_o [RP][lda]
  constexpr int ldy = stage_ld<Tin>(kMixCols);   // the slice [RP][ldy]
  constexpr int kSlot = RP * lda + RP * ldy;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(kMixSlots == 3, "steps j + 1 and j + 2 in flight");
  Tin* slots = reinterpret_cast<Tin*>(smem_raw);    // [kMixSlots][kSlot]
  float* nvs = reinterpret_cast<float*>(slots + kMixSlots * kSlot);  // [2w]
  int* offs = reinterpret_cast<int*>(nvs + 2 * w);             // [2w]
  __shared__ float cnt_s;
  __shared__ int steps_s;

  const int slices = (E + kMixCols - 1) / kMixCols;
  const int e0 = (int)(blockIdx.x % slices) * kMixCols;
  const int t = (int)(blockIdx.x / slices);
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const int c = t + w;
  const size_t frame = (size_t)R * E;
  const int rr = R * R;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const Tin* ab = alpha + ((size_t)b * T + t) * 2 * w * rr;

  // the live offsets in order, and sum_o nv_o in offset order
  for (int i = threadIdx.x; i < 2 * w; i += blockDim.x)
    nvs[i] = fm[c + offset_of(i, w)] * fm[c];
  __syncthreads();
  if (threadIdx.x == 0) {
    float cnt = 0.f;
    int k = 0;
    for (int i = 0; i < 2 * w; ++i) {
      cnt += nvs[i];
      if (nvs[i] != 0.f) offs[k++] = i;
    }
    cnt_s = cnt;
    steps_s = k;
  }
  __syncthreads();
  const int steps = steps_s;
  auto stage_y = [&](int j) {                    // v does not need the pairs
    if (j < steps)
      stage_tile_any(
          slots + (j % kMixSlots) * kSlot + RP * lda,
          v_ext + ((size_t)b * t_ext + c + offset_of(offs[j], w)) * frame, RP,
          R, E, e0, kMixCols, ldy);
  };
  auto stage_a = [&](int j) {                    // alpha does
    if (j < steps)
      stage_tile_any(slots + (j % kMixSlots) * kSlot,
                     ab + (size_t)offs[j] * rr, RP, R, R, 0, RP, lda);
  };

  // steps 0 and 1 in four groups (y0, y1, a0, a1), then one a step; each
  // step's group lands while the two before it are summed
  stage_y(0);
  cp_async_commit();
  stage_y(1);
  cp_async_commit();
  wait_for_pairs();
  stage_a(0);
  cp_async_commit();
  stage_a(1);
  cp_async_commit();
  const float den = fmaxf(cnt_s, 1.f);
  float* ub = u + ((size_t)b * T + t) * frame;

  if constexpr (kBf16) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int n0 = warp * 16;                    // this warp's columns
    float acc[MT][2][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
    for (int j = 0; j < steps; ++j) {
      cp_async_wait(1);              // step j's groups; j + 1's may fly
      __syncthreads();               // ... for every thread; j - 1 is read
      stage_y(j + 2);                // into the slot of step j - 1
      stage_a(j + 2);
      cp_async_commit();
      const __nv_bfloat16* A = slots + (j % kMixSlots) * kSlot;
      const __nv_bfloat16* Y = A + RP * lda;
      if (e0 + n0 < E) {             // warp-uniform
#pragma unroll
        for (int k = 0; k < RP; k += 16) {
          uint32_t y[4];             // B fragments of two n8 tiles
          frag_b2_trans(y, Y, ldy, k, n0);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            if (mi * 16 >= R) continue;          // block-uniform
            uint32_t x[4];
            frag_a(x, A, lda, mi * 16, k);
            mma_bf16(acc[mi][0], x, y[0], y[1]);
            mma_bf16(acc[mi][1], x, y[2], y[3]);
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
          const int row = mi * 16 + g + (z >> 1) * 8;
          const int col = e0 + n0 + ni * 8 + 2 * tig + (z & 1);
          if (row < R && col < E)
            ub[(size_t)row * E + col] = acc[mi][ni][z] / den;
        }
  } else {
    // warp w: columns 32 (w % 4).. of the slice and, of the 2 MT groups of
    // 8 rows, groups w / 4, w / 4 + 2, ...; lane (rg, cg): rows rg + 8 k of
    // those groups k, columns 8 cg.. (two float4). Four source rows a step:
    // a 16-byte read of alpha a row (eight rows a warp, distinct banks: lda
    // / 4 is odd) and two of each source row (four distinct a warp) feed 32
    // FMAs a row
    constexpr int KR = MT;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rg = lane >> 2, q0 = (warp & 3) * 8 + 2 * (lane & 3);
    const int k0 = warp >> 2;                    // row groups k0 + 2 k
    float acc[KR][8];
#pragma unroll
    for (int k = 0; k < KR; ++k)
#pragma unroll
      for (int z = 0; z < 8; ++z) acc[k][z] = 0.f;
    for (int j = 0; j < steps; ++j) {
      cp_async_wait(1);
      __syncthreads();
      stage_y(j + 2);
      stage_a(j + 2);
      cp_async_commit();
      const float* A = slots + (j % kMixSlots) * kSlot;
      const float* Y = A + RP * lda;
      if (e0 + 32 * (warp & 3) >= E) continue;   // warp-uniform
      for (int s = 0; s < R; s += 4) {           // rows past R are zeros
        float4 y[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          y[q][0] = lds4(Y + (s + q) * ldy, q0);
          y[q][1] = lds4(Y + (s + q) * ldy, q0 + 1);
        }
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          if (8 * (k0 + 2 * k) >= R) continue;   // padding rows: uniform
          const float4 x = lds4(A + (rg + 8 * (k0 + 2 * k)) * lda, s / 4);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[k][0] = fmaf(xs[q], y[q][0].x, acc[k][0]);
            acc[k][1] = fmaf(xs[q], y[q][0].y, acc[k][1]);
            acc[k][2] = fmaf(xs[q], y[q][0].z, acc[k][2]);
            acc[k][3] = fmaf(xs[q], y[q][0].w, acc[k][3]);
            acc[k][4] = fmaf(xs[q], y[q][1].x, acc[k][4]);
            acc[k][5] = fmaf(xs[q], y[q][1].y, acc[k][5]);
            acc[k][6] = fmaf(xs[q], y[q][1].z, acc[k][6]);
            acc[k][7] = fmaf(xs[q], y[q][1].w, acc[k][7]);
          }
        }
      }
    }
    const int col = e0 + 4 * q0;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int r = rg + 8 * (k0 + 2 * k);
      if (r >= R) continue;
      float* o = ub + (size_t)r * E + col;
      if (E % 4 == 0 && col + 8 <= E) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[k][0] / den, acc[k][1] / den, acc[k][2] / den,
                        acc[k][3] / den);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(acc[k][4] / den, acc[k][5] / den, acc[k][6] / den,
                        acc[k][7] / den);
      } else {
#pragma unroll
        for (int z = 0; z < 8; ++z)
          if (col + z < E) o[z] = acc[k][z] / den;
      }
    }
  }
}

// Past kTileRows regions: the wide kernels.
template <typename Tin>
__global__ void __launch_bounds__(kAnyThreads)
ctx_mix_fwd_pairs_wide(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                       const float* __restrict__ fm_ext,  // [B, T+2w]
                       const float* __restrict__ rm_ext,  // [B, T+2w, R] / null
                       Tin* __restrict__ alpha,           // [B, T, 2w, R, R]
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
  const float nv = fm[n] * fm[c];
  Tin* a = alpha + (((size_t)b * T + t) * 2 * w + oi) * R * R;
  const int r0 = rt * kAnyRows;
  if (nv == 0.f) {                               // dead pair: alpha is zero
    const size_t hi = (size_t)min(R, r0 + kAnyRows) * R;
    for (size_t i = (size_t)r0 * R + threadIdx.x; i < hi; i += blockDim.x)
      store_as(a + i, 0.f);
    return;
  }
  const Tin* vb = v_ext + (size_t)b * t_ext * frame;
  const float* rm = rm_ext ? rm_ext + ((size_t)b * t_ext + n) * R : nullptr;
  any_row_softmax(
      vb + c * frame, vb + n * frame, R, E, r0, temp,
      [&](int s) { return rm == nullptr || rm[s] > 0.f; }, sm,
      [&](int r, int s, float p) { store_as(a + (size_t)r * R + s, p * nv); });
}

template <typename Tin>
__global__ void __launch_bounds__(kAnyThreads)
ctx_mix_fwd_mix_wide(const Tin* __restrict__ v_ext,     // [B, T+2w, R, E]
                     const float* __restrict__ fm_ext,  // [B, T+2w]
                     const Tin* __restrict__ alpha,     // [B, T, 2w, R, R]
                     float* __restrict__ u,             // [B, T, R, E]
                     int T, int R, int E, int w) {
  __shared__ __align__(16) float A[kAnyRows * kAnyMatLd];  // [r][s] of alpha
  __shared__ __align__(16) float Y[kAnyRows * kAnyCols];   // [s][e] of v_n
  const int tiles = (R + kAnyRows - 1) / kAnyRows;
  const int slices = (E + kAnyCols - 1) / kAnyCols;
  const int e0 = (int)(blockIdx.x % slices) * kAnyCols;
  const int rest = (int)(blockIdx.x / slices);
  const int r0 = (rest % tiles) * kAnyRows;
  const int t = rest / tiles;
  const int b = blockIdx.y;
  const int t_ext = T + 2 * w;
  const int c = t + w;
  const size_t frame = (size_t)R * E;
  const float* fm = fm_ext + (size_t)b * t_ext;
  const int tx = threadIdx.x % kAnyCols;         // this thread's column
  const int ty = threadIdx.x / kAnyCols;         // ... and rows 8 ty + k

  float cnt = 0.f;
  for (int i = 0; i < 2 * w; ++i) cnt += fm[c + offset_of(i, w)] * fm[c];
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int i = 0; i < 2 * w; ++i) {
    const int n = c + offset_of(i, w);
    if (fm[n] * fm[c] == 0.f) continue;          // block-uniform
    const Tin* a = alpha + (((size_t)b * T + t) * 2 * w + i) * R * R;
    const Tin* y = v_ext + ((size_t)b * t_ext + n) * frame;
    for (int k0 = 0; k0 < R; k0 += kAnyRows) {
      __syncthreads();                           // the last tiles are read
      for (int j = threadIdx.x; j < kAnyRows * kAnyRows; j += blockDim.x) {
        const int r = j / kAnyRows, s = j - r * kAnyRows;
        A[r * kAnyMatLd + s] = r0 + r < R && k0 + s < R
            ? load1(a + (size_t)(r0 + r) * R + k0 + s) : 0.f;
      }
      for (int j = threadIdx.x; j < kAnyRows * kAnyCols; j += blockDim.x) {
        const int s = j / kAnyCols, col = j - s * kAnyCols;
        Y[j] = k0 + s < R && e0 + col < E
            ? load1(y + (size_t)(k0 + s) * E + e0 + col) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int s = 0; s < kAnyRows; s += 4) {
        const float y0 = Y[s * kAnyCols + tx], y1 = Y[(s + 1) * kAnyCols + tx];
        const float y2 = Y[(s + 2) * kAnyCols + tx];
        const float y3 = Y[(s + 3) * kAnyCols + tx];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 x = *reinterpret_cast<const float4*>(
              A + (8 * ty + k) * kAnyMatLd + s);
          acc[k] = fmaf(x.x, y0, acc[k]);
          acc[k] = fmaf(x.y, y1, acc[k]);
          acc[k] = fmaf(x.z, y2, acc[k]);
          acc[k] = fmaf(x.w, y3, acc[k]);
        }
      }
    }
  }

  const float den = fmaxf(cnt, 1.f);
  float* ub = u + ((size_t)b * T + t) * frame;
  if (e0 + tx < E) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = r0 + 8 * ty + k;
      if (r < R) ub[(size_t)r * E + e0 + tx] = acc[k] / den;
    }
  }
}

// Whether the specialised kernels above take this shape; the general
// variant takes every other.
bool in_envelope(int R, int E, int w) {
  return R <= 32 && E % 4 == 0 && E >= 4 && E <= kMaxThreads && w <= 16;
}

template <typename Tin, int MT>
int run_tiles(const void* v_ext, const float* fm_ext, const float* rm_ext,
              float* u, void* alpha, int B, int T, int R, int E, int w,
              float temp, cudaStream_t stream) {
  const size_t mix_x = (size_t)T * ((E + kMixCols - 1) / kMixCols);
  if ((size_t)T + w > 0x7fffffff || mix_x > 0x7fffffff)  // the grids' x
    return (int)cudaErrorInvalidValue;
  const int err = launch_dyn(
      ctx_mix_fwd_pairs_any<Tin, MT>, dim3(T + w, w, B), kPairThreads,
      pairs_any_smem<Tin>(16 * MT), stream, false,
      static_cast<const Tin*>(v_ext), fm_ext, rm_ext, static_cast<Tin*>(alpha),
      T, R, E, w, temp);
  if (err != 0) return err;
  return launch_dyn(ctx_mix_fwd_mix_any<Tin, MT>, dim3((unsigned)mix_x, B),
                    kPairThreads, mix_any_smem<Tin>(16 * MT, w), stream, true,
                    static_cast<const Tin*>(v_ext), fm_ext,
                    static_cast<const Tin*>(alpha), u, T, R, E, w);
}

template <typename Tin>
int run_wide(const void* v_ext, const float* fm_ext, const float* rm_ext,
             float* u, void* alpha, int B, int T, int R, int E, int w,
             float temp, cudaStream_t stream) {
  const size_t tiles = (R + kAnyRows - 1) / kAnyRows;
  const size_t slices = (E + kAnyCols - 1) / kAnyCols;
  const size_t pairs_x = (size_t)T * 2 * w * tiles;
  const size_t mix_x = (size_t)T * tiles * slices;
  if (pairs_x > 0x7fffffff || mix_x > 0x7fffffff)   // the grid's x limit
    return (int)cudaErrorInvalidValue;
  ctx_mix_fwd_pairs_wide<Tin><<<dim3((unsigned)pairs_x, B), kAnyThreads, 0,
                                stream>>>(
      static_cast<const Tin*>(v_ext), fm_ext, rm_ext, static_cast<Tin*>(alpha),
      T, R, E, w, temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctx_mix_fwd_mix_wide<Tin><<<dim3((unsigned)mix_x, B), kAnyThreads, 0,
                              stream>>>(
      static_cast<const Tin*>(v_ext), fm_ext, static_cast<const Tin*>(alpha),
      u, T, R, E, w);
  return (int)cudaGetLastError();
}

template <typename Tin>
int run_any(const void* v_ext, const float* fm_ext, const float* rm_ext,
            float* u, void* alpha, int B, int T, int R, int E, int w,
            float temp, cudaStream_t stream) {
  static_assert(kTileRows == 4 * 16, "MT <= 4 below");
  if (R > kTileRows || 2 * w > kTileOffsets)
    return run_wide<Tin>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp,
                         stream);
  switch ((R + 15) / 16) {       // MT: R padded to 16 MT rows
    case 1: return run_tiles<Tin, 1>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R,
                                     E, w, temp, stream);
    case 2: return run_tiles<Tin, 2>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R,
                                     E, w, temp, stream);
    case 3: return run_tiles<Tin, 3>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R,
                                     E, w, temp, stream);
    default: return run_tiles<Tin, 4>(v_ext, fm_ext, rm_ext, u, alpha, B, T,
                                      R, E, w, temp, stream);
  }
}

template <typename Tin>
int run(const void* v_ext, const float* fm_ext, const float* rm_ext,
        float* u, void* alpha, int B, int T, int R, int E, int w, float temp,
        cudaStream_t stream) {
  if (!in_envelope(R, E, w))
    return run_any<Tin>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp,
                        stream);
  const size_t smem = pairs_smem<Tin>(R, E);
  const int err = launch_dyn(
      ctx_mix_fwd_pairs<Tin>, dim3(T + w, w, B), kPairThreads, smem, stream,
      false, static_cast<const Tin*>(v_ext), fm_ext, rm_ext,
      static_cast<Tin*>(alpha), T, R, E, w, temp);
  if (err != 0) return err;
  if constexpr (sizeof(Tin) == 2) {
    return launch_dyn(ctx_mix_fwd_mix_mma, dim3(T, B), mix_threads_bf16(E),
                      mix_smem_bf16(E), stream, true,
                      static_cast<const __nv_bfloat16*>(v_ext), fm_ext,
                      static_cast<const __nv_bfloat16*>(alpha), u, T, R, E, w);
  } else {
    return launch_mix_f32(static_cast<const float*>(v_ext), fm_ext,
                          static_cast<const float*>(alpha), u, B, T, R, E, w,
                          stream);
  }
}

}  // namespace

extern "C" {

// Launches the two kernels on `stream` and returns the cudaError_t of the
// launches (0 = ok). v_ext is float* when v_is_bf16 == 0, __nv_bfloat16*
// otherwise; rm_ext may be null; alpha, of v_ext's type and shape
// [B, T, 2w, R, R], is written whole: the residual for K1fr, a scratch for
// K1f. All tensors are contiguous; v_ext is 16-byte aligned. Shapes with
// R <= 32, E a multiple of 4 in [4, 512] and w <= 16 take the kernels
// above, every other the general variant. Limits: B <= 65535 (the grids'
// z or y), and, in the general variant, T + w and T ceil(E/128) below 2^31
// up to R = 64 and w = 512, T 2w ceil(R/32) and T ceil(R/32) ceil(E/64)
// past them (the grids' x); R, E, w, T >= 1.
int nafae_ctx_mix_fwd(const void* v_ext, int v_is_bf16, const float* fm_ext,
                      const float* rm_ext, float* u, void* alpha, int B,
                      int T, int R, int E, int w, float temp, void* stream) {
  if (R < 1 || E < 1 || w < 1 || B < 0 || B > 65535 || T < 0 ||
      alpha == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_is_bf16
      ? run<__nv_bfloat16>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w,
                           temp, s)
      : run<float>(v_ext, fm_ext, rm_ext, u, alpha, B, T, R, E, w, temp, s);
}

}  // extern "C"
