// Diagonal epilogue of the config-4 training step, forward: the context-loss
// partial sums, the top-region selection and the cluster distances, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nafae_tpu/ops/pallas/fused_diag.py::_fwd_kernel
// (K4f, via _diag_core_fwd). Same function as the port's plain version,
// nafae_torch/ops/kernels/diag.py::diag_fwd_plain. Per video b, word k,
// frame t:
//
//   s[r]  = w[k] . v[t, r],   sh[r] = w[k] . u[t, r]     (u: stop-gradient)
//   live  = rm[t, r] > 0;     m[r] = live && fm[t] > 0 && hc[t] > 0
//   ctx   = sum_r m ? (s - sh)^2 : 0     (each term rounded to bf16 in bf16
//                                          mode, as fused_ctx.py::_sel_dot)
//   r*    = first argmax_r of (live ? s : -1e9)  (frame validity ignored; an
//           all-masked frame picks region 0)
//   f     = v[t, r*]                                     (exact, f32)
//   c*    = first argmax_c of f . ch[c],  ch[c] = C[c] / sqrt(|C[c]|^2 + 1e-8)
//           (ch rounded to bf16 in bf16 mode)
//   clu   = |f - C[c*]|^2     (C[c*] rounded to bf16 in bf16 mode)
//
// Outputs ctx, clu [B, K, T] f32 and f [B, T, K, E] f32, and the residuals
// that the backward (diag_epilogue_bwd.cu) reads instead of re-running this
// kernel: d = m ? s - sh : 0 [B, K, T, R] f32, r* and c* [B, K, T] int32.
//
// Design: two kernels, one call.
//
//   centers  normalises the centers once a call: one warp per center writes
//            ch [Kc, E] in the compute dtype (a scratch the wrapper
//            allocates), rounded where the reference rounds it.
//   main     one block per 3 frames (one block an SM: 107 blocks at config4,
//            where 320 frames on 132 SMs give no SM fewer than 3 anyway),
//            3 workers of 4 warps, one frame a worker; launched as a
//            programmatic dependent of the centers kernel, it waits for it
//            only before its first read of ch.
//            (a) Scores, per worker: the pass's 8 words (4 at E > 256) sit
//                in every lane's registers, a strided quarter of each row;
//                each warp takes one region at a time with the next one's
//                v and u rows in flight, forms the 2 x 8 dots s and sh by
//                FFMA and adds the partial sums across the warp in one
//                transposed butterfly (16 shuffles). Regions come 32 at a
//                time; a warp per word takes the ctx terms by a fixed-order
//                butterfly and r* by a (value, index) butterfly that keeps
//                the lower index on equal values.
//            (b) Centers: f = v[t, r*] goes to shared memory (and to f);
//                the 3 workers share a ring of chunks of ch copied by
//                cp.async (f32: 4 slots of 20 centers; bf16: 3 of 32; all
//                of config4's 67 are in flight at once). f32: each warp takes
//                the centers j = warp (mod 4) with the pass's f in
//                registers, 8 FFMA dots and one transposed butterfly a
//                center. bf16: mma.sync m16n8k16 on the tensor cores, the
//                words as A (8 rows of zeros below), a warp an n8 tile of
//                centers, f32 accumulators; f is a row of v, exact in bf16.
//                Each lane keeps a running first maximum, the 4 warps'
//                maxima meet in shared memory (the lower index on equal
//                values), and a warp per word sums |f - C[c*]|^2.
//            Every FFMA is full f32 (no TF32: the port holds f32 to the
//            reference's HIGHEST precision). Every output has one writer and
//            one order of sums, so two launches give the same bits.
//
// Any R, any Kc and 1 <= K <= 32 fit: regions come 32 at a time, words 8
// (4) at a time, centers a ring slot at a time; shared memory grows with K
// and E only (213 KB at most, bf16 at K = 32, E = 256). Every other shape
// (K > 32: long descriptions; E not a multiple of 4: GloVe-50d's E = 50;
// E > 512) takes a general variant after the centers kernel, diag_fwd_any
// below: a block a frame, the words 32 at a time and E in slices through
// shared memory, so it takes any K, E, R and Kc. It is a first, simple
// kernel; at R = 36, E = 1024 (K = 8) its bound is ~0.031 ms f32 and ~0.017
// ms bf16, both bytes (v, u and f).
//
// Bound on an H100 SXM (config4 training shapes B=16, K=8, T=20, R=20,
// E=256, Kc=67, f32): 2*2*B*K*T*R*E + 2*B*K*T*Kc*E = 140 MFLOP (~2.1 us at
// 67 TFLOP/s) against ~15.8 MB moved (v and u 6.6 MB each, f 1.3 MB, the
// residuals, w, centers, masks), ~4.7 us at 3.35 TB/s: bound by bytes. In
// bf16, v and u are half the bytes: ~2.7 us. These count every region as
// live and the residuals as needed; the function needs only ctx, clu and f
// written, v at live regions (region 0 of an all-masked frame) and u at the
// ctx mask, so chip_smoke.py counts the bound from a batch's masks, without
// the residuals. What is left above the bound: the two launches, and on
// each SM three frames' dots with 12 warps to hide the latency of the
// dependent butterflies and loads (the 8 x 67 sims of a frame are most of
// the f32 work). PERF.md has the measured times.

#include "ctx_mix_common.cuh"

namespace {

using namespace nafae_ctx;

constexpr int kFrames = 3;      // frames a main block: one a worker
constexpr int kWorker = 128;    // threads of a worker: 4 warps
constexpr int kThreads = kFrames * kWorker;   // a main block, one an SM
constexpr int kWarps = kWorker / 32;          // warps of a worker
constexpr int kCenterThreads = 256;   // the centers kernel: a warp a center
constexpr int kRegions = 32;    // regions of a chunk: one lane each in the scan

// The ring of ch chunks in shared memory. f32: 20 centers a slot, rows of
// E padded to 128, 4 slots. bf16 (tensor cores): 32 centers a slot (one n8
// tile a warp), rows of E padded to 16 and 8 more (no bank conflicts in the
// fragment loads), 3 slots. Either way config4's 67 centers are in flight
// at once.
template <typename Tin>
struct RingOf {
  static constexpr int rows = 20, slots = 4;
};
template <>
struct RingOf<__nv_bfloat16> {
  static constexpr int rows = 32, slots = 3;
};

__host__ __device__ __forceinline__ int padded16(int E) {
  return (E + 15) & ~15;
}

// Elements of a row of the ring (and of the bf16 rows of f): f32 rows are
// padded with zeros to whole 128-column steps of the lanes' quads, so the
// sims read every quad unguarded.
template <typename Tin>
__host__ __device__ __forceinline__ int ring_ld(int E) {
  return sizeof(Tin) == 2 ? padded16(E) + 8 : (E + 127) & ~127;
}

// Words of a pass: their rows of w (then of f) sit in each lane's registers,
// NQ 16-byte quads a word.
template <int NQ>
__host__ __device__ constexpr int words_of() {
  return NQ <= 2 ? 8 : 4;
}

// Programmatic dependent launch (Hopper): the main kernel's blocks run their
// score phase while the centers kernel still runs, and wait for its grid
// (complete, its writes visible) before reading ch; a no-op in a launch
// without the attribute.
__device__ __forceinline__ void wait_for_centers() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_main_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The sums over the warp's 32 lanes of N values a lane (N a power of 2, at
// most 32) in log2(N) exchanges of halves (lane bits 4, 3, ...) plus
// 5 - log2(N) butterfly steps: N - 1 + 5 - log2(N) shuffles in all. Lane L
// returns the total of value L >> (5 - log2 N); the lanes that share it
// hold the same bits. One fixed order of sums.
template <int N, int O = 16>
__device__ __forceinline__ float transpose_sum(const float (&x)[N]) {
  if constexpr (N == 1) {
    float y = x[0];
#pragma unroll
    for (int o = O; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
    return y;
  } else {
    constexpr int H = N / 2;
    const bool up = threadIdx.x & O;
    float z[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? x[i] : x[i + H];
      const float keep = up ? x[i + H] : x[i];
      z[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return transpose_sum<H, O / 2>(z);
  }
}

// (val, idx) <- the larger of its own and lane ^ o's, the lower index on
// equal values: a butterfly of these is the warp's first maximum.
__device__ __forceinline__ void max_first(float& val, int& idx, int o) {
  const float ov = __shfl_xor_sync(0xffffffffu, val, o);
  const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
  if (ov > val || (ov == val && oi < idx)) {
    val = ov;
    idx = oi;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The lane's quads q = lane + 32 i (i < NQ) of a row of E/4 quads, as f32,
// zero beyond the row.
template <int NQ, typename Tin>
__device__ __forceinline__ void load_quads(float4 (&x)[NQ],
                                           const Tin* __restrict__ row,
                                           int e4) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int q = lane + 32 * i;
    x[i] = q < e4 ? load4(row, q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void wait_chunks() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier of one worker's 128 threads (named barrier 1 + worker; 0 is
// __syncthreads).
__device__ __forceinline__ void worker_sync(int worker) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(worker + 1), "r"(kWorker)
               : "memory");
}

// Floats of a worker's shared memory (see the main kernel's layout), a
// multiple of 4: every worker's f rows are 16-byte aligned.
__host__ __device__ __forceinline__ int worker_floats(int K, int E, int kw) {
  return (kw * E + 2 * kw * kRegions + 3 * K + 2 * kWarps * kw + kw + 3) &
         ~3;
}

// Bytes of a worker's shared memory: the floats, and in bf16 the pass's f
// as 16 bf16 rows (the A operand of the sims; rows kW.. zero).
template <typename Tin>
__host__ __device__ __forceinline__ int worker_bytes(int K, int E, int kw) {
  return worker_floats(K, E, kw) * 4 +
         (sizeof(Tin) == 2 ? 16 * ring_ld<Tin>(E) * 2 : 0);
}

// Bytes of the ring.
template <typename Tin>
__host__ __device__ __forceinline__ int ring_bytes(int E) {
  return RingOf<Tin>::slots * RingOf<Tin>::rows * ring_ld<Tin>(E) *
         (int)sizeof(Tin);
}

// Chunk i of ch (its rows of ch, zero beyond Kc and E) into ring slot
// i % slots by cp.async, 16-byte copies (8-byte for bf16 rows that are not
// 16-byte aligned); every thread commits one group, empty past the end.
template <typename Tin>
__device__ __forceinline__ void fetch_centers(Tin* __restrict__ ring,
                                              const Tin* __restrict__ chat,
                                              int i, int Kc, int E) {
  constexpr int rows = RingOf<Tin>::rows;
  const int ld = ring_ld<Tin>(E);
  const int kw = sizeof(Tin) == 2 ? padded16(E) : ld;
  const int c0 = i * rows;
  Tin* dst = ring + (size_t)(i % RingOf<Tin>::slots) * rows * ld;
  if (c0 < Kc) {
    if (sizeof(Tin) == 4 || E % 8 == 0)
      stage_tile_async<16 / sizeof(Tin)>(dst, chat + (size_t)c0 * E, rows,
                                         Kc - c0, E, 0, kw, ld);
    else
      stage_tile_async<4>(dst, chat + (size_t)c0 * E, rows, Kc - c0, E, 0,
                          kw, ld);
  }
  cp_async_commit();
}

// ch = C / sqrt(|C|^2 + 1e-8), one warp per center, in the compute dtype.
template <typename Tin>
__global__ void __launch_bounds__(kCenterThreads)
diag_centers_kernel(const float* __restrict__ centers,  // [Kc, E]
                    Tin* __restrict__ chat,             // [Kc, E]
                    int Kc, int E) {
  let_main_launch();
  const int c = blockIdx.x * (kCenterThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= Kc) return;
  const float* src = centers + (size_t)c * E;
  float ss = 0.f;
  for (int e = lane; e < E; e += 32) ss = fmaf(src[e], src[e], ss);
  const float inv = 1.f / sqrtf(warp_sum(ss) + 1e-8f);
  for (int e = lane; e < E; e += 32) store_as(chat + (size_t)c * E + e,
                                              src[e] * inv);
}

template <typename Tin, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
diag_fwd_kernel(const Tin* __restrict__ w,          // [B, K, E]
                const Tin* __restrict__ v,          // [B, T, R, E]
                const Tin* __restrict__ u,          // [B, T, R, E]
                const Tin* __restrict__ chat,       // [Kc, E] (centers kernel)
                const float* __restrict__ centers,  // [Kc, E]
                const float* __restrict__ fm,       // [B, T]
                const float* __restrict__ hc,       // [B, T]
                const float* __restrict__ rm,       // [B, T, R] or null
                float* __restrict__ ctx,            // [B, K, T]
                float* __restrict__ clu,            // [B, K, T]
                float* __restrict__ f,              // [B, T, K, E]
                float* __restrict__ dres,           // [B, K, T, R]
                int* __restrict__ rstar,            // [B, K, T]
                int* __restrict__ cstar,            // [B, K, T]
                int B, int K, int T, int R, int E, int Kc) {
  constexpr int kW = words_of<NQ>();
  constexpr int kShift = kW == 8 ? 1 : 2;   // of 2 kW values lane L has
                                            // value L >> kShift
  extern __shared__ __align__(16) float smem[];
  const int worker = threadIdx.x / kWorker;
  const int wt = threadIdx.x - worker * kWorker;   // thread of the worker
  constexpr int kRows = RingOf<Tin>::rows, kSlots = RingOf<Tin>::slots;
  constexpr bool kMma = sizeof(Tin) == 2;   // the sims on tensor cores
  const int ld = ring_ld<Tin>(E);
  Tin* ring = reinterpret_cast<Tin*>(smem);   // [kSlots][kRows][ld] ch
  float* fs = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem) + ring_bytes<Tin>(E) +
      worker * worker_bytes<Tin>(K, E, kW));
  //                                           [kW][E]            f of a pass
  float* sq = fs + kW * E;                  // [kW][kRegions]     ctx terms
  float* sc = sq + kW * kRegions;           // [kW][kRegions]     masked s
  float* acc = sc + kW * kRegions;          // [K]                ctx sums
  float* best = acc + K;                    // [K]                top masked s
  float* gbest = best + K;                  // [kWarps][kW]       top sims
  int* arg = reinterpret_cast<int*>(gbest + kWarps * kW);   // [K] r*
  int* garg = arg + K;                      // [kWarps][kW]       their c
  int* cs = garg + kWarps * kW;             // [kW]               c*
  __nv_bfloat16* fsh = reinterpret_cast<__nv_bfloat16*>(
      fs + worker_floats(K, E, kW));      // bf16: [16][ld]     f, as bf16

  const int frame = blockIdx.x * kFrames + worker;   // (b, t) of the worker
  const bool live = frame < B * T;
  const int b = live ? frame / T : 0;
  const int t = live ? frame - b * T : 0;
  const size_t bt = (size_t)b * T + t;
  const Tin* vt = v + bt * R * E;
  const Tin* ut = u + bt * R * E;
  const bool on = fm[bt] > 0.f && hc[bt] > 0.f;     // the ctx mask's frame part
  const int warp = wt >> 5;
  const int lane = wt & 31;
  const int e4 = E >> 2;

  if (live && wt < K) {
    acc[wt] = 0.f;
    best[wt] = -CUDART_INF_F;
    arg[wt] = 0;
  }
  if (kMma && live)                   // the padding rows and columns of f
    for (int p = wt; p < 16 * ld; p += kWorker)
      fsh[p] = __float2bfloat16_rn(0.f);

  // (a) s, sh, the ctx terms, the residual and the first-max region, kW
  // words a pass; each worker on its own frame
  for (int k0 = 0; live && k0 < K; k0 += kW) {
    float4 wq[kW][NQ];                // the pass's words, in every warp
#pragma unroll
    for (int kk = 0; kk < kW; ++kk) {
      const bool ok = k0 + kk < K;
      load_quads(wq[kk], w + ((size_t)b * K + (ok ? k0 + kk : 0)) * E,
                 ok ? e4 : 0);
    }
    for (int r0 = 0; r0 < R; r0 += kRegions) {
      const int rc = min(kRegions, R - r0);
      worker_sync(worker);            // sq and sc are free; acc set
      int j = warp;                   // regions j, j + 4, ..., one ahead
      float4 vq[NQ], uq[NQ];
      float lq = 0.f;                 // rm of the region
      if (j < rc) {
        load_quads(vq, vt + (size_t)(r0 + j) * E, e4);
        load_quads(uq, ut + (size_t)(r0 + j) * E, e4);
        lq = rm ? rm[bt * R + r0 + j] : 1.f;
      }
      for (; j < rc; j += kWarps) {
        const bool more = j + kWarps < rc;
        float4 vn[NQ], un[NQ];
        float ln = 0.f;
        if (more) {
          load_quads(vn, vt + (size_t)(r0 + j + kWarps) * E, e4);
          load_quads(un, ut + (size_t)(r0 + j + kWarps) * E, e4);
          ln = rm ? rm[bt * R + r0 + j + kWarps] : 1.f;
        }
        float x[2 * kW];              // s of the words, then their sh
#pragma unroll
        for (int kk = 0; kk < kW; ++kk) {
          float s = 0.f, sh = 0.f;
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            s = dot4(wq[kk][i], vq[i], s);
            sh = dot4(wq[kk][i], uq[i], sh);
          }
          x[kk] = s;
          x[kW + kk] = sh;
        }
        const float y = transpose_sum(x);    // lane L: value L >> kShift
        const float ysh = __shfl_down_sync(0xffffffffu, y, 16);
        const int kk = lane >> kShift;
        if (lane < 16 && !(lane & ((1 << kShift) - 1)) && k0 + kk < K) {
          const bool lv = lq > 0.f;
          const bool m = lv && on;
          const float diff = y - ysh;
          dres[(((size_t)b * K + k0 + kk) * T + t) * R + r0 + j] =
              m ? diff : 0.f;
          sq[kk * kRegions + j] = m ? as_operand(diff * diff, v) : 0.f;
          sc[kk * kRegions + j] = lv ? y : kNeg;
        }
        if (more) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            vq[i] = vn[i];
            uq[i] = un[i];
          }
          lq = ln;
        }
      }
      worker_sync(worker);
      for (int kk = warp; kk < kW && k0 + kk < K; kk += kWarps) {
        const int k = k0 + kk;        // the chunk's sum and first max
        float term = lane < rc ? sq[kk * kRegions + lane] : 0.f;
        float val = lane < rc ? sc[kk * kRegions + lane] : -CUDART_INF_F;
        int idx = lane;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          term += __shfl_xor_sync(0xffffffffu, term, o);
          max_first(val, idx, o);
        }
        if (lane == 0) {
          acc[k] += term;
          if (val > best[k]) {        // an earlier chunk keeps equal values
            best[k] = val;
            arg[k] = r0 + idx;
          }
        }
      }
    }
  }
  if (live) {
    worker_sync(worker);
    if (wt < K) {
      const size_t o = ((size_t)b * K + wt) * T + t;
      ctx[o] = acc[wt];
      rstar[o] = arg[wt];
    }
  }

  // (b) c* = first argmax of f . ch, then clu, kW words a pass; the
  // workers share each chunk of ch
  wait_for_centers();
  for (int k0 = 0; k0 < K; k0 += kW) {
    for (int kk = warp; live && kk < kW; kk += kWarps) {
      const int k = k0 + kk;          // f = v[t, r*]: shared memory and f
      for (int q = lane; q < e4; q += 32) {
        const float4 x = k < K ? load4(vt + (size_t)arg[k] * E, q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < K) {
          reinterpret_cast<float4*>(fs + kk * E)[q] = x;
          reinterpret_cast<float4*>(f + (bt * K + k) * E)[q] = x;
        }
        if (kMma) {                   // exact: x is a bf16 value
          __nv_bfloat162* h =
              reinterpret_cast<__nv_bfloat162*>(fsh + kk * ld + 4 * q);
          h[0] = __floats2bfloat162_rn(x.x, x.y);
          h[1] = __floats2bfloat162_rn(x.z, x.w);
        }
      }
    }
    const int chunks = (Kc + kRows - 1) / kRows;
    for (int i = 0; i < kSlots; ++i) fetch_centers(ring, chat, i, Kc, E);
    __syncthreads();
    float4 fq[kMma ? 1 : kW][NQ];     // f32: the pass's f, in every warp
#pragma unroll
    for (int kk = 0; kk < (kMma ? 0 : kW); ++kk)
      load_quads(fq[kk], fs + kk * E, live && k0 + kk < K ? e4 : 0);
    float top = -CUDART_INF_F;        // f32: word lane >> (kShift + 1)
    int top_c = 0;
    // the ring's slots hold consecutive rows of ch, so a group of kSlots
    // chunks is one block of rows: each warp walks its centers of the group
    // with no barrier between chunks (one group at config4)
    for (int g0 = 0; g0 < chunks; g0 += kSlots) {
      wait_chunks<0>();
      __syncthreads();
      const int cc = min(kSlots * kRows, Kc - g0 * kRows);   // its centers
      if constexpr (kMma) {
        // one n8 tile of centers at a time a warp, mma.sync m16n8k16 over
        // E: lane (g, tig) gets word g's sims with centers n0 + 2 tig, + 1
        const int g = lane >> 2, tig = lane & 3;
        for (int n0 = 8 * warp; live && n0 < cc; n0 += 8 * kWarps) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < padded16(E); k += 16) {
            uint32_t a[4];
            frag_a(a, fsh, ld, 0, k);
            const __nv_bfloat16* q = ring + (n0 + g) * ld + k + 2 * tig;
            mma_bf16(d, a, lds32(q), lds32(q + 8));
          }
          const int c = n0 + 2 * tig;  // in order: the first max
          if (c < cc && d[0] > top) {
            top = d[0];
            top_c = g0 * kRows + c;
          }
          if (c + 1 < cc && d[1] > top) {
            top = d[1];
            top_c = g0 * kRows + c + 1;
          }
        }
      } else {
        for (int j = warp; live && j < cc; j += kWarps) {   // in order
          float x[kW];
#pragma unroll
          for (int kk = 0; kk < kW; ++kk) x[kk] = 0.f;
#pragma unroll
          for (int n = 0; n < NQ; ++n) {   // zero past E in fq and the ring
            const float4 c4 = lds4(ring + j * ld, lane + 32 * n);
#pragma unroll
            for (int kk = 0; kk < kW; ++kk)
              x[kk] = dot4(fq[kk][n], c4, x[kk]);
          }
          const float y = transpose_sum(x);
          if (y > top) {              // the first max of the warp's centers
            top = y;
            top_c = g0 * kRows + j;
          }
        }
      }
      __syncthreads();                // the ring is read
      for (int i = 0; i < kSlots; ++i)
        fetch_centers(ring, chat, g0 + kSlots + i, Kc, E);
    }
    if (kMma) {                       // the 4 lanes of a word: first max
      max_first(top, top_c, 1);
      max_first(top, top_c, 2);
    }
    if (live) {
      const int word = kMma ? lane >> 2 : lane >> (kShift + 1);
      if (kMma ? !(lane & 3) && word < kW : !(lane & ((2 << kShift) - 1))) {
        gbest[warp * kW + word] = top;
        garg[warp * kW + word] = top_c;
      }
      worker_sync(worker);
      if (wt < kW) {                  // the warps' maxima, lower c on ties
        float val = gbest[wt];
        int idx = garg[wt];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) {
          const float gv = gbest[g * kW + wt];
          const int gi = garg[g * kW + wt];
          if (gv > val || (gv == val && gi < idx)) {
            val = gv;
            idx = gi;
          }
        }
        cs[wt] = idx;
      }
      worker_sync(worker);
    }
    for (int kk = warp; live && kk < kW && k0 + kk < K; kk += kWarps) {
      const int k = k0 + kk;          // clu = |f - C[c*]|^2, a warp a word
      const float* tgt = centers + (size_t)cs[kk] * E;
      float ss = 0.f;
      for (int q = lane; q < e4; q += 32) {
        const float4 x = lds4(fs + kk * E, q);
        const float4 y = load4(tgt, q);
        const float dx = x.x - as_operand(y.x, v);
        const float dy = x.y - as_operand(y.y, v);
        const float dz = x.z - as_operand(y.z, v);
        const float dw = x.w - as_operand(y.w, v);
        ss = fmaf(dx, dx, ss);
        ss = fmaf(dy, dy, ss);
        ss = fmaf(dz, dz, ss);
        ss = fmaf(dw, dw, ss);
      }
      ss = warp_sum(ss);
      if (lane == 0) {
        const size_t o = ((size_t)b * K + k) * T + t;
        clu[o] = ss;
        cstar[o] = cs[kk];
      }
    }
    __syncthreads();                  // fs, gbest and cs are read
  }
}

// An empty kernel: launched with a real kernel's grid, block and shared
// memory it reads the floor that any kernel of that shape pays.
__global__ void null_kernel() {}

// Dynamic shared memory of a main block, in bytes: 113,792 B in f32 and
// 107,904 B in bf16 at config4 (K = 8, E = 256); 193,072 B at most (f32,
// K = 32, E = 512).
template <typename Tin>
size_t smem_bytes(int K, int E) {
  const int kw = E <= 256 ? 8 : 4;           // words_of<NQ>()
  return (size_t)ring_bytes<Tin>(E) +
         (size_t)kFrames * worker_bytes<Tin>(K, E, kw);
}

dim3 main_grid(int B, int T) {
  return dim3((B * T + kFrames - 1) / kFrames);
}

// Sets a kernel's dynamic shared memory limit and launches it; `after`: as
// a programmatic dependent of the kernel launched before it on the stream.
template <typename... KArgs, typename... Args>
int launch_dyn(void (*kern)(KArgs...), dim3 grid, int threads, size_t smem,
               cudaStream_t stream, bool after, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
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

dim3 centers_grid(int Kc) {
  return dim3((Kc + kCenterThreads / 32 - 1) / (kCenterThreads / 32));
}

template <typename Tin, int NQ>
int launch_main(const void* w, const void* v, const void* u, const void* chat,
                const float* centers, const float* fm, const float* hc,
                const float* rm, float* ctx, float* clu, float* f, float* dres,
                int* rstar, int* cstar, int B, int K, int T, int R, int E,
                int Kc, cudaStream_t stream) {
  return launch_dyn(diag_fwd_kernel<Tin, NQ>, main_grid(B, T), kThreads,
                    smem_bytes<Tin>(K, E), stream, true,
                    static_cast<const Tin*>(w), static_cast<const Tin*>(v),
                    static_cast<const Tin*>(u),
                    static_cast<const Tin*>(chat), centers, fm, hc, rm, ctx,
                    clu, f, dres, rstar, cstar, B, K, T, R, E, Kc);
}

template <typename Tin>
int run(const void* w, const void* v, const void* u, const float* centers,
        void* chat, const float* fm, const float* hc, const float* rm,
        float* ctx, float* clu, float* f, float* dres, int* rstar, int* cstar,
        int B, int K, int T, int R, int E, int Kc, cudaStream_t stream) {
  const int err = launch_dyn(diag_centers_kernel<Tin>, centers_grid(Kc),
                             kCenterThreads, 0, stream, false, centers,
                             static_cast<Tin*>(chat), Kc, E);
  if (err != 0) return err;
  switch ((E + 127) / 128) {      // NQ: 16-byte quads a lane
    case 1:
      return launch_main<Tin, 1>(w, v, u, chat, centers, fm, hc, rm, ctx, clu,
                                 f, dres, rstar, cstar, B, K, T, R, E, Kc,
                                 stream);
    case 2:
      return launch_main<Tin, 2>(w, v, u, chat, centers, fm, hc, rm, ctx, clu,
                                 f, dres, rstar, cstar, B, K, T, R, E, Kc,
                                 stream);
    case 3:
      return launch_main<Tin, 3>(w, v, u, chat, centers, fm, hc, rm, ctx, clu,
                                 f, dres, rstar, cstar, B, K, T, R, E, Kc,
                                 stream);
    default:
      return launch_main<Tin, 4>(w, v, u, chat, centers, fm, hc, rm, ctx, clu,
                                 f, dres, rstar, cstar, B, K, T, R, E, Kc,
                                 stream);
  }
}

// ---------------------------------------------------------------------------
// The general variant (diag_fwd_any), for every shape outside the main
// kernel's envelope (in_envelope: K > 32, E not a multiple of 4, E > 512):
// one block of 256 threads a frame, launched after the centers kernel in
// stream order. Words come kGenWords at a time (warp j holds words j, j + 8,
// j + 16, j + 24 of the pass), regions and centers 32 at a time (one a
// lane), and E in slices of kGenCols columns staged as f32 in shared memory
// by scalar loads (zero past E and past the live rows: no row needs any
// alignment, and nothing grows with K, E, R or Kc).
//   (a) Each lane sums s and sh of its region for the warp's words over the
//       slices, every column in order, one fmaf each; the warp then writes
//       the residual d, adds the tile's ctx terms by a fixed butterfly and
//       takes its first maximum by the (value, index) butterfly, carried
//       over the tiles in registers (an earlier tile keeps equal values).
//   (b) f = v[t, r*] is copied whole to f; each lane sums the cosine sims of
//       its center with the words' f rows (staged from v) over the slices,
//       the same way, and the (value, index) butterfly keeps the first
//       maximum over each tile of 32 centers, carried over the tiles.
//   (c) clu: a warp a word, lanes over E, one butterfly.
// So equal rows of v (or of C) give equal scores (sims), and r* and c* are
// the first index; every output has one writer and one order of sums.
constexpr int kGenThreads = 256;
constexpr int kGenWarps = kGenThreads / 32;
constexpr int kGenWords = 32;           // words of a pass: 4 a warp
constexpr int kGenPer = kGenWords / kGenWarps;
constexpr int kGenRows = 32;            // regions or centers of a tile
constexpr int kGenCols = 64;            // columns of E a slice
constexpr int kGenLd = kGenCols + 4;    // staged rows: float4 reads

// Columns [e0, e0 + kGenCols) of `rows` rows (row(i): the i-th row's start)
// into shared rows of stride kGenLd as f32, zero past E and past `rows`.
template <typename RowOf>
__device__ __forceinline__ void gen_stage(float* __restrict__ dst, int rows,
                                          int E, int e0, RowOf row) {
  for (int p = threadIdx.x; p < kGenRows * kGenCols; p += blockDim.x) {
    const int i = p / kGenCols, c = p % kGenCols;
    const int e = e0 + c;
    dst[i * kGenLd + c] = i < rows && e < E ? load1(row(i) + e) : 0.f;
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kGenThreads)
diag_fwd_any(const Tin* __restrict__ w, const Tin* __restrict__ v,
             const Tin* __restrict__ u, const Tin* __restrict__ chat,
             const float* __restrict__ centers, const float* __restrict__ fm,
             const float* __restrict__ hc, const float* __restrict__ rm,
             float* __restrict__ ctx, float* __restrict__ clu,
             float* __restrict__ f, float* __restrict__ dres,
             int* __restrict__ rstar, int* __restrict__ cstar, int K, int T,
             int R, int E, int Kc) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // [kGenWords][kGenLd] words, then f
  float* ys = xs + kGenWords * kGenLd;   // [kGenRows][kGenLd] v, then ch
  float* zs = ys + kGenRows * kGenLd;    // [kGenRows][kGenLd] u
  int* rs = reinterpret_cast<int*>(zs + kGenRows * kGenLd);   // [32] r*

  const size_t bt = blockIdx.x;          // the frame (b, t)
  const int b = (int)(bt / T), t = (int)(bt - (size_t)b * T);
  const Tin* vt = v + bt * R * E;
  const Tin* ut = u + bt * R * E;
  const bool on = fm[bt] > 0.f && hc[bt] > 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int k0 = 0; k0 < K; k0 += kGenWords) {
    const int kw = min(kGenWords, K - k0);
    const int nw =                       // this warp's words of the pass
        min(kGenPer, max(0, (kw - warp + kGenWarps - 1) / kGenWarps));
    const Tin* wk = w + ((size_t)b * K + k0) * E;
    float acc[kGenPer], best[kGenPer];
    int arg[kGenPer];
#pragma unroll
    for (int i = 0; i < kGenPer; ++i) {
      acc[i] = 0.f;
      best[i] = -CUDART_INF_F;
      arg[i] = 0;
    }
    // (a) s, sh, the ctx terms, the residual and the first-max region
    for (int r0 = 0; r0 < R; r0 += kGenRows) {
      const int rc = min(kGenRows, R - r0);
      float s[kGenPer], sh[kGenPer];
#pragma unroll
      for (int i = 0; i < kGenPer; ++i) s[i] = sh[i] = 0.f;
      for (int e0 = 0; e0 < E; e0 += kGenCols) {
        __syncthreads();                 // the last slice is read
        gen_stage(xs, kw, E, e0, [&](int i) { return wk + (size_t)i * E; });
        gen_stage(ys, rc, E, e0,
                  [&](int i) { return vt + (size_t)(r0 + i) * E; });
        gen_stage(zs, rc, E, e0,
                  [&](int i) { return ut + (size_t)(r0 + i) * E; });
        __syncthreads();
        for (int q = 0; q < kGenCols / 4; ++q) {
          const float4 y = lds4(ys + lane * kGenLd, q);
          const float4 z = lds4(zs + lane * kGenLd, q);
#pragma unroll
          for (int i = 0; i < kGenPer; ++i) {
            if (i < nw) {                // warp-uniform
              const float4 x = lds4(xs + (warp + kGenWarps * i) * kGenLd, q);
              s[i] = dot4(x, y, s[i]);
              sh[i] = dot4(x, z, sh[i]);
            }
          }
        }
      }
      const int r = r0 + lane;
      const bool in = lane < rc;
      const bool lv = in && (rm ? rm[bt * R + r] > 0.f : true);
      const bool m = lv && on;
#pragma unroll
      for (int i = 0; i < kGenPer; ++i) {
        if (i >= nw) continue;
        const int k = k0 + warp + kGenWarps * i;
        const float diff = s[i] - sh[i];
        if (in) dres[(((size_t)b * K + k) * T + t) * R + r] = m ? diff : 0.f;
        float term = m ? as_operand(diff * diff, v) : 0.f;
        float val = in ? (lv ? s[i] : kNeg) : -CUDART_INF_F;
        int idx = r;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          term += __shfl_xor_sync(0xffffffffu, term, o);
          max_first(val, idx, o);
        }
        acc[i] += term;
        if (val > best[i]) {             // an earlier tile keeps equal values
          best[i] = val;
          arg[i] = idx;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGenPer; ++i) {
      if (i >= nw || lane != 0) continue;
      const int kk = warp + kGenWarps * i;
      const size_t o = ((size_t)b * K + k0 + kk) * T + t;
      ctx[o] = acc[i];
      rstar[o] = arg[i];
      rs[kk] = arg[i];
    }
    __syncthreads();
    // (b) f = v[t, r*] whole, then c* = first argmax of f . ch
    for (int p = threadIdx.x; p < kw * E; p += blockDim.x) {
      const int kk = p / E, e = p - kk * E;
      f[(bt * K + k0 + kk) * E + e] = load1(vt + (size_t)rs[kk] * E + e);
    }
    float top[kGenPer];
    int top_c[kGenPer];
#pragma unroll
    for (int i = 0; i < kGenPer; ++i) {
      top[i] = -CUDART_INF_F;
      top_c[i] = 0;
    }
    for (int c0 = 0; c0 < Kc; c0 += kGenRows) {
      const int cc = min(kGenRows, Kc - c0);
      float x4[kGenPer];
#pragma unroll
      for (int i = 0; i < kGenPer; ++i) x4[i] = 0.f;
      for (int e0 = 0; e0 < E; e0 += kGenCols) {
        __syncthreads();
        gen_stage(xs, kw, E, e0,
                  [&](int i) { return vt + (size_t)rs[i] * E; });
        gen_stage(ys, cc, E, e0,
                  [&](int i) { return chat + (size_t)(c0 + i) * E; });
        __syncthreads();
        for (int q = 0; q < kGenCols / 4; ++q) {
          const float4 y = lds4(ys + lane * kGenLd, q);
#pragma unroll
          for (int i = 0; i < kGenPer; ++i) {
            if (i < nw) {
              const float4 x = lds4(xs + (warp + kGenWarps * i) * kGenLd, q);
              x4[i] = dot4(x, y, x4[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGenPer; ++i) {
        if (i >= nw) continue;
        float val = lane < cc ? x4[i] : -CUDART_INF_F;
        int idx = c0 + lane;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) max_first(val, idx, o);
        if (val > top[i]) {
          top[i] = val;
          top_c[i] = idx;
        }
      }
    }
    // (c) clu = |f - C[c*]|^2, a warp a word
#pragma unroll
    for (int i = 0; i < kGenPer; ++i) {
      if (i >= nw) continue;
      const int kk = warp + kGenWarps * i;
      const Tin* fr = vt + (size_t)rs[kk] * E;
      const float* tgt = centers + (size_t)top_c[i] * E;
      float ss = 0.f;
      for (int e = lane; e < E; e += 32) {
        const float dx = load1(fr + e) - as_operand(tgt[e], v);
        ss = fmaf(dx, dx, ss);
      }
      ss = warp_sum(ss);
      if (lane == 0) {
        const size_t o = ((size_t)b * K + k0 + kk) * T + t;
        clu[o] = ss;
        cstar[o] = top_c[i];
      }
    }
    __syncthreads();                     // rs is read
  }
}

// Dynamic shared memory of a general block: 26,240 B at any size.
size_t smem_any() {
  return (size_t)(kGenWords + 2 * kGenRows) * kGenLd * sizeof(float) +
         kGenWords * sizeof(int);
}

// Whether the main kernel takes these sizes (words in registers 8 a pass, at
// most 4 16-byte quads a lane); every other shape takes diag_fwd_any.
bool in_envelope(int K, int E) {
  return K <= 32 && E >= 4 && E % 4 == 0 && E <= 512;
}

template <typename Tin>
int run_any(const void* w, const void* v, const void* u, const float* centers,
            void* chat, const float* fm, const float* hc, const float* rm,
            float* ctx, float* clu, float* f, float* dres, int* rstar,
            int* cstar, int B, int K, int T, int R, int E, int Kc,
            cudaStream_t stream) {
  const int err = launch_dyn(diag_centers_kernel<Tin>, centers_grid(Kc),
                             kCenterThreads, 0, stream, false, centers,
                             static_cast<Tin*>(chat), Kc, E);
  if (err != 0) return err;
  return launch_dyn(diag_fwd_any<Tin>, dim3((unsigned)(B * T)), kGenThreads,
                    smem_any(), stream, false, static_cast<const Tin*>(w),
                    static_cast<const Tin*>(v), static_cast<const Tin*>(u),
                    static_cast<const Tin*>(chat), centers, fm, hc, rm, ctx,
                    clu, f, dres, rstar, cstar, K, T, R, E, Kc);
}

// Limits: the grids' (B <= 65535; the general variant's B T blocks below
// 2^31) and sizes of at least 1.
bool bad_sizes(int B, int K, int T, int R, int E, int Kc) {
  return K < 1 || R < 1 || Kc < 1 || E < 1 || B < 0 || B > 65535 || T < 0 ||
         (long long)B * T > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Launches the two kernels on `stream` and returns the cudaError_t of the
// launches (0 = ok). w [B, K, E], v and u [B, T, R, E] and the scratch chat
// [Kc, E] are float* when is_bf16 == 0 and __nv_bfloat16* otherwise;
// centers [Kc, E], fm and hc [B, T] and rm [B, T, R] (may be null: every
// region valid) are f32. Written whole: ctx, clu [B, K, T] f32, f
// [B, T, K, E] f32, dres [B, K, T, R] f32, rstar and cstar [B, K, T] int32.
// All tensors are contiguous; w, v, u, centers, chat and f are 16-byte
// aligned. Shapes in_envelope takes run the kernels above, every other the
// general variant. Limits: K, R, Kc, E >= 1, B <= 65535, B T < 2^31.
int nafae_diag_fwd(const void* w, const void* v, const void* u, int is_bf16,
                   const float* centers, void* chat, const float* fm,
                   const float* hc, const float* rm, float* ctx, float* clu,
                   float* f, float* dres, int* rstar, int* cstar, int B, int K,
                   int T, int R, int E, int Kc, void* stream) {
  if (bad_sizes(B, K, T, R, E, Kc) || chat == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_envelope(K, E))
    return is_bf16
        ? run_any<__nv_bfloat16>(w, v, u, centers, chat, fm, hc, rm, ctx, clu,
                                 f, dres, rstar, cstar, B, K, T, R, E, Kc, s)
        : run_any<float>(w, v, u, centers, chat, fm, hc, rm, ctx, clu, f,
                         dres, rstar, cstar, B, K, T, R, E, Kc, s);
  return is_bf16
      ? run<__nv_bfloat16>(w, v, u, centers, chat, fm, hc, rm, ctx, clu, f,
                           dres, rstar, cstar, B, K, T, R, E, Kc, s)
      : run<float>(w, v, u, centers, chat, fm, hc, rm, ctx, clu, f, dres,
                   rstar, cstar, B, K, T, R, E, Kc, s);
}

// Launches two empty kernels with the grids, block sizes and dynamic shared
// memory that nafae_diag_fwd would use for these sizes, the second as the
// first's programmatic dependent (in stream order for the general variant):
// the launch floor the measured times are judged against. Same limits and
// return value.
int nafae_diag_fwd_floor(int is_bf16, int B, int K, int T, int R, int E,
                         int Kc, void* stream) {
  if (bad_sizes(B, K, T, R, E, Kc) || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_dyn(null_kernel, centers_grid(Kc), kCenterThreads,
                             0, s, false);
  if (err != 0) return err;
  if (!in_envelope(K, E))
    return launch_dyn(null_kernel, dim3((unsigned)(B * T)), kGenThreads,
                      smem_any(), s, false);
  return launch_dyn(null_kernel, main_grid(B, T), kThreads,
                    is_bf16 ? smem_bytes<__nv_bfloat16>(K, E)
                            : smem_bytes<float>(K, E),
                    s, true);
}

}  // extern "C"
