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
//   ctx   = sum_r m ? (s - sh)^2 : 0     (each term rounded to the 16-bit
//                                          type in bf16 or f16 mode, as
//                                          fused_ctx.py::_sel_dot)
//   r*    = first argmax_r of (live ? s : -1e9)  (frame validity ignored; an
//           all-masked frame picks region 0)
//   f     = v[t, r*]                                     (exact, f32)
//   c*    = first argmax_c of f . ch[c],  ch[c] = C[c] / sqrt(|C[c]|^2 + 1e-8)
//           (ch rounded to the 16-bit type in bf16 or f16 mode)
//   clu   = |f - C[c*]|^2     (C[c*] rounded the same way)
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
//                cp.async (f32: 4 slots of 20 centers; 16-bit: 3 of 32;
//                all of config4's 67 are in flight at once). f32: each warp
//                takes the centers j = warp (mod 4) with the pass's f in
//                registers, 8 FFMA dots and one transposed butterfly a
//                center. bf16 and f16 (one code, a template on the type):
//                mma.sync m16n8k16 on the tensor cores, the words as A (8
//                rows of zeros below), a warp an n8 tile of centers, f32
//                accumulators; f is a row of v, exact in its type.
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
// E > 512) takes the general variant below after the centers kernel: a
// scores kernel (a block a frame, v and u streamed once) and a sims kernel
// (a block a tile of 16 rows of f, the centers streamed once a block), each
// the programmatic dependent of the kernel before it.

// Bound on an H100 SXM (config4 training shapes B=16, K=8, T=20, R=20,
// E=256, Kc=67, f32): 2*2*B*K*T*R*E + 2*B*K*T*Kc*E = 140 MFLOP (~2.1 us at
// 67 TFLOP/s) against ~15.8 MB moved (v and u 6.6 MB each, f 1.3 MB, the
// residuals, w, centers, masks), ~4.7 us at 3.35 TB/s: bound by bytes. In
// bf16 and f16, v and u are half the bytes: ~2.7 us. These count every
// region as live and the residuals as needed; the function needs only ctx,
// clu and f written, v at live regions (region 0 of an all-masked frame)
// and u at the ctx mask, so chip_smoke.py counts the bound from a batch's
// masks, without the residuals. What is left above the bound: the two
// launches, and on each SM three frames' dots with 12 warps to hide the latency of the
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
// E padded to 128, 4 slots. 16-bit (tensor cores): 32 centers a slot (one
// n8 tile a warp), rows of E padded to 16 and 8 more (no bank conflicts in
// the fragment loads), 3 slots. Either way config4's 67 centers are in
// flight at once.
template <typename Tin>
struct RingOf {
  static constexpr int rows = sizeof(Tin) == 2 ? 32 : 20;
  static constexpr int slots = sizeof(Tin) == 2 ? 3 : 4;
};

__host__ __device__ __forceinline__ int padded16(int E) {
  return (E + 15) & ~15;
}

// Elements of a row of the ring (and of the 16-bit rows of f): f32 rows are
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

// Bytes of a worker's shared memory: the floats, and in 16 bits the pass's
// f as 16 rows of the type (the A operand of the sims; rows kW.. zero).
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
// i % slots by cp.async, 16-byte copies (8-byte for 16-bit rows that are not
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
  using T16 = std::conditional_t<kMma, Tin, __nv_bfloat16>;   // f's rows
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
  T16* fsh = reinterpret_cast<T16*>(
      fs + worker_floats(K, E, kW));      // 16-bit: [16][ld]   f, as T16

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
      store_as(fsh + p, 0.f);

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
        if (kMma) {                   // exact: x is a value of type Tin
          store2_as(fsh + kk * ld + 4 * q, x.x, x.y);
          store2_as(fsh + kk * ld + 4 * q + 2, x.z, x.w);
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
            const Tin* q = ring + (n0 + g) * ld + k + 2 * tig;
            mma16<Tin>(d, a, lds32(q), lds32(q + 8));
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
// The general variant, for every shape outside the main kernel's envelope
// (in_envelope: K > 32, E not a multiple of 4, E > 512): after the centers
// kernel, two kernels, each streaming E through a ring of stages of 64
// columns by cp.async (rows of any alignment, as stage_tile_any copies them),
// the stages after the current one in flight during its sums, and each
// output with one writer and one order of sums:
//
//   scores  one block a frame (b, t), the centers kernel's programmatic
//           dependent (it reads no center). v_t's and u_t's rows, regions
//           padded to RP = 16 MT (a tile of up to 64: past it, tiles in
//           turn), stream once beside w[b]'s rows, up to kScoreWords words a
//           pass (K = 40 in one); only v's rows at live regions and u's where
//           the ctx mask is on are read (the bound counts just those). A
//           warp takes 8 words (a lane 4 words x MT regions, for s and sh)
//           over 64 / S of each stage's columns, where S warps split the
//           columns when the pass has fewer than 8 octets of words (S = 8 at
//           K = 8); their partial sums meet in shared memory in a fixed
//           order. Then a warp a word takes the residual d, the ctx terms (a
//           fixed butterfly) and the first-index maximum over live regions
//           ((value, index) butterfly; an earlier tile keeps equal values),
//           so equal rows of v give equal scores and tie to the first region.
//   sims    one block a tile of kSimRows rows of f ((b, t, k) in f's
//           order: 2,560 rows, 160 blocks at B = 16, T = 20, K = 8), the
//           scores kernel's programmatic dependent: it reads r*, then
//           streams the rows f = v[t, r*] and up to kSimCenters rows of the
//           normalised centers a pass (all of config 4's 67) once, writes f
//           from the staged rows, and forms the sims: f32 on CUDA cores (a
//           thread 4 rows x 2 centers, one fmaf order for every output, so
//           equal rows of ch tie), bf16 and f16 on mma.sync with f32
//           accumulators (a warp one or two n8 tiles of centers, as the
//           main kernel's 16-bit sims; f is a row of v, exact in its type,
//           and ch is rounded as the reference rounds it). c* is the
//           first maximum ((value, index) butterflies, the lower center on
//           equal values); then clu =
//           |f - C[c*]|^2 (C[c*] rounded where the reference rounds it), a
//           warp a row, from f as this block wrote it.
//
// Bound at R = 36, E = 1024 (B = 16, K = 8, T = 20): ~0.031 ms f32 and
// ~0.017 ms bf16 in all (v, u and f bytes; chip_smoke.py counts it from a
// batch's masks). The sims re-read ch from L2 once a block (44 MB at f32
// there), the price of spreading 2,560 rows over the 132 SMs.
constexpr int kGenThreads = 256;
constexpr int kGenK = 64;               // E columns a stage of either kernel
constexpr int kScoreStages = 2;         // the scores kernel's ring
constexpr int kSimStages = 4;           // the sims kernel's ring
constexpr int kScoreWords = 64;         // words of a scores pass
constexpr int kScoreTile = 64;          // regions of a scores tile
constexpr int kSimRows = 16;            // rows of f a sims block
constexpr int kSimCenters = 128;        // centers of a sims pass

// The scores kernel waits for the centers kernel at its end, so that its
// grid completes after the centers'; the sims kernel waits for the scores
// kernel before its first read of r* (and of ch).
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Warps that split a stage's columns when a pass has `oct` octets of words.
__device__ __forceinline__ int col_splits(int oct) {
  return oct == 1 ? 8 : oct == 2 ? 4 : oct <= 4 ? 2 : 1;
}

// Rows [0, rows) of kGenK columns from k0 of E-element rows row(i) (16-byte
// aligned bases, as stage_tile_any's) into shared rows of stride ld, zero
// where live(i) is false and past E: stage_tile_any for rows that are not
// one array's, or not all needed.
template <typename T, typename RowOf, typename Live>
__device__ __forceinline__ void stage_rows_any(T* __restrict__ dst, int rows,
                                               int E, int k0, int ld,
                                               RowOf row, Live live) {
  constexpr int kSz = (int)sizeof(T);
  const int row_bytes = E * kSz;
  const int vec = row_bytes % 16 == 0 ? 16 / kSz
                  : row_bytes % 8 == 0 ? 8 / kSz
                  : row_bytes % 4 == 0 ? 4 / kSz : 0;
  if (vec == 0) {                                // plain loads (bf16, odd E)
    for (int p = threadIdx.x; p < rows * kGenK; p += blockDim.x) {
      const int r = p / kGenK, k = p - r * kGenK;
      store_as(dst + r * ld + k, live(r) && k0 + k < E
                                     ? load1(row(r) + k0 + k) : 0.f);
    }
    return;
  }
  const int sh = __ffs(kGenK / vec) - 1;         // chunks a row: 2^sh
  for (int p = threadIdx.x; p < rows << sh; p += blockDim.x) {
    const int r = p >> sh, k = (p & ((1 << sh) - 1)) * vec;
    const bool ok = live(r) && k0 + k < E;
    const T* src = ok ? row(r) + k0 + k : row(0);
    T* d = dst + r * ld + k;
    if (vec * kSz == 16) cp_async<16>(d, src, ok ? 16 : 0);
    else if (vec * kSz == 8) cp_async<8>(d, src, ok ? 8 : 0);
    else cp_async<4>(d, src, ok ? 4 : 0);
  }
}

// Three blocks an SM (at most 80 registers a thread): all 320 frames of
// B = 16, T = 20 in one wave.
template <typename Tin, int MT>
__global__ void __launch_bounds__(kGenThreads, 3)
diag_scores_any(const Tin* __restrict__ w, const Tin* __restrict__ v,
                const Tin* __restrict__ u, const float* __restrict__ fm,
                const float* __restrict__ hc, const float* __restrict__ rm,
                float* __restrict__ ctx, float* __restrict__ dres,
                int* __restrict__ rstar, int K, int T, int R, int E) {
  constexpr int RP = 16 * MT;                    // regions of a tile, padded
  constexpr int ld = stage_ld<Tin>(kGenK);
  constexpr int kPer = (RP + 31) / 32;           // regions a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* ring = reinterpret_cast<Tin*>(smem_raw);  // [stages][KW + 2 RP][ld]
  float* red = reinterpret_cast<float*>(smem_raw);   // after a tile's stream
  __shared__ float lv_s[RP];                     // the tile's region masks
  const Tin* tag = nullptr;                      // picks as_operand's dtype

  let_main_launch();                             // the sims kernel may start
  const size_t bt = blockIdx.x;                  // the frame (b, t)
  const int b = (int)(bt / T), t = (int)(bt - (size_t)b * T);
  const bool on = fm[bt] > 0.f && hc[bt] > 0.f;  // the ctx mask's frame part
  const int KW = min(kScoreWords, (K + 7) & ~7); // staged word rows
  const int kStage = (KW + 2 * RP) * ld;
  const int nk = (E + kGenK - 1) / kGenK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = lane >> 4, rg = lane & 15;

  for (int k0 = 0; k0 < K; k0 += kScoreWords) {
    const int kp = min(kScoreWords, K - k0);     // words of the pass
    const int oct = (kp + 7) >> 3;
    const int S = col_splits(oct);
    const int sp = warp % S, oc = warp / S;      // column split, word octet
    const int q_lo = sp * (kGenK / 4 / S), q_hi = q_lo + kGenK / 4 / S;
    const Tin* wk = w + ((size_t)b * K + k0) * E;
    float acc[8], best[8];                       // words warp + 8 m, m < 8
    int arg[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      acc[m] = 0.f;
      best[m] = -CUDART_INF_F;
      arg[m] = 0;
    }
    for (int r0 = 0; r0 < R; r0 += RP) {
      const int rc = min(RP, R - r0);            // regions of the tile
      const Tin* vt = v + (bt * R + r0) * E;
      const Tin* ut = u + (bt * R + r0) * E;
      // only the rows that count are read: v's at live regions, u's where
      // the ctx mask is on; the others stay zeros, which nothing uses
      auto stage = [&](int ks) {                 // one group a stage
        if (ks < nk) {
          Tin* d = ring + (ks % kScoreStages) * kStage;
          stage_tile_any(d, wk, KW, kp, E, ks * kGenK, kGenK, ld);
          stage_rows_any(
              d + KW * ld, RP, E, ks * kGenK, ld,
              [&](int i) { return vt + (size_t)i * E; },
              [&](int i) { return lv_s[i] > 0.f; });
          stage_rows_any(
              d + (KW + RP) * ld, RP, E, ks * kGenK, ld,
              [&](int i) { return ut + (size_t)i * E; },
              [&](int i) { return on && lv_s[i] > 0.f; });
        }
        cp_async_commit();
      };
      float s[4][MT], sh[4][MT];
#pragma unroll
      for (int z = 0; z < 4; ++z)
#pragma unroll
        for (int i = 0; i < MT; ++i) s[z][i] = sh[z][i] = 0.f;
      __syncthreads();                           // the last tile's red is read
      for (int i = threadIdx.x; i < RP; i += blockDim.x)
        lv_s[i] = i < rc && (rm == nullptr || rm[bt * R + r0 + i] > 0.f);
      __syncthreads();
      for (int ks = 0; ks < kScoreStages - 1; ++ks) stage(ks);
      for (int ks = 0; ks < nk; ++ks) {
        cp_async_wait(kScoreStages - 2);         // stage ks; later ones fly
        __syncthreads();                         // ... for all; ks - 1 read
        stage(ks + kScoreStages - 1);            // into the slot of ks - 1
        if (oc >= oct) continue;                 // warp-uniform
        const Tin* st = ring + (ks % kScoreStages) * kStage;
        const Tin* W = st + (oc * 8 + wg * 4) * ld;
        const Tin* V = st + (KW + rg) * ld;
        const Tin* U = V + RP * ld;
        for (int q = q_lo; q < q_hi; ++q) {
          float4 x[4], y[MT], z4[MT];
#pragma unroll
          for (int z = 0; z < 4; ++z) x[z] = lds4(W + z * ld, q);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            y[i] = lds4(V + 16 * i * ld, q);
            z4[i] = lds4(U + 16 * i * ld, q);
          }
#pragma unroll
          for (int z = 0; z < 4; ++z)
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              s[z][i] = dot4(x[z], y[i], s[z][i]);
              sh[z][i] = dot4(x[z], z4[i], sh[z][i]);
            }
        }
      }
      __syncthreads();                           // the ring is read
      // partial sums [S][kp8][RP] of s, then of sh
      const int kp8 = oct * 8;
      float* red_h = red + S * kp8 * RP;
      if (oc < oct) {
#pragma unroll
        for (int z = 0; z < 4; ++z)
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int at = (sp * kp8 + oc * 8 + wg * 4 + z) * RP + rg + 16 * i;
            red[at] = s[z][i];
            red_h[at] = sh[z][i];
          }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int kk = warp + 8 * m;             // a warp a word
        if (kk >= kp) continue;                  // warp-uniform
        float term = 0.f, val = -CUDART_INF_F;
        int idx = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int r = lane + 32 * j;
          if (r >= rc) continue;
          float x = 0.f, y = 0.f;
          for (int p = 0; p < S; ++p) {          // the splits in order
            x += red[(p * kp8 + kk) * RP + r];
            y += red_h[(p * kp8 + kk) * RP + r];
          }
          const bool lv = lv_s[r] > 0.f;
          const bool msk = lv && on;
          const float diff = x - y;
          dres[(((size_t)b * K + k0 + kk) * T + t) * R + r0 + r] =
              msk ? diff : 0.f;
          term += msk ? as_operand(diff * diff, tag) : 0.f;
          const float sv = lv ? x : kNeg;
          if (sv > val) {                        // the lane's regions ascend
            val = sv;
            idx = r0 + r;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          term += __shfl_xor_sync(0xffffffffu, term, o);
          max_first(val, idx, o);
        }
        acc[m] += term;
        if (val > best[m]) {                     // an earlier tile keeps ties
          best[m] = val;
          arg[m] = idx;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int kk = warp + 8 * m;
      if (kk >= kp || lane != 0) continue;
      const size_t o = ((size_t)b * K + k0 + kk) * T + t;
      ctx[o] = acc[m];
      rstar[o] = arg[m];
    }
  }
  wait_for_primary();                            // the centers kernel's grid
}

template <typename Tin>
__global__ void __launch_bounds__(kGenThreads)
diag_sims_any(const Tin* __restrict__ v, const Tin* __restrict__ chat,
              const float* __restrict__ centers,
              const int* __restrict__ rstar, float* __restrict__ clu,
              float* __restrict__ f, int* __restrict__ cstar, int B, int K,
              int T, int R, int E, int Kc) {
  constexpr bool kMma = sizeof(Tin) == 2;        // 16-bit sims on mma.sync
  constexpr int ld = stage_ld<Tin>(kGenK);
  constexpr int NR = kSimRows;
  constexpr int kWarps = kGenThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* ring = reinterpret_cast<Tin*>(smem_raw);  // [stages][NR + CW][ld]
  __shared__ const Tin* src[NR];                 // the rows v[t, r*]
  __shared__ float wbest[kWarps][NR];            // each warp's first maxima
  __shared__ int warg[kWarps][NR];
  __shared__ float rbest[NR];                    // each row's, so far
  __shared__ int rarg[NR];
  const Tin* tag = nullptr;

  const size_t rows_all = (size_t)B * T * K;
  const size_t row0 = (size_t)blockIdx.x * NR;
  const int live = rows_all - row0 < (size_t)NR ? (int)(rows_all - row0)
                                                : NR;   // rows here
  const int CW = min(kSimCenters, (Kc + 7) & ~7);    // staged center rows
  const int kStage = (NR + CW) * ld;
  const int nk = (E + kGenK - 1) / kGenK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = threadIdx.x >> 6;               // f32: rows 4 tr..
  const int tc = threadIdx.x & 63;               // ... centers tc, tc + 64
  const int g4 = lane >> 2, tig = lane & 3;      // 16-bit: fragment lanes

  wait_for_primary();                            // r* (and ch) are written
  for (int i = threadIdx.x; i < NR; i += blockDim.x) {
    const size_t row = row0 + i;                 // (b, t, k) in f's order
    const size_t frame = row / K;                // b T + t
    const int k = (int)(row - frame * K);
    const int b = (int)(frame / T), t = (int)(frame - (size_t)b * T);
    src[i] = i < live
        ? v + (frame * R + rstar[((size_t)b * K + k) * T + t]) * E : v;
    rbest[i] = -CUDART_INF_F;
    rarg[i] = 0;
  }
  __syncthreads();

  for (int c0 = 0; c0 < Kc; c0 += kSimCenters) {
    const int cc = min(kSimCenters, Kc - c0);    // centers of the pass
    auto stage = [&](int ks) {
      if (ks < nk) {
        Tin* d = ring + (ks % kSimStages) * kStage;
        stage_rows_any(d, NR, E, ks * kGenK, ld,
                       [&](int i) { return src[i]; },
                       [&](int i) { return i < live; });
        stage_tile_any(d + NR * ld, chat + (size_t)c0 * E, cc, cc, E,
                       ks * kGenK, kGenK, ld);
      }
      cp_async_commit();
    };
    // f32: a thread's 4 rows x its centers tc and tc + 64; 16-bit: a warp's
    // n8 tiles of centers warp, warp + 8 (all 16 rows, one m16 tile)
    float acc[4][2], mac[2][4];                  // f32, 16-bit
    for (auto& x : acc) x[0] = x[1] = 0.f;
    for (auto& x : mac) x[0] = x[1] = x[2] = x[3] = 0.f;
    const bool two = kMma ? 8 * (warp + kWarps) < cc : tc + 64 < cc;
    for (int ks = 0; ks < kSimStages - 1; ++ks) stage(ks);
    for (int ks = 0; ks < nk; ++ks) {
      cp_async_wait(kSimStages - 2);
      __syncthreads();
      stage(ks + kSimStages - 1);
      const Tin* F = ring + (ks % kSimStages) * kStage;
      const Tin* C = F + NR * ld;
      if (c0 == 0)                               // f from the staged rows
        for (int p = threadIdx.x; p < live * kGenK; p += blockDim.x) {
          const int i = p / kGenK, e = ks * kGenK + p % kGenK;
          if (e < E) f[(row0 + i) * E + e] = load1(F + i * ld + p % kGenK);
        }
      if constexpr (kMma) {
        if (8 * warp >= cc) continue;            // warp-uniform
#pragma unroll
        for (int k = 0; k < kGenK; k += 16) {
          uint32_t x[4];
          frag_a(x, F, ld, 0, k);
          const Tin* q = C + (8 * warp + g4) * ld + k + 2 * tig;
          mma16<Tin>(mac[0], x, lds32(q), lds32(q + 8));
          if (two) {
            q += 8 * kWarps * ld;
            mma16<Tin>(mac[1], x, lds32(q), lds32(q + 8));
          }
        }
      } else {
        if (tc >= cc) continue;
#pragma unroll 4
        for (int q = 0; q < kGenK / 4; ++q) {
          const float4 y0 = lds4(C + tc * ld, q);
          const float4 y1 = two ? lds4(C + (tc + 64) * ld, q)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 x = lds4(F + (4 * tr + i) * ld, q);
            acc[i][0] = dot4(x, y0, acc[i][0]);
            acc[i][1] = dot4(x, y1, acc[i][1]);
          }
        }
      }
    }
    // the pass's first maximum of each row: each warp's over its centers
    // (a lane's own, then a butterfly), then the warps in turn (the lower
    // index on equal values), then the passes (an earlier pass keeps equal
    // values)
    for (int i = lane; i < NR; i += 32) wbest[warp][i] = -CUDART_INF_F;
    __syncwarp();
    if constexpr (kMma) {
      // lane (g4, tig): rows g4, g4 + 8; columns 8 n + 2 tig, + 1 of tiles
      // n = warp, warp + 8; the 4 lanes of a row by butterflies
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float val = -CUDART_INF_F;
        int idx = 0;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int z = 0; z < 2; ++z) {
            const int c = 8 * (warp + kWarps * n) + 2 * tig + z;
            if (c < cc && mac[n][2 * h + z] > val) {   // ascending c
              val = mac[n][2 * h + z];
              idx = c0 + c;
            }
          }
        max_first(val, idx, 1);
        max_first(val, idx, 2);
        if (tig == 0) {
          wbest[warp][g4 + 8 * h] = val;
          warg[warp][g4 + 8 * h] = idx;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float val = -CUDART_INF_F;
        int idx = 0;
        if (tc < cc) {
          val = acc[i][0];
          idx = c0 + tc;
        }
        if (two && acc[i][1] > val) {
          val = acc[i][1];
          idx = c0 + tc + 64;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) max_first(val, idx, o);
        if (lane == 0) {
          wbest[warp][4 * tr + i] = val;
          warg[warp][4 * tr + i] = idx;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < NR) {
      const int j = threadIdx.x;
      float val = -CUDART_INF_F;
      int idx = 0;
      for (int w = 0; w < kWarps; ++w)
        if (wbest[w][j] > val || (wbest[w][j] == val && warg[w][j] < idx)) {
          val = wbest[w][j];
          idx = warg[w][j];
        }
      if (val > rbest[j]) {
        rbest[j] = val;
        rarg[j] = idx;
      }
    }
  }
  __syncthreads();                               // f is written; c* known
  // clu = |f - C[c*]|^2, a warp a row
  for (int i = warp; i < live; i += kWarps) {
    const size_t row = row0 + i;
    const float* fr = f + row * E;
    const float* tgt = centers + (size_t)rarg[i] * E;
    float ss = 0.f;
#pragma unroll 8
    for (int e = lane; e < E; e += 32) {         // 8 loads of each in flight
      const float dx = fr[e] - as_operand(tgt[e], tag);
      ss = fmaf(dx, dx, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) {
      const size_t frame = row / K;
      const int k = (int)(row - frame * K);
      const int b = (int)(frame / T), t = (int)(frame - (size_t)b * T);
      const size_t o = ((size_t)b * K + k) * T + t;
      clu[o] = ss;
      cstar[o] = rarg[i];
    }
  }
}

// The general kernels' grids and dynamic shared memory.
int scores_mt(int R) { return min(4, (R + 15) / 16); }

template <typename Tin>
size_t scores_smem(int K, int R) {
  const int rp = 16 * scores_mt(R);
  const int kw = min(kScoreWords, (K + 7) & ~7);
  const size_t ring =
      kScoreStages * (size_t)(kw + 2 * rp) * stage_ld<Tin>(kGenK) *
      sizeof(Tin);
  const size_t red = 2 * (size_t)kScoreWords * rp * sizeof(float);
  return ring > red ? ring : red;
}

template <typename Tin>
size_t sims_smem(int Kc) {
  const int cw = min(kSimCenters, (Kc + 7) & ~7);
  return kSimStages * (size_t)(kSimRows + cw) * stage_ld<Tin>(kGenK) *
         sizeof(Tin);
}

dim3 sims_grid(int B, int K, int T) {
  return dim3((unsigned)(((size_t)B * T * K + kSimRows - 1) / kSimRows));
}

// Whether the main kernel takes these sizes (words in registers 8 a pass, at
// most 4 16-byte quads a lane); every other shape takes the general variant.
bool in_envelope(int K, int E) {
  return K <= 32 && E >= 4 && E % 4 == 0 && E <= 512;
}

template <typename Tin, int MT>
int launch_scores(const void* w, const void* v, const void* u,
                  const float* fm, const float* hc, const float* rm,
                  float* ctx, float* dres, int* rstar, int B, int K, int T,
                  int R, int E, cudaStream_t stream) {
  return launch_dyn(diag_scores_any<Tin, MT>, dim3((unsigned)(B * T)),
                    kGenThreads, scores_smem<Tin>(K, R), stream, true,
                    static_cast<const Tin*>(w), static_cast<const Tin*>(v),
                    static_cast<const Tin*>(u), fm, hc, rm, ctx, dres, rstar,
                    K, T, R, E);
}

template <typename Tin>
int run_any(const void* w, const void* v, const void* u, const float* centers,
            void* chat, const float* fm, const float* hc, const float* rm,
            float* ctx, float* clu, float* f, float* dres, int* rstar,
            int* cstar, int B, int K, int T, int R, int E, int Kc,
            cudaStream_t stream) {
  int err = launch_dyn(diag_centers_kernel<Tin>, centers_grid(Kc),
                       kCenterThreads, 0, stream, false, centers,
                       static_cast<Tin*>(chat), Kc, E);
  if (err != 0) return err;
  switch (scores_mt(R)) {        // MT: a tile of 16 MT regions
    case 1: err = launch_scores<Tin, 1>(w, v, u, fm, hc, rm, ctx, dres, rstar, B, K, T, R, E, stream); break;
    case 2: err = launch_scores<Tin, 2>(w, v, u, fm, hc, rm, ctx, dres, rstar, B, K, T, R, E, stream); break;
    case 3: err = launch_scores<Tin, 3>(w, v, u, fm, hc, rm, ctx, dres, rstar, B, K, T, R, E, stream); break;
    default: err = launch_scores<Tin, 4>(w, v, u, fm, hc, rm, ctx, dres, rstar, B, K, T, R, E, stream); break;
  }
  if (err != 0) return err;
  return launch_dyn(diag_sims_any<Tin>, sims_grid(B, K, T), kGenThreads,
                    sims_smem<Tin>(Kc), stream, true,
                    static_cast<const Tin*>(v),
                    static_cast<const Tin*>(chat), centers,
                    static_cast<const int*>(rstar), clu, f, cstar, B, K, T,
                    R, E, Kc);
}

// Limits: the grids' (B <= 65535; the general variant's B T and B T K / 16
// blocks below 2^31) and sizes of at least 1.
bool bad_sizes(int B, int K, int T, int R, int E, int Kc) {
  return K < 1 || R < 1 || Kc < 1 || E < 1 || B < 0 || B > 65535 || T < 0 ||
         (long long)B * T > 0x7fffffffLL ||
         (long long)B * T * K / kSimRows >= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Launches the kernels (two, or three in the general variant) on `stream`
// and returns the cudaError_t of the launches (0 = ok). w [B, K, E], v and
// u [B, T, R, E] and the scratch chat [Kc, E] are of the type of the dtype
// code: float* (0), __nv_bfloat16* (1) or __half* (2; any other code is
// refused); centers [Kc, E], fm and hc [B, T] and rm [B, T, R] (may be
// null: every region valid) are f32. Written whole: ctx, clu [B, K, T] f32,
// f [B, T, K, E] f32, dres [B, K, T, R] f32, rstar and cstar [B, K, T]
// int32. All tensors are contiguous; w, v, u, centers, chat and f are
// 16-byte aligned. Shapes in_envelope takes run the kernels above, every
// other the general variant. Limits: K, R, Kc, E >= 1, B <= 65535,
// B T < 2^31 and B T K / 16 < 2^31.
int nafae_diag_fwd(const void* w, const void* v, const void* u, int dtype,
                   const float* centers, void* chat, const float* fm,
                   const float* hc, const float* rm, float* ctx, float* clu,
                   float* f, float* dres, int* rstar, int* cstar, int B, int K,
                   int T, int R, int E, int Kc, void* stream) {
  if (bad_sizes(B, K, T, R, E, Kc) || chat == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool spec = in_envelope(K, E);
  return by_dtype(dtype, (int)cudaErrorInvalidValue, [&](auto tag) {
    using Tin = decltype(tag);
    return spec ? run<Tin>(w, v, u, centers, chat, fm, hc, rm, ctx, clu, f,
                           dres, rstar, cstar, B, K, T, R, E, Kc, s)
                : run_any<Tin>(w, v, u, centers, chat, fm, hc, rm, ctx, clu,
                               f, dres, rstar, cstar, B, K, T, R, E, Kc, s);
  });
}

// Launches empty kernels with the grids, block sizes and dynamic shared
// memory that nafae_diag_fwd would use for these sizes, each after the first
// as the programmatic dependent of the one before (two kernels, or three in
// the general variant): the launch floor the measured times are judged
// against. Same limits and return value.
int nafae_diag_fwd_floor(int dtype, int B, int K, int T, int R, int E,
                         int Kc, void* stream) {
  if (bad_sizes(B, K, T, R, E, Kc) || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, (int)cudaErrorInvalidValue, [&](auto tag) {
    using Tin = decltype(tag);
    const int err = launch_dyn(null_kernel, centers_grid(Kc), kCenterThreads,
                               0, s, false);
    if (err != 0) return err;
    if (!in_envelope(K, E)) {
      const int e2 = launch_dyn(null_kernel, dim3((unsigned)(B * T)),
                                kGenThreads, scores_smem<Tin>(K, R), s, true);
      if (e2 != 0) return e2;
      return launch_dyn(null_kernel, sims_grid(B, K, T), kGenThreads,
                        sims_smem<Tin>(Kc), s, true);
    }
    return launch_dyn(null_kernel, main_grid(B, T), kThreads,
                      smem_bytes<Tin>(K, E), s, true);
  });
}

}  // extern "C"
