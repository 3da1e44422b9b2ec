// Batched greedy NMS for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nafae_tpu/ops/pallas/nms.py::_kernel (K2, called by
// nms_pallas_planes :98 and nms_pallas :149). Same function as the port's
// plain version, nafae_torch/ops/nms.py::nms_planes, and the same survivors
// exactly:
//
//   for every row b, starting with every box of score > -inf live
//   (masked score m = score if live, else -1e9):
//     num_keep times:  best  = the first index of max_j m[j]
//                      valid = m[best] > -1e9
//                      emit (best, valid); if !valid the row is exhausted and
//                      emits (0, 0) from then on
//                      kill best and every box with iou(best, j) > thresh
//
// Exactness: the IoU is written with __fsub_rn / __fadd_rn / __fmul_rn /
// __fdiv_rn so that nvcc contracts nothing into an FMA, in the reference's
// order (union = area_j + area_best - inter, then inter / max(union, 1e-12),
// 0 where union <= 0), with f32 constants and the threshold passed as f32.
//
// Design: candidates first, exact by construction. The greedy loop emits the
// same winners as a walk over the boxes in (score descending, index
// ascending) order that keeps a box unless an earlier winner killed it, and
// only boxes of score > -1e9 can be valid winners. So one block per row
// (1024 threads) keeps the row's scores in registers as order-preserving
// integer keys (24 a thread: rows of up to 24,576 boxes; a longer row
// re-reads the rest from device memory), and works in tiers:
//
//   select   the next boxes by (key, -index) below the previous tier's last
//            one: every box whose key reaches the s-th largest of the
//            threads' own largest keys (s = 384, else 48, else 1: the top
//            key), found by one warp bit by bit (32 steps, no barrier) and
//            taken if one count says it holds at most kTier boxes. When more
//            than kTier boxes share the top key (some of the detector's rows
//            have all their scores equal), the tier is the first kTier of
//            them by index, read from one ballot mask a key slot and warp (a
//            binary search over the index, a count a step, for rows longer
//            than the registers);
//   gather   their coordinates, one candidate a thread, in registers; the
//            winners of earlier tiers kill theirs first;
//   rounds   the live candidate of largest key, then lowest index, by two
//            32-bit warp reductions, a barrier, and two more; emit it, kill
//            the overlaps.
//
// A tier whose candidates all die before num_keep winners continues the walk
// in the next tier; that continuation is exact for the same reason and costs
// one selection, not a pass over the row per round. A row whose boxes of
// score > -1e9 are all dead is exhausted: it emits the first index of the
// max of the masked scores (valid 0), as the reference does, then (0, 0);
// a box below -1e9 that a winner's IoU killed reads -1e9 there.
//
// Bound on an H100 SXM (config 5: 320 rows x N = 24,000 anchors, num_keep
// 20): the function must read every score once (30.7 MB, 9.2 us at 3.35
// TB/s) and the coordinates of the boxes ranked at or above each row's last
// winner (a few hundred a row on the detector's rows), and test those boxes
// against the winners: it is bound by the scores' bytes. chip_smoke.py
// counts these bytes and operations on the rows it times. This design reads
// the scores once into registers and only the candidates' coordinates; one
// block an SM runs 320 rows in three waves, and a block's time goes to its
// chain of barriers (the counts of the selection, one a round). PERF.md has
// its times.
//
// Limits: 1 <= N < 2^31; any number of rows and any num_keep.

#include <cuda_runtime.h>

#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 24;                 // keys a thread keeps in registers
constexpr int kTier = kThreads;           // candidates a tier, one a thread
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving key of a possible winner's score (score > -1e9), 0 for
// every other box (-1e9 and below, -inf, NaN). -0 and +0 share a key: they
// tie in the reference's max.
__device__ __forceinline__ unsigned order_key(float s) {
  if (!(s > kNeg)) return 0u;
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key, index) as one integer whose order is the walk's: larger key first,
// then lower index.
__device__ __forceinline__ uint64_t rank_of(unsigned key, int j) {
  return ((uint64_t)key << 32) | (uint64_t)(~(unsigned)j);
}

__device__ __forceinline__ uint64_t warp_min(uint64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Sum of v over the block, returned to every thread: one barrier. `red`
// holds two buffers of kWarps, used in turn, so that a thread writing the
// next sum never overwrites one that a slower thread is still reading.
__device__ __forceinline__ int block_sum(int v, int* red, int& par) {
  v = (int)__reduce_add_sync(kFull, (unsigned)v);
  int* buf = red + par * kWarps;
  par ^= 1;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  return (int)__reduce_add_sync(kFull, (unsigned)buf[threadIdx.x & 31]);
}

// block_sum of v and, over the same barrier, the block's max of mx (`redm`
// is buffered as `red`).
__device__ __forceinline__ int block_sum_max(int v, unsigned& mx, int* red,
                                             unsigned* redm, int& par) {
  mx = __reduce_max_sync(kFull, mx);
  if ((threadIdx.x & 31) == 0) redm[par * kWarps + (threadIdx.x >> 5)] = mx;
  unsigned* buf = redm + par * kWarps;
  v = block_sum(v, red, par);
  mx = __reduce_max_sync(kFull, buf[threadIdx.x & 31]);
  return v;
}

// The s-th largest of the kThreads values v (0 if fewer than s are nonzero),
// found by one warp bit by bit, with no barrier: the largest m such that at
// least s values reach m.
__device__ __forceinline__ unsigned kth_largest(const unsigned* v, int s) {
  const uint4* v4 = reinterpret_cast<const uint4*>(v);
  const int lane = threadIdx.x & 31;
  unsigned m = 0u;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned c = m | (1u << bit);
    int n = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 128; ++i) {
      const uint4 q = v4[i * 32 + lane];
      n += (q.x >= c) + (q.y >= c) + (q.z >= c) + (q.w >= c);
    }
    if ((int)__reduce_add_sync(kFull, (unsigned)n) >= s) m = c;
  }
  return m;
}

// IoU of box a (area aa) with box b (area ab), in the reference's order.
__device__ __forceinline__ float iou(float ax1, float ay1, float ax2,
                                     float ay2, float aa, float bx1,
                                     float by1, float bx2, float by2,
                                     float ab) {
  const float ix = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.f);
  const float iy = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.f);
  const float inter = __fmul_rn(ix, iy);
  const float uni = __fsub_rn(__fadd_rn(aa, ab), inter);
  return uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
}

__device__ __forceinline__ float area_of(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

struct Box {
  float x1, y1, x2, y2, area;
};

// The walk so far ends at rank (hu, iu): a possible winner below it is still
// to come.
struct Below {
  unsigned hu;
  int iu;
  __device__ __forceinline__ bool operator()(unsigned k, int j) const {
    return k != 0u && (k < hu || (k == hu && j > iu));
  }
};

// How many of this thread's boxes below the walk (bit k of `mine` for the
// register keys; `below` for the rest of a long row, re-read from device
// memory) pred holds for.
template <typename Pred>
__device__ __forceinline__ int count_mine(const unsigned (&key)[kKeys],
                                          unsigned mine,
                                          const float* __restrict__ sc,
                                          unsigned n_reg, int N, Below below,
                                          Pred pred) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < kKeys; ++k)
    c += ((mine >> k) & 1u) && pred(key[k], k * kThreads + (int)threadIdx.x);
  for (unsigned j = n_reg + threadIdx.x; j < (unsigned)N; j += kThreads) {
    const unsigned k = order_key(sc[j]);
    c += below(k, (int)j) && pred(k, (int)j);
  }
  return c;
}

// Appends (k, j) to the tier when sel: one shared atomic a warp.
__device__ __forceinline__ void take(bool sel, unsigned k, int j,
                                     unsigned* cand_key, int* cand_idx,
                                     int* n_cand) {
  const unsigned ball = __ballot_sync(kFull, sel);
  if (ball == 0u) return;
  const int lane = threadIdx.x & 31;
  int at = 0;
  if (lane == 0) at = atomicAdd(n_cand, __popc(ball));
  at = __shfl_sync(kFull, at, 0);
  if (sel) {
    const int slot = at + __popc(ball & ((1u << lane) - 1u));
    cand_key[slot] = k;
    cand_idx[slot] = j;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
           const float* __restrict__ x2, const float* __restrict__ y2,
           const float* __restrict__ scores, int* __restrict__ idx_out,
           float* __restrict__ valid_out, int* __restrict__ tiers_out, int N,
           int num_keep, float thresh) {
  __shared__ unsigned cand_key[kTier];
  __shared__ int cand_idx[kTier];
  __shared__ __align__(16) unsigned top_of[kThreads];  // threads' top keys
  __shared__ unsigned tie[kKeys][kWarps];
  __shared__ int red[2 * kWarps];
  __shared__ unsigned redm[2 * kWarps];
  __shared__ unsigned best_key[2][kWarps];
  __shared__ unsigned best_idx[2][kWarps];
  __shared__ Box best_box[2][kWarps];
  __shared__ uint64_t low_rank[kWarps];
  __shared__ float ex_v[kWarps];
  __shared__ int ex_i[kWarps];
  __shared__ int n_cand;
  __shared__ unsigned sel;

  const size_t row = blockIdx.x;
  const size_t base = row * (size_t)N;
  const float* sc = scores + base;
  int* idx_row = idx_out + row * num_keep;
  float* val_row = valid_out + row * num_keep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned n_reg = (unsigned)min(N, kKeys * kThreads);

  unsigned key[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int j = k * kThreads + tid;
    key[k] = j < N ? order_key(sc[j]) : 0u;
  }

  int par = 0;
  Below below{kFull, 0};
  int kept = 0, tiers = 0, rpar = 0;
  while (kept < num_keep) {
    if (tid == 0) n_cand = 0;
    // this thread's keys below the walk, and the largest of them
    unsigned mine = 0u, top_mine = 0u;
#pragma unroll
    for (int k = 0; k < kKeys; ++k)
      if (below(key[k], k * kThreads + tid)) {
        mine |= 1u << k;
        top_mine = max(top_mine, key[k]);
      }
    for (unsigned j = n_reg + tid; j < (unsigned)N; j += kThreads) {
      const unsigned k = order_key(sc[j]);
      if (below(k, (int)j)) top_mine = max(top_mine, k);
    }
    top_of[tid] = top_mine;
    auto all = [](unsigned, int) { return true; };
    unsigned top = top_mine;                 // then the largest of them all
    const int left = block_sum_max(
        count_mine(key, mine, sc, n_reg, N, below, all), top, red, redm, par);
    // every possible winner seen; a tier takes at least one box, so the
    // second test never fires unless the selection is at fault, and then
    // it ends the row instead of hanging the card
    if (left == 0 || tiers > N) break;
    ++tiers;
    // the tier: every box below the walk with (key, -index) >= (hs, is)
    unsigned hs = 1u;
    int is = INT_MAX;
    if (left > kTier) {
      const int c_top = block_sum(
          count_mine(key, mine, sc, n_reg, N, below,
                     [=](unsigned k, int) { return k == top; }),
          red, par);
      hs = top;
      if (c_top <= kTier) {
        // Fast cut: hs = the s-th largest of the threads' own largest keys
        // (s = 384, else 48, else 1: the top key), taken if at most kTier
        // boxes reach it; at least s do, so the tier is never empty.
        for (int s : {384, 48}) {
          if (warp == 0) {
            const unsigned m = kth_largest(top_of, s);
            if (lane == 0) sel = m;
          }
          __syncthreads();
          const unsigned m = max(sel, 1u);
          const int c = block_sum(
              count_mine(key, mine, sc, n_reg, N, below,
                         [=](unsigned k, int) { return k >= m; }),
              red, par);
          if (c <= kTier) {
            hs = m;
            break;
          }
        }
      } else if (n_reg == (unsigned)N) {
        // More than kTier boxes share the top key: the exact cut, the
        // kTier-th of them by index. Box j = k kThreads + 32 warp + lane sits
        // in bit lane of tie[k][warp], so every thread reads it from the
        // masks: the chunk k, then the warp, then the lane.
#pragma unroll
        for (int k = 0; k < kKeys; ++k) {
          const unsigned m = __ballot_sync(kFull, ((mine >> k) & 1u) &&
                                                      key[k] == top);
          if (lane == 0) tie[k][warp] = m;
        }
        __syncthreads();
        int need = kTier, k = 0;
        for (;; ++k) {                    // the tied boxes number > kTier
          const int c = (int)__reduce_add_sync(kFull, __popc(tie[k][lane]));
          if (c >= need) break;
          need -= c;
        }
        const unsigned mw = tie[k][lane];
        int upto = __popc(mw);            // inclusive prefix over the warps
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(kFull, upto, off);
          if (lane >= off) upto += o;
        }
        const int w_at = __ffs(__ballot_sync(kFull, upto >= need)) - 1;
        unsigned bits = __shfl_sync(kFull, mw, w_at);
        for (int q = need - __shfl_sync(kFull, upto - __popc(mw), w_at);
             q > 1; --q)
          bits &= bits - 1u;
        is = k * kThreads + 32 * w_at + __ffs(bits) - 1;
      } else {
        // ... by binary search over the index, for rows longer than the
        // keys kept in registers
        int l = -1, r = N - 1;            // count(l) < kTier <= count(r)
        while (r - l > 1) {
          const int mid = l + (r - l) / 2;
          const int c = block_sum(
              count_mine(key, mine, sc, n_reg, N, below,
                         [=](unsigned k, int j) {
                           return k == hs && j <= mid;
                         }),
              red, par);
          if (c >= kTier) r = mid; else l = mid;
        }
        is = r;
      }
    }
    // gather the tier: a slot each, in no particular order
    auto in_tier = [=](unsigned k, int j) {
      return k > hs || (k == hs && j <= is);
    };
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const int j = k * kThreads + tid;
      take(((mine >> k) & 1u) && in_tier(key[k], j), key[k], j, cand_key,
           cand_idx, &n_cand);
    }
    for (unsigned b0 = n_reg; b0 < (unsigned)N; b0 += kThreads) {
      const unsigned j = b0 + tid;
      const unsigned k = j < (unsigned)N ? order_key(sc[j]) : 0u;
      take(below(k, (int)j) && in_tier(k, (int)j), k, (int)j, cand_key,
           cand_idx, &n_cand);
    }
    __syncthreads();
    const int n_tier = n_cand;
    const bool last_tier = n_tier == left;

    const bool slot = tid < n_tier;
    unsigned ck = 0u;                       // this slot's candidate (ck, cj)
    int cj = INT_MAX;
    Box box{0.f, 0.f, 0.f, 0.f, 0.f};
    bool live = false;
    if (slot) {
      ck = cand_key[tid];
      cj = cand_idx[tid];
      box.x1 = x1[base + cj];
      box.y1 = y1[base + cj];
      box.x2 = x2[base + cj];
      box.y2 = y2[base + cj];
      box.area = area_of(box.x1, box.y1, box.x2, box.y2);
      live = true;
      for (int w = 0; w < kept && live; ++w) {   // earlier tiers' winners
        const size_t b = base + idx_row[w];
        const float bx1 = x1[b], by1 = y1[b], bx2 = x2[b], by2 = y2[b];
        live = !(iou(box.x1, box.y1, box.x2, box.y2, box.area, bx1, by1, bx2,
                     by2, area_of(bx1, by1, bx2, by2)) > thresh);
      }
    }

    // rounds: the best live candidate (largest key, then lowest index) wins
    // and kills its overlaps; a warp's best and then the block's by two
    // 32-bit reductions each
    while (kept < num_keep) {
      const unsigned kw = __reduce_max_sync(kFull, live ? ck : 0u);
      const unsigned jw = __reduce_min_sync(
          kFull, live && ck == kw ? (unsigned)cj : kFull);
      if (lane == 0) {
        best_key[rpar][warp] = kw;
        best_idx[rpar][warp] = jw;
      }
      if (live && (unsigned)cj == jw) best_box[rpar][warp] = box;
      __syncthreads();
      const unsigned kl = best_key[rpar][lane];
      const unsigned kb = __reduce_max_sync(kFull, kl);
      if (kb == 0u) break;                      // the tier is spent
      const unsigned jl = best_idx[rpar][lane];
      const unsigned jb = __reduce_min_sync(kFull, kl == kb ? jl : kFull);
      const int from = __ffs(__ballot_sync(kFull, kl == kb && jl == jb)) - 1;
      const Box win = best_box[rpar][from];
      rpar ^= 1;
      if (tid == 0) {
        idx_row[kept] = (int)jb;
        val_row[kept] = 1.f;
      }
      if (live)
        live = (unsigned)cj != jb &&
               !(iou(box.x1, box.y1, box.x2, box.y2, box.area, win.x1,
                     win.y1, win.x2, win.y2, win.area) > thresh);
      ++kept;
    }
    if (kept == num_keep || last_tier) break;
    // continue the walk below the tier's last candidate
    const uint64_t wlow = warp_min(slot ? rank_of(ck, cj) : ~0ull);
    if (lane == 0) low_rank[warp] = wlow;
    __syncthreads();
    const uint64_t low = warp_min(low_rank[lane]);
    below = Below{(unsigned)(low >> 32), (int)~(unsigned)low};
  }

  if (kept < num_keep) {
    // exhausted: every box of score > -1e9 is dead, so the masked score is
    // -1e9 for every box but those of finite score below -1e9 that no winner
    // killed, which keep their score; emit the first index of its max with
    // valid 0, then (0, 0). No masked score exceeds -1e9, so a thread stops
    // at its first -1e9.
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    for (unsigned j = tid; j < (unsigned)N && bv != kNeg; j += kThreads) {
      const float s = sc[j];
      float m = kNeg;
      if (s < kNeg && s > -CUDART_INF_F) {
        m = s;
        const float ax1 = x1[base + j], ay1 = y1[base + j];
        const float ax2 = x2[base + j], ay2 = y2[base + j];
        const float aa = area_of(ax1, ay1, ax2, ay2);
        for (int w = 0; w < kept; ++w) {
          const size_t b = base + idx_row[w];
          const float bx1 = x1[b], by1 = y1[b], bx2 = x2[b], by2 = y2[b];
          if (iou(ax1, ay1, ax2, ay2, aa, bx1, by1, bx2, by2,
                  area_of(bx1, by1, bx2, by2)) > thresh) {
            m = kNeg;
            break;
          }
        }
      }
      if (m > bv) {
        bv = m;
        bi = (int)j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      ex_v[warp] = bv;
      ex_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = ex_v[lane];
      bi = ex_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        idx_row[kept] = bi;
        val_row[kept] = 0.f;
      }
    }
    for (int k = kept + 1 + tid; k < num_keep; k += kThreads) {
      idx_row[k] = 0;
      val_row[k] = 0.f;
    }
  }
  if (tiers_out != nullptr && tid == 0) tiers_out[row] = tiers;
}

}  // namespace

extern "C" {

// Candidates a tier (the walk's step; rows whose winners all lie among their
// first kTier boxes by score take one tier).
int nafae_nms_tier_boxes() { return kTier; }

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// x1, y1, x2, y2, scores: [B, N] f32, contiguous; idx [B, num_keep] int32 and
// valid [B, num_keep] f32 are written whole; tiers [B] int32 (may be null)
// receives the number of tiers each row took.
int nafae_nms(const float* x1, const float* y1, const float* x2,
              const float* y2, const float* scores, int* idx, float* valid,
              int* tiers, int B, int N, int num_keep, float thresh,
              void* stream) {
  if (B < 0 || N < 1 || num_keep < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || num_keep == 0) return 0;
  nms_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, x2, y2, scores, idx, valid, tiers, N, num_keep, thresh);
  return (int)cudaGetLastError();
}

}  // extern "C"
