// The host-side batch packer of the port: a pool of worker threads packs
// batches of padded, masked segments from a flat binary segment cache
// (.nbin), off the Python GIL, straight into the caller's numpy buffers.
// Built with g++ at first use and bound with ctypes
// (nafae_torch/utils/native_io.py); a plain C interface, no PyTorch headers.
//
// .nbin layout (little-endian), version 3:
//   int32 magic 0x4e414641 ('NAFA'), int32 version
//   int32 T, R, D, K
//   float feats[T*R*D]; float boxes[T*R*4]; int32 word_ids[K]
//   (version>=3) int32 has_rm; float region_mask[T*R]
//   (version>=2) int32 has_gt; float gt_boxes[K*T*4]; float gt_mask[K*T]
//
// Batches are bit for bit those of the Python packer (SegmentDataset +
// np.stack), including feats converted to float16 / bfloat16 with numpy's
// and ml_dtypes' rounding.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#if defined(__F16C__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Segment packer
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t kMagic = 0x4e414641;

// feats output dtype codes (must match nafae_torch/utils/native_io.py)
enum FeatDtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

// float32 -> bfloat16, round-to-nearest-even, NaN quieted — bitwise
// identical to numpy/ml_dtypes `astype(bfloat16)` (Eigen semantics),
// which the Python loader path uses (data/youcook2.py transfer_dtype).
inline uint16_t f32_to_bf16(float v) {
  uint32_t x;
  std::memcpy(&x, &v, 4);
  if ((x & 0x7fffffffu) > 0x7f800000u)                   // NaN -> fixed qNaN
    return static_cast<uint16_t>(((x >> 16) & 0x8000u) | 0x7fc0u);
  uint32_t rounding = 0x7fffu + ((x >> 16) & 1u);        // RNE
  return static_cast<uint16_t>((x + rounding) >> 16);
}

// float32 -> float16, IEEE round-to-nearest-even (overflow -> inf,
// gradual underflow) — bitwise identical to numpy `astype(float16)`.
// F16C hardware path when compiled with -mf16c; portable fallback below.
inline uint16_t f32_to_f16(float v) {
  uint32_t x;
  std::memcpy(&x, &v, 4);
  if ((x & 0x7fffffffu) > 0x7f800000u) {
    // NaN: numpy truncates the payload (no quiet-bit forcing — F16C would
    // set it, diverging bitwise), bumping to 0x7c01 if truncation would
    // collapse to inf
    uint16_t ret =
        static_cast<uint16_t>(0x7c00u | ((x & 0x7fffffu) >> 13));
    if (ret == 0x7c00u) ret = 0x7c01u;
    return static_cast<uint16_t>(((x >> 16) & 0x8000u) | ret);
  }
#if defined(__F16C__)
  return _cvtss_sh(v, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
#else
  uint32_t sign = (x >> 16) & 0x8000u;
  uint32_t mant = x & 0x7fffffu;
  int32_t exp8 = static_cast<int32_t>((x >> 23) & 0xffu);
  if (exp8 == 0xff)                                       // inf (NaN above)
    return static_cast<uint16_t>(sign | 0x7c00u);
  int32_t exp = exp8 - 127 + 15;                          // f16-biased
  if (exp >= 0x1f) return static_cast<uint16_t>(sign | 0x7c00u);
  if (exp <= 0) {                                         // subnormal/zero
    if (exp < -11) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);     // 14..25 (< 32)
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1u);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1u))) half++;
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t half = (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1fffu;
  // RNE; a mantissa carry correctly overflows into the exponent bits
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;
  return static_cast<uint16_t>(sign | half);
#endif
}

struct SegHeader {
  int32_t magic, version, T, R, D, K;
};

struct PackerTask {
  int sample;      // position in the batch
  int seg_index;   // which segment file
};

struct Packer {
  std::vector<std::string> files;
  // padded batch dims
  int T, R, D, K;
  bool with_gt;
  int feat_dtype = kF32;      // FeatDtype: feats output element type
  // current batch output pointers (caller-owned)
  void* feats = nullptr;      // [B,T,R,D] float32 | float16 | bfloat16
  float* boxes = nullptr;     // [B,T,R,4]
  int32_t* word_ids = nullptr;  // [B,K]
  float* frame_mask = nullptr;  // [B,T]
  float* word_mask = nullptr;   // [B,K]
  float* region_mask = nullptr; // [B,T,R]
  float* gt_boxes = nullptr;    // [B,K,T,4]
  float* gt_mask = nullptr;     // [B,K,T]

  std::vector<std::thread> workers;
  std::queue<PackerTask> tasks;
  std::mutex mu;
  std::condition_variable cv_task, cv_done;
  int pending = 0;
  std::atomic<int> errors{0};
  bool stop = false;

  ~Packer() {
    {
      std::unique_lock<std::mutex> lk(mu);
      stop = true;
    }
    cv_task.notify_all();
    for (auto& t : workers) t.join();
  }

  void worker_loop() {
    for (;;) {
      PackerTask task;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_task.wait(lk, [&] { return stop || !tasks.empty(); });
        if (stop && tasks.empty()) return;
        task = tasks.front();
        tasks.pop();
      }
      // defense-in-depth: any exception escaping a std::thread calls
      // std::terminate() and kills the whole training process — a bad_alloc
      // under memory pressure (the header guards bound but don't eliminate
      // large rows) must count as a per-task error instead
      try {
        if (!load_one(task)) errors.fetch_add(1);
      } catch (...) {
        errors.fetch_add(1);
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        if (--pending == 0) cv_done.notify_all();
      }
    }
  }

  size_t feat_elem_size() const {
    return feat_dtype == kF32 ? sizeof(float) : sizeof(uint16_t);
  }

  // Write `cnt` f32 values into feats[off..], converting to the configured
  // transfer dtype (the host->device copy is half the bytes for f16/bf16).
  void store_feats(size_t off, const float* src, size_t cnt) {
    if (feat_dtype == kF32) {
      std::memcpy(static_cast<float*>(feats) + off, src, sizeof(float) * cnt);
    } else if (feat_dtype == kF16) {
      uint16_t* dst = static_cast<uint16_t*>(feats) + off;
      for (size_t i = 0; i < cnt; ++i) dst[i] = f32_to_f16(src[i]);
    } else {
      uint16_t* dst = static_cast<uint16_t*>(feats) + off;
      for (size_t i = 0; i < cnt; ++i) dst[i] = f32_to_bf16(src[i]);
    }
  }

  bool load_one(const PackerTask& task) {
    const std::string& path = files[task.seg_index];
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    SegHeader h;
    if (std::fread(&h, sizeof(h), 1, f) != 1 || h.magic != kMagic) {
      std::fclose(f);
      return false;
    }
    // sanity-check dims BEFORE sizing any allocation: a corrupt header
    // passing the magic check would otherwise throw bad_alloc inside this
    // worker thread and std::terminate() the whole process
    if (h.version < 1 || h.version > 3 || h.T < 0 || h.R < 0 || h.K < 0 ||
        h.D < 0 || h.T > 1000000 || h.R > 1000000 || h.K > 1000000 ||
        h.D > 1000000 ||
        static_cast<size_t>(h.R) * static_cast<size_t>(h.D) > (1u << 28) ||
        // the GT block sizes K*T*4 floats — bound the PRODUCT too, the
        // per-dim caps alone still admit a 16 TB bad_alloc
        static_cast<size_t>(h.K) * static_cast<size_t>(h.T) > (1u << 26)) {
      std::fclose(f);
      return false;
    }
    // feat dim must match exactly: the Python loader keeps the file's D
    // (a mismatch fails loudly downstream), so silently truncating/padding
    // here would break the bitwise native==python invariant
    if (h.D != D) {
      std::fclose(f);
      return false;
    }
    int t = std::min(h.T, T), r = std::min(h.R, R), k = std::min(h.K, K);
    size_t b = static_cast<size_t>(task.sample);
    // feats: row-by-row copy with padding
    std::vector<float> row(static_cast<size_t>(h.R) * h.D);
    for (int ti = 0; ti < t; ++ti) {
      if (std::fseek(f, sizeof(SegHeader) +
                     sizeof(float) * static_cast<long>(ti) * h.R * h.D, SEEK_SET))
        { std::fclose(f); return false; }
      if (std::fread(row.data(), sizeof(float), static_cast<size_t>(h.R) * h.D,
                     f) != static_cast<size_t>(h.R) * h.D)
        { std::fclose(f); return false; }
      for (int ri = 0; ri < r; ++ri) {
        store_feats(((b * T + ti) * R + ri) * static_cast<size_t>(D),
                    row.data() + static_cast<size_t>(ri) * h.D,
                    static_cast<size_t>(std::min(h.D, D)));
      }
    }
    // boxes
    long boxes_off = sizeof(SegHeader) +
                     sizeof(float) * static_cast<long>(h.T) * h.R * h.D;
    std::vector<float> brow(static_cast<size_t>(h.R) * 4);
    for (int ti = 0; ti < t; ++ti) {
      std::fseek(f, boxes_off + sizeof(float) * static_cast<long>(ti) * h.R * 4,
                 SEEK_SET);
      if (std::fread(brow.data(), sizeof(float), static_cast<size_t>(h.R) * 4,
                     f) != static_cast<size_t>(h.R) * 4)
        { std::fclose(f); return false; }
      std::memcpy(boxes + ((b * T + ti) * R) * 4, brow.data(),
                  sizeof(float) * static_cast<size_t>(r) * 4);
    }
    // word ids
    long wid_off = boxes_off + sizeof(float) * static_cast<long>(h.T) * h.R * 4;
    std::fseek(f, wid_off, SEEK_SET);
    std::vector<int32_t> wids(h.K);
    if (h.K > 0 &&
        std::fread(wids.data(), sizeof(int32_t), h.K, f) !=
            static_cast<size_t>(h.K))
      { std::fclose(f); return false; }
    for (int ki = 0; ki < k; ++ki) word_ids[b * K + ki] = wids[ki];
    // masks
    for (int ti = 0; ti < t; ++ti) frame_mask[b * T + ti] = 1.0f;
    for (int ki = 0; ki < k; ++ki) word_mask[b * K + ki] = 1.0f;
    // region validity: from the file's v3 block, else structural (r < file R)
    long after_wids = wid_off + sizeof(int32_t) * h.K;
    bool rm_from_file = false;
    if (h.version >= 3) {
      std::fseek(f, after_wids, SEEK_SET);
      int32_t has_rm = 0;
      if (std::fread(&has_rm, sizeof(int32_t), 1, f) != 1)
        { std::fclose(f); return false; }
      after_wids += sizeof(int32_t);
      if (has_rm) {
        std::vector<float> rmrow(static_cast<size_t>(h.R));
        for (int ti = 0; ti < t; ++ti) {
          std::fseek(f, after_wids +
                     sizeof(float) * static_cast<long>(ti) * h.R, SEEK_SET);
          if (std::fread(rmrow.data(), sizeof(float), h.R, f)
              != static_cast<size_t>(h.R))
            { std::fclose(f); return false; }
          for (int ri = 0; ri < r; ++ri)
            region_mask[(b * T + ti) * R + ri] = rmrow[ri];
        }
        after_wids += sizeof(float) * static_cast<long>(h.T) * h.R;
        rm_from_file = true;
      }
    }
    if (!rm_from_file) {
      for (int ti = 0; ti < t; ++ti)
        for (int ri = 0; ri < r; ++ri)
          region_mask[(b * T + ti) * R + ri] = 1.0f;
    }
    // optional GT block. Truncation anywhere inside it is an ERROR, not
    // "no GT": reading a damaged cache as gt_mask=0 would silently drop
    // the segment's annotated pairs from the accuracy denominator.
    if (with_gt && gt_boxes && gt_mask) {
      if (h.version < 2) {   // v1 predates the GT block: same stale-cache
        std::fclose(f);      // error as has_gt=0 below
        return false;
      }
      long gt_off = after_wids;
      std::fseek(f, gt_off, SEEK_SET);
      int32_t has_gt = 0;
      if (std::fread(&has_gt, sizeof(int32_t), 1, f) != 1) {
        std::fclose(f);
        return false;
      }
      if (!has_gt) {
        // GT requested but this cache entry was written without it (e.g. a
        // stale pre-merge .nbin): serving gt_mask=0 would silently drop the
        // segment from the eval denominator — the Python loader raises
        // KeyError for the same input, so error here too
        std::fclose(f);
        return false;
      }
      if (has_gt) {
        std::vector<float> gb(static_cast<size_t>(h.K) * h.T * 4);
        std::vector<float> gm(static_cast<size_t>(h.K) * h.T);
        if (std::fread(gb.data(), sizeof(float), gb.size(), f) != gb.size() ||
            std::fread(gm.data(), sizeof(float), gm.size(), f) != gm.size()) {
          std::fclose(f);
          return false;
        }
        for (int ki = 0; ki < k; ++ki)
          for (int ti = 0; ti < t; ++ti) {
            std::memcpy(gt_boxes + ((b * K + ki) * T + ti) * 4,
                        gb.data() + (static_cast<size_t>(ki) * h.T + ti) * 4,
                        sizeof(float) * 4);
            gt_mask[(b * K + ki) * T + ti] =
                gm[static_cast<size_t>(ki) * h.T + ti];
          }
      }
    }
    std::fclose(f);
    return true;
  }
};

}  // namespace

// manifest: newline-separated .nbin paths. Returns opaque handle or null.
// feat_dtype: 0 = float32, 1 = float16, 2 = bfloat16 (FeatDtype).
void* packer_create2(const char* manifest, int T, int R, int D, int K,
                     int with_gt, int num_threads, int feat_dtype) {
  if (feat_dtype < kF32 || feat_dtype > kBF16) return nullptr;
  FILE* f = std::fopen(manifest, "rb");
  if (!f) return nullptr;
  auto* p = new Packer();
  p->T = T; p->R = R; p->D = D; p->K = K; p->with_gt = with_gt != 0;
  p->feat_dtype = feat_dtype;
  char line[4096];
  while (std::fgets(line, sizeof(line), f)) {
    size_t n = std::strlen(line);
    while (n && (line[n - 1] == '\n' || line[n - 1] == '\r')) line[--n] = 0;
    if (n) p->files.emplace_back(line);
  }
  std::fclose(f);
  if (num_threads < 1) num_threads = 1;
  for (int i = 0; i < num_threads; ++i)
    p->workers.emplace_back([p] { p->worker_loop(); });
  return p;
}

int packer_num_segments(void* handle) {
  return static_cast<int>(static_cast<Packer*>(handle)->files.size());
}

// Pack segments files[idxs[0..n)] into the caller-provided (zeroed by us)
// batch buffers. Blocking; internally parallel. Returns 0 on success.
int packer_pack(void* handle, const int32_t* idxs, int n,
                void* feats, float* boxes, int32_t* word_ids,
                float* frame_mask, float* word_mask, float* region_mask,
                float* gt_boxes, float* gt_mask) {
  auto* p = static_cast<Packer*>(handle);
  size_t B = static_cast<size_t>(n);
  std::memset(feats, 0, p->feat_elem_size() * B * p->T * p->R * p->D);
  std::memset(boxes, 0, sizeof(float) * B * p->T * p->R * 4);
  std::memset(word_ids, 0, sizeof(int32_t) * B * p->K);
  std::memset(frame_mask, 0, sizeof(float) * B * p->T);
  std::memset(word_mask, 0, sizeof(float) * B * p->K);
  std::memset(region_mask, 0, sizeof(float) * B * p->T * p->R);
  if (p->with_gt && gt_boxes && gt_mask) {
    std::memset(gt_boxes, 0, sizeof(float) * B * p->K * p->T * 4);
    std::memset(gt_mask, 0, sizeof(float) * B * p->K * p->T);
  }
  p->feats = feats; p->boxes = boxes; p->word_ids = word_ids;
  p->frame_mask = frame_mask; p->word_mask = word_mask;
  p->region_mask = region_mask;
  p->gt_boxes = gt_boxes; p->gt_mask = gt_mask;
  p->errors.store(0);
  // validate BEFORE queueing: a mid-loop early return would leave stale
  // tasks + an unset pending count for the next call (deadlock/OOB writes)
  for (int i = 0; i < n; ++i) {
    if (idxs[i] < 0 || idxs[i] >= static_cast<int>(p->files.size())) return 1;
  }
  {
    std::unique_lock<std::mutex> lk(p->mu);
    for (int i = 0; i < n; ++i) {
      p->tasks.push(PackerTask{i, idxs[i]});
    }
    p->pending = n;
  }
  p->cv_task.notify_all();
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return p->pending == 0; });
  }
  return p->errors.load() == 0 ? 0 : 2;
}

void packer_destroy(void* handle) { delete static_cast<Packer*>(handle); }

}  // extern "C"
