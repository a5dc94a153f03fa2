// The port's own copy of the reference's native/cfear_io.cpp, built by
// utils/native_io.py into the package's _build/; held equal to the
// reference by tests/test_torch_selfcontained.py (the host filter gives
// the reference's rows bit for bit).
//
// cfear_io: native radar data plane.
//
// The reference ingests radar sweeps from rosbags on the main thread
// (offline_odometry.cpp:64-126, radar_driver.cpp:74-111). For TPU feeding,
// decode/IO must never stall the device, so this library provides:
//
//  - a packed binary sweep format ("radar pack"): one mmap-able file holding
//    all polar sweeps of a sequence contiguously (header + per-frame
//    timestamp + A*R uint8 payload), convertible once from PNG directories;
//  - a zero-copy mmap reader;
//  - a multi-threaded prefetch loader that assembles fixed-size frame
//    batches in pinned host buffers ahead of the consumer (double-buffered
//    ring), so the host->TPU transfer pipeline stays full.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5241444152504b31ull;  // "RADARPK1"

struct PackHeader {
  uint64_t magic;
  uint64_t n_frames;
  uint64_t n_azimuths;
  uint64_t n_bins;
};

struct Pack {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  PackHeader hdr{};
  size_t frame_bytes() const { return 8 + hdr.n_azimuths * hdr.n_bins; }
  const uint8_t* frame(uint64_t i) const {
    return map + sizeof(PackHeader) + i * frame_bytes();
  }
};

struct Batch {
  std::vector<uint8_t> data;
  std::vector<uint64_t> stamps;
  uint64_t first_frame = 0;
  uint64_t n = 0;
};

struct Loader {
  Pack* pack = nullptr;
  uint64_t batch = 0;
  uint64_t next_submit = 0;
  uint64_t total = 0;
  size_t depth = 0;
  bool loop = false;

  std::deque<Batch*> ready;
  std::deque<Batch*> free_bufs;
  std::vector<std::unique_ptr<Batch>> all;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<bool> stop{false};
  std::thread worker;
};

void loader_thread(Loader* L) {
  const size_t fb = L->pack->hdr.n_azimuths * L->pack->hdr.n_bins;
  while (!L->stop.load()) {
    if (!L->loop && L->next_submit >= L->total) break;
    Batch* b = nullptr;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_free.wait(lk, [&] { return L->stop.load() || !L->free_bufs.empty(); });
      if (L->stop.load()) break;
      b = L->free_bufs.front();
      L->free_bufs.pop_front();
    }
    b->first_frame = L->next_submit;
    b->n = 0;
    for (uint64_t k = 0; k < L->batch; ++k) {
      uint64_t idx = L->next_submit + k;
      if (L->loop) idx %= L->total;
      if (!L->loop && idx >= L->total) break;
      const uint8_t* src = L->pack->frame(idx);
      std::memcpy(&b->stamps[k], src, 8);
      std::memcpy(b->data.data() + k * fb, src + 8, fb);
      b->n++;
    }
    L->next_submit += b->n;
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->ready.push_back(b);
    }
    L->cv_ready.notify_one();
  }
  // signal end-of-stream with an empty batch
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->ready.push_back(nullptr);
  }
  L->cv_ready.notify_one();
}

}  // namespace

extern "C" {

// ---------------- pack writer ----------------
void* cfear_pack_create(const char* path, uint64_t n_frames,
                        uint64_t n_azimuths, uint64_t n_bins) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  PackHeader hdr{kMagic, n_frames, n_azimuths, n_bins};
  std::fwrite(&hdr, sizeof(hdr), 1, f);
  return f;
}

int cfear_pack_append(void* handle, uint64_t stamp_ns, const uint8_t* data,
                      uint64_t n_azimuths, uint64_t n_bins) {
  FILE* f = static_cast<FILE*>(handle);
  if (std::fwrite(&stamp_ns, 8, 1, f) != 1) return -1;
  if (std::fwrite(data, 1, n_azimuths * n_bins, f) != n_azimuths * n_bins)
    return -1;
  return 0;
}

int cfear_pack_close_writer(void* handle) {
  return std::fclose(static_cast<FILE*>(handle));
}

// ---------------- pack reader (mmap) ----------------
void* cfear_pack_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { ::close(fd); return nullptr; }
  Pack* p = new Pack();
  p->fd = fd;
  p->map = static_cast<const uint8_t*>(map);
  p->map_size = st.st_size;
  std::memcpy(&p->hdr, p->map, sizeof(PackHeader));
  if (p->hdr.magic != kMagic) {
    munmap(map, st.st_size); ::close(fd); delete p; return nullptr;
  }
  return p;
}

void cfear_pack_info(void* handle, uint64_t* n_frames, uint64_t* n_azimuths,
                     uint64_t* n_bins) {
  Pack* p = static_cast<Pack*>(handle);
  *n_frames = p->hdr.n_frames;
  *n_azimuths = p->hdr.n_azimuths;
  *n_bins = p->hdr.n_bins;
}

int cfear_pack_read(void* handle, uint64_t idx, uint8_t* out,
                    uint64_t* stamp_ns) {
  Pack* p = static_cast<Pack*>(handle);
  if (idx >= p->hdr.n_frames) return -1;
  const uint8_t* src = p->frame(idx);
  std::memcpy(stamp_ns, src, 8);
  std::memcpy(out, src + 8, p->hdr.n_azimuths * p->hdr.n_bins);
  return 0;
}

void cfear_pack_close(void* handle) {
  Pack* p = static_cast<Pack*>(handle);
  munmap(const_cast<uint8_t*>(p->map), p->map_size);
  ::close(p->fd);
  delete p;
}

// ---------------- prefetch loader ----------------
void* cfear_loader_create(void* pack_handle, uint64_t batch, uint64_t depth,
                          int loop) {
  Pack* p = static_cast<Pack*>(pack_handle);
  Loader* L = new Loader();
  L->pack = p;
  L->batch = batch;
  L->depth = depth;
  L->loop = loop != 0;
  L->total = p->hdr.n_frames;
  const size_t fb = p->hdr.n_azimuths * p->hdr.n_bins;
  for (size_t i = 0; i < depth; ++i) {
    auto b = std::make_unique<Batch>();
    b->data.resize(batch * fb);
    b->stamps.resize(batch);
    L->free_bufs.push_back(b.get());
    L->all.push_back(std::move(b));
  }
  L->worker = std::thread(loader_thread, L);
  return L;
}

// Blocks until the next batch is ready. Returns number of frames copied
// (0 = end of stream). Copies into caller-owned memory and recycles the
// internal buffer.
uint64_t cfear_loader_next(void* handle, uint8_t* out_data,
                           uint64_t* out_stamps, uint64_t* first_frame) {
  Loader* L = static_cast<Loader*>(handle);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return !L->ready.empty(); });
    b = L->ready.front();
    L->ready.pop_front();
  }
  if (b == nullptr) return 0;  // end of stream
  const size_t fb = L->pack->hdr.n_azimuths * L->pack->hdr.n_bins;
  std::memcpy(out_data, b->data.data(), b->n * fb);
  std::memcpy(out_stamps, b->stamps.data(), b->n * 8);
  *first_frame = b->first_frame;
  uint64_t n = b->n;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_bufs.push_back(b);
  }
  L->cv_free.notify_one();
  return n;
}

void cfear_loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"

// ---------------- host-side k-strongest + axial-NMS filter ----------------
//
// Production ingest splits the pipeline: the data plane reduces each polar
// sweep (A x R uint8, ~1.5 MB) to its k-strongest candidate set
// (A x K bins/intensities/peak flags, ~64 KB) before the host->device
// transfer, so the accelerator link carries 20-30x fewer bytes. Semantics
// are bit-identical to the on-device filter (`ops/filtering.py`
// `kstrongest_mask` + `nms_peak_image`, themselves reproducing the
// reference's `StructuredKStrongest`, radar_filters.cpp:209-298):
//  - keep the k strongest bins with intensity >= z_min per azimuth row,
//    ties broken toward the larger range bin, output sorted by
//    (intensity, bin) descending; empty slots carry bin = -1;
//  - peak flag: the 7-bin smoothed score (w = 3) is a windowed local max
//    and the bin is >= w away from the image border.

namespace {

void filter_rows(const uint8_t* images, int64_t n_rows, int64_t r, int k,
                 int z_min, int w, int16_t* out_bins, uint8_t* out_intens,
                 uint8_t* out_peaks, int64_t row_begin, int64_t row_end,
                 const int32_t* z_frames = nullptr, int64_t rows_per_frame = 0) {
  // O(R) per row: incremental sliding-window NMS score fused with candidate
  // (I >= z_min) collection; histogram-threshold top-k over the CANDIDATES
  // only (usually far fewer than R bins clear the noise floor); local-max
  // test only at the <= k selected bins.
  std::vector<int32_t> score(r);
  std::vector<int32_t> cand;
  cand.reserve(r);
  std::vector<int32_t> keys;
  keys.reserve(k);
  std::vector<int16_t> tie_bins(k > 0 ? k : 1);
  int shift = 1;
  while (shift < r) shift <<= 1;
  for (int64_t row = row_begin; row < row_end; ++row) {
    // adaptive mode: per-frame effective threshold (already max'd with
    // z_min by cfear_frame_thresholds)
    const int z_row = z_frames ? z_frames[row / rows_per_frame] : z_min;
    const int zc = z_row < 0 ? 0 : (z_row > 256 ? 256 : z_row);
    const uint8_t* img = images + row * r;
    // NMS score (sum of raw intensities over [b-w, b+w], zero-padded) and
    // candidate bins in one pass
    cand.clear();
    {
      int32_t s = 0;
      for (int64_t j = 0; j <= w && j < r; ++j) s += img[j];
      score[0] = s;
      if (img[0] >= zc) cand.push_back(0);
      for (int64_t b = 1; b < r; ++b) {
        if (b + w < r) s += img[b + w];
        if (b - w - 1 >= 0) s -= img[b - w - 1];
        score[b] = s;
        if (img[b] >= zc) cand.push_back(static_cast<int32_t>(b));
      }
    }
    // intensity histogram of the candidates
    int32_t hist[257] = {0};
    for (int32_t b : cand) hist[img[b]]++;
    int32_t n_above = 0;  // candidates with intensity strictly above vt
    int vt = 256;
    {
      int32_t total = 0;
      for (int v = 255; v >= zc; --v) {
        if (total + hist[v] >= k) { vt = v; n_above = total; break; }
        total += hist[v];
      }
      if (vt == 256) { vt = zc - 1; n_above = total; }  // fewer than k cands
    }
    int take_at_vt = k - n_above;
    // collect: strictly-above candidates (sorted later) + ties at vt in
    // descending-bin order (the reference tie-break keeps larger bins)
    keys.clear();
    int n_tie = 0;
    for (auto it = cand.rbegin(); it != cand.rend(); ++it) {
      int32_t b = *it;
      int v = img[b];
      if (v > vt) {
        keys.push_back(v * shift + b);
      } else if (v == vt && n_tie < take_at_vt) {
        tie_bins[n_tie++] = static_cast<int16_t>(b);
      }
    }
    std::sort(keys.begin(), keys.end(), std::greater<int32_t>());
    int16_t* ob = out_bins + row * k;
    uint8_t* oi = out_intens + row * k;
    uint8_t* op = out_peaks + row * k;
    int out = 0;
    auto emit = [&](int32_t bin, uint8_t inten) {
      ob[out] = static_cast<int16_t>(bin);
      oi[out] = inten;
      bool peak = bin >= w && bin < r - w;
      if (peak) {
        int32_t sc = score[bin];
        for (int64_t j = bin - w; j <= bin + w; ++j)
          if (score[j] > sc) { peak = false; break; }
      }
      op[out] = peak ? 1 : 0;
      ++out;
    };
    for (size_t j = 0; j < keys.size() && out < k; ++j)
      emit(keys[j] % shift, static_cast<uint8_t>(keys[j] / shift));
    for (int j = 0; j < n_tie && out < k; ++j)
      emit(tie_bins[j], static_cast<uint8_t>(vt));
    for (; out < k; ++out) {
      ob[out] = -1;
      oi[out] = 0;
      op[out] = 0;
    }
  }
}

// ---------------- host-side CA-CFAR filter ----------------
//
// Exclusive CA-CFAR candidate extraction (the reference dispatches CFAR
// INSTEAD of k-strongest, radar_driver.cpp:52-57; detection test
// cfar.cpp:35-71). Semantics are bit-identical to the device filter
// (`ops/filtering.py:cacfar_mask` + `cfar_select`): integer window sums of
// squared intensities (exact in int32), detection via the cross-multiplied
// f32 comparison 2*I^2*t_cnt*f_cnt > alpha*(t_sum*f_cnt + f_sum*t_cnt), and
// per-azimuth top-Kc selection ordered by (intensity, bin) descending with
// overflow dropping the weakest detections. Peak flags are always 0 on this
// path (the reference publishes an empty peaks cloud for CFAR).

void cfar_rows(const uint8_t* images, int64_t r, int kc, int win, int guard,
               float alpha, float dr, float min_dist, float max_dist,
               float static_th, int16_t* out_bins, uint8_t* out_intens,
               uint8_t* out_peaks, int64_t row_begin, int64_t row_end) {
  std::vector<int32_t> prefix(r + 1);
  std::vector<int32_t> keys;
  keys.reserve(r);
  int shift = 1;
  while (shift < r) shift <<= 1;
  for (int64_t row = row_begin; row < row_end; ++row) {
    const uint8_t* img = images + row * r;
    prefix[0] = 0;
    for (int64_t b = 0; b < r; ++b)
      prefix[b + 1] = prefix[b] + int32_t(img[b]) * int32_t(img[b]);
    keys.clear();
    for (int64_t b = 0; b < r; ++b) {
      const float rng = float(b) * dr;
      if (!(rng > min_dist) || !(rng < max_dist)) continue;
      if (!(float(img[b]) > static_th)) continue;
      const int32_t t_lo = std::max<int32_t>(0, int32_t(b) - guard - win);
      const int32_t t_hi = std::min<int32_t>(r, std::max<int32_t>(0, int32_t(b) - guard));
      const int32_t f_lo = std::min<int32_t>(r, std::max<int32_t>(0, int32_t(b) + guard));
      const int32_t f_hi = std::min<int32_t>(r, int32_t(b) + guard + win);
      const int32_t t_cnt = t_hi - t_lo;
      const int32_t f_cnt = f_hi - f_lo;
      if (t_cnt <= 0 || f_cnt <= 0) continue;
      const int32_t t_sum = prefix[t_hi] - prefix[t_lo];
      const int32_t f_sum = prefix[f_hi] - prefix[f_lo];
      const int32_t sq = int32_t(img[b]) * int32_t(img[b]);
      const float lhs = float(2 * sq * t_cnt * f_cnt);
      const float rhs = alpha * float(t_sum * f_cnt + f_sum * t_cnt);
      if (lhs > rhs)
        keys.push_back(int32_t(img[b]) * shift + int32_t(b));
    }
    std::sort(keys.begin(), keys.end(), std::greater<int32_t>());
    int16_t* ob = out_bins + row * kc;
    uint8_t* oi = out_intens + row * kc;
    uint8_t* op = out_peaks + row * kc;
    int out = 0;
    for (size_t j = 0; j < keys.size() && out < kc; ++j, ++out) {
      ob[out] = static_cast<int16_t>(keys[j] % shift);
      oi[out] = static_cast<uint8_t>(keys[j] / shift);
      op[out] = 0;
    }
    for (; out < kc; ++out) {
      ob[out] = -1;
      oi[out] = 0;
      op[out] = 0;
    }
  }
}

}  // namespace

// ---------------- point-budget compaction ----------------
//
// Reduces a frame's (A, K) candidate set to exactly `budget` rows, selected
// by (intensity descending, flat azimuth-major index ascending) among
// candidates that pass the min-range bin gate — the same set AND order the
// device-side row compaction produces (`ops/features.py` point_budget:
// stable argsort of -intensity over the flattened (A*K) cloud whose
// validity already includes the `bin > min_bin` gate of
// `radar_filters.cpp:324-330`). Doing it on the host removes a ~2 ms
// device-side sort per batched step and shrinks the link transfer.
// Counting sort by intensity: O(A*K + 256) per frame.

namespace {

void budget_frames(const int16_t* bins, const uint8_t* intens,
                   const uint8_t* peaks, int64_t a, int64_t k, int budget,
                   int min_bin, int16_t* out_bins, int16_t* out_az,
                   uint8_t* out_intens, uint8_t* out_peaks,
                   int64_t frame_begin, int64_t frame_end) {
  const int64_t n = a * k;
  for (int64_t f = frame_begin; f < frame_end; ++f) {
    const int16_t* fb = bins + f * n;
    const uint8_t* fi = intens + f * n;
    const uint8_t* fp = peaks + f * n;
    int16_t* ob = out_bins + f * budget;
    int16_t* oa = out_az + f * budget;
    uint8_t* oi = out_intens + f * budget;
    uint8_t* op = out_peaks + f * budget;
    // pass 1: histogram of gated candidates
    int32_t hist[256] = {0};
    for (int64_t i = 0; i < n; ++i)
      if (fb[i] > min_bin) hist[fi[i]]++;
    // per-intensity output start offsets, filling from the strongest down
    int32_t start[256];
    int32_t quota[256];
    int32_t used = 0;
    for (int v = 255; v >= 0; --v) {
      start[v] = used;
      int32_t q = hist[v];
      if (used + q > budget) q = budget - used;
      quota[v] = q;
      used += q;
    }
    // pass 2: place candidates in (intensity desc, flat asc) order
    int32_t remaining = used;
    for (int64_t i = 0; i < n && remaining > 0; ++i) {
      if (fb[i] <= min_bin) continue;
      const int v = fi[i];
      if (quota[v] <= 0) continue;
      const int32_t pos = start[v]++;
      quota[v]--;
      remaining--;
      ob[pos] = fb[i];
      oa[pos] = static_cast<int16_t>(i / k);
      oi[pos] = fi[i];
      op[pos] = fp[i];
    }
    // pad
    for (int32_t i = used; i < budget; ++i) {
      ob[i] = -1;
      oa[i] = 0;
      oi[i] = 0;
      op[i] = 0;
    }
  }
}

}  // namespace

extern "C" {

// candidates (T, A, K) -> (T, budget) compacted rows.
void cfear_budget_compact(const int16_t* bins, const uint8_t* intens,
                          const uint8_t* peaks, int64_t t, int64_t a,
                          int64_t k, int budget, int min_bin,
                          int16_t* out_bins, int16_t* out_az,
                          uint8_t* out_intens, uint8_t* out_peaks,
                          int n_threads) {
  if (n_threads <= 1 || t < 2) {
    budget_frames(bins, intens, peaks, a, k, budget, min_bin, out_bins,
                  out_az, out_intens, out_peaks, 0, t);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (t + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int64_t lo = i * per;
    int64_t hi = lo + per > t ? t : lo + per;
    if (lo >= hi) break;
    threads.emplace_back(budget_frames, bins, intens, peaks, a, k, budget,
                         min_bin, out_bins, out_az, out_intens, out_peaks,
                         lo, hi);
  }
  for (auto& th : threads) th.join();
}

// images: (T, A, R) uint8. Outputs: (T, A, Kc) int16 / uint8 / uint8.
void cfear_cfar_filter_frames(const uint8_t* images, int64_t t, int64_t a,
                              int64_t r, int kc, int win, int guard,
                              float alpha, float dr, float min_dist,
                              float max_dist, float static_th,
                              int16_t* out_bins, uint8_t* out_intens,
                              uint8_t* out_peaks, int n_threads) {
  const int64_t n_rows = t * a;
  if (n_threads <= 1 || n_rows < 64) {
    cfar_rows(images, r, kc, win, guard, alpha, dr, min_dist, max_dist,
              static_th, out_bins, out_intens, out_peaks, 0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_rows + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int64_t lo = i * per;
    int64_t hi = lo + per > n_rows ? n_rows : lo + per;
    if (lo >= hi) break;
    threads.emplace_back(cfar_rows, images, r, kc, win, guard, alpha, dr,
                         min_dist, max_dist, static_th, out_bins, out_intens,
                         out_peaks, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Adaptive per-frame noise thresholds (bit-identical twin of
// `ops/filtering.py:frame_noise_threshold`): out_z[f] = max(z_min,
// q_thr + 1) with q_thr the smallest uint8 value whose frame CDF reaches
// q_count pixels (q_count = ceil(q * a * r), computed by the caller so
// host and device share one integer rule).
void cfear_frame_thresholds(const uint8_t* images, int64_t t, int64_t a,
                            int64_t r, int64_t q_count, int z_min,
                            int32_t* out_z, int n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t f = lo; f < hi; ++f) {
      const uint8_t* img = images + f * a * r;
      int64_t hist[256] = {0};
      for (int64_t i = 0; i < a * r; ++i) hist[img[i]]++;
      int64_t cdf = 0;
      int q_thr = 255;
      for (int v = 0; v < 256; ++v) {
        cdf += hist[v];
        if (cdf >= q_count) { q_thr = v; break; }
      }
      int z = q_thr + 1;
      out_z[f] = z > z_min ? z : z_min;
    }
  };
  if (n_threads <= 1 || t < 4) { work(0, t); return; }
  std::vector<std::thread> threads;
  int64_t per = (t + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int64_t lo = i * per, hi = lo + per > t ? t : lo + per;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// cfear_filter_frames with a per-frame threshold array (adaptive mode).
void cfear_filter_frames_z(const uint8_t* images, int64_t t, int64_t a,
                           int64_t r, int k, const int32_t* z_frames, int w,
                           int16_t* out_bins, uint8_t* out_intens,
                           uint8_t* out_peaks, int n_threads) {
  const int64_t n_rows = t * a;
  if (n_threads <= 1 || n_rows < 64) {
    filter_rows(images, n_rows, r, k, 0, w, out_bins, out_intens,
                out_peaks, 0, n_rows, z_frames, a);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_rows + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int64_t lo = i * per;
    int64_t hi = lo + per > n_rows ? n_rows : lo + per;
    if (lo >= hi) break;
    threads.emplace_back(filter_rows, images, n_rows, r, k, 0, w,
                         out_bins, out_intens, out_peaks, lo, hi,
                         z_frames, a);
  }
  for (auto& th : threads) th.join();
}

// images: (T, A, R) uint8. Outputs: (T, A, K) int16 / uint8 / uint8.
void cfear_filter_frames(const uint8_t* images, int64_t t, int64_t a,
                         int64_t r, int k, int z_min, int w,
                         int16_t* out_bins, uint8_t* out_intens,
                         uint8_t* out_peaks, int n_threads) {
  const int64_t n_rows = t * a;
  if (n_threads <= 1 || n_rows < 64) {
    filter_rows(images, n_rows, r, k, z_min, w, out_bins, out_intens,
                out_peaks, 0, n_rows, nullptr, 0);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_rows + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int64_t lo = i * per;
    int64_t hi = lo + per > n_rows ? n_rows : lo + per;
    if (lo >= hi) break;
    threads.emplace_back(filter_rows, images, n_rows, r, k, z_min, w,
                         out_bins, out_intens, out_peaks, lo, hi,
                         nullptr, static_cast<int64_t>(0));
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
