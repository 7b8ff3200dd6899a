// Native data-loader core: threaded batch producer with a lock-free-ish
// ring buffer.
//
// TPU-native replacement for the role tf.data's C++ runtime plays in the
// reference (yang-song's datasets.py:176-192 — 48-thread private
// threadpool feeding the host loop). The Python side hands us an in-memory
// uint8 NHWC dataset; worker threads assemble float32 batches (epoch
// shuffling, optional horizontal flip, optional uniform dequantization
// (u + 255x)/256, else /255) into a bounded ring of pinned host buffers the
// consumer drains without holding the GIL.
//
// C ABI (ctypes):
//   void* dl_create(const uint8_t* data, int64 n, int h, int w, int c,
//                   int batch, int flags, uint64 seed, int nthreads,
//                   int ring_depth);
//   void  dl_next(void* handle, float* out);     // blocks until a batch
//   void  dl_destroy(void* handle);
// flags: 1 = shuffle, 2 = random flip, 4 = uniform dequantization.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // uniform float in [0, 1)
  float uniform() { return (next() >> 40) * (1.0f / (1 << 24)); }
};

constexpr int kShuffle = 1;
constexpr int kFlip = 2;
constexpr int kDequant = 4;

struct Loader {
  const uint8_t* data;
  int64_t n;
  int h, w, c, batch, flags;
  uint64_t seed;
  size_t batch_elems;

  // ring of ready batches
  std::vector<std::vector<float>> ring;
  std::vector<bool> full;
  size_t head = 0, tail = 0;  // consumer reads head, producer writes tail
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::atomic<bool> stop{false};

  // global sample cursor protected by cursor_mu
  std::mutex cursor_mu;
  std::vector<int64_t> order;
  int64_t cursor = 0;
  uint64_t epoch = 0;

  std::vector<std::thread> workers;

  Loader(const uint8_t* d, int64_t n_, int h_, int w_, int c_, int batch_,
         int flags_, uint64_t seed_, int nthreads, int ring_depth)
      : data(d), n(n_), h(h_), w(w_), c(c_), batch(batch_), flags(flags_),
        seed(seed_) {
    batch_elems = static_cast<size_t>(batch) * h * w * c;
    ring.resize(ring_depth);
    full.assign(ring_depth, false);
    for (auto& b : ring) b.resize(batch_elems);
    order.resize(n);
    std::iota(order.begin(), order.end(), 0);
    reshuffle();
    for (int i = 0; i < nthreads; ++i)
      workers.emplace_back([this, i] { worker_loop(i); });
  }

  void reshuffle() {
    if (flags & kShuffle) {
      std::mt19937_64 rng(seed ^ (0x5851F42D4C957F2Dull * (epoch + 1)));
      std::shuffle(order.begin(), order.end(), rng);
    }
    cursor = 0;
  }

  // Claim `batch` sample indices (drop-remainder epoch semantics).
  void claim(std::vector<int64_t>& idx, uint64_t& tick) {
    std::lock_guard<std::mutex> lock(cursor_mu);
    if (cursor + batch > n) {  // drop remainder, next epoch
      ++epoch;
      reshuffle();
    }
    idx.assign(order.begin() + cursor, order.begin() + cursor + batch);
    cursor += batch;
    tick = epoch * (n / batch) + (cursor / batch);
  }

  void fill(std::vector<float>& out, const std::vector<int64_t>& idx,
            uint64_t tick) {
    const size_t img_elems = static_cast<size_t>(h) * w * c;
    SplitMix64 rng(seed * 0x9E3779B97F4A7C15ull + tick);
    for (int b = 0; b < batch; ++b) {
      const uint8_t* src = data + idx[b] * img_elems;
      float* dst = out.data() + b * img_elems;
      const bool flip = (flags & kFlip) && (rng.uniform() < 0.5f);
      if (flags & kDequant) {
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const uint8_t* s =
                src + (static_cast<size_t>(y) * w + (flip ? w - 1 - x : x)) * c;
            float* d = dst + (static_cast<size_t>(y) * w + x) * c;
            for (int ch = 0; ch < c; ++ch)
              d[ch] = (rng.uniform() + s[ch]) * (1.0f / 256.0f);
          }
      } else if (flip) {
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const uint8_t* s =
                src + (static_cast<size_t>(y) * w + (w - 1 - x)) * c;
            float* d = dst + (static_cast<size_t>(y) * w + x) * c;
            for (int ch = 0; ch < c; ++ch) d[ch] = s[ch] * (1.0f / 255.0f);
          }
      } else {
        for (size_t e = 0; e < img_elems; ++e)
          dst[e] = src[e] * (1.0f / 255.0f);
      }
    }
  }

  void worker_loop(int /*wid*/) {
    std::vector<int64_t> idx;
    std::vector<float> scratch(batch_elems);
    while (!stop.load(std::memory_order_relaxed)) {
      uint64_t tick;
      claim(idx, tick);
      fill(scratch, idx, tick);
      std::unique_lock<std::mutex> lock(mu);
      cv_producer.wait(lock, [this] {
        return stop.load(std::memory_order_relaxed) || !full[tail];
      });
      if (stop.load(std::memory_order_relaxed)) return;
      ring[tail].swap(scratch);
      full[tail] = true;
      tail = (tail + 1) % ring.size();
      cv_consumer.notify_one();
    }
  }

  void next(float* out) {
    std::unique_lock<std::mutex> lock(mu);
    cv_consumer.wait(lock, [this] { return full[head]; });
    std::memcpy(out, ring[head].data(), batch_elems * sizeof(float));
    full[head] = false;
    head = (head + 1) % ring.size();
    cv_producer.notify_one();
  }

  ~Loader() {
    stop.store(true);
    cv_producer.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* dl_create(const uint8_t* data, int64_t n, int h, int w, int c,
                int batch, int flags, uint64_t seed, int nthreads,
                int ring_depth) {
  if (nthreads < 1) nthreads = 1;
  if (ring_depth < 2) ring_depth = 2;
  return new Loader(data, n, h, w, c, batch, flags, seed, nthreads,
                    ring_depth);
}

void dl_next(void* handle, float* out) {
  static_cast<Loader*>(handle)->next(out);
}

void dl_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
