// Native data-loader runtime of pddl_tpu_torch (a copy of the JAX
// package's native/pddl_io.cpp: the same C ABI, the same packed format and
// the same batches for the same file and seed).
//
// The counterpart of the reference's C++ input substrate (every map, batch,
// prefetch and shard call of the reference runs inside TensorFlow's C++
// tf.data runtime). It provides that layer for the packed-sample format
// written by pddl_tpu_torch.data.native_loader:
//
//   * worker thread pool reading + assembling fixed-shape batches
//   * bounded ring buffer (prefetch queue) between IO threads and the
//     training loop — the .prefetch(AUTOTUNE) analogue
//   * deterministic per-epoch shuffling (seeded xorshift + Fisher-Yates),
//     per-process sharding for multi-host input (auto-shard DATA analogue)
//   * zero-copy handoff: batches land directly in caller-owned numpy
//     buffers (pinned once, reused)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
//
// Packed file format "PDL1" (little-endian):
//   magic u32 'PDL1' | u32 n_samples | u16 height | u16 width | u16 chans
//   | u16 reserved | then per sample: i32 label + h*w*c bytes (uint8 HWC).

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

#include "pddl_rng.h"

namespace {

constexpr uint32_t kMagic = 0x314C4450;  // "PDL1"

struct SampleRef {
  uint32_t file;    // index into files_
  uint64_t offset;  // byte offset of the sample record
};

struct Batch {
  std::vector<uint8_t> images;
  std::vector<int32_t> labels;
  long epoch;
};


class Loader {
 public:
  Loader(std::vector<std::string> paths, int batch, int shuffle,
         uint64_t seed, int shard_index, int shard_count, int prefetch_depth,
         int n_workers, int drop_remainder, int loop)
      : paths_(std::move(paths)),
        batch_(batch),
        shuffle_(shuffle),
        seed_(seed),
        shard_index_(shard_index),
        shard_count_(shard_count),
        depth_(std::max(1, prefetch_depth)),
        drop_remainder_(drop_remainder),
        loop_(loop) {
    if (!index()) {
      ok_ = false;
      return;
    }
    int workers = std::max(1, n_workers);
    for (int i = 0; i < workers; ++i) {
      threads_.emplace_back([this, i] { worker(i); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_slots_.notify_all();
    cv_items_.notify_all();
    for (auto& t : threads_) t.join();
  }

  bool ok() const { return ok_; }
  int height() const { return h_; }
  int width() const { return w_; }
  int channels() const { return c_; }
  long num_samples() const { return (long)samples_.size(); }
  long batches_per_epoch() const {
    long n = (long)samples_.size();
    return drop_remainder_ ? n / batch_ : (n + batch_ - 1) / batch_;
  }

  // Blocking pop into caller buffers. Returns the number of samples in the
  // batch (0 = end of epoch for non-looping loaders).
  int next(uint8_t* images_out, int32_t* labels_out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_items_.wait(lk, [this] {
      return stop_ || !queue_.empty() || (done_epoch_ && in_flight_ == 0);
    });
    if (stop_) return -1;
    if (queue_.empty()) return 0;  // epoch exhausted; reset() starts the next
    Batch b = std::move(queue_.front());
    queue_.pop();
    lk.unlock();
    cv_slots_.notify_one();
    int n = (int)b.labels.size();
    std::memcpy(images_out, b.images.data(), b.images.size());
    std::memcpy(labels_out, b.labels.data(), n * sizeof(int32_t));
    return n;
  }

  void reset() {
    std::unique_lock<std::mutex> lk(mu_);
    ++epoch_;
    done_epoch_ = false;
    cursor_ = 0;
    // Discard batches the workers prefetched past the epoch boundary (only
    // possible for non-drop_remainder tails).
    while (!queue_.empty()) queue_.pop();
    reshuffle();
    lk.unlock();
    cv_slots_.notify_all();
  }

 private:
  bool index() {
    for (uint32_t fi = 0; fi < paths_.size(); ++fi) {
      FILE* f = std::fopen(paths_[fi].c_str(), "rb");
      if (!f) return false;
      uint32_t magic = 0, count = 0;
      uint16_t h = 0, w = 0, c = 0, reserved = 0;
      if (std::fread(&magic, 4, 1, f) != 1 || magic != kMagic ||
          std::fread(&count, 4, 1, f) != 1 || std::fread(&h, 2, 1, f) != 1 ||
          std::fread(&w, 2, 1, f) != 1 || std::fread(&c, 2, 1, f) != 1 ||
          std::fread(&reserved, 2, 1, f) != 1) {
        std::fclose(f);
        return false;
      }
      if (h_ == 0) {
        h_ = h;
        w_ = w;
        c_ = c;
      } else if (h != h_ || w != w_ || c != c_) {
        std::fclose(f);
        return false;  // heterogeneous shapes across files
      }
      uint64_t sample_bytes = 4ull + (uint64_t)h_ * w_ * c_;
      uint64_t off = 16;
      for (uint32_t i = 0; i < count; ++i) {
        // Per-process sharding: every shard_count-th sample (DATA policy).
        if ((all_count_ % shard_count_) == (uint64_t)shard_index_) {
          samples_.push_back({fi, off});
        }
        ++all_count_;
        off += sample_bytes;
      }
      std::fclose(f);
    }
    order_.resize(samples_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    reshuffle();
    return !samples_.empty();
  }

  void reshuffle() {  // call with mu_ held (or before threads start)
    if (shuffle_) pddl::epoch_shuffle(order_, seed_, epoch_);
  }

  void worker(int) {
    // One pread-style FILE* per worker per file (no shared seek state).
    std::vector<FILE*> files;
    for (auto& p : paths_) files.push_back(std::fopen(p.c_str(), "rb"));
    uint64_t image_bytes = (uint64_t)h_ * w_ * c_;

    while (true) {
      // Claim the next batch's sample indices under the lock (order_ may be
      // reshuffled by another worker at an epoch boundary — copy, don't
      // alias).
      std::vector<size_t> idxs;
      long epoch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_slots_.wait(lk, [this] {
          return stop_ ||
                 (!done_epoch_ && queue_.size() + in_flight_ < (size_t)depth_);
        });
        if (stop_) break;
        size_t begin = cursor_;
        size_t end = std::min(begin + (size_t)batch_, samples_.size());
        if (begin >= samples_.size() ||
            (drop_remainder_ && end - begin < (size_t)batch_)) {
          if (loop_) {
            ++epoch_;
            cursor_ = 0;
            reshuffle();
            continue;
          }
          done_epoch_ = true;
          lk.unlock();
          cv_items_.notify_all();
          continue;
        }
        cursor_ = end;
        idxs.assign(order_.begin() + begin, order_.begin() + end);
        ++in_flight_;
        epoch = epoch_;
      }

      Batch b;
      b.epoch = epoch;
      b.labels.resize(idxs.size());
      b.images.resize(idxs.size() * image_bytes);
      bool read_ok = true;
      for (size_t i = 0; i < idxs.size(); ++i) {
        const SampleRef& s = samples_[idxs[i]];
        FILE* f = files[s.file];
        if (!f || std::fseek(f, (long)s.offset, SEEK_SET) != 0) {
          read_ok = false;
          break;
        }
        int32_t label;
        if (std::fread(&label, 4, 1, f) != 1) {
          read_ok = false;
          break;
        }
        b.labels[i] = label;
        if (std::fread(b.images.data() + i * image_bytes, 1, image_bytes,
                       f) != image_bytes) {
          read_ok = false;
          break;
        }
      }

      {
        std::lock_guard<std::mutex> lk(mu_);
        --in_flight_;
        // Drop batches assembled for an epoch that reset() superseded —
        // their shuffle order is stale and their samples will be re-read.
        if (read_ok && b.epoch == epoch_) queue_.push(std::move(b));
      }
      cv_items_.notify_one();
      cv_slots_.notify_one();
    }
    for (FILE* f : files)
      if (f) std::fclose(f);
  }

  std::vector<std::string> paths_;
  int batch_, shuffle_;
  uint64_t seed_;
  int shard_index_, shard_count_, depth_, drop_remainder_, loop_;
  int h_ = 0, w_ = 0, c_ = 0;
  uint64_t all_count_ = 0;
  std::vector<SampleRef> samples_;
  std::vector<size_t> order_;
  std::vector<std::thread> threads_;

  std::mutex mu_;
  std::condition_variable cv_items_, cv_slots_;
  std::queue<Batch> queue_;
  size_t cursor_ = 0, in_flight_ = 0;
  long epoch_ = 0;
  bool done_epoch_ = false, stop_ = false, ok_ = true;
};

}  // namespace

extern "C" {

void* pddl_loader_open(const char** paths, int n_paths, int batch,
                       int shuffle, uint64_t seed, int shard_index,
                       int shard_count, int prefetch_depth, int n_workers,
                       int drop_remainder, int loop) {
  std::vector<std::string> ps;
  for (int i = 0; i < n_paths; ++i) ps.emplace_back(paths[i]);
  if (shard_count < 1 || shard_index < 0 || shard_index >= shard_count ||
      batch < 1)
    return nullptr;
  auto* l = new Loader(std::move(ps), batch, shuffle, seed, shard_index,
                       shard_count, prefetch_depth, n_workers, drop_remainder,
                       loop);
  if (!l->ok()) {
    delete l;
    return nullptr;
  }
  return l;
}

int pddl_loader_shape(void* handle, int* h, int* w, int* c) {
  auto* l = static_cast<Loader*>(handle);
  *h = l->height();
  *w = l->width();
  *c = l->channels();
  return 0;
}

long pddl_loader_num_samples(void* handle) {
  return static_cast<Loader*>(handle)->num_samples();
}

long pddl_loader_batches_per_epoch(void* handle) {
  return static_cast<Loader*>(handle)->batches_per_epoch();
}

// Returns samples filled (0 = end of epoch, -1 = closed).
int pddl_loader_next(void* handle, uint8_t* images, int32_t* labels) {
  return static_cast<Loader*>(handle)->next(images, labels);
}

void pddl_loader_reset(void* handle) {
  static_cast<Loader*>(handle)->reset();
}

void pddl_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
