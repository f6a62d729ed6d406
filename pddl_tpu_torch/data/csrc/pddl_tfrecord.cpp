// Native TFRecord reader of pddl_tpu_torch (a copy of the JAX package's
// native/pddl_tfrecord.cpp: the same C ABI, and the same records in the
// same order for the same files, shards and seed).
//
// The reference's ImageNet ingest runs on TFDS-prepared TFRecord shards,
// read and validated inside TensorFlow's C++ tf.data runtime
// (SURVEY.md §2b C15 — imagenet-resnet50.py:20-34). This file is the
// framework's own record-level substrate for that path:
//
//   * full-file indexing of the TFRecord framing
//     (u64 length | u32 masked-crc32c(length) | payload | u32
//     masked-crc32c(payload)) with CRC validation, so corruption is
//     detected at open time rather than mid-epoch
//   * per-process sharding over the global record sequence (the DATA
//     auto-shard analogue, imagenet-resnet50-multiworkers.py:66-69)
//   * deterministic per-epoch shuffling (same xorshift/Fisher-Yates
//     scheme as the packed loader)
//   * a reader thread filling a bounded record queue, overlapping disk
//     IO with the consumer — the .prefetch(AUTOTUNE) analogue
//
// Payload decode (tf.Example proto, JPEG) stays above this layer, exactly
// as TFRecordDataset is decode-agnostic in tf.data.
//
// Plain C ABI, ctypes-consumed (no pybind11).

#include <algorithm>
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

// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), byte-table driven.
struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
  }
};

uint32_t crc32c(const uint8_t* data, size_t n) {
  static const Crc32cTable table;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table.t[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// TFRecord's masking, applied so CRCs stored alongside CRC-bearing data
// don't collide with themselves.
uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t c = crc32c(data, n);
  return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

struct RecordRef {
  uint32_t file;
  uint64_t offset;  // offset of the 12-byte header
  uint32_t length;  // payload bytes
};

struct QueuedRecord {
  std::vector<uint8_t> payload;
  bool bad = false;  // read or payload-CRC failure at this position
};

class TFRecordReader {
 public:
  TFRecordReader(std::vector<std::string> paths, int shuffle, uint64_t seed,
                 int shard_index, int shard_count, int verify_payload_crc,
                 int prefetch_depth)
      : paths_(std::move(paths)),
        shuffle_(shuffle),
        seed_(seed),
        shard_index_(shard_index),
        shard_count_(shard_count),
        verify_(verify_payload_crc),
        depth_(std::max(1, prefetch_depth)) {
    if (!index()) {
      ok_ = false;
      return;
    }
    reader_ = std::thread([this] { reader_main(); });
  }

  ~TFRecordReader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_slots_.notify_all();
    cv_items_.notify_all();
    if (reader_.joinable()) reader_.join();
  }

  bool ok() const { return ok_; }
  long count() const { return (long)records_.size(); }
  long total_count() const { return (long)all_count_; }
  long max_length() const { return (long)max_len_; }

  // Blocking pop of the next record into caller memory. Returns payload
  // bytes written (>= 0 — zero-length records are legal TFRecord framing),
  // -4 at end of epoch, -1 closed, -2 cap too small, -3 a read/CRC error
  // was hit at this position.
  long next(uint8_t* out, long cap) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_items_.wait(lk, [this] {
      return stop_ || !queue_.empty() || done_epoch_;
    });
    if (stop_) return -1;
    if (queue_.empty()) return -4;  // epoch exhausted; reset() rearms
    if ((long)queue_.front().payload.size() > cap)
      return -2;  // leave the record queued; caller can retry bigger
    QueuedRecord rec = std::move(queue_.front());
    queue_.pop();
    lk.unlock();
    cv_slots_.notify_one();
    if (rec.bad) return -3;
    std::memcpy(out, rec.payload.data(), rec.payload.size());
    return (long)rec.payload.size();
  }

  void reset() {
    std::unique_lock<std::mutex> lk(mu_);
    ++epoch_;
    done_epoch_ = false;
    cursor_ = 0;
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
      uint64_t off = 0;
      while (true) {
        uint8_t hdr[12];
        size_t got = std::fread(hdr, 1, 12, f);
        if (got == 0) break;  // clean EOF
        if (got != 12) {
          std::fclose(f);
          return false;  // truncated header
        }
        uint64_t len;
        uint32_t len_crc;
        std::memcpy(&len, hdr, 8);
        std::memcpy(&len_crc, hdr + 8, 4);
        if (masked_crc(hdr, 8) != len_crc || len > (1ull << 31)) {
          std::fclose(f);
          return false;  // corrupt length field
        }
        // Skip payload + its CRC at index time; payload CRC is checked on
        // read (if verify_) so indexing a pod-scale shard set stays fast.
        if (std::fseek(f, (long)(len + 4), SEEK_CUR) != 0) {
          std::fclose(f);
          return false;
        }
        if ((all_count_ % shard_count_) == (uint64_t)shard_index_) {
          records_.push_back({fi, off, (uint32_t)len});
          max_len_ = std::max(max_len_, len);
        }
        ++all_count_;
        off += 12 + len + 4;
      }
      std::fclose(f);
    }
    order_.resize(records_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    reshuffle();
    return !records_.empty();
  }

  void reshuffle() {  // call with mu_ held (or before the thread starts)
    if (shuffle_) pddl::epoch_shuffle(order_, seed_, epoch_);
  }

  void reader_main() {
    // Files open lazily and stay cached up to a cap, so a pod-scale shard
    // set (ImageNet: 1024 train files) never exhausts the fd limit.
    constexpr size_t kMaxOpenFiles = 64;
    std::vector<FILE*> files(paths_.size(), nullptr);
    std::vector<uint32_t> open_order;
    auto file_for = [&](uint32_t fi) -> FILE* {
      if (files[fi]) return files[fi];
      if (open_order.size() >= kMaxOpenFiles) {
        uint32_t evict = open_order.front();
        open_order.erase(open_order.begin());
        std::fclose(files[evict]);
        files[evict] = nullptr;
      }
      files[fi] = std::fopen(paths_[fi].c_str(), "rb");
      if (files[fi]) open_order.push_back(fi);
      return files[fi];
    };

    while (true) {
      size_t idx;
      long epoch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_slots_.wait(lk, [this] {
          return stop_ || (!done_epoch_ && queue_.size() < (size_t)depth_);
        });
        if (stop_) break;
        if (cursor_ >= records_.size()) {
          done_epoch_ = true;
          lk.unlock();
          cv_items_.notify_all();
          continue;
        }
        idx = order_[cursor_++];
        epoch = epoch_;
      }

      const RecordRef& r = records_[idx];
      QueuedRecord rec;
      rec.payload.resize(r.length);
      FILE* f = file_for(r.file);
      if (!f || std::fseek(f, (long)(r.offset + 12), SEEK_SET) != 0 ||
          (r.length && std::fread(rec.payload.data(), 1, r.length, f) !=
                           r.length)) {
        rec.bad = true;
      } else if (verify_) {
        uint32_t stored;
        if (std::fread(&stored, 4, 1, f) != 1 ||
            masked_crc(rec.payload.data(), rec.payload.size()) != stored)
          rec.bad = true;
      }
      if (rec.bad) rec.payload.clear();

      {
        std::lock_guard<std::mutex> lk(mu_);
        if (epoch == epoch_) queue_.push(std::move(rec));
      }
      cv_items_.notify_one();
    }
    for (FILE* f : files)
      if (f) std::fclose(f);
  }

  std::vector<std::string> paths_;
  int shuffle_;
  uint64_t seed_;
  int shard_index_, shard_count_, verify_, depth_;
  uint64_t all_count_ = 0, max_len_ = 0;
  std::vector<RecordRef> records_;
  std::vector<size_t> order_;
  std::thread reader_;

  std::mutex mu_;
  std::condition_variable cv_items_, cv_slots_;
  std::queue<QueuedRecord> queue_;
  size_t cursor_ = 0;
  long epoch_ = 0;
  bool done_epoch_ = false, stop_ = false, ok_ = true;
};

}  // namespace

extern "C" {

void* pddl_tfr_open(const char** paths, int n_paths, int shuffle,
                    uint64_t seed, int shard_index, int shard_count,
                    int verify_payload_crc, int prefetch_depth) {
  if (shard_count < 1 || shard_index < 0 || shard_index >= shard_count)
    return nullptr;
  std::vector<std::string> ps;
  for (int i = 0; i < n_paths; ++i) ps.emplace_back(paths[i]);
  auto* r = new TFRecordReader(std::move(ps), shuffle, seed, shard_index,
                               shard_count, verify_payload_crc,
                               prefetch_depth);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

long pddl_tfr_count(void* h) {
  return static_cast<TFRecordReader*>(h)->count();
}

long pddl_tfr_total_count(void* h) {
  return static_cast<TFRecordReader*>(h)->total_count();
}

long pddl_tfr_max_length(void* h) {
  return static_cast<TFRecordReader*>(h)->max_length();
}

long pddl_tfr_next(void* h, uint8_t* out, long cap) {
  return static_cast<TFRecordReader*>(h)->next(out, cap);
}

void pddl_tfr_reset(void* h) { static_cast<TFRecordReader*>(h)->reset(); }

void pddl_tfr_close(void* h) { delete static_cast<TFRecordReader*>(h); }

// Exposed for parity tests against Python/TF implementations.
uint32_t pddl_crc32c(const uint8_t* data, long n) {
  return crc32c(data, (size_t)n);
}

uint32_t pddl_masked_crc32c(const uint8_t* data, long n) {
  return masked_crc(data, (size_t)n);
}

}  // extern "C"
