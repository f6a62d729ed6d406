// Deterministic shuffling for the native loaders (a copy of the JAX
// package's native/pddl_rng.h). Every loader built on it (the packed
// loader, pddl_io.cpp, and the TFRecord reader still to be ported) must
// produce identical per-epoch orders for the same seed, so the PRNG and
// the epoch-seeding scheme live here once.
#ifndef PDDL_RNG_H_
#define PDDL_RNG_H_

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace pddl {

// Deterministic 64-bit xorshift.
struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
};

// In-place Fisher-Yates reshuffle of an index order, reseeded per epoch.
inline void epoch_shuffle(std::vector<size_t>& order, uint64_t seed,
                          long epoch) {
  XorShift rng(seed + 0x1000003ull * (uint64_t)(epoch + 1));
  for (size_t i = order.size(); i > 1; --i) {
    size_t j = rng.next() % i;
    std::swap(order[i - 1], order[j]);
  }
}

}  // namespace pddl

#endif  // PDDL_RNG_H_
