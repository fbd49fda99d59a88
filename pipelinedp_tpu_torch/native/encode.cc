// Host-side integer factorization for the fused-plane encoder.
//
// np.unique(return_inverse=True) sorts all N rows (O(N log N) with a
// full-size permutation); ingest only needs a dense vocabulary, which a
// grow-as-needed open-addressing hash builds in O(N + U log U) for U
// distinct keys (U << N for keyed DP datasets). The unique values are
// returned ASCENDING and the inverse indexes into that sorted order, so
// the result is bit-identical to np.unique — callers can swap freely.
//
// Build: compiled on first use by pipelinedp_tpu_torch/native/__init__.py
// (_build_shared_lib) with the same g++ recipe as secure_noise.cc.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

struct Table {
  // Parallel arrays: keys_ holds the key, ids_ holds its first-appearance
  // id (-1 = empty slot).
  std::vector<int64_t> keys_;
  std::vector<int32_t> ids_;
  uint64_t mask_ = 0;
  int64_t size_ = 0;

  explicit Table(uint64_t cap_pow2) {
    keys_.resize(cap_pow2);
    ids_.assign(cap_pow2, -1);
    mask_ = cap_pow2 - 1;
  }

  // Returns the id of `key`, inserting with id `next_id` when absent.
  inline int32_t lookup_or_insert(int64_t key, int32_t next_id) {
    uint64_t slot = fmix64(static_cast<uint64_t>(key)) & mask_;
    while (true) {
      int32_t id = ids_[slot];
      if (id == -1) {
        keys_[slot] = key;
        ids_[slot] = next_id;
        ++size_;
        return next_id;
      }
      if (keys_[slot] == key) return id;
      slot = (slot + 1) & mask_;
    }
  }

  bool needs_grow() const {
    return static_cast<uint64_t>(size_) * 10 >= (mask_ + 1) * 7;
  }
};

}  // namespace

extern "C" {

// Factorizes `in[0..n)`: writes sorted unique values to `out_uniq`
// (capacity must be >= number of uniques; n always suffices) and the
// rank of each input among them to `out_inverse[0..n)`. Returns the
// number of uniques, -1 on allocation failure, or -2 when an early
// sample finds mostly-distinct keys — there the table degenerates to
// ~2N cache-missing slots plus an O(N log N) vocabulary sort, and the
// caller's np.unique is the better algorithm.
int64_t pdp_factorize_i64(const int64_t* in, int64_t n,
                          int32_t* out_inverse, int64_t* out_uniq) {
  // Distinctness probe: an eighth of the way in, mostly-new keys imply
  // the degenerate U~N regime. Probing earlier misclassifies
  // moderate vocabularies (a 200k vocab still looks "mostly new" in the
  // first 2^17 rows); probing at n/8 costs at most 12.5% extra work on
  // the bail path.
  const int64_t bail_check_at = (n >> 3) >= (1 << 17) ? (n >> 3) : -1;
  try {
    uint64_t cap = 1 << 10;
    Table table(cap);
    std::vector<int64_t> uniq;  // first-appearance order
    uniq.reserve(1 << 10);
    for (int64_t i = 0; i < n; ++i) {
      if (i == bail_check_at &&
          static_cast<int64_t>(uniq.size()) * 5 > i * 3) {
        return -2;
      }
      if (table.needs_grow()) {
        Table bigger((table.mask_ + 1) * 2);
        for (uint64_t s = 0; s <= table.mask_; ++s) {
          if (table.ids_[s] != -1) {
            bigger.lookup_or_insert(table.keys_[s], table.ids_[s]);
          }
        }
        bigger.size_ = table.size_;
        table = std::move(bigger);
      }
      if (uniq.size() >= 0x7fffffffULL) return -1;  // int32 id overflow
      int32_t next = static_cast<int32_t>(uniq.size());
      int32_t id = table.lookup_or_insert(in[i], next);
      if (id == next) uniq.push_back(in[i]);
      out_inverse[i] = id;  // first-appearance id; remapped below
    }

    // Sort the vocabulary and remap first-appearance ids to sorted ranks.
    const int64_t u = static_cast<int64_t>(uniq.size());
    std::vector<int32_t> order(u);
    for (int64_t i = 0; i < u; ++i) order[i] = static_cast<int32_t>(i);
    std::sort(order.begin(), order.end(),
              [&uniq](int32_t a, int32_t b) { return uniq[a] < uniq[b]; });
    std::vector<int32_t> rank(u);
    for (int64_t r = 0; r < u; ++r) {
      rank[order[r]] = static_cast<int32_t>(r);
      out_uniq[r] = uniq[order[r]];
    }
    for (int64_t i = 0; i < n; ++i) {
      out_inverse[i] = rank[out_inverse[i]];
    }
    return u;
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
