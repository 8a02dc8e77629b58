// A table split into equal row ranges over the cards of an index group
// (index/device.Shards, from index/device.upload_index_sharded), as the
// kernels of csrc/fm.cu and csrc/verify.cu read it in their SHARD instances.
//
// The reference's sharded fetch (bitmapperbs_tpu/ops/fm.py:46-69,
// ops/verify.py:105-112) gathers each device's local range, zeroes the rows
// of other devices and psums the partial rows.  Every row lives on exactly
// one shard, so that sum is the row itself, and a row outside every shard
// is a zero row.  A kernel here does the same with one load: it picks the
// shard that holds the row and reads it there (through peer access where
// the shard sits on another card); a row outside [0, n * rows) reads the
// zero row below and never touches the table.  That zero row is not a
// clamp: garbage lanes reach it and their output reaches the tuples, so the
// kernels keep their arithmetic on it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 8;          // ops/kernels.MAX_SHARDS
constexpr int kMaxRowWords = 17;       // the widest table row (checkpoints)

struct ShardSet {
  const uint32_t* part[kMaxShards];    // part s: rows [s * rows, (s + 1) * rows)
  // first[s]: the first row of part s, s * rows, for s < n; 0xFFFFFFFF for
  // the unused s >= n, which no row below n * rows < 2^32 reaches
  uint32_t first[kMaxShards];
  int64_t rows;                        // rows per part
  int n;                               // parts
};

__device__ const uint32_t kZeroRow[kMaxRowWords] = {};

// Row r (W words) of a shard set; n * rows < 2^32 (checked at the entry).
// The part is the last s whose first row r reaches: a compare against each
// part's first row, folded into the select over the kMaxShards pointers (no
// division on the chain of dependent rows an FM step loop walks).  The
// select is not an index into part[]: a kernel takes the set as a
// parameter, and an index computed at run time would make the compiler
// copy the whole parameter into each thread's local memory.
template <int W>
__device__ __forceinline__ const uint32_t* shard_row(const ShardSet& t,
                                                     int64_t r) {
  static_assert(W <= kMaxRowWords, "zero row too short");
  if (r < 0 || r >= t.rows * t.n) return kZeroRow;
  const uint32_t u = uint32_t(r);
  const uint32_t* p = t.part[0];
  uint32_t lo = 0u;
#pragma unroll
  for (int k = 1; k < kMaxShards; ++k) {
    if (u >= t.first[k]) {
      p = t.part[k];
      lo = t.first[k];
    }
  }
  return p + size_t(u - lo) * W;
}

// The host side: nparts device pointers of `rows` rows each -> ShardSet.
inline bool make_shard_set(const void* const* parts, int nparts, int64_t rows,
                           ShardSet* out) {
  if (parts == nullptr || nparts < 1 || nparts > kMaxShards || rows < 1 ||
      rows * nparts > int64_t(0xFFFFFFFFll))
    return false;
  for (int s = 0; s < kMaxShards; ++s) {
    out->part[s] = s < nparts ? static_cast<const uint32_t*>(parts[s])
                              : nullptr;
    out->first[s] = s < nparts ? uint32_t(s * rows) : 0xFFFFFFFFu;
  }
  out->rows = rows;
  out->n = nparts;
  return true;
}

// The kernels' table argument: a whole table (a pointer; `param` is the
// restrict-qualified one a kernel takes) or a shard set.
template <bool SHARD>
struct Table {
  using type = const uint32_t*;
  using param = const uint32_t* __restrict__;
};
template <>
struct Table<true> {
  using type = ShardSet;
  using param = ShardSet;
};

}  // namespace
