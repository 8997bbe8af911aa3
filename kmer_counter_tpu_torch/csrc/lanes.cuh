// lanes.cuh — what the package's kernels share: rows of NL uint32 key lanes
// plus one uint32 value lane (a count or a payload), held as one device
// array per lane, and the merge-path split that merges two sorted runs of
// such rows.  Included by every source of csrc/.
#pragma once

#include <cstdint>

namespace lanes {

constexpr int kMaxOps = 9;  // 8 key lanes + the value lane

struct Ops {
  const uint32_t* p[kMaxOps];
};
struct OutOps {
  uint32_t* p[kMaxOps];
};

// Unsigned lexicographic x <= y over NL lanes, lane 0 most significant.
template <int NL>
__device__ __forceinline__ bool key_le(const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (x[l] != y[l]) return x[l] < y[l];
  }
  return true;
}

// The same order between rows x and y of a shared-memory tile S whose
// member ops[l][row] holds lane l.
template <int NL, class S>
__device__ __forceinline__ bool smem_le(const S& sm, int x, int y) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (sm.ops[l][x] != sm.ops[l][y]) return sm.ops[l][x] < sm.ops[l][y];
  }
  return true;
}

// Merge-path split of diagonal d in the merge of sorted runs A (la rows)
// and B (lb rows), A first on equal keys: the number of A rows among the
// first d merged rows.  a_le_b(i, j) is A row i <= B row j.  Every search
// of a merge that must partition its input exactly (the split kernels and
// the per-thread searches inside a block) goes through here, so all of
// them break ties the same way.
template <class Index, class LE>
__device__ __forceinline__ Index merge_path_split(Index d, Index la, Index lb, LE a_le_b) {
  Index lo = d > lb ? d - lb : 0;
  Index hi = d < la ? d : la;
  while (lo < hi) {
    const Index mid = (lo + hi) >> 1;
    if (a_le_b(mid, d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The rows (4-byte words) from p up to its first 16-byte boundary, at most
// len: where a lane's 16-byte accesses can start.  A lane may start at any
// word (a column slice of a wider table), so every 16-byte access to it has
// a head of up to 3 rows moved one word at a time.
template <class Index>
__device__ __forceinline__ Index head_rows(const void* p, Index len) {
  const Index h = (Index)(((16u - ((unsigned)(uintptr_t)p & 15u)) & 15u) >> 2);
  return h < len ? h : len;
}

inline Ops make_ops(const void* const* ptrs, int n_ops) {
  Ops o{};
  for (int i = 0; i < n_ops; ++i) o.p[i] = static_cast<const uint32_t*>(ptrs[i]);
  return o;
}

inline OutOps make_out_ops(void* const* ptrs, int n_ops) {
  OutOps o{};
  for (int i = 0; i < n_ops; ++i) o.p[i] = static_cast<uint32_t*>(ptrs[i]);
  return o;
}

inline long long num_tiles(long long n, long long tile) { return (n + tile - 1) / tile; }

}  // namespace lanes
