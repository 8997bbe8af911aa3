// lanes.cuh — what the package's kernels share: rows of NL uint32 key lanes
// plus one uint32 value lane (a count or a payload), held as one device
// array per lane, the merge-path split that merges two sorted runs of such
// rows, and the padded shared-memory tile the merges run in.  Included by
// every source of csrc/.
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

// A tile of kT rows of NL key lanes + one value lane in (dynamic) shared
// memory: lane l of row r lives at word l*padded(kT) + pad(r), one spare
// word after every 32 rows, so that a warp's blocked accesses (thread i at
// row i*k + q, k a power of two up to 32) and striped ones (row b + i)
// touch 32 distinct banks.
__host__ __device__ constexpr int padded(int rows) { return rows + rows / 32; }
__device__ __forceinline__ int pad(int r) { return r + (r >> 5); }

template <int NL, int kT>
struct Tile {
  uint32_t* w;
  __device__ __forceinline__ uint32_t& at(int l, int r) const { return w[l * padded(kT) + pad(r)]; }
  // Rows x <= y (key_le).
  __device__ __forceinline__ bool le(int x, int y) const {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (at(l, x) != at(l, y)) return at(l, x) < at(l, y);
    }
    return true;
  }
};

// Rows [0, len) of lane p (device memory) written from get(row) by a block
// of kThreads: 16-byte stores, with the head and tail rows (at most 3 each)
// one word at a time.
template <int kThreads, class Get>
__device__ __forceinline__ void store_lane(uint32_t* p, int len, Get get) {
  const int head = head_rows(p, len);
  const int body = (len - head) >> 2;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (int i = threadIdx.x; i < body; i += kThreads) {
    const int r = head + 4 * i;
    v[i] = make_uint4(get(r), get(r + 1), get(r + 2), get(r + 3));
  }
  if (threadIdx.x < 6) {
    const int r = (int)threadIdx.x < head ? (int)threadIdx.x : (int)threadIdx.x + 4 * body;
    if (r < len) p[r] = get(r);
  }
}

// Rows [at, at+cnt) of a tile from a thread's registers.
template <int NL, int kT, int kI>
__device__ __forceinline__ void store_rows(const Tile<NL, kT>& sm, int at, int cnt,
                                           const uint32_t (&reg)[kI][NL + 1]) {
#pragma unroll
  for (int q = 0; q < kI; ++q) {
    if (q < cnt) {
#pragma unroll
      for (int l = 0; l <= NL; ++l) sm.at(l, at + q) = reg[q][l];
    }
  }
}

// Output rows [diag, diag+cnt) of the merge of the tile's sorted runs A =
// rows [a0, a0+la) and B = [b0, b0+lb), A first on ties, into reg.  The
// keys of the next A row and the next B row wait in registers, so each
// row's lanes are read from shared memory once.
template <int NL, int kT, int kI>
__device__ __forceinline__ void merge_rows(const Tile<NL, kT>& sm, int a0, int la, int b0, int lb,
                                           int diag, int cnt, uint32_t (&reg)[kI][NL + 1]) {
  int ia = merge_path_split(diag, la, lb, [&](int i, int j) { return sm.le(a0 + i, b0 + j); });
  int ib = diag - ia;
  uint32_t ka[NL], kb[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    ka[l] = ia < la ? sm.at(l, a0 + ia) : 0u;
    kb[l] = ib < lb ? sm.at(l, b0 + ib) : 0u;
  }
#pragma unroll
  for (int q = 0; q < kI; ++q) {
    if (q < cnt) {
      const bool take_a = ib >= lb || (ia < la && key_le<NL>(ka, kb));
      reg[q][NL] = sm.at(NL, take_a ? a0 + ia : b0 + ib);
#pragma unroll
      for (int l = 0; l < NL; ++l) reg[q][l] = take_a ? ka[l] : kb[l];
      if (take_a) {
        if (++ia < la) {
#pragma unroll
          for (int l = 0; l < NL; ++l) ka[l] = sm.at(l, a0 + ia);
        }
      } else if (++ib < lb) {
#pragma unroll
        for (int l = 0; l < NL; ++l) kb[l] = sm.at(l, b0 + ib);
      }
    }
  }
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
