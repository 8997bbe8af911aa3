// merge_fold_compact.cu — the merge-path kernels of the two-level count
// table's consolidation for Hopper (sm_90a): one template over (B stored
// descending, run fold, compaction), instantiated for four variants.
//
// Replaces four Pallas kernels of kmer_counter_tpu/ops/pallas_sort.py:
//   K1 _merge_pair_fold_compact_bitonic_call (merge_fold_compact_bitonic):
//      B descending, fold, compact
//   K3 _merge_pair_fold_bitonic_call (merge_sorted_runs_fold_bitonic):
//      B descending, fold
//   K4 _merge_pair_fold_call (merge_sorted_runs_fold): B ascending, fold
//   K5 _merge_pair_call (merge_sorted_runs): B ascending, no fold
//
// Every variant merges A = NL key lanes + a value lane, sorted ascending,
// with B = NL key lanes + a value lane, sorted ascending or stored
// descending, into one ascending stream of na+nb rows; on equal keys A
// comes first.
//   * No fold (K5): the value lane rides along as a payload; the merged
//     rows are written as they are.
//   * Fold (K3, K4): every run of equal keys gets its total count mod 2^32
//     on its LAST row and 0 on every other row; runs whose key is the
//     all-ones sentinel get 0 throughout.  Rows stay at their merged index.
//   * Fold + compact (K1): one row per run whose key is not the sentinel
//     and whose total is not 0, carrying the total, packed to the front;
//     every row after them holds the sentinel key and count 0.
// Liveness comes from the count only, never from the key (dead B rows of
// the descending raw sort carry all-zero keys, bit-identical to a genuine
// A^k record, and count 0).
//
// What bounds it: memory.  Per merged row the kernels do a few dozen
// integer compares but move (NL+1)*4 bytes in and (NL+1)*4 bytes out of
// device memory, far below the card's compute-to-bandwidth ratio.  The
// least time is 2*(na+nb)*(NL+1)*4 bytes at 3.35 TB/s.
//
// Design.  The TPU kernels rely on their grid running tiles in order: the
// partial sum of a run that crosses a tile edge and the output offset are
// carried from one grid step to the next in SMEM.  CUDA blocks run in no
// order, so the work is split into passes whose cross-tile state is a
// handful of numbers per tile:
//   1. splits:  one thread per tile boundary finds the merge-path split of
//      diagonal t*TILE by binary search (for a descending B through the
//      reversed index nb-1-j, as _diag_splits_pair_desc does).
//   2. stats (fold variants): each block stages its two windows in shared
//      memory, merges them (a merge-path search per thread, then a serial
//      merge of ITEMS rows), finds run heads and ends against the merged
//      stream's neighbours of the tile, and runs one block-wide segmented
//      scan.  It writes per-tile numbers: the count sum, the partial sum of
//      the run open at the tile's start, and the number of live rows that
//      end here.
//   3. (torch, between launches) scans of those per-tile numbers give each
//      tile its incoming run carry and, for K1, its output offset.
//   4. write:   each block merges its tile again; K5 writes it out; K3/K4
//      complete the run totals with the carry and write every row at its
//      merged index; K1 ranks its live rows with a block scan, writes them
//      at its offset, and fills its share of the rows past the live count.
// Merging twice instead of storing the merged stream reads A and B twice
// but needs no n-row scratch: 2 reads + 1 write of (NL+1)*4 bytes per row
// (K5: 1 read + 1 write).  The TPU kernels read once; fusing the passes
// (decoupled look-back) is later work.  Blocks mask their own ragged edge,
// so n needs no alignment.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#include "lanes.cuh"

namespace {

using lanes::key_le;
using lanes::merge_path_split;
using lanes::Ops;
using lanes::OutOps;
using lanes::smem_le;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // merged rows per block

// The variants (the wrapper passes one as an int).
enum Variant {
  kMergeFoldCompactDesc = 0,  // K1
  kMergeFoldDesc = 1,         // K3
  kMergeFold = 2,             // K4
  kMerge = 3,                 // K5
  kNumVariants
};

__host__ __device__ constexpr bool b_desc(int v) {
  return v == kMergeFoldCompactDesc || v == kMergeFoldDesc;
}
__host__ __device__ constexpr bool folds(int v) { return v != kMerge; }

// Rows of the per-tile stats array [kNumStats, num_tiles] (int64).
enum Stat {
  kTileSum = 0,  // sum of the tile's counts, mod 2^32
  kHasEnd,       // 1 if a run ends inside the tile
  kOpenSum,      // counts of the run open at the tile's start, up to its end here
  kHasOpen,      // 1 if that open run ends inside the tile
  kOpenSent,     // 1 if that open run's key is the sentinel
  kLiveLocal,    // live rows among the runs that start inside the tile
  kTail,         // counts after the tile's last run end (if it has one)
  kNumStats
};

template <int NL>
__device__ __forceinline__ void load_a(const Ops& a, long long i, uint32_t* key) {
#pragma unroll
  for (int l = 0; l < NL; ++l) key[l] = a.p[l][i];
}

// B's row of ascending index j: row nb-1-j when B is stored descending.
template <int NL, bool kBDesc>
__device__ __forceinline__ void load_b_asc(const Ops& b, long long nb, long long j,
                                           uint32_t* key) {
  const long long row = kBDesc ? nb - 1 - j : j;
#pragma unroll
  for (int l = 0; l < NL; ++l) key[l] = b.p[l][row];
}

template <int NL>
struct TileSmem {
  uint32_t ops[NL + 1][kTile];  // the tile's rows; merged in place
  uint32_t prev[NL];            // merged row just before the tile
  uint32_t next[NL];            // merged row just after the tile
  int has_prev;
  int has_next;
};

template <int NL>
__device__ __forceinline__ bool smem_eq(const TileSmem<NL>& sm, int x, int y) {
  bool eq = true;
#pragma unroll
  for (int l = 0; l < NL; ++l) eq &= sm.ops[l][x] == sm.ops[l][y];
  return eq;
}

template <int NL>
__device__ __forceinline__ bool smem_eq_key(const TileSmem<NL>& sm, int x,
                                            const uint32_t* key) {
  bool eq = true;
#pragma unroll
  for (int l = 0; l < NL; ++l) eq &= sm.ops[l][x] == key[l];
  return eq;
}

template <int NL>
__device__ __forceinline__ bool smem_is_sentinel(const TileSmem<NL>& sm, int x) {
  bool s = true;
#pragma unroll
  for (int l = 0; l < NL; ++l) s &= sm.ops[l][x] == 0xFFFFFFFFu;
  return s;
}

// Merge-path split of diagonal d: the number of A rows among the first d
// merged rows (A first on equal keys).
template <int NL, bool kBDesc>
__global__ void splits_kernel(Ops a, Ops b, long long na, long long nb,
                              long long num_tiles, long long* splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > num_tiles) return;
  const long long n = na + nb;
  const long long d = t * kTile < n ? t * kTile : n;
  splits[t] = merge_path_split(d, na, nb, [&](long long i, long long j) {
    uint32_t ka[NL], kb[NL];
    load_a<NL>(a, i, ka);
    load_b_asc<NL, kBDesc>(b, nb, j, kb);
    return key_le<NL>(ka, kb);
  });
}

// Stages tile t's windows of A and B in shared memory and merges them in
// place; records the merged stream's neighbours of the tile.  Returns the
// tile's row count.
template <int NL, bool kBDesc>
__device__ int merge_tile(const Ops& a, const Ops& b, long long na, long long nb,
                          const long long* splits, long long t, TileSmem<NL>& sm) {
  const long long n = na + nb;
  const long long d0 = t * kTile;
  const long long d1 = d0 + kTile < n ? d0 + kTile : n;
  const long long i0 = splits[t], i1 = splits[t + 1];
  const long long j0 = d0 - i0, j1 = d1 - i1;
  const int la = (int)(i1 - i0);
  const int lb = (int)(j1 - j0);
  const int len = la + lb;

  // A's window ascending at [0, la); B's window ascending at [la, len).  A
  // descending B's window (rows [nb-j1, nb-j0), read forward) is reversed.
  for (int r = threadIdx.x; r < la; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) sm.ops[l][r] = a.p[l][i0 + r];
  }
  if (kBDesc) {
    const long long b_row0 = nb - j1;
    for (int r = threadIdx.x; r < lb; r += kThreads) {
#pragma unroll
      for (int l = 0; l <= NL; ++l) sm.ops[l][len - 1 - r] = b.p[l][b_row0 + r];
    }
  } else {
    for (int r = threadIdx.x; r < lb; r += kThreads) {
#pragma unroll
      for (int l = 0; l <= NL; ++l) sm.ops[l][la + r] = b.p[l][j0 + r];
    }
  }
  if (threadIdx.x == 0) {
    // The row before the tile is the larger of the last consumed A and B
    // rows; the row after it the smaller of the next unconsumed ones.
    uint32_t ka[NL], kb[NL];
    sm.has_prev = d0 > 0;
    if (d0 > 0) {
      const bool use_a = i0 > 0, use_b = j0 > 0;
      if (use_a) load_a<NL>(a, i0 - 1, ka);
      if (use_b) load_b_asc<NL, kBDesc>(b, nb, j0 - 1, kb);
      const bool pick_a = use_a && (!use_b || key_le<NL>(kb, ka));
#pragma unroll
      for (int l = 0; l < NL; ++l) sm.prev[l] = pick_a ? ka[l] : kb[l];
    }
    sm.has_next = d1 < n;
    if (d1 < n) {
      const bool use_a = i1 < na, use_b = j1 < nb;
      if (use_a) load_a<NL>(a, i1, ka);
      if (use_b) load_b_asc<NL, kBDesc>(b, nb, j1, kb);
      const bool pick_a = use_a && (!use_b || key_le<NL>(ka, kb));
#pragma unroll
      for (int l = 0; l < NL; ++l) sm.next[l] = pick_a ? ka[l] : kb[l];
    }
  }
  __syncthreads();

  // Thread i merges output rows [i*kItems, (i+1)*kItems) of the tile.
  const int diag = min((int)threadIdx.x * kItems, len);
  const int lo = merge_path_split(diag, la, lb, [&](int i, int j) {
    return smem_le<NL>(sm, i, la + j);
  });
  int ia = lo, ib = la + diag - lo;
  uint32_t reg[kItems][NL + 1];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (diag + q < len) {
      const bool take_a = ib >= len || (ia < la && smem_le<NL>(sm, ia, ib));
      const int src = take_a ? ia++ : ib++;
#pragma unroll
      for (int l = 0; l <= NL; ++l) reg[q][l] = sm.ops[l][src];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (diag + q < len) {
#pragma unroll
      for (int l = 0; l <= NL; ++l) sm.ops[l][diag + q] = reg[q][l];
    }
  }
  __syncthreads();
  return len;
}

// Segmented-scan element: flag = a run head was seen; seg = counts since
// the last head (or since the tile's start when flag is 0); tot = all
// counts.  uint32 arithmetic wraps mod 2^32, as the counts do.
struct Seg {
  uint32_t flag, seg, tot;
};
struct SegOp {
  __device__ __forceinline__ Seg operator()(const Seg& x, const Seg& y) const {
    return Seg{x.flag | y.flag, y.flag ? y.seg : x.seg + y.seg, x.tot + y.tot};
  }
};
using SegScan = cub::BlockScan<Seg, kThreads>;
using RankScan = cub::BlockScan<int, kThreads>;

struct Items {
  Seg seg[kItems];  // inclusive segmented scan at each of the thread's rows
  bool end[kItems];
  bool sent[kItems];
};

// Run heads/ends of the thread's rows and the block-wide segmented scan of
// their counts.  Returns the block aggregate (tot = the tile's count sum).
template <int NL>
__device__ Seg scan_tile(const TileSmem<NL>& sm, int len, SegScan::TempStorage& tmp,
                         Items& it) {
  const int base = threadIdx.x * kItems;
  Seg item[kItems];
  Seg agg{0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int p = base + q;
    bool head = false, end = false, sent = false;
    uint32_t c = 0u;
    if (p < len) {
      head = p == 0 ? (!sm.has_prev || !smem_eq_key<NL>(sm, 0, sm.prev))
                    : !smem_eq<NL>(sm, p - 1, p);
      end = p == len - 1 ? (!sm.has_next || !smem_eq_key<NL>(sm, p, sm.next))
                         : !smem_eq<NL>(sm, p, p + 1);
      sent = smem_is_sentinel<NL>(sm, p);
      c = sm.ops[NL][p];
    }
    it.end[q] = end;
    it.sent[q] = sent;
    item[q] = Seg{head ? 1u : 0u, c, c};
    agg = SegOp()(agg, item[q]);
  }
  Seg excl, total;
  SegScan(tmp).ExclusiveScan(agg, excl, Seg{0u, 0u, 0u}, SegOp(), total);
  Seg run = excl;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    run = SegOp()(run, item[q]);
    it.seg[q] = run;
  }
  return total;
}

template <int NL, bool kBDesc>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(Ops a, Ops b, long long na, long long nb, const long long* splits,
                 long long num_tiles, long long* stats) {
  __shared__ TileSmem<NL> sm;
  __shared__ SegScan::TempStorage scan_tmp;
  __shared__ int s_has_end, s_has_open, s_open_sent, s_live;
  __shared__ uint32_t s_open_sum, s_tail;
  const long long t = blockIdx.x;
  if (threadIdx.x == 0) {
    s_has_end = s_has_open = s_open_sent = s_live = 0;
    s_open_sum = s_tail = 0u;
  }
  const int len = merge_tile<NL, kBDesc>(a, b, na, nb, splits, t, sm);
  Items it;
  const Seg total = scan_tile<NL>(sm, len, scan_tmp, it);
  int live = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int p = threadIdx.x * kItems + q;
    if (p < len && it.end[q]) {
      s_has_end = 1;
      if (it.seg[q].flag) {
        live += (!it.sent[q] && it.seg[q].seg != 0u) ? 1 : 0;
      } else {
        // At most one row per tile ends a run with no head in the tile.
        s_has_open = 1;
        s_open_sum = it.seg[q].seg;
        s_open_sent = it.sent[q] ? 1 : 0;
      }
    }
    if (p == len - 1) s_tail = it.end[q] ? 0u : it.seg[q].seg;
  }
  if (live) atomicAdd(&s_live, live);
  __syncthreads();
  if (threadIdx.x == 0) {
    stats[kTileSum * num_tiles + t] = total.tot;
    stats[kHasEnd * num_tiles + t] = s_has_end;
    stats[kOpenSum * num_tiles + t] = s_open_sum;
    stats[kHasOpen * num_tiles + t] = s_has_open;
    stats[kOpenSent * num_tiles + t] = s_open_sent;
    stats[kLiveLocal * num_tiles + t] = s_live;
    stats[kTail * num_tiles + t] = s_tail;
  }
}

// The last pass of every variant.  carry, out_off and live_total are read
// only by the variants that need them (fold: carry; compact: all three).
template <int NL, int V>
__global__ void __launch_bounds__(kThreads)
    write_kernel(Ops a, Ops b, OutOps out, long long na, long long nb,
                 const long long* splits, const long long* carry,
                 const long long* out_off, const long long* live_total) {
  constexpr bool kBDesc = b_desc(V);
  __shared__ TileSmem<NL> sm;
  __shared__ union {
    SegScan::TempStorage seg;
    RankScan::TempStorage rank;
  } tmp;
  const long long t = blockIdx.x;
  const long long d0 = t * kTile;
  const int len = merge_tile<NL, kBDesc>(a, b, na, nb, splits, t, sm);
  if (folds(V)) {
    Items it;
    scan_tile<NL>(sm, len, tmp.seg, it);
    const uint32_t carry_in = (uint32_t)carry[t];
    uint32_t total[kItems];
    bool alive[kItems];
    int n_alive = 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int p = threadIdx.x * kItems + q;
      total[q] = it.seg[q].flag ? it.seg[q].seg : carry_in + it.seg[q].seg;
      alive[q] = p < len && it.end[q] && !it.sent[q] &&
                 (V != kMergeFoldCompactDesc || total[q] != 0u);
      n_alive += alive[q] ? 1 : 0;
    }
    __syncthreads();  // every row's count is read; tmp.seg is free
    if (V == kMergeFoldCompactDesc) {
      int rank;
      RankScan(tmp.rank).ExclusiveSum(n_alive, rank);
      long long pos = out_off[t] + rank;
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (alive[q]) {
          const int p = threadIdx.x * kItems + q;
#pragma unroll
          for (int l = 0; l < NL; ++l) out.p[l][pos] = sm.ops[l][p];
          out.p[NL][pos] = total[q];
          ++pos;
        }
      }
      // This tile's share of the rows past the live ones: sentinel key,
      // count 0.
      const long long n = na + nb;
      const long long d1 = d0 + kTile < n ? d0 + kTile : n;
      const long long lt = *live_total;
      for (long long r = (d0 > lt ? d0 : lt) + threadIdx.x; r < d1; r += kThreads) {
#pragma unroll
        for (int l = 0; l < NL; ++l) out.p[l][r] = 0xFFFFFFFFu;
        out.p[NL][r] = 0u;
      }
      return;
    }
    // K3/K4: the folded counts replace the tile's counts in place.
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int p = threadIdx.x * kItems + q;
      if (p < len) sm.ops[NL][p] = alive[q] ? total[q] : 0u;
    }
    __syncthreads();
  }
  // K3/K4/K5: the tile's merged rows at their merged index.
  for (int r = threadIdx.x; r < len; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) out.p[l][d0 + r] = sm.ops[l][r];
  }
}

long long num_tiles(long long n) { return lanes::num_tiles(n, kTile); }

template <int NL, bool kBDesc>
int run_splits(const Ops& a, const Ops& b, long long na, long long nb, long long* splits,
               cudaStream_t stream) {
  const long long tiles = num_tiles(na + nb);
  const long long blocks = (tiles + 1 + 255) / 256;
  splits_kernel<NL, kBDesc><<<(unsigned)blocks, 256, 0, stream>>>(a, b, na, nb, tiles, splits);
  return cudaGetLastError();
}

template <int NL, bool kBDesc>
int run_stats(const Ops& a, const Ops& b, long long na, long long nb,
              const long long* splits, long long* stats, cudaStream_t stream) {
  const long long tiles = num_tiles(na + nb);
  stats_kernel<NL, kBDesc><<<(unsigned)tiles, kThreads, 0, stream>>>(a, b, na, nb, splits,
                                                                     tiles, stats);
  return cudaGetLastError();
}

struct WriteArgs {
  Ops a, b;
  OutOps out;
  long long na, nb;
  const long long *splits, *carry, *out_off, *live_total;
  cudaStream_t stream;
};

template <int NL, int V>
int run_write(const WriteArgs& w) {
  const long long tiles = num_tiles(w.na + w.nb);
  write_kernel<NL, V><<<(unsigned)tiles, kThreads, 0, w.stream>>>(
      w.a, w.b, w.out, w.na, w.nb, w.splits, w.carry, w.out_off, w.live_total);
  return cudaGetLastError();
}

template <int NL>
int write_variant(int variant, const WriteArgs& w) {
  switch (variant) {
    case kMergeFoldCompactDesc: return run_write<NL, kMergeFoldCompactDesc>(w);
    case kMergeFoldDesc: return run_write<NL, kMergeFoldDesc>(w);
    case kMergeFold: return run_write<NL, kMergeFold>(w);
    case kMerge: return run_write<NL, kMerge>(w);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One switch over the key-lane count, shared by the entry points below:
// CALL(NL) must be an expression that returns the cudaError_t as an int.
#define MFC_DISPATCH_NL(num_keys, CALL) \
  switch (num_keys) {                   \
    case 1: return CALL(1);             \
    case 2: return CALL(2);             \
    case 3: return CALL(3);             \
    case 4: return CALL(4);             \
    case 5: return CALL(5);             \
    case 6: return CALL(6);             \
    case 7: return CALL(7);             \
    case 8: return CALL(8);             \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

int mfc_tile_rows() { return kTile; }

int mfc_num_stats() { return kNumStats; }

int mfc_num_variants() { return kNumVariants; }

// Pass 1.  a_ptrs / b_ptrs: host arrays of num_keys+1 device pointers (key
// lanes, then the value lane).  splits: [num_tiles+1] int64.  Returns a
// cudaError_t.
int mfc_splits(const void* const* a_ptrs, const void* const* b_ptrs, int variant,
               int num_keys, long long na, long long nb, void* splits, void* stream) {
  if (variant < 0 || variant >= kNumVariants) return (int)cudaErrorInvalidValue;
  const Ops a = lanes::make_ops(a_ptrs, num_keys + 1);
  const Ops b = lanes::make_ops(b_ptrs, num_keys + 1);
  auto* sp = static_cast<long long*>(splits);
  auto s = static_cast<cudaStream_t>(stream);
#define MFC_SPLITS_CALL(NL)                                      \
  (b_desc(variant) ? run_splits<NL, true>(a, b, na, nb, sp, s) \
                   : run_splits<NL, false>(a, b, na, nb, sp, s))
  MFC_DISPATCH_NL(num_keys, MFC_SPLITS_CALL)
}

// Pass 2, for the fold variants.  stats: [kNumStats, num_tiles] int64.
int mfc_stats(const void* const* a_ptrs, const void* const* b_ptrs, int variant,
              int num_keys, long long na, long long nb, const void* splits, void* stats,
              void* stream) {
  if (variant < 0 || variant >= kNumVariants || !folds(variant)) {
    return (int)cudaErrorInvalidValue;
  }
  const Ops a = lanes::make_ops(a_ptrs, num_keys + 1);
  const Ops b = lanes::make_ops(b_ptrs, num_keys + 1);
  auto* sp = static_cast<const long long*>(splits);
  auto* st = static_cast<long long*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
#define MFC_STATS_CALL(NL)                                              \
  (b_desc(variant) ? run_stats<NL, true>(a, b, na, nb, sp, st, s) \
                   : run_stats<NL, false>(a, b, na, nb, sp, st, s))
  MFC_DISPATCH_NL(num_keys, MFC_STATS_CALL)
}

// Pass 4.  out_ptrs: host array of num_keys+1 device pointers to [na+nb]
// rows; carry (fold variants), out_off and live_total (K1): [num_tiles]
// int64 and one int64; the pointers a variant does not read may be null.
int mfc_write(const void* const* a_ptrs, const void* const* b_ptrs, void* const* out_ptrs,
              int variant, int num_keys, long long na, long long nb, const void* splits,
              const void* carry, const void* out_off, const void* live_total,
              void* stream) {
  WriteArgs w;
  w.a = lanes::make_ops(a_ptrs, num_keys + 1);
  w.b = lanes::make_ops(b_ptrs, num_keys + 1);
  w.out = lanes::make_out_ops(out_ptrs, num_keys + 1);
  w.na = na;
  w.nb = nb;
  w.splits = static_cast<const long long*>(splits);
  w.carry = static_cast<const long long*>(carry);
  w.out_off = static_cast<const long long*>(out_off);
  w.live_total = static_cast<const long long*>(live_total);
  w.stream = static_cast<cudaStream_t>(stream);
#define MFC_WRITE_CALL(NL) write_variant<NL>(variant, w)
  MFC_DISPATCH_NL(num_keys, MFC_WRITE_CALL)
}

}  // extern "C"
