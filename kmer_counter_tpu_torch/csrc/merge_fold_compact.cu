// merge_fold_compact.cu — the merge-path kernels of the two-level count
// table's consolidation for Hopper (sm_90a).
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
//     every row after them holds the sentinel key and count 0.  The output
//     is out_rows wide (at most na+nb): live rows from out_rows on are not
//     written, and the live total counts them all.
// Liveness comes from the count only, never from the key (dead B rows of
// the descending raw sort carry all-zero keys, bit-identical to a genuine
// A^k record, and count 0).
//
// What bounds it: memory.  Per merged row the kernels do a few dozen
// integer compares but move (NL+1)*4 bytes in and out of device memory,
// far below the card's compute-to-bandwidth ratio.  The sentinel is the
// largest key, so the merged stream is S rows that are not the sentinel
// (A's and B's, S = nsa + nsb) and then sentinel rows only; in the two-level
// table most of A is its empty sentinel tail, and the raw region of K4
// ends in sentinel rows.  So K1, K3 and K4 need to read only the first S
// merged rows' inputs, and write every output row.
//
// K1, K3 and K4: one ticketed pass with a decoupled look-back (Merrill &
// Garland, 2016) that carries the run fold (fold_kernel):
//   1. A block takes a tile of kT merged rows from an atomic ticket, so
//      every tile before it belongs to a block that has started.  The block
//      of tile 0 first counts nsa and nsb (a warp-wide search each) and
//      publishes them; every other block waits for them.
//   2. A tile at or past S is all sentinel: K3 and K4 write sentinel keys
//      and count 0 there with 16-byte stores; K1 writes nothing (its live
//      rows all lie below S, and its fill writes the rest).  It reads none
//      of its rows.
//   3. Otherwise the tile is rows [d0, e), e = min(d0+kT, S): two warps find
//      the merge-path splits of d0 and e among the first nsa and nsb rows
//      (32 probes a round, first around the proportional point), and warp 1
//      loads the merged row e (when e < S) to tell whether the tile's last
//      row ends a run.  The block stages A's window and B's (reversed when
//      B is stored descending) with 16-byte loads, merges them in shared
//      memory (kI rows a thread, registers, written back), folds each
//      thread's rows into a Fold (below), then scans the threads' Folds
//      (cub) into the tile's aggregate.
//   4. Warp 0 publishes the aggregate, looks back over the status of the
//      tiles before (32 a round, one per lane) for their fold, publishes
//      the tile's inclusive fold.  Then K1 packs its live rows in shared
//      memory and writes those of rank below out_rows from their first
//      output row on, K3 and K4 their rows with their folded counts at
//      their merged index, all with 16-byte stores; for K3 and K4 the tile
//      that holds row S-1 fills its rows from S on.
//   5. K1: a write-only launch fills rows [min(live total, out_rows),
//      out_rows) with the sentinel key and count 0 (16-byte stores); the
//      block of the tile that holds row S-1 stores the live total.
// A tile's first row is never taken as a run head: the fold of the rows
// before it (the look-back's result) carries whatever was open.
//
// K5 keeps the two passes of the first port (a split kernel, then a write
// pass that merges each tile): its sentinel rows carry payloads, so it
// cannot skip them.  Blocks mask their own ragged edge, so n needs no
// alignment.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#include "lanes.cuh"

namespace {

using lanes::key_le;
using lanes::merge_path_split;
using lanes::merge_rows;
using lanes::Ops;
using lanes::OutOps;
using lanes::padded;
using lanes::smem_le;
using lanes::store_lane;
using lanes::store_rows;
using lanes::Tile;

constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// The variants (the wrapper passes one as an int).
enum Variant {
  kMergeFoldCompactDesc = 0,  // K1
  kMergeFoldDesc = 1,         // K3
  kMergeFold = 2,             // K4
  kMerge = 3,                 // K5
  kNumVariants
};

// =========================================================================
// K1, K3 and K4: fold_kernel
// =========================================================================

// Rows a thread and blocks an SM, per NL: a thread holds its kI merged rows
// ((NL + 1) * kI words) in registers, so kI shrinks and the blocks an SM
// with it as NL grows; a tile is 256 * kI rows in shared memory.
constexpr int kFoldThreads = 256;
template <int NL>
__host__ __device__ constexpr int fold_items() {
  return NL <= 2 ? 16 : 8;
}
template <int NL>
__host__ __device__ constexpr int fold_blocks_per_sm() {
  return NL <= 2 ? 3 : (NL <= 4 ? 4 : 2);
}
template <int NL>
__host__ __device__ constexpr int fold_tile() {
  return kFoldThreads * fold_items<NL>();
}
template <int NL>
__host__ __device__ constexpr int fold_smem() {
  return (NL + 1) * padded(fold_tile<NL>()) * 4;
}

// The run fold of a stretch of merged rows, a monoid under combine().
// A run end is a row whose key differs from the next merged row's.
struct Fold {
  uint32_t head_sum;  // counts up to and including the first run end
  uint32_t tail;      // counts after the last run end (all of them without one)
  long long live;     // runs that end after the first run end, total != 0
  int has_end;
};

__device__ __forceinline__ Fold combine(const Fold& x, const Fold& y) {
  if (!x.has_end) {
    if (y.has_end) return Fold{x.tail + y.head_sum, y.tail, y.live, 1};
    return Fold{0u, x.tail + y.tail, 0, 0};
  }
  if (!y.has_end) return Fold{x.head_sum, x.tail + y.tail, x.live, 1};
  return Fold{x.head_sum, y.tail, x.live + y.live + (x.tail + y.head_sum != 0u ? 1 : 0), 1};
}

struct FoldOp {
  __device__ __forceinline__ Fold operator()(const Fold& x, const Fold& y) const {
    return combine(x, y);
  }
};
using FoldScan = cub::BlockScan<Fold, kFoldThreads>;

// Live runs ended in the rows of f when they start at the stream's first
// row (whose run has no carry).
__device__ __forceinline__ long long live_count(const Fold& f) {
  return f.live + (f.has_end && f.head_sum != 0u ? 1 : 0);
}

// The scratch the wrapper zeroes: a header, then six status words per tile,
// the tile's aggregate fold and then its inclusive fold, three words each.
// Every published word carries its kind in its top two bits (kAggregate,
// kInclusive; nsa and nsb in the header carry kAggregate) and is written
// once, with one 64-bit store: a reader that sees the kind in all three
// words of a slot holds that slot's final value.  So no fence is needed,
// and a look-back round costs one round trip to memory.
enum Header {
  kNonSentA = 0,  // nsa
  kNonSentB,      // nsb
  kTicket,        // the next tile to take
  kLiveTotal,     // K1: live rows of the output
  kHeaderWords = 8
};
constexpr int kStatusWords = 6;
constexpr unsigned long long kAggregate = 1ull << 62, kInclusive = 2ull << 62, kKind = 3ull << 62;
constexpr unsigned long long kLiveBits = (1ull << 61) - 1;

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}
__device__ __forceinline__ void store_word(unsigned long long* w, unsigned long long x) {
  *reinterpret_cast<volatile unsigned long long*>(w) = x;
}

__device__ __forceinline__ void publish(unsigned long long* status, unsigned long long kind,
                                        const Fold& f) {
  unsigned long long* w = status + (kind == kInclusive ? 3 : 0);
  store_word(w, kind | f.head_sum);
  store_word(w + 1, kind | f.tail);
  store_word(w + 2, kind | (unsigned long long)f.has_end << 61 | (unsigned long long)f.live);
}

// A tile's status from its six words: 0 (nothing yet), kAggregate or
// kInclusive, and that slot's fold in f.
__device__ __forceinline__ unsigned long long decode(const unsigned long long (&w)[kStatusWords], Fold& f) {
  const bool incl = (w[3] & kKind) == kInclusive && (w[4] & kKind) == kInclusive &&
                    (w[5] & kKind) == kInclusive;
  const bool agg = (w[0] & kKind) == kAggregate && (w[1] & kKind) == kAggregate &&
                   (w[2] & kKind) == kAggregate;
  const int s = incl ? 3 : 0;
  f = Fold{(uint32_t)w[s], (uint32_t)w[s + 1], (long long)(w[s + 2] & kLiveBits), (int)(w[s + 2] >> 61 & 1)};
  return incl ? kInclusive : (agg ? kAggregate : 0);
}

__device__ __forceinline__ Fold shfl_down(const Fold& f, int o) {
  return Fold{__shfl_down_sync(0xFFFFFFFFu, f.head_sum, o), __shfl_down_sync(0xFFFFFFFFu, f.tail, o),
              __shfl_down_sync(0xFFFFFFFFu, f.live, o), __shfl_down_sync(0xFFFFFFFFu, f.has_end, o)};
}

// The fold of tiles [0, t), t > 0, found by one warp (as compact_live.cu's
// look-back, with an ordered reduction: the fold does not commute).  Lane 0
// first waits, with a growing pause, until tile t-1 has published
// something.  Then each round lane k reads the status of tile end-1-k; the
// warp waits while a tile nearer than the nearest inclusive fold has
// published nothing, folds the tiles from that inclusive fold up to tile
// end-1 (lane k+o's fold before lane k's, 5 shuffle rounds), prepends it to
// what it holds, and moves 32 tiles back when there was no inclusive fold.
// Tile 0 publishes its inclusive fold at once, so the walk ends there at
// the latest.  Every lane returns it.  (Two tiles a lane, 64 a round, took
// 3-5% longer.)
//
// Why one round trip a round matters: tiles are taken in ticket order by
// the hundreds of blocks resident on the card, so a look-back finds the
// tiles just before it still looking back themselves (only their
// aggregates out), as far back as the tiles in flight reach.
__device__ Fold look_back(const unsigned long long* status, long long t, int lane) {
  unsigned long long w[kStatusWords];
  Fold f;
  if (lane == 0) {
    for (unsigned ns = 32;; ns = ns < 1024 ? 2 * ns : ns) {
#pragma unroll
      for (int k = 0; k < kStatusWords; ++k) w[k] = load_word(status + kStatusWords * (t - 1) + k);
      if (decode(w, f)) break;
      __nanosleep(ns);
    }
  }
  __syncwarp();
  Fold excl{0u, 0u, 0, 0};
  unsigned ns = 32;
  for (long long end = t;;) {
    const long long i = end - 1 - lane;
#pragma unroll
    for (int k = 0; k < kStatusWords; ++k) {
      w[k] = i >= 0 ? load_word(status + kStatusWords * i + k) : (k < 3 ? 0ull : kInclusive);
    }
    const unsigned long long kind = decode(w, f);
    const unsigned incl = __ballot_sync(0xFFFFFFFFu, kind == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    if (__any_sync(0xFFFFFFFFu, lane <= stop && kind == 0)) {
      __nanosleep(ns);
      ns = ns < 1024 ? 2 * ns : ns;
      continue;
    }
    Fold x = lane <= stop ? f : Fold{0u, 0u, 0, 0};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Fold y = shfl_down(x, o);
      if (lane + o < 32) x = combine(y, x);
    }
    excl = combine(Fold{__shfl_sync(0xFFFFFFFFu, x.head_sum, 0), __shfl_sync(0xFFFFFFFFu, x.tail, 0),
                        __shfl_sync(0xFFFFFFFFu, x.live, 0), __shfl_sync(0xFFFFFFFFu, x.has_end, 0)},
                   excl);
    if (incl) return excl;
    end -= 32;
  }
}

// The first index in [lo, hi) where pred is false (pred is true up to some
// index and false from it on), or hi, found by one warp: each round lane k
// probes the last index of the k-th of 32 equal slices of the range, and
// the ballot names the slice that holds the change.  Every lane returns it.
template <class Pred>
__device__ long long warp_partition(long long lo, long long hi, Pred pred) {
  const int lane = threadIdx.x % 32;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + (lane + 1) * step - 1;
    const bool t = i < hi && pred(i);
    const long long c = __popc(__ballot_sync(0xFFFFFFFFu, t));
    const long long end = lo + (c + 1) * step - 1;
    lo += c * step;
    hi = end < hi ? end : hi;
  }
  return lo;
}

template <int NL>
__device__ __forceinline__ bool is_sentinel(const Ops& o, long long r) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (__ldg(o.p[l] + r) != kSentinel) return false;
  }
  return true;
}

// A row ra <= B row rb (device memory), reading lane after lane only while
// they are equal.
template <int NL>
__device__ __forceinline__ bool row_le(const Ops& a, long long ra, const Ops& b, long long rb) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const uint32_t x = __ldg(a.p[l] + ra), y = __ldg(b.p[l] + rb);
    if (x != y) return x < y;
  }
  return true;
}

// B's stored row of its ascending row j: nb-1-j when B is stored
// descending (kBDesc), j otherwise.
template <bool kBDesc>
__device__ __forceinline__ long long b_row(long long nb, long long j) {
  return kBDesc ? nb - 1 - j : j;
}

// The merge-path split of diagonal d <= nsa + nsb (A rows among the first d
// merged rows, A first on ties), computed by a whole warp among the rows
// that are not the sentinel.  Most splits lie near d's proportional point:
// first, lanes 0 and 1 test whether kNear candidates around it bracket the
// split, and if they do the search starts from those alone.
template <int NL, bool kBDesc>
__device__ long long fold_split(const Ops& a, const Ops& b, long long nb, long long nsa, long long nsb,
                                long long d) {
  const int lane = threadIdx.x % 32;
  long long lo = d > nsb ? d - nsb : 0, hi = d < nsa ? d : nsa;
  // A row i <= B's ascending row d-1-i
  auto a_le_b = [&](long long i) { return row_le<NL>(a, i, b, b_row<kBDesc>(nb, d - 1 - i)); };
  constexpr long long kNear = 32768;
  if (hi - lo > kNear) {
    const long long est = (long long)((double)d * (double)nsa / (double)(nsa + nsb));
    const long long w_lo = est - kNear / 2 > lo ? est - kNear / 2 : lo;
    const long long w_hi = w_lo + kNear < hi ? w_lo + kNear : hi;
    const long long i = lane == 0 ? w_lo - 1 : w_hi;  // split > w_lo-1, split <= w_hi
    bool holds = lane > 1 || (lane == 0 ? w_lo == lo : w_hi == hi);
    if (!holds) holds = a_le_b(i) == (lane == 0);
    if (__all_sync(0xFFFFFFFFu, holds)) {
      lo = w_lo;
      hi = w_hi;
    }
  }
  return warp_partition(lo, hi, a_le_b);
}

// A's window (rows [a_row, a_row+la)) to tile rows [0, la) and B's window
// (stored rows [b_first, b_first+lb)) to tile rows [la, la+lb), ascending:
// reversed when B is stored descending (kBDesc).  Every lane: 16-byte
// loads, and one word at a time for the up to 3 rows before each window's
// first 16-byte boundary and after its last; all of the block's loads are
// in flight before the first store to shared memory.
template <int NL, int kT, bool kBDesc>
__device__ __forceinline__ void stage_windows(const Ops& a, long long a_row, int la, const Ops& b,
                                              long long b_first, int lb, const Tile<NL, kT>& sm) {
  constexpr int kPer = kT / 4 / kFoldThreads;  // 16-byte loads per thread and lane, at most
  const int last = la + lb - 1;                // tile row of B's stored row 0 of a descending window
  // The tile row of the window's stored row r.
  auto b_at = [&](int r) { return kBDesc ? last - r : la + r; };
  uint4 x[NL + 1][kPer];
  uint32_t edge[NL + 1];
  const int e = threadIdx.x;  // thread e < 12 moves edge row e%6 of window e/6
#pragma unroll
  for (int l = 0; l <= NL; ++l) {
    const uint32_t* pa = a.p[l] + a_row;
    const uint32_t* pb = b.p[l] + b_first;
    const int ha = lanes::head_rows(pa, la), hb = lanes::head_rows(pb, lb);
    const int va = (la - ha) >> 2, vb = (lb - hb) >> 2;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = threadIdx.x + j * kFoldThreads;
      if (k < va) {
        x[l][j] = __ldg(reinterpret_cast<const uint4*>(pa + ha) + k);
      } else if (k - va < vb) {
        x[l][j] = __ldg(reinterpret_cast<const uint4*>(pb + hb) + (k - va));
      }
    }
    if (e < 12) {
      const int f = e % 6, len = e < 6 ? la : lb, h = e < 6 ? ha : hb, v = e < 6 ? va : vb;
      const int r = f < h ? f : f + 4 * v;
      if (r < len) edge[l] = __ldg((e < 6 ? pa : pb) + r);
    }
  }
#pragma unroll
  for (int l = 0; l <= NL; ++l) {
    const int ha = lanes::head_rows(a.p[l] + a_row, la), hb = lanes::head_rows(b.p[l] + b_first, lb);
    const int va = (la - ha) >> 2, vb = (lb - hb) >> 2;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = threadIdx.x + j * kFoldThreads;
      if (k < va) {
        const int r = ha + 4 * k;
        sm.at(l, r) = x[l][j].x;
        sm.at(l, r + 1) = x[l][j].y;
        sm.at(l, r + 2) = x[l][j].z;
        sm.at(l, r + 3) = x[l][j].w;
      } else if (k - va < vb) {
        const int r = hb + 4 * (k - va);
        sm.at(l, b_at(r)) = x[l][j].x;
        sm.at(l, b_at(r + 1)) = x[l][j].y;
        sm.at(l, b_at(r + 2)) = x[l][j].z;
        sm.at(l, b_at(r + 3)) = x[l][j].w;
      }
    }
    if (e < 12) {
      const int f = e % 6, len = e < 6 ? la : lb, h = e < 6 ? ha : hb, v = e < 6 ? va : vb;
      const int r = f < h ? f : f + 4 * v;
      if (r < len) sm.at(l, e < 6 ? r : b_at(r)) = edge[l];
    }
  }
}

// Rows [row, row+len) of every lane of `out`: the sentinel in the key
// lanes, 0 in the count lane; 16-byte stores, spread over `threads`
// threads numbered from g.
template <int NL>
__device__ __forceinline__ void fill_sentinel(const OutOps& out, long long row, long long len, long long g,
                                              long long threads) {
#pragma unroll
  for (int l = 0; l <= NL; ++l) {
    const uint32_t x = l < NL ? kSentinel : 0u;
    uint32_t* p = out.p[l] + row;
    const long long head = lanes::head_rows(p, len);
    const long long body = (len - head) / 4;
    uint4* v = reinterpret_cast<uint4*>(p + head);
    for (long long i = g; i < body; i += threads) v[i] = make_uint4(x, x, x, x);
    if (g < 6) {  // head rows [0, head), tail rows [head + 4*body, len)
      const long long r = g < head ? g : g + 4 * body;
      if (r < len) p[r] = x;
    }
  }
}

template <int NL>
__device__ __forceinline__ bool keys_equal(const uint32_t* x, const uint32_t* y) {
  bool eq = true;
#pragma unroll
  for (int l = 0; l < NL; ++l) eq &= x[l] == y[l];
  return eq;
}

// Merged row d (< nsa + nsb) from s, the split of d: A's row s or B's
// ascending row d - s, the smaller, A on ties.
template <int NL, bool kBDesc>
__device__ __forceinline__ void merged_row(const Ops& a, const Ops& b, long long nb, long long nsa,
                                           long long nsb, long long d, long long s, uint32_t* key) {
  uint32_t ka[NL], kb[NL];
  const bool use_a = s < nsa, use_b = d - s < nsb;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    ka[l] = use_a ? __ldg(a.p[l] + s) : 0u;
    kb[l] = use_b ? __ldg(b.p[l] + b_row<kBDesc>(nb, d - s)) : 0u;
  }
  const bool pick_a = use_a && (!use_b || key_le<NL>(ka, kb));
#pragma unroll
  for (int l = 0; l < NL; ++l) key[l] = pick_a ? ka[l] : kb[l];
}

// What a block knows of its tile, in shared memory.  Each phase of
// fold_kernel reads back the few numbers it needs, so that none of them
// holds a register through the staging and the merge, which need every
// register they can get.
struct TileInfo {
  long long t, nsa, nsb, split[2];
  int has_next;
  __device__ __forceinline__ long long d0(int kT) const { return t * kT; }
  __device__ __forceinline__ long long rows_end(int kT, long long n) const {  // d1
    return t * kT + kT < n ? t * kT + kT : n;
  }
  __device__ __forceinline__ long long end(int kT) const {  // e = min(d0 + kT, S)
    return t * kT + kT < nsa + nsb ? t * kT + kT : nsa + nsb;
  }
};

// K1 (kCompact, B stored descending), K3 (B stored descending) and K4 (B
// ascending), one tile a block.  out_rows: K1's output width; K3 and K4
// write na+nb rows.  (A persistent grid, each block looping over tickets,
// was slower: its loop-carried state pushed the staged loads and the
// merged rows into local memory.)
template <int NL, bool kCompact, bool kBDesc>
__global__ void __launch_bounds__(kFoldThreads, fold_blocks_per_sm<NL>())
    fold_kernel(Ops a, Ops b, OutOps out, long long na, long long nb, long long out_rows,
                unsigned long long* scratch) {
  constexpr int kI = fold_items<NL>(), kT = fold_tile<NL>();
  extern __shared__ uint32_t smem[];
  __shared__ typename FoldScan::TempStorage scan_tmp;
  __shared__ TileInfo s;
  __shared__ uint32_t s_next[NL];
  __shared__ Fold s_before;
  __shared__ int s_tile_live;
  const Tile<NL, kT> sm{smem};
  unsigned long long* hdr = scratch;
  unsigned long long* status = scratch + kHeaderWords;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n = na + nb;

  if (threadIdx.x == 0) s.t = (long long)atomicAdd(hdr + kTicket, 1ull);
  __syncthreads();

  // 1. nsa and nsb: counted by tile 0's block, waited for by the others.
  if (s.t == 0) {
    if (warp == 0) {
      const long long c = warp_partition(0, na, [&](long long i) { return !is_sentinel<NL>(a, i); });
      if (lane == 0) s.nsa = c;
    } else if (warp == 1) {  // B's sentinel rows come first when it is stored descending
      const long long c =
          warp_partition(0, nb, [&](long long r) { return is_sentinel<NL>(b, r) == kBDesc; });
      if (lane == 0) s.nsb = kBDesc ? nb - c : c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      store_word(hdr + kNonSentA, kAggregate | (unsigned long long)s.nsa);
      store_word(hdr + kNonSentB, kAggregate | (unsigned long long)s.nsb);
    }
  } else {
    if (threadIdx.x == 0) {
      unsigned long long x, y;
      for (unsigned ns = 32;; ns = ns < 1024 ? 2 * ns : ns) {
        x = load_word(hdr + kNonSentA);
        y = load_word(hdr + kNonSentB);
        if (x & y & kAggregate) break;
        __nanosleep(ns);
      }
      s.nsa = (long long)(x & ~kKind);
      s.nsb = (long long)(y & ~kKind);
    }
    __syncthreads();
  }

  // 2. A sentinel tile (K1's fill writes its output rows from the live
  // total on).
  if (s.d0(kT) >= s.nsa + s.nsb) {
    if (!kCompact) {
      fill_sentinel<NL>(out, s.d0(kT), s.rows_end(kT, n) - s.d0(kT), threadIdx.x, kFoldThreads);
    }
    return;
  }

  // 3. Rows [d0, e): the splits of d0 and e (warps 0 and 1), then warp 1
  // loads merged row e, when e < S, to tell whether row e-1 ends a run;
  // staging; the merge.
  if (warp < 2) {
    const long long e = s.end(kT);
    const long long split = fold_split<NL, kBDesc>(a, b, nb, s.nsa, s.nsb, warp ? e : s.d0(kT));
    if (lane == 0) {
      s.split[warp] = split;
      if (warp == 1) {
        s.has_next = e < s.nsa + s.nsb;
        if (s.has_next) merged_row<NL, kBDesc>(a, b, nb, s.nsa, s.nsb, e, split, s_next);
      }
    }
  }
  __syncthreads();
  {  // B's ascending rows [j0, j1)
    const long long i0 = s.split[0], i1 = s.split[1], j0 = s.d0(kT) - i0, j1 = s.end(kT) - i1;
    stage_windows<NL, kT, kBDesc>(a, i0, (int)(i1 - i0), b, kBDesc ? nb - j1 : j0, (int)(j1 - j0), sm);
  }
  __syncthreads();
  const int len = (int)(s.end(kT) - s.d0(kT));
  const int diag = min((int)threadIdx.x * kI, len);
  const int cnt = min(kI, len - diag);
  {
    const int la = (int)(s.split[1] - s.split[0]);
    uint32_t reg[kI][NL + 1];
    merge_rows<NL, kT, kI>(sm, 0, la, la, len - la, diag, cnt, reg);
    __syncthreads();
    store_rows<NL, kT, kI>(sm, diag, cnt, reg);
  }
  __syncthreads();

  // Run ends among the thread's rows (the row after its last one is the
  // next thread's first, or merged row e), and their fold: a running sum
  // of the counts since the last end.
  unsigned ends = 0;
  Fold excl, agg;
  {
    uint32_t run = 0u, head = 0u, key[NL];
    int live = 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) key[l] = sm.at(l, diag);
#pragma unroll 1
    for (int q = 0; q < kI; ++q) {
      if (q < cnt) {
        const bool last = diag + q + 1 == len;
        uint32_t next[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) next[l] = last ? s_next[l] : sm.at(l, diag + q + 1);
        const bool end = (last && !s.has_next) || !keys_equal<NL>(key, next);
        run += sm.at(NL, diag + q);
        if (end) {
          if (ends) {
            live += run != 0u ? 1 : 0;
          } else {
            head = run;
          }
          ends |= 1u << q;
          run = 0u;
        }
#pragma unroll
        for (int l = 0; l < NL; ++l) key[l] = next[l];
      }
    }
    FoldScan(scan_tmp).ExclusiveScan(Fold{head, run, live, ends != 0}, excl, Fold{0u, 0u, 0, 0},
                                     FoldOp(), agg);
  }

  // 4. Publish, look back, publish.
  if (warp == 0) {
    const long long t = s.t;
    Fold before{0u, 0u, 0, 0};
    if (t > 0) {
      if (lane == 0) publish(status + kStatusWords * t, kAggregate, agg);
      before = look_back(status, t, lane);
    }
    if (lane == 0) {
      const Fold incl = combine(before, agg);
      publish(status + kStatusWords * t, kInclusive, incl);
      s_before = before;
      s_tile_live = (int)(live_count(incl) - live_count(before));
      if (kCompact && s.end(kT) == s.nsa + s.nsb) hdr[kLiveTotal] = (unsigned long long)live_count(incl);
    }
  }
  __syncthreads();
  const Fold mine = combine(s_before, excl);  // every row before the thread's first
  uint32_t carry = mine.tail;
  if constexpr (kCompact) {
    // K1: the thread's live rows (run ends with a total) to registers, then
    // packed at the front of the tile in output order, then out with
    // 16-byte stores from the tile's first output row on.
    uint32_t rows[kI][NL + 1];
    unsigned take = 0;
#pragma unroll
    for (int q = 0; q < kI; ++q) {
      if (q < cnt) {
        const uint32_t c = sm.at(NL, diag + q);
        if (ends >> q & 1u) {
          const uint32_t total = carry + c;
          carry = 0u;
          if (total != 0u) {
            take |= 1u << q;
#pragma unroll
            for (int l = 0; l < NL; ++l) rows[q][l] = sm.at(l, diag + q);
            rows[q][NL] = total;
          }
        } else {
          carry += c;
        }
      }
    }
    __syncthreads();
    const long long base = live_count(s_before);
    int k = (int)(live_count(mine) - base);
#pragma unroll
    for (int q = 0; q < kI; ++q) {
      if (take >> q & 1u) {
#pragma unroll
        for (int l = 0; l <= NL; ++l) sm.at(l, k) = rows[q][l];
        ++k;
      }
    }
    __syncthreads();
    // The tile's live rows of rank below out_rows.
    const long long room = out_rows - base;
    const int len_out = room <= 0 ? 0 : (room < s_tile_live ? (int)room : s_tile_live);
    if (len_out > 0) {
#pragma unroll
      for (int l = 0; l <= NL; ++l) {
        store_lane<kFoldThreads>(out.p[l] + base, len_out, [&](int r) { return sm.at(l, r); });
      }
    }
  } else {
    // K3 and K4: the folded counts replace the tile's counts, then every
    // lane of rows [d0, e) at their merged index.
#pragma unroll 1
    for (int q = 0; q < kI; ++q) {
      if (q < cnt) {
        const uint32_t c = sm.at(NL, diag + q);
        const bool end = ends >> q & 1u;
        sm.at(NL, diag + q) = end ? carry + c : 0u;
        carry = end ? 0u : carry + c;
      }
    }
    __syncthreads();
    const long long d0 = s.d0(kT);
#pragma unroll
    for (int l = 0; l <= NL; ++l) {
      store_lane<kFoldThreads>(out.p[l] + d0, len, [&](int r) { return sm.at(l, r); });
    }
    // The rows from S on of the tile that holds row S-1.
    if (s.rows_end(kT, n) > s.end(kT)) {
      fill_sentinel<NL>(out, s.end(kT), s.rows_end(kT, n) - s.end(kT), threadIdx.x, kFoldThreads);
    }
  }
}

// K1's rows [min(live total, out_rows), out_rows): the sentinel key and
// count 0, grid-stride.
constexpr int kFillThreads = 256;
constexpr long long kFillBlocks = 132 * 8;  // at most; the fill is grid-stride
template <int NL>
__global__ void __launch_bounds__(kFillThreads)
    fill_kernel(OutOps out, long long out_rows, const unsigned long long* hdr) {
  const long long lt = (long long)hdr[kLiveTotal] < out_rows ? (long long)hdr[kLiveTotal] : out_rows;
  fill_sentinel<NL>(out, lt, out_rows - lt, (long long)blockIdx.x * kFillThreads + threadIdx.x,
                    (long long)gridDim.x * kFillThreads);
}

template <int NL>
int run_fold(const Ops& a, const Ops& b, const OutOps& out, int variant, long long na, long long nb,
             long long out_rows, unsigned long long* scratch, cudaStream_t stream) {
  constexpr int kSmem = fold_smem<NL>();
  const long long n = na + nb, tiles = lanes::num_tiles(n, fold_tile<NL>());
  const bool compact = variant == kMergeFoldCompactDesc;
  auto kernel = compact                     ? fold_kernel<NL, true, true>
                : variant == kMergeFoldDesc ? fold_kernel<NL, false, true>
                                            : fold_kernel<NL, false, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)tiles, kFoldThreads, kSmem, stream>>>(a, b, out, na, nb, out_rows, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess || !compact || out_rows == 0) return err;
  const long long want = lanes::num_tiles(out_rows, 4LL * kFillThreads);
  fill_kernel<NL><<<(unsigned)(want < kFillBlocks ? want : kFillBlocks), kFillThreads, 0, stream>>>(
      out, out_rows, scratch);
  return cudaGetLastError();
}

// =========================================================================
// K5: split, write
// =========================================================================

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // merged rows per block

template <int NL>
__device__ __forceinline__ void load_row(const Ops& o, long long i, uint32_t* key) {
#pragma unroll
  for (int l = 0; l < NL; ++l) key[l] = o.p[l][i];
}

template <int NL>
struct TileSmem {
  uint32_t ops[NL + 1][kTile];  // the tile's rows; merged in place
};

// Merge-path split of diagonal d: the number of A rows among the first d
// merged rows (A first on equal keys).
template <int NL>
__global__ void splits_kernel(Ops a, Ops b, long long na, long long nb, long long num_tiles,
                              long long* splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > num_tiles) return;
  const long long n = na + nb;
  const long long d = t * kTile < n ? t * kTile : n;
  splits[t] = merge_path_split(d, na, nb, [&](long long i, long long j) {
    uint32_t ka[NL], kb[NL];
    load_row<NL>(a, i, ka);
    load_row<NL>(b, j, kb);
    return key_le<NL>(ka, kb);
  });
}

// Stages tile t's windows of A and B in shared memory and merges them in
// place.  Returns the tile's row count.
template <int NL>
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

  // A's window at [0, la); B's window at [la, len).
  for (int r = threadIdx.x; r < la; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) sm.ops[l][r] = a.p[l][i0 + r];
  }
  for (int r = threadIdx.x; r < lb; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) sm.ops[l][la + r] = b.p[l][j0 + r];
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

// K5's second pass: each tile's merged rows at their merged index.
template <int NL>
__global__ void __launch_bounds__(kThreads)
    write_kernel(Ops a, Ops b, OutOps out, long long na, long long nb, const long long* splits) {
  __shared__ TileSmem<NL> sm;
  const long long t = blockIdx.x;
  const long long d0 = t * kTile;
  const int len = merge_tile<NL>(a, b, na, nb, splits, t, sm);
  for (int r = threadIdx.x; r < len; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) out.p[l][d0 + r] = sm.ops[l][r];
  }
}

long long num_tiles(long long n) { return lanes::num_tiles(n, kTile); }

template <int NL>
int run_splits(const Ops& a, const Ops& b, long long na, long long nb, long long* splits,
               cudaStream_t stream) {
  const long long tiles = num_tiles(na + nb);
  const long long blocks = (tiles + 1 + 255) / 256;
  splits_kernel<NL><<<(unsigned)blocks, 256, 0, stream>>>(a, b, na, nb, tiles, splits);
  return cudaGetLastError();
}

template <int NL>
int run_write(const Ops& a, const Ops& b, const OutOps& out, long long na, long long nb,
              const long long* splits, cudaStream_t stream) {
  write_kernel<NL><<<(unsigned)num_tiles(na + nb), kThreads, 0, stream>>>(a, b, out, na, nb, splits);
  return cudaGetLastError();
}

int fold_tile_rows(int num_keys) {
  switch (num_keys) {
    case 1: return fold_tile<1>();
    case 2: return fold_tile<2>();
    case 3: return fold_tile<3>();
    case 4: return fold_tile<4>();
    case 5: return fold_tile<5>();
    case 6: return fold_tile<6>();
    case 7: return fold_tile<7>();
    case 8: return fold_tile<8>();
    default: return 0;
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

int mfc_num_variants() { return kNumVariants; }

// ---- K1, K3 and K4 ----

// Merged rows per tile of fold_kernel at num_keys key lanes; 0 for an
// unsupported num_keys.
int mfc_fold_tile_rows(int num_keys) { return fold_tile_rows(num_keys); }

// int64 words of the scratch that mfc_fold takes (zeroed by the caller).
long long mfc_fold_scratch_words(int num_keys, long long n) {
  const int tile = fold_tile_rows(num_keys);
  return tile ? kHeaderWords + kStatusWords * lanes::num_tiles(n, tile) : -1;
}

// K1 (variant 0: fold_kernel, then fill_kernel), K3 (variant 1) or K4
// (variant 2: fold_kernel), enqueued on `stream`.  a_ptrs / b_ptrs /
// out_ptrs: host arrays of num_keys+1 device pointers (key lanes, then the
// value lane); A ascending, B stored descending (K1, K3) or ascending (K4);
// out has out_rows rows a lane, 0 <= out_rows <= na+nb for K1 and na+nb
// for K3 and K4.  scratch: mfc_fold_scratch_words int64 words, zero; K1
// leaves its live row count, all of them whatever out_rows, at word
// kLiveTotal (3).  Returns a cudaError_t.
int mfc_fold(const void* const* a_ptrs, const void* const* b_ptrs, void* const* out_ptrs, int variant,
             int num_keys, long long na, long long nb, long long out_rows, void* scratch, void* stream) {
  if (variant != kMergeFoldCompactDesc && variant != kMergeFoldDesc && variant != kMergeFold) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_keys < 1 || num_keys > 8 || na < 0 || nb < 0 || na + nb == 0) return (int)cudaErrorInvalidValue;
  if (out_rows < 0 || out_rows > na + nb || (variant != kMergeFoldCompactDesc && out_rows != na + nb)) {
    return (int)cudaErrorInvalidValue;
  }
  const Ops a = lanes::make_ops(a_ptrs, num_keys + 1);
  const Ops b = lanes::make_ops(b_ptrs, num_keys + 1);
  const OutOps out = lanes::make_out_ops(out_ptrs, num_keys + 1);
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
#define MFC_FOLD_CALL(NL) run_fold<NL>(a, b, out, variant, na, nb, out_rows, sc, s)
  MFC_DISPATCH_NL(num_keys, MFC_FOLD_CALL)
}

// ---- K5 ----

int mfc_tile_rows() { return kTile; }

// Pass 1.  a_ptrs / b_ptrs: host arrays of num_keys+1 device pointers (key
// lanes, then the value lane), both ascending.  splits: [num_tiles+1]
// int64.  Returns a cudaError_t.
int mfc_splits(const void* const* a_ptrs, const void* const* b_ptrs, int num_keys, long long na,
               long long nb, void* splits, void* stream) {
  const Ops a = lanes::make_ops(a_ptrs, num_keys + 1);
  const Ops b = lanes::make_ops(b_ptrs, num_keys + 1);
  auto* sp = static_cast<long long*>(splits);
  auto s = static_cast<cudaStream_t>(stream);
#define MFC_SPLITS_CALL(NL) run_splits<NL>(a, b, na, nb, sp, s)
  MFC_DISPATCH_NL(num_keys, MFC_SPLITS_CALL)
}

// Pass 2.  out_ptrs: host array of num_keys+1 device pointers to [na+nb]
// rows.
int mfc_write(const void* const* a_ptrs, const void* const* b_ptrs, void* const* out_ptrs, int num_keys,
              long long na, long long nb, const void* splits, void* stream) {
  const Ops a = lanes::make_ops(a_ptrs, num_keys + 1);
  const Ops b = lanes::make_ops(b_ptrs, num_keys + 1);
  const OutOps out = lanes::make_out_ops(out_ptrs, num_keys + 1);
  auto* sp = static_cast<const long long*>(splits);
  auto s = static_cast<cudaStream_t>(stream);
#define MFC_WRITE_CALL(NL) run_write<NL>(a, b, out, na, nb, sp, s)
  MFC_DISPATCH_NL(num_keys, MFC_WRITE_CALL)
}

}  // extern "C"
