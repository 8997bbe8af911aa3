// probes.cu — the Mosaic probes under docs/ (D1–D7) for Hopper (sm_90a).
//
// Replaces the seven Pallas kernels of three probe scripts:
//   pair_merge_kernel   D2 docs/experiments_bitonic_merge.py merge (:52)
//                       D3 docs/experiments_bitonic_merge.py merge_many (:88)
//                       D7 docs/experiments_mosaic_caps.py q4 (:196)
//   tile_compact_kernel D1 docs/probe_compact_overhead.py _blocked(...).call
//                       (:48-68), bodies v_copy, v_cumsum, v_network
//   row_gather_kernel   D4 q1 (:36), D5 q2 (:55), D6 q3 (:75),
//                       docs/experiments_mosaic_caps.py
// Each computes what its probe computes; none carries a Pallas body over.
// The probes asked whether Mosaic could lower a pattern (a bitonic
// half-cleaner, an odd-even network, a doubling-roll scan, a row roll, a
// DMA at a runtime row offset).  On Hopper those patterns are a merge-path
// merge, a block scan and an indexed copy.
//
// What bounds them: memory.  Each reads its inputs once and writes its
// output once with next to no arithmetic; at the probes' shapes D2 and
// D4-D7 move 8 KB to 1 MB and are bound by the launch, D3 moves 8 MB and
// D1 0.6-1 GB (576 tiles
// of 65,536 rows, 3 operands).  D1's network writes 97% of its bytes as
// the zero tail at 3% live, so it is built to stream that tail: short
// CTAs (an eighth of a tile each) with no serial chain of chunks.
//
// pair_merge_kernel<S, kBDesc>: G pairs of sorted uint32 runs A (ta keys)
// and B (tb keys, stored descending when kBDesc) into sort(A ++ B).  A
// block takes a tile of S::kTile output words of one pair, the tiles laid
// on the output's 16-byte grid: 2048 words where the pair fits one tile
// (D2, D3), else 1024 (D7's 131,072 keys: 128 blocks).  At the probes'
// shapes the block's chain of dependent steps, not bytes, sets its pace,
// so each step is cut:
// - the split: warp 0 finds the merge-path split of the tile's first
//   diagonal and warp 1 of its last, each by a 32-ary ballot search over
//   device memory (warp_split: log32 rounds of loads, not log2); a pair
//   that fits one tile searches nothing;
// - the staging: the block's A range and B range go into padded
//   shared-memory tiles in 16-byte loads (a B stored descending reversed in
//   registers), the head and tail of a range a word at a time;
// - the merge: each thread finds its own split in shared memory and merges
//   S::kItems outputs, reading the next key of both runs at each step (no
//   branch), into the padded output tile; a warp's staging stores, output
//   loads and (where its row starts on the grid) merge stores each fall in
//   32 distinct banks;
// - the output: 16-byte stores, the head and tail a word at a time.
// Keys only: equal keys are interchangeable, but every split takes A first
// on ties (lanes::merge_path_split's rule), so the blocks partition the
// merge exactly.
//
// tile_compact_kernel<kMode>, a tile being kTile = 65,536 rows:
// - copy: a block a tile, 16-byte copies.
// - cumsum: a block a tile, walking it in chunks of 4 rows a thread (one
//   16-byte load of the flags); each thread's dead rows counted, the
//   counts scanned across the block (warp shuffles, then the warp totals),
//   the chunk's total carried into the next, each row's exclusive dead
//   count added to every operand (uint32, so mod 2^32).
// - network: a thread-block cluster of kCluster CTAs a tile, a CTA a part
//   of kPart rows, a thread 32 consecutive rows.  A warp issues its eight
//   coalesced 16-byte flag loads a lane at once; ballots turn them into one
//   mask word a thread for its 32 rows; one block scan of the popcounts ranks the threads in the
//   part; the parts' live counts cross the cluster through distributed
//   shared memory (one cluster barrier), which gives each part its base
//   rank and the tile's total.  Then two independent kinds of write: a
//   thread loads every operand of its live rows (four at a time) before it
//   stores them at consecutive ranks, and each CTA zeroes its part's rows
//   at or past the tile's total (a scalar head, then 16-byte stores) while
//   its first loads are in flight.  Live rows land anywhere below the
//   total, in any part, so no CTA zeroes below it.
// No carry crosses a tile.
//
// row_gather_kernel: a warp an output row, warps striding over the output
// rows; output row j of window g is x[(starts[g] + shift + j) mod R],
// copied 16 bytes a lane where the row width and the pointers allow.  The
// kernel reads the starts on the device (the Pallas probe's scalar
// prefetch) and never leaves x.  At the probes' shapes it is bound by its
// launch: the wrapper's host path is kept short (ops/probes.py).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

namespace cg = cooperative_groups;
using lanes::Ops;
using lanes::OutOps;

// ---- pair_merge_kernel -------------------------------------------------------

// A block of kThreads threads merging kItems outputs each.
template <int kThreads_, int kItems_>
struct MergeShape {
  static constexpr int kThreads = kThreads_, kItems = kItems_;
  static constexpr int kTile = kThreads * kItems;  // output words a block
  // A staged range (at most kTile keys) starts up to 31 words into its
  // tile (stage_store) and spans at most kTile / 4 + 2 16-byte chunks.
  static constexpr int kStageWords = lanes::padded(kTile + 32);
  static constexpr int kStageIters = (kTile / 4 + 2 + kThreads - 1) / kThreads;
};
// A pair that fits one block needs no split search and takes the wider
// block; a pair spread over blocks pays for the searches anyway, and
// narrower tiles give it twice the blocks, each with half the chain.
using FitShape = MergeShape<256, 8>;
using SpreadShape = MergeShape<256, 4>;

// The word of its 16-byte chunk that p points at.
__host__ __device__ __forceinline__ int word_in_chunk(const void* p) { return (int)(((uintptr_t)p >> 2) & 3u); }

__device__ __forceinline__ uint32_t word(const uint4& x, int q) {
  return q == 0 ? x.x : (q == 1 ? x.y : (q == 2 ? x.z : x.w));
}

// lanes::merge_path_split of diagonal d in the merge of A (ta keys, a_at(i)
// the i-th) and B (tb keys, b_at(j) the j-th smallest) in device memory,
// computed by a whole warp: each round, lane k probes the last candidate
// of the k-th of 32 equal slices of the candidates; "A <= B" holds up to
// the split and not after it, so the count of the ballot names the slice
// that holds it.  log32 rounds of dependent loads, not log2: four at
// 65,536 keys a side.  Every lane returns the split.
template <class AAt, class BAt>
__device__ __forceinline__ long long warp_split(long long d, long long ta, long long tb, AAt a_at, BAt b_at) {
  const int lane = threadIdx.x & 31;
  long long lo = d > tb ? d - tb : 0, hi = d < ta ? d : ta;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long i = lo + (lane + 1) * step - 1;
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, i < hi && a_at(i) <= b_at(d - 1 - i)));
    const long long end = lo + (c + 1) * step - 1;
    lo += c * step;
    hi = end < hi ? end : hi;
  }
  return lo;
}

// Keys [0, len) of p (device memory) into registers, by 16-byte chunks:
// chunk c is the c-th from the one p starts in, and the thread takes
// chunks threadIdx.x + i * S::kThreads into w[i].  A whole chunk is one
// 16-byte load; the range's first and last (a head or tail of up to 3
// keys) move a word at a time, and no word outside the range is read.
template <class S>
__device__ __forceinline__ void stage_load(const uint32_t* p, int len, uint4 (&w)[S::kStageIters]) {
  const int h = word_in_chunk(p), chunks = (h + len + 3) >> 2;
#pragma unroll
  for (int it = 0; it < S::kStageIters; ++it) {
    const int c = (int)threadIdx.x + it * S::kThreads, k0 = 4 * c - h;  // k0: the key in word 0
    if (c < chunks) {
      if (k0 >= 0 && k0 + 4 <= len) {
        w[it] = __ldg(reinterpret_cast<const uint4*>(p + k0));
      } else {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = k0 + q >= 0 && k0 + q < len ? __ldg(p + k0 + q) : 0u;
        w[it] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// stage_load's keys into the padded tile t: key k at index f + k or, kRev,
// at f + len - 1 - k (a B stored descending turned ascending: each chunk's
// four keys reversed in registers).  f puts a chunk's keys on four indices
// from a multiple of 4, and a warp's 32 chunks on 128 indices from a
// multiple of 32, so that the warp's stores of one word of its chunks hit
// 32 distinct banks.  Returns f.
template <class S, bool kRev>
__device__ __forceinline__ int stage_store(const uint32_t* p, int len, const uint4 (&w)[S::kStageIters],
                                           uint32_t* t) {
  const int h = word_in_chunk(p), chunks = (h + len + 3) >> 2;
  const int f = kRev ? -(h + len) & 31 : h;
#pragma unroll
  for (int it = 0; it < S::kStageIters; ++it) {
    const int c = (int)threadIdx.x + it * S::kThreads, k0 = 4 * c - h;
    if (c < chunks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + q;
        if (k >= 0 && k < len) t[lanes::pad(kRev ? f + len - 1 - k : f + k)] = word(w[it], q);
      }
    }
  }
  return f;
}

template <class S, bool kBDesc>
__global__ void __launch_bounds__(S::kThreads)
    pair_merge_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, long long ta, long long tb,
                      int tiles) {
  __shared__ uint32_t s_a[S::kStageWords];  // the block's A range
  __shared__ uint32_t s_b[S::kStageWords];  // its B range, ascending
  __shared__ uint32_t s_out[lanes::padded(S::kTile)];  // its tile of the output
  __shared__ long long s_split[2];
  const int g = (int)blockIdx.x / tiles;  // the pair
  const long long n = ta + tb;
  const uint32_t* pa = a + g * ta;
  const uint32_t* pb = b + g * tb;
  uint32_t* po = out + g * n;
  // The block's tile is output words [e0, e0 + S::kTile) of the row, on
  // the output's 16-byte grid (a row that starts off it begins inside its
  // first tile); it merges the diagonals [d0, d1) of the tile in the row.
  const long long e0 = (long long)((int)blockIdx.x - g * tiles) * S::kTile - word_in_chunk(po);
  const long long d0 = e0 > 0 ? e0 : 0;
  const long long d1 = e0 + S::kTile < n ? e0 + S::kTile : n;
  if (d0 >= d1) return;  // past the row's end: the grid has room for rows off the grid
  auto a_at = [&](long long i) { return __ldg(pa + i); };
  auto b_at = [&](long long j) { return __ldg(kBDesc ? pb + (tb - 1 - j) : pb + j); };
  const int warp = (int)threadIdx.x >> 5;
  if (warp < 2) {  // warp 0 finds where the tile starts in A, warp 1 where it ends
    const long long s = warp_split(warp ? d1 : d0, ta, tb, a_at, b_at);
    if ((threadIdx.x & 31) == 0) s_split[warp] = s;
  }
  __syncthreads();
  const int len = (int)(d1 - d0);
  const long long a0 = s_split[0], b0 = d0 - a0;
  // Clamped so that runs that are not sorted (the contract, unchecked)
  // merge wrong but read and write inside their rows and tiles.
  const long long sa1 = s_split[1] - a0;
  const int la = sa1 < 0 ? 0 : (sa1 > len ? len : (int)sa1), lb = len - la;
  const uint32_t* src_a = pa + a0;
  const uint32_t* src_b = kBDesc ? pb + (tb - b0 - lb) : pb + b0;  // B's range as stored
  uint4 wa[S::kStageIters], wb[S::kStageIters];
  stage_load<S>(src_a, la, wa);
  stage_load<S>(src_b, lb, wb);
  const int fa = stage_store<S, false>(src_a, la, wa, s_a);
  const int fb = stage_store<S, kBDesc>(src_b, lb, wb, s_b);
  __syncthreads();

  // Thread t merges the tile's words [kItems t, kItems (t + 1)) that lie
  // in its range [lo, hi): a warp's stores of one q fall in 32 distinct
  // banks.
  const int lo = (int)(d0 - e0), hi = lo + len;
  const int t0 = S::kItems * (int)threadIdx.x;
  const int first = t0 > lo ? t0 : lo;
  const int cnt = (t0 + S::kItems < hi ? t0 + S::kItems : hi) - first;
  if (cnt > 0) {
    auto sa = [&](int i) { return s_a[lanes::pad(fa + i)]; };
    auto sb = [&](int j) { return s_b[lanes::pad(fb + j)]; };
    int ia = lanes::merge_path_split(first - lo, la, lb, [&](int i, int j) { return sa(i) <= sb(j); });
    int ib = first - lo - ia;
    // Each step reads the next key of both runs (a run's word past its end
    // lies inside its tile and is never taken), so no lane branches.
#pragma unroll
    for (int q = 0; q < S::kItems; ++q) {
      if (q < cnt) {
        const uint32_t ka = sa(ia), kb = sb(ib);
        const bool take_a = ib >= lb || (ia < la && ka <= kb);
        s_out[lanes::pad(first + q)] = take_a ? ka : kb;
        ia += take_a;
        ib += !take_a;
      }
    }
  }
  __syncthreads();

  // Chunk c of the tile, words [4c, 4c + 4), is 16-byte aligned in the
  // output: one 16-byte store when it lies in [lo, hi), else (the range's
  // first and last chunk) a word at a time.
  for (int i = 4 * (int)threadIdx.x; i < hi; i += 4 * S::kThreads) {
    if (i >= lo && i + 4 <= hi) {
      *reinterpret_cast<uint4*>(po + (e0 + i)) = make_uint4(s_out[lanes::pad(i)], s_out[lanes::pad(i + 1)],
                                                            s_out[lanes::pad(i + 2)], s_out[lanes::pad(i + 3)]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (i + q >= lo && i + q < hi) po[e0 + i + q] = s_out[lanes::pad(i + q)];
      }
    }
  }
}

// ---- tile_compact_kernel -----------------------------------------------------

constexpr int kTile = 65536;
enum Mode { kCopy = 0, kCumsum = 1, kNetwork = 2 };
// copy and cumsum: a block a tile; cumsum in chunks of 4 rows a thread.
constexpr int kTileThreads = 1024;
constexpr int kChunk = 4 * kTileThreads;  // rows a block scans at once
// network: a cluster of kCluster CTAs a tile, a CTA a part of kPart rows, a
// thread kNetRows consecutive rows (one mask word).
constexpr int kCluster = 8;
constexpr int kPart = kTile / kCluster;
constexpr int kNetThreads = 256;
constexpr int kNetRows = kPart / kNetThreads;
constexpr int kBatch = 4;  // live rows whose operands a thread loads before it stores
static_assert(kNetRows == 32, "a thread's rows are one mask word");

constexpr int mode_threads(int mode) { return mode == kNetwork ? kNetThreads : kTileThreads; }
constexpr int mode_min_blocks(int mode) { return mode == kNetwork ? 4 : 1; }

// The block's exclusive prefix sum of x (one value a thread) and, in
// total, the sum over the block.  s_warp holds kWarps ints.
template <int kWarps>
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is reused by the next chunk
  return before + inc - x;
}

// The operand loops below run over the most lanes there can be, unrolled,
// so that the pointer arrays are indexed by constants.

__device__ __forceinline__ void copy_body(const Ops& in, const OutOps& out, int n_ops) {
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int o = 0; o < lanes::kMaxOps; ++o) {
    if (o < n_ops) {
      const uint4* src = reinterpret_cast<const uint4*>(in.p[o] + base);
      uint4* dst = reinterpret_cast<uint4*>(out.p[o] + base);
      for (int i = threadIdx.x; i < kTile / 4; i += kTileThreads) dst[i] = __ldcs(src + i);
    }
  }
}

__device__ __forceinline__ void cumsum_body(const Ops& in, const OutOps& out, int n_ops, const uint32_t* live) {
  __shared__ int s_warp[kTileThreads / 32];
  const long long base = (long long)blockIdx.x * kTile;
  int carry = 0;  // the dead rows of the chunks before
#pragma unroll 1
  for (int c = 0; c < kTile; c += kChunk) {
    const int r = c + 4 * (int)threadIdx.x;  // the thread's first row in the tile
    const uint4 f = __ldcs(reinterpret_cast<const uint4*>(live + base + r));
    int on[4], mine = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      on[q] = word(f, q) == 0u;
      mine += on[q];
    }
    int total;
    const int before = carry + block_exclusive_scan<kTileThreads / 32>(mine, s_warp, total);
    uint32_t delta[4];
    int k = before;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      delta[q] = (uint32_t)k;
      k += on[q];
    }
#pragma unroll
    for (int o = 0; o < lanes::kMaxOps; ++o) {
      if (o < n_ops) {
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(in.p[o] + base + r));
        *reinterpret_cast<uint4*>(out.p[o] + base + r) =
            make_uint4(v.x + delta[0], v.y + delta[1], v.z + delta[2], v.w + delta[3]);
      }
    }
    carry += total;
  }
}

// A cluster barrier split in two: a CTA arrives once it has read the
// others' shared memory and waits before it exits, so that no CTA's
// shared memory goes while another may still read it.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

// Bit k of a byte moved to bit 4k.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The liveness of the lane's 32 rows of the warp's 1024 (from row p), bit
// i for row 32 * lane + i, from coalesced loads: load i brings 16-byte word
// 32 i + l of the flags to lane l, and a ballot a load and word position
// says where the live rows are; lane L's rows lie in load L / 4, so it
// takes byte L % 4 of that load's four ballots.
__device__ __forceinline__ uint32_t warp_masks(const uint32_t* p) {
  const int lane = threadIdx.x & 31;
  const uint4* f = reinterpret_cast<const uint4*>(p);
  uint4 w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = __ldcs(f + 32 * i + lane);
  uint32_t b[4] = {0u, 0u, 0u, 0u};  // the ballots of load lane / 4, by word position
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = __ballot_sync(0xFFFFFFFFu, w[i].x != 0u), y = __ballot_sync(0xFFFFFFFFu, w[i].y != 0u),
                   z = __ballot_sync(0xFFFFFFFFu, w[i].z != 0u), v = __ballot_sync(0xFFFFFFFFu, w[i].w != 0u);
    if (i == lane >> 2) {
      b[0] = x;
      b[1] = y;
      b[2] = z;
      b[3] = v;
    }
  }
  const int sh = 8 * (lane & 3);
  uint32_t mask = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) mask |= spread4((b[q] >> sh) & 0xFFu) << q;
  return mask;
}

__device__ __forceinline__ void network_body(const Ops& in, const OutOps& out, int n_ops, const uint32_t* live) {
  __shared__ int s_warp[kNetThreads / 32];
  __shared__ int s_count;  // the part's live rows, read by every CTA of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const long long base = (long long)(blockIdx.x / kCluster) * kTile;
  const int r0 = part * kPart + kNetRows * (int)threadIdx.x;  // the thread's first row in the tile

  // The thread's rows' liveness: every 16-byte load of the warp's flags
  // issued before any is used.
  const uint32_t mask = warp_masks(live + base + part * kPart + ((int)threadIdx.x & ~31) * kNetRows);

  // The thread's rank in its part, then the parts' counts through
  // distributed shared memory: the part's base rank and the tile's total.
  int part_live;
  int rank = block_exclusive_scan<kNetThreads / 32>(__popc(mask), s_warp, part_live);
  if (threadIdx.x == 0) s_count = part_live;
  cluster.sync();
  int total = 0;
#pragma unroll
  for (int c = 0; c < kCluster; ++c) {
    const int k = *cluster.map_shared_rank(&s_count, c);
    rank += c < part ? k : 0;
    total += k;
  }
  cluster_arrive();

  // The live rows, lowest first, kBatch a round: every operand of a round
  // loaded before any is stored, at consecutive ranks.
  uint32_t m = mask;
  int rows[kBatch];
  uint32_t v[kBatch][lanes::kMaxOps];
  auto load = [&]() {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      rows[b] = m ? __ffs(m) - 1 : -1;
      m &= m - 1;
#pragma unroll
      for (int o = 0; o < lanes::kMaxOps; ++o) {
        if (o < n_ops && rows[b] >= 0) v[b][o] = __ldcs(in.p[o] + base + r0 + rows[b]);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (rows[b] >= 0) {
#pragma unroll
        for (int o = 0; o < lanes::kMaxOps; ++o) {
          if (o < n_ops) out.p[o][base + rank] = v[b][o];
        }
        ++rank;
      }
    }
  };
  load();

  // The zero tail: the part's rows at or past the tile's total (no live
  // row lands there), a scalar head to the next 16-byte boundary, then
  // 16-byte stores.  It runs while the first round's loads are in flight.
  const int lo = total > part * kPart ? total : part * kPart, hi = (part + 1) * kPart;
  if (lo < hi) {
    const int lo4 = (lo + 3) & ~3;  // <= hi: hi is a multiple of 4
#pragma unroll
    for (int o = 0; o < lanes::kMaxOps; ++o) {
      if (o < n_ops) {
        uint32_t* p = out.p[o] + base;
        if ((int)threadIdx.x < lo4 - lo) p[lo + threadIdx.x] = 0u;
        uint4* q = reinterpret_cast<uint4*>(p);
        for (int i = lo4 / 4 + (int)threadIdx.x; i < hi / 4; i += kNetThreads) {
          __stcs(q + i, make_uint4(0u, 0u, 0u, 0u));
        }
      }
    }
  }
  store();
  while (m) {
    load();
    store();
  }
  cluster_wait();
}

template <int kMode>
__global__ void __launch_bounds__(mode_threads(kMode), mode_min_blocks(kMode))
    tile_compact_kernel(Ops in, OutOps out, int n_ops, const uint32_t* live) {
  if constexpr (kMode == kCopy) {
    copy_body(in, out, n_ops);
  } else if constexpr (kMode == kCumsum) {
    cumsum_body(in, out, n_ops, live);
  } else {
    network_body(in, out, n_ops, live);
  }
}

// ---- row_gather_kernel -------------------------------------------------------

constexpr int kGatherThreads = 128;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherBlocks = 132 * 16;  // at most; warps stride over the output rows

// A warp an output row at a time: its source row from 32-bit arithmetic
// (no 64-bit division, whose call spilled registers), then the row's words,
// 16 bytes a lane when kVec (W a multiple of 4, x and out on 16-byte
// boundaries).  start % R and shift (already taken % R) each lie in (-R, R)
// and j in [0, R), so two additions or subtractions of R bring their sum
// into [0, R) whatever the start.
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
    row_gather_kernel(const uint32_t* x, const int* starts, uint32_t* out, int R, long long W, int rows,
                      int shift, int out_rows) {
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kGatherWarps + (threadIdx.x >> 5); row < out_rows; row += gridDim.x * kGatherWarps) {
    const int g = row / rows, j = row - g * rows;
    long long v = (long long)(starts[g] % R) + shift + j;
    if (v < 0) v += R;
    if (v < 0) v += R;
    if (v >= R) v -= R;
    if (v >= R) v -= R;
    if constexpr (kVec) {
      const uint4* src = reinterpret_cast<const uint4*>(x + v * W);
      uint4* dst = reinterpret_cast<uint4*>(out + (long long)row * W);
      for (long long c = lane; c < W / 4; c += 32) dst[c] = src[c];
    } else {
      const uint32_t* src = x + v * W;
      uint32_t* dst = out + (long long)row * W;
      for (long long c = lane; c < W; c += 32) dst[c] = src[c];
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// network: a cluster of kCluster CTAs a tile, launched with the cluster
// dimension as a launch attribute.  A cluster's CTAs must be resident
// together: the first launch asks the runtime how many clusters fit at
// once and refuses if none does.
cudaError_t launch_network(const Ops& ins, const OutOps& outs, int n_ops, const uint32_t* lv, long long n,
                           cudaStream_t s) {
  static int clusters = 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n / kTile * kCluster));
  cfg.blockDim = dim3(kNetThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, tile_compact_kernel<kNetwork>, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
  }
  return cudaLaunchKernelEx(&cfg, tile_compact_kernel<kNetwork>, ins, outs, n_ops, lv);
}

template <class S>
int launch_pair_merge(const void* a, const void* b, void* out, long long G, long long ta, long long tb, int b_desc,
                      long long shift, cudaStream_t s) {
  const long long tiles = (ta + tb + shift + S::kTile - 1) / S::kTile;
  if (G * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  if (b_desc) {
    pair_merge_kernel<S, true><<<(unsigned)(G * tiles), S::kThreads, 0, s>>>(pa, pb, po, ta, tb, (int)tiles);
  } else {
    pair_merge_kernel<S, false><<<(unsigned)(G * tiles), S::kThreads, 0, s>>>(pa, pb, po, ta, tb, (int)tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pr_tile() { return kTile; }

// G pairs: a [G, ta] ascending, b [G, tb] descending (b_desc) or
// ascending, out [G, ta + tb]; all contiguous, G * (ta + tb) > 0.
// Returns a cudaError_t.
int pr_pair_merge(const void* a, const void* b, void* out, long long G, long long ta, long long tb, int b_desc,
                  void* stream) {
  const long long n = ta + tb;
  if (G < 1 || ta < 0 || tb < 0 || n < 1) return (int)cudaErrorInvalidValue;
  // A row's tiles lie on the output's 16-byte grid: a row that starts k
  // words past it needs room for k more keys (all rows start where out
  // does when n is a multiple of 4).
  const long long shift = n % 4 ? 3 : word_in_chunk(out);
  auto s = static_cast<cudaStream_t>(stream);
  return n + shift <= FitShape::kTile ? launch_pair_merge<FitShape>(a, b, out, G, ta, tb, b_desc, shift, s)
                                      : launch_pair_merge<SpreadShape>(a, b, out, G, ta, tb, b_desc, shift, s);
}

// n_ops operand lanes and n_ops output lanes of n rows, and the live
// flags: n a positive multiple of the tile, every pointer on a 16-byte
// boundary, mode 0 copy, 1 cumsum, 2 network.  Returns a cudaError_t.
int pr_tile_compact(const void* const* in, void* const* out, int n_ops, const void* live, long long n, int mode,
                    void* stream) {
  if (n_ops < 1 || n_ops > lanes::kMaxOps || n < kTile || n % kTile || n / kTile * kCluster > 0x7FFFFFFFLL ||
      mode < 0 || mode > 2 || !aligned16(live)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int o = 0; o < n_ops; ++o) {
    if (!aligned16(in[o]) || !aligned16(out[o])) return (int)cudaErrorInvalidValue;
  }
  const Ops ins = lanes::make_ops(in, n_ops);
  const OutOps outs = lanes::make_out_ops(out, n_ops);
  const auto* lv = static_cast<const uint32_t*>(live);
  const unsigned grid = (unsigned)(n / kTile);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCopy: tile_compact_kernel<kCopy><<<grid, kTileThreads, 0, s>>>(ins, outs, n_ops, lv); break;
    case kCumsum: tile_compact_kernel<kCumsum><<<grid, kTileThreads, 0, s>>>(ins, outs, n_ops, lv); break;
    default: {
      const cudaError_t e = launch_network(ins, outs, n_ops, lv, n, s);
      if (e != cudaSuccess) return (int)e;
      break;
    }
  }
  return (int)cudaGetLastError();
}

// x [R, W], starts [G] int32 (on the device), out [G, rows, W]; all
// contiguous, R, W, G, rows >= 1, R and G * rows below 2^31.  Returns a
// cudaError_t.
int pr_row_gather(const void* x, const void* starts, void* out, long long R, long long W, long long G, int rows,
                  long long shift, void* stream) {
  if (R < 1 || R > 0x7FFFFFFFLL || W < 1 || G < 1 || rows < 1 || G * rows > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int out_rows = (int)(G * rows);
  const int warps = (out_rows + kGatherWarps - 1) / kGatherWarps;
  const unsigned grid = warps < kGatherBlocks ? warps : kGatherBlocks;
  const auto* px = static_cast<const uint32_t*>(x);
  const auto* ps = static_cast<const int*>(starts);
  auto* po = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(x) && aligned16(out)) {
    row_gather_kernel<true><<<grid, kGatherThreads, 0, s>>>(px, ps, po, (int)R, W, rows, (int)(shift % R),
                                                             out_rows);
  } else {
    row_gather_kernel<false><<<grid, kGatherThreads, 0, s>>>(px, ps, po, (int)R, W, rows, (int)(shift % R),
                                                              out_rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
