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
// output once with next to no arithmetic; at the probes' shapes D2-D7 move
// 8 KB to 1 MB and are bound by the launch, D1 moves 0.6-1 GB (576 tiles
// of 65,536 rows, 3 operands).
//
// pair_merge_kernel<kBDesc>: G pairs of sorted uint32 runs A (ta keys) and
// B (tb keys, stored descending when kBDesc) into sort(A ++ B).  A block
// takes kMergeTile consecutive output diagonals of one pair (so a pair
// longer than a block, D7's 131,072 keys, is spread over blocks); two
// threads find the merge-path splits of its first and last diagonal in
// device memory (lanes::merge_path_split), the block stages its A range and
// its B range (ascending) in shared memory, each thread merges kMergeItems
// diagonals from its own split there into a shared output tile, and the
// block writes the tile out coalesced.  Keys only: equal keys are
// interchangeable, but every split takes A first on ties, so the blocks
// partition the merge exactly.
//
// tile_compact_kernel<kMode>: one block per tile of kTile = 65,536 rows.
// copy: 16-byte copies.  cumsum and network: the block walks its tile in
// chunks of 4 rows a thread (one 16-byte load of the flags), counts each
// thread's dead (cumsum) or live (network) rows, scans the counts across
// the block (warp shuffles, then the warp totals), carries the chunk's
// total into the next chunk, and then: cumsum adds each row's exclusive
// dead count to every operand (uint32, so mod 2^32); network lists the
// chunk's live rows by rank in shared memory, and a thread a rank copies
// that row of every operand to its in-tile rank (all loads before any
// store); after the last chunk, zeros from the tile's live count to its
// end.  No carry crosses a tile.
//
// row_gather_kernel: blocks stride over the output rows, a block copying a
// row's words; output row j of window g is x[(starts[g] + shift + j) mod
// R].  The kernel reads the starts on the device (the Pallas probe's
// scalar prefetch) and never leaves x.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::Ops;
using lanes::OutOps;

// ---- pair_merge_kernel -------------------------------------------------------

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kMergeTile = kMergeThreads * kMergeItems;  // output keys a block

template <bool kBDesc>
__global__ void __launch_bounds__(kMergeThreads)
    pair_merge_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, long long ta, long long tb,
                      long long tiles) {
  __shared__ uint32_t s_in[kMergeTile];   // the block's A range, then its B range ascending
  __shared__ uint32_t s_out[kMergeTile];  // the block's merged keys
  __shared__ long long s_split[2];
  const long long g = blockIdx.x / tiles;
  const long long n = ta + tb;
  const long long d0 = (blockIdx.x - g * tiles) * kMergeTile;
  const long long d1 = d0 + kMergeTile < n ? d0 + kMergeTile : n;
  const uint32_t* pa = a + g * ta;
  const uint32_t* pb = b + g * tb;
  // B's j-th smallest key.
  auto b_at = [&](long long j) { return kBDesc ? pb[tb - 1 - j] : pb[j]; };
  if (threadIdx.x < 2) {
    s_split[threadIdx.x] = lanes::merge_path_split(threadIdx.x == 0 ? d0 : d1, ta, tb,
                                                   [&](long long i, long long j) { return pa[i] <= b_at(j); });
  }
  __syncthreads();
  const long long a0 = s_split[0], b0 = d0 - a0;
  const int la = (int)(s_split[1] - a0), lb = (int)(d1 - d0) - la;
  for (int i = threadIdx.x; i < la; i += kMergeThreads) s_in[i] = pa[a0 + i];
  for (int j = threadIdx.x; j < lb; j += kMergeThreads) s_in[la + j] = b_at(b0 + j);
  __syncthreads();

  const int len = la + lb;
  const int t0 = threadIdx.x * kMergeItems;
  if (t0 < len) {
    const uint32_t* sb = s_in + la;
    int ia = lanes::merge_path_split(t0, la, lb, [&](int i, int j) { return s_in[i] <= sb[j]; });
    int ib = t0 - ia;
    const int cnt = len - t0 < kMergeItems ? len - t0 : kMergeItems;
#pragma unroll
    for (int q = 0; q < kMergeItems; ++q) {
      if (q < cnt) {
        const bool take_a = ib >= lb || (ia < la && s_in[ia] <= sb[ib]);
        s_out[t0 + q] = take_a ? s_in[ia++] : sb[ib++];
      }
    }
  }
  __syncthreads();
  uint32_t* po = out + g * n + d0;
  for (int i = threadIdx.x; i < len; i += kMergeThreads) po[i] = s_out[i];
}

// ---- tile_compact_kernel -----------------------------------------------------

constexpr int kTile = 65536;
constexpr int kTileThreads = 1024;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kChunk = 4 * kTileThreads;  // rows a block scans at once
enum Mode { kCopy = 0, kCumsum = 1, kNetwork = 2 };

// The block's exclusive prefix sum of x (one value a thread) and, in
// total, the sum over the block.  s_warp holds kTileWarps ints.
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
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  total = s_warp[kTileWarps - 1];
  __syncthreads();  // s_warp is reused by the next chunk
  return before + inc - x;
}

__device__ __forceinline__ uint32_t word(const uint4& x, int q) {
  return q == 0 ? x.x : (q == 1 ? x.y : (q == 2 ? x.z : x.w));
}

template <int kMode>
__global__ void __launch_bounds__(kTileThreads)
    tile_compact_kernel(Ops in, OutOps out, int n_ops, const uint32_t* live) {
  __shared__ int s_warp[kTileWarps];
  __shared__ uint16_t s_rows[kMode == kNetwork ? kChunk : 1];  // network: the chunk's live rows (in-tile)
  const long long base = (long long)blockIdx.x * kTile;
  // The operand loops run over the most lanes there can be, unrolled, so
  // that the pointer arrays are indexed by constants.
  if constexpr (kMode == kCopy) {
#pragma unroll
    for (int o = 0; o < lanes::kMaxOps; ++o) {
      if (o < n_ops) {
        const uint4* src = reinterpret_cast<const uint4*>(in.p[o] + base);
        uint4* dst = reinterpret_cast<uint4*>(out.p[o] + base);
        for (int i = threadIdx.x; i < kTile / 4; i += kTileThreads) dst[i] = __ldcs(src + i);
      }
    }
    return;
  }
  int carry = 0;  // the dead (cumsum) or live (network) rows of the chunks before
#pragma unroll 1
  for (int c = 0; c < kTile; c += kChunk) {
    const int r = c + 4 * (int)threadIdx.x;  // the thread's first row in the tile
    const uint4 f = __ldcs(reinterpret_cast<const uint4*>(live + base + r));
    int on[4], mine = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      on[q] = kMode == kCumsum ? word(f, q) == 0u : word(f, q) != 0u;
      mine += on[q];
    }
    int total;
    const int before = carry + block_exclusive_scan(mine, s_warp, total);
    if constexpr (kMode == kCumsum) {
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
    } else {
      // The chunk's live rows by rank in shared memory, then a thread a
      // rank: every operand's value loaded before any is stored, so that a
      // chunk waits on one round trip to device memory (a load and a store
      // a row and operand in turn waited on one round trip each).
      int k = before - carry;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (on[q]) s_rows[k++] = (uint16_t)(r + q);
      }
      __syncthreads();
      for (int t = threadIdx.x; t < total; t += kTileThreads) {
        const long long src = base + s_rows[t], dst = base + carry + t;
        uint32_t v[lanes::kMaxOps];
#pragma unroll
        for (int o = 0; o < lanes::kMaxOps; ++o) {
          if (o < n_ops) v[o] = __ldcs(in.p[o] + src);
        }
#pragma unroll
        for (int o = 0; o < lanes::kMaxOps; ++o) {
          if (o < n_ops) out.p[o][dst] = v[o];
        }
      }
    }
    carry += total;  // the next chunk's scan synchronises before s_rows is written again
  }
  if constexpr (kMode == kNetwork) {
#pragma unroll
    for (int o = 0; o < lanes::kMaxOps; ++o) {
      if (o < n_ops) {
        for (int i = carry + (int)threadIdx.x; i < kTile; i += kTileThreads) out.p[o][base + i] = 0u;
      }
    }
  }
}

// ---- row_gather_kernel -------------------------------------------------------

constexpr int kGatherThreads = 128;
constexpr int kGatherBlocks = 132 * 16;  // at most; blocks stride over the output rows

// A block an output row at a time: its source row from 32-bit arithmetic
// (no 64-bit division, whose call spilled registers), then the row's words.
// start % R and shift (already taken % R) each lie in (-R, R) and j in
// [0, R), so two additions or subtractions of R bring their sum into
// [0, R) whatever the start.
__global__ void __launch_bounds__(kGatherThreads)
    row_gather_kernel(const uint32_t* x, const int* starts, uint32_t* out, int R, long long W, int rows,
                      int shift, int out_rows) {
  for (int row = blockIdx.x; row < out_rows; row += gridDim.x) {
    const int g = row / rows, j = row - g * rows;
    long long v = (long long)(starts[g] % R) + shift + j;
    if (v < 0) v += R;
    if (v < 0) v += R;
    if (v >= R) v -= R;
    if (v >= R) v -= R;
    const uint32_t* src = x + v * W;
    uint32_t* dst = out + (long long)row * W;
    for (long long c = threadIdx.x; c < W; c += kGatherThreads) dst[c] = src[c];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

int pr_tile() { return kTile; }

// G pairs: a [G, ta] ascending, b [G, tb] descending (b_desc) or
// ascending, out [G, ta + tb]; all contiguous, G * (ta + tb) > 0.
// Returns a cudaError_t.
int pr_pair_merge(const void* a, const void* b, void* out, long long G, long long ta, long long tb, int b_desc,
                  void* stream) {
  const long long tiles = (ta + tb + kMergeTile - 1) / kMergeTile;
  if (G < 1 || ta < 0 || tb < 0 || tiles < 1 || G * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (b_desc) {
    pair_merge_kernel<true><<<(unsigned)(G * tiles), kMergeThreads, 0, s>>>(pa, pb, po, ta, tb, tiles);
  } else {
    pair_merge_kernel<false><<<(unsigned)(G * tiles), kMergeThreads, 0, s>>>(pa, pb, po, ta, tb, tiles);
  }
  return (int)cudaGetLastError();
}

// n_ops operand lanes and n_ops output lanes of n rows, and the live
// flags: n a positive multiple of the tile, every pointer on a 16-byte
// boundary, mode 0 copy, 1 cumsum, 2 network.  Returns a cudaError_t.
int pr_tile_compact(const void* const* in, void* const* out, int n_ops, const void* live, long long n, int mode,
                    void* stream) {
  if (n_ops < 1 || n_ops > lanes::kMaxOps || n < kTile || n % kTile || n / kTile > 0x7FFFFFFFLL || mode < 0 ||
      mode > 2 || !aligned16(live)) {
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
    default: tile_compact_kernel<kNetwork><<<grid, kTileThreads, 0, s>>>(ins, outs, n_ops, lv); break;
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
  row_gather_kernel<<<out_rows < kGatherBlocks ? out_rows : kGatherBlocks, kGatherThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const uint32_t*>(x),
                                                           static_cast<const int*>(starts),
                                                           static_cast<uint32_t*>(out), (int)R, W, rows,
                                                           (int)(shift % R), out_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
