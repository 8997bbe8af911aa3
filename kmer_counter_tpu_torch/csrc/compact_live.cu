// compact_live.cu — stable stream compaction for Hopper (sm_90a).
//
// Replaces kmer_counter_tpu/ops/pallas_sort.py compact_live (K2).
//
// Computes, for n_ops value lanes of n rows and a live flag per row: the
// rows with live != 0 packed to the front in their original order; every
// row after them holds 0xFFFFFFFF in the first num_keys lanes (the
// sentinel key) and 0 in the rest.  The output has the input's widths.
//
// What bounds it: memory.  It must read the flags (4 bytes a row) and the
// other lanes of the live rows, and write every output row (n_ops*4 bytes),
// at 3.35 TB/s; at the two-level table's densities (a few percent live)
// that is about n_ops*4 + 4 bytes a row.  There is no arithmetic to speak
// of.
//
// Design.  The Pallas kernel appends each tile's live prefix at a running
// offset kept in SMEM across its in-order grid.  CUDA blocks run in no
// order, so:
//   1. count:   each block counts the live rows of its tile (warp ballots);
//   2. (torch, between launches) a cumsum of the per-tile counts gives
//      each tile its output offset and the live total;
//   3. compact: each warp takes a contiguous stretch of its tile and keeps
//      one ballot of its flags per 32 rows in registers; the block's warps
//      add up their live counts in order; then, lane by lane, each live
//      row goes to offset + the live rows before it (popcounts of the
//      ballots).  Reads are coalesced, and consecutive live rows are
//      written to consecutive slots.  The block then fills its share of
//      the rows past the live total.
// The flags are read twice, once by each pass.  Any n works.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::Ops;
using lanes::OutOps;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 512;                // rows of a tile per warp
constexpr int kTile = kWarps * kWarpRows;     // rows per block

constexpr int kWarpSteps = kWarpRows / 32;     // ballots per warp stretch

// The ballots of a warp's stretch of rows [w0, w0 + kWarpRows) (bit i of
// m[s]: row w0 + 32*s + i is live).  All the flag loads are in flight at
// once.  Returns the stretch's live count.
__device__ __forceinline__ int warp_ballots(const uint32_t* live, long long w0, long long d1,
                                            int lane, unsigned (&m)[kWarpSteps]) {
  int c = 0;
#pragma unroll
  for (int s = 0; s < kWarpSteps; ++s) {
    const long long r = w0 + 32 * s + lane;
    m[s] = __ballot_sync(0xFFFFFFFFu, r < d1 && live[r] != 0u);
    c += __popc(m[s]);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint32_t* live, long long n, long long* tile_live) {
  __shared__ int s_warp[kWarps];
  const long long t = blockIdx.x;
  const long long d0 = t * kTile;
  const long long d1 = d0 + kTile < n ? d0 + kTile : n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned m[kWarpSteps];
  const int c = warp_ballots(live, d0 + (long long)warp * kWarpRows, d1, lane, m);
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += s_warp[w];
    tile_live[t] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
    compact_kernel(Ops in, OutOps out, int n_ops, int num_keys, const uint32_t* live,
                   long long n, const long long* tile_off, const long long* live_total) {
  __shared__ int s_warp[kWarps];
  const long long t = blockIdx.x;
  const long long d0 = t * kTile;
  const long long d1 = d0 + kTile < n ? d0 + kTile : n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long w0 = d0 + (long long)warp * kWarpRows;
  unsigned m[kWarpSteps];
  const int c = warp_ballots(live, w0, d1, lane, m);
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();
  long long pos0 = tile_off[t];
  for (int w = 0; w < warp; ++w) pos0 += s_warp[w];
  const unsigned below = (1u << lane) - 1u;
  // Lane by lane (unrolled over the most lanes there can be, so that the
  // pointer arrays are indexed by constants): every live row's value is
  // loaded first, then stored, so that the loads overlap rather than each
  // waiting behind the store before it.
#pragma unroll
  for (int l = 0; l < lanes::kMaxOps; ++l) {
    if (l >= n_ops) break;
    uint32_t v[kWarpSteps];
#pragma unroll
    for (int s = 0; s < kWarpSteps; ++s) {
      if ((m[s] >> lane) & 1u) v[s] = in.p[l][w0 + 32 * s + lane];
    }
    long long pos = pos0;
#pragma unroll
    for (int s = 0; s < kWarpSteps; ++s) {
      if ((m[s] >> lane) & 1u) out.p[l][pos + __popc(m[s] & below)] = v[s];
      pos += __popc(m[s]);
    }
  }
  // This tile's share of the rows past the live ones.
  const long long lt = *live_total;
  for (long long r = (d0 > lt ? d0 : lt) + threadIdx.x; r < d1; r += kThreads) {
#pragma unroll
    for (int l = 0; l < lanes::kMaxOps; ++l) {
      if (l < n_ops) out.p[l][r] = l < num_keys ? 0xFFFFFFFFu : 0u;
    }
  }
}

}  // namespace

extern "C" {

int cl_tile_rows() { return kTile; }

// Pass 1.  live: [n] uint32; tile_live: [num_tiles] int64.  Returns a
// cudaError_t.
int cl_count(const void* live, long long n, void* tile_live, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = lanes::num_tiles(n, kTile);
  count_kernel<<<(unsigned)tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(live), n, static_cast<long long*>(tile_live));
  return cudaGetLastError();
}

// Pass 3.  in_ptrs / out_ptrs: host arrays of n_ops device pointers to [n]
// lanes; tile_off: [num_tiles] int64 (exclusive cumsum of pass 1's counts);
// live_total: one int64.
int cl_compact(const void* const* in_ptrs, void* const* out_ptrs, int n_ops, int num_keys,
               const void* live, long long n, const void* tile_off, const void* live_total,
               void* stream) {
  if (n <= 0 || n_ops < 1 || n_ops > lanes::kMaxOps || num_keys < 0 || num_keys > n_ops) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = lanes::num_tiles(n, kTile);
  compact_kernel<<<(unsigned)tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lanes::make_ops(in_ptrs, n_ops), lanes::make_out_ops(out_ptrs, n_ops), n_ops, num_keys,
      static_cast<const uint32_t*>(live), n, static_cast<const long long*>(tile_off),
      static_cast<const long long*>(live_total));
  return cudaGetLastError();
}

}  // extern "C"
