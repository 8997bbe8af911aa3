// compact_live.cu — stable stream compaction for Hopper (sm_90a).
//
// Replaces kmer_counter_tpu/ops/pallas_sort.py compact_live (K2).
//
// Computes, for n_ops value lanes of n rows and a live flag per row: the
// rows with live != 0 packed to the front in their original order; every
// row after them holds 0xFFFFFFFF in the first num_keys lanes (the
// sentinel key) and 0 in the rest.  The output is out_rows <= n rows wide:
// live rows of rank out_rows and above are not written.
//
// What bounds it: memory.  It must read the flags (4 bytes a row) and the
// other lanes of the live rows, and write every output row (n_ops*4 bytes),
// at 3.35 TB/s; at the two-level table's densities (a few percent live)
// that is about 4 bytes a row and n_ops*4 bytes an output row.  There is no arithmetic to speak
// of.  So the flags are read once, and the fill, most of the bytes, is
// written with 16-byte stores.
//
// Design.  The Pallas kernel appends each tile's live rows at a running
// offset kept in SMEM across its in-order grid.  CUDA blocks run in no
// order, so the offsets come from a single-pass chained scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016):
//   1. compact: a block takes its tile from an atomic ticket, so every
//      tile before it belongs to a block that has started and finishes
//      without waiting on it.  It reads the tile's flags with 16-byte loads
//      and ranks its live rows with warp ballots (each warp lists its live
//      rows by rank in shared memory); publishes the tile's live count (its
//      aggregate) in the tile's 64-bit status word; looks back over the
//      words of the tiles before it, 32 at a time, one per lane of a warp,
//      adding aggregates up to the nearest inclusive prefix; then publishes
//      its own inclusive prefix and writes its live rows of rank below
//      out_rows to consecutive slots, each lane of the warp taking every
//      32nd of them, every value of a row loaded before any is stored.
//   2. fill: a write-only launch reads the live total (the last tile's
//      inclusive prefix) and writes every row from it (or from out_rows, if
//      less) up to out_rows, lane after lane, with 16-byte stores,
//      grid-stride.
// A status word holds its flag in the top two bits (0 nothing yet, 1 the
// aggregate, 2 the inclusive prefix) and the value below them, written and
// read whole (volatile), so a reader sees a flag and its value together.
// The caller zeroes the words, and the ticket after them, on the stream.
//
// Tiles lie on the flags' 16-byte grid: flag row r is "virtual" row r +
// shift, shift being how many words the flags start past a 16-byte
// boundary, so that every flag load is an aligned 16-byte load.  A load
// that holds virtual rows below shift or from n + shift on reads words of
// the same 16-byte chunk as the first or last flag, which are not rows and
// count as dead.  Any n works.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::Ops;
using lanes::OutOps;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;                   // 16-byte flag loads per thread
constexpr int kWarpRows = 32 * 4 * kSteps;  // rows of a tile per warp
constexpr int kTile = kWarps * kWarpRows;   // rows per block
constexpr int kFillThreads = 256;
constexpr long long kFillBlocks = 132 * 8;  // at most; the fill is grid-stride

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}

__device__ __forceinline__ void store_status(unsigned long long* w, unsigned long long x) {
  *reinterpret_cast<volatile unsigned long long*>(w) = x;
}

__device__ __forceinline__ uint32_t word(const uint4& x, int q) {
  return q == 0 ? x.x : (q == 1 ? x.y : (q == 2 ? x.z : x.w));
}

__host__ __device__ __forceinline__ int shift_of(const void* live) {
  return (int)(((uintptr_t)live & 15u) >> 2);
}

// The live rows before tile t > 0, found by one warp.  First lane 0 alone
// waits, with a growing pause, until tile t-1 has published something (a
// block usually looks back while the block before it still loads its
// flags, and a whole warp polling then would load L2 for nothing).  Then
// lane k reads the status word of tile end-1-k; the warp waits while a tile
// nearer than the nearest inclusive prefix has published nothing, adds the
// values from the nearest tile up to and including that prefix, and moves
// 32 tiles back when there is none.  Tile 0 publishes its inclusive prefix
// at once, so the walk ends there at the latest.  (Reading 8 words a lane,
// 256 tiles a round, took longer: the polling loads L2.)  Every lane
// returns it.
__device__ long long look_back(const unsigned long long* status, long long t, int lane) {
  if (lane == 0) {
    for (unsigned ns = 32; (load_status(status + t - 1) >> 62) == 0; ns = ns < 1024 ? 2 * ns : ns) {
      __nanosleep(ns);
    }
  }
  __syncwarp();
  long long excl = 0;
  unsigned ns = 32;
  for (long long end = t;;) {
    const long long i = end - 1 - lane;
    const unsigned long long w = i >= 0 ? load_status(status + i) : kPrefix;
    const unsigned prefix = __ballot_sync(0xFFFFFFFFu, (w >> 62) == 2);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    if (__any_sync(0xFFFFFFFFu, lane <= stop && (w >> 62) == 0)) {
      __nanosleep(ns);
      ns = ns < 1024 ? 2 * ns : ns;
      continue;
    }
    long long v = lane <= stop ? (long long)(w & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    excl += v;
    if (prefix) return excl;
    end -= 32;
  }
}

// Few registers a thread, so that 5 blocks share an SM: a block spends most
// of its life waiting (ticket, flags, look-back, live rows), and the
// others fill the time.
__global__ void __launch_bounds__(kThreads, 5)
    compact_kernel(Ops in, OutOps out, int n_ops, const uint32_t* live, long long n, long long out_rows,
                   unsigned long long* status, unsigned long long* ticket) {
  __shared__ long long s_tile, s_excl;
  __shared__ int s_warp[kWarps];
  __shared__ uint16_t s_rows[kWarps][kWarpRows];  // a warp's live rows, by rank
  if (threadIdx.x == 0) s_tile = (long long)atomicAdd(ticket, 1ull);
  __syncthreads();
  const long long t = s_tile;
  const int shift = shift_of(live);
  const long long nv = n + shift;
  const uint4* flags = reinterpret_cast<const uint4*>(live - shift);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The warp's virtual rows: w0 + 128*j + 4*lane + q, step j < kSteps, q < 4.
  const long long w0 = t * kTile + (long long)warp * kWarpRows;

  uint4 f[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const long long v = w0 + 128 * j + 4 * lane;
    f[j] = v < nv ? __ldcs(flags + v / 4) : make_uint4(0u, 0u, 0u, 0u);
  }
  // Each live row's rank among the warp's live rows: the live rows of the
  // steps before, of the lanes before in its step, and its own before it.
  const unsigned below = (1u << lane) - 1u;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    unsigned m[4];
    bool on[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long v = w0 + 128 * j + 4 * lane + q;
      on[q] = v >= shift && v < nv && word(f[j], q) != 0u;
      m[q] = __ballot_sync(0xFFFFFFFFu, on[q]);
    }
    int k = c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      k += __popc(m[q] & below);
      c += __popc(m[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (on[q]) s_rows[warp][k++] = (uint16_t)(128 * j + 4 * lane + q);
    }
  }
  if (lane == 0) s_warp[warp] = c;
  __syncthreads();

  if (warp == 0) {
    long long agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) agg += s_warp[w];
    long long excl = 0;
    if (t > 0) {
      if (lane == 0) store_status(status + t, kAggregate | (unsigned long long)agg);
      excl = look_back(status, t, lane);
    }
    if (lane == 0) {
      store_status(status + t, kPrefix | (unsigned long long)(excl + agg));
      s_excl = excl;
    }
  }
  __syncthreads();

  // The warp's live rows go to consecutive slots from pos0, those below
  // out_rows, lane k taking ranks k, k+32, ...: every lane of a row loaded
  // (unrolled over the most lanes there can be, so that the pointer arrays
  // are indexed by constants), then stored, so the stores of a warp are
  // coalesced.
  long long pos0 = s_excl;
  for (int w = 0; w < warp; ++w) pos0 += s_warp[w];
  const long long row0 = w0 - shift;
  const long long room = out_rows - pos0;
  const int take = room <= 0 ? 0 : (room < c ? (int)room : c);
  for (int k = lane; k < take; k += 32) {
    const long long r = row0 + s_rows[warp][k];
    uint32_t x[lanes::kMaxOps];
#pragma unroll
    for (int l = 0; l < lanes::kMaxOps; ++l) {
      if (l < n_ops) x[l] = __ldg(in.p[l] + r);
    }
#pragma unroll
    for (int l = 0; l < lanes::kMaxOps; ++l) {
      if (l < n_ops) out.p[l][pos0 + k] = x[l];
    }
  }
}

// Rows [min(live total, out_rows), out_rows) of every lane: the sentinel in
// the first num_keys lanes, 0 in the rest.
__global__ void __launch_bounds__(kFillThreads)
    fill_kernel(OutOps out, int n_ops, int num_keys, long long out_rows,
                const unsigned long long* last_status) {
  const long long total = (long long)(*last_status & kValue);
  const long long lt = total < out_rows ? total : out_rows;
  const long long g = (long long)blockIdx.x * kFillThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kFillThreads;
  const long long len = out_rows - lt;
#pragma unroll
  for (int l = 0; l < lanes::kMaxOps; ++l) {
    if (l >= n_ops) break;
    const uint32_t x = l < num_keys ? 0xFFFFFFFFu : 0u;
    uint32_t* p = out.p[l] + lt;
    const long long head = lanes::head_rows(p, len);
    const long long body = (len - head) / 4;
    uint4* v = reinterpret_cast<uint4*>(p + head);
    for (long long i = g; i < body; i += stride) v[i] = make_uint4(x, x, x, x);
    if (g < 6) {  // head rows [0, head), tail rows [head + 4*body, len)
      const long long r = g < head ? g : g + 4 * body;
      if (r < len) p[r] = x;
    }
  }
}

}  // namespace

extern "C" {

int cl_tile_rows() { return kTile; }

// Tiles of n flag rows at `live` (the status words the caller zeroes are
// one per tile, then the ticket).
long long cl_num_tiles(const void* live, long long n) {
  return lanes::num_tiles(n + shift_of(live), kTile);
}

// Both launches.  in_ptrs / out_ptrs: host arrays of n_ops device pointers
// to [n] and [out_rows] lanes, 0 < out_rows <= n; live: [n] uint32;
// scratch: cl_num_tiles(live, n) + 1 int64 words, zero.  Returns a
// cudaError_t.
int cl_compact(const void* const* in_ptrs, void* const* out_ptrs, int n_ops, int num_keys,
               const void* live, long long n, long long out_rows, void* scratch, void* stream) {
  if (n <= 0 || out_rows <= 0 || out_rows > n || n_ops < 1 || n_ops > lanes::kMaxOps || num_keys < 0 ||
      num_keys > n_ops) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = cl_num_tiles(live, n);
  auto* status = static_cast<unsigned long long*>(scratch);
  const OutOps out = lanes::make_out_ops(out_ptrs, n_ops);
  auto s = static_cast<cudaStream_t>(stream);
  compact_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      lanes::make_ops(in_ptrs, n_ops), out, n_ops, static_cast<const uint32_t*>(live), n, out_rows, status,
      status + tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long want = lanes::num_tiles(out_rows, 4LL * kFillThreads);
  fill_kernel<<<(unsigned)(want < kFillBlocks ? want : kFillBlocks), kFillThreads, 0, s>>>(
      out, n_ops, num_keys, out_rows, status + tiles - 1);
  return cudaGetLastError();
}

}  // extern "C"
