// records.cu — the dump's record image, packed on the card (sm_90a).
//
// Replaces no TPU kernel.  The JAX package formats the dump on the host
// (kmer_counter_tpu/io/dump.py dump_table: the count filter,
// records.lanes_to_words and records.serialize_table) from a table copied
// back and transposed to row-major.  This kernel writes the same bytes on
// the card from the finalized lane-major table, so that only the record
// image crosses the bus and the host neither transposes nor formats.
//
// Computes, for a table of n rows (NL uint32 key lanes, lane l of row r at
// lanes[l * stride + r], and a uint32 count per row): for every row whose
// count is not 0, in row order, its reference record: W = ceil(NL/2)
// little-endian uint64 words, word w = lane[2w] << 32 | lane[2w+1] (a zero
// lane NL when NL is odd), then the little-endian uint32 count.  As uint32
// words a record is lane[1], lane[0], lane[3], lane[2], ..., count: RW =
// 2W + 1 words, written back to back from the output's first word.
//
// What bounds it: memory.  It reads 4 (NL + 1) bytes a row and writes
// 4 RW bytes a kept row, nothing to compute: at NL = 2, 24 bytes a row,
// about 7 us a million rows at 3.35 TB/s.  The counts are read twice (the
// count pass and the pack), 4 bytes a row more.
//
// Design.  Three launches on the caller's stream:
//   1. record_count_kernel: a block a tile of kTile rows counts the tile's rows
//      with a nonzero count (__syncthreads_count), one int64 a tile.
//   2. record_scan_kernel: one block turns the tiles' counts into exclusive
//      offsets (cub::BlockScan in a loop with a carry) and writes the
//      total after them, where the wrapper reads it.
//   3. record_pack_kernel: a block a tile loads its rows' counts and lanes with
//      coalesced 4-byte loads (each lane of a tile is one contiguous run),
//      all of them before any use; ranks its kept rows by warp ballots
//      (one exclusive warp scan over the tile's 32 (step, warp) counts);
//      writes each kept row's RW words into a shared-memory image of the
//      tile at its rank (RW is odd, so a warp's writes hit 32 banks); and
//      stores the image with 16-byte stores.  A record of 12 bytes (NL <=
//      2) does not align to 16, so the image is staged at the same offset
//      modulo 16 bytes as its place in the output: each 16-byte chunk of
//      the output that the tile fills whole is one aligned shared load and
//      one aligned store, and only the tile's first and last chunk are
//      stored a word at a time.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;                 // rows a thread
constexpr int kTile = kThreads * kSteps;  // rows a block
// 512 threads leave a thread 128 registers: at 1024 the 64-bit block scan
// spilled (172 bytes).
constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int kMaxLanes = 8;
static_assert(kSteps * kWarps == 32, "one warp scans the tile's (step, warp) counts");

__global__ void __launch_bounds__(kThreads)
    record_count_kernel(const uint32_t* __restrict__ counts, long long n, long long* __restrict__ tile_kept) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int kept = 0;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const long long row = base + j * kThreads + threadIdx.x;
    kept += __syncthreads_count(row < n && counts[row] != 0u);
  }
  if (threadIdx.x == 0) tile_kept[blockIdx.x] = kept;
}

using Scan = cub::BlockScan<long long, kScanThreads>;

__global__ void __launch_bounds__(kScanThreads) record_scan_kernel(long long* offsets, long long tiles) {
  __shared__ typename Scan::TempStorage temp;
  long long carry = 0;
  for (long long base = 0; base < tiles; base += static_cast<long long>(kScanThreads) * kScanItems) {
    const long long first = base + static_cast<long long>(threadIdx.x) * kScanItems;
    long long v[kScanItems];
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = first + i < tiles ? offsets[first + i] : 0;
      sum += v[i];
    }
    long long prefix, total;
    Scan(temp).ExclusiveSum(sum, prefix, total);
    prefix += carry;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (first + i < tiles) offsets[first + i] = prefix;
      prefix += v[i];
    }
    carry += total;
    __syncthreads();  // temp is reused
  }
  if (threadIdx.x == 0) offsets[tiles] = carry;
}

template <int NL>
__global__ void __launch_bounds__(kThreads)
    record_pack_kernel(const uint32_t* __restrict__ lanes, long long stride, const uint32_t* __restrict__ counts,
                       long long n, const long long* __restrict__ offsets, uint32_t* __restrict__ out) {
  constexpr int W = (NL + 1) / 2;
  constexpr int RW = 2 * W + 1;
  __shared__ __align__(16) uint32_t image[kTile * RW + 4];
  __shared__ int step_off[kSteps * kWarps];
  __shared__ int tile_kept;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  uint32_t* const first = out + offsets[blockIdx.x] * RW;
  // Words from the 16-byte boundary at or below the tile's first word.
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(first) >> 2) & 3);

  uint32_t key[kSteps][NL];
  uint32_t cnt[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const long long row = base + j * kThreads + threadIdx.x;
    const bool in = row < n;
    cnt[j] = in ? counts[row] : 0u;
#pragma unroll
    for (int l = 0; l < NL; ++l) key[j][l] = in ? lanes[l * stride + row] : 0u;
  }
  unsigned kept[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    kept[j] = __ballot_sync(0xFFFFFFFFu, cnt[j] != 0u);
    if (lane == 0) step_off[j * kWarps + warp] = __popc(kept[j]);
  }
  __syncthreads();
  if (warp == 0) {
    // Rows run step-major, then warp, then lane: the exclusive scan of the
    // 32 (step, warp) counts in that order is each one's first rank.
    const int v = step_off[lane];
    int inclusive = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, inclusive, d);
      if (lane >= d) inclusive += t;
    }
    step_off[lane] = inclusive - v;
    if (lane == 31) tile_kept = inclusive;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    if (cnt[j] == 0u) continue;
    const int rank = step_off[j * kWarps + warp] + __popc(kept[j] & below);
    uint32_t* r = image + shift + rank * RW;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      r[2 * w] = 2 * w + 1 < NL ? key[j][2 * w + 1] : 0u;
      r[2 * w + 1] = key[j][2 * w];
    }
    r[2 * W] = cnt[j];
  }
  __syncthreads();
  // The tile's words are image[shift, end), bound for dst[shift, end):
  // dst is 16-byte aligned, and its words below shift are not the tile's.
  const int end = shift + tile_kept * RW;
  uint32_t* const dst = first - shift;
  for (int c = threadIdx.x; 4 * c < end; c += kThreads) {
    const int w0 = 4 * c;
    if (w0 >= shift && w0 + 4 <= end) {
      *reinterpret_cast<uint4*>(dst + w0) = *reinterpret_cast<const uint4*>(image + w0);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int w = w0 + q;
        if (w >= shift && w < end) dst[w] = image[w];
      }
    }
  }
}

template <int NL>
void launch_pack(long long tiles, cudaStream_t s, const uint32_t* lanes, long long stride, const uint32_t* counts,
                 long long n, const long long* offsets, uint32_t* out) {
  record_pack_kernel<NL><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(lanes, stride, counts, n, offsets, out);
}

}  // namespace

extern "C" {

int rp_tile_rows() { return kTile; }

long long rp_num_tiles(long long n) { return (n + kTile - 1) / kTile; }

// The three launches.  lanes: nl lanes of n rows, lane l at lanes + l *
// stride (stride >= n when nl > 1); counts: [n]; scratch: rp_num_tiles(n)
// + 1 int64 words, which hold, once the launches have run, the kept rows
// before each tile and then the kept total; out: n * (2 ceil(nl/2) + 1)
// uint32 words, 16-byte aligned, of which the first kept total * that many
// are written.  Returns a cudaError_t.
int rp_pack(const void* lanes, long long stride, int nl, const void* counts, long long n, void* scratch, void* out,
            void* stream) {
  if (n <= 0 || nl < 1 || nl > kMaxLanes || (nl > 1 && stride < n)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long tiles = rp_num_tiles(n);
  auto s = static_cast<cudaStream_t>(stream);
  auto* offsets = static_cast<long long*>(scratch);
  const auto* c = static_cast<const uint32_t*>(counts);
  record_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(c, n, offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  record_scan_kernel<<<1, kScanThreads, 0, s>>>(offsets, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* l = static_cast<const uint32_t*>(lanes);
  auto* o = static_cast<uint32_t*>(out);
  switch (nl) {
    case 1: launch_pack<1>(tiles, s, l, stride, c, n, offsets, o); break;
    case 2: launch_pack<2>(tiles, s, l, stride, c, n, offsets, o); break;
    case 3: launch_pack<3>(tiles, s, l, stride, c, n, offsets, o); break;
    case 4: launch_pack<4>(tiles, s, l, stride, c, n, offsets, o); break;
    case 5: launch_pack<5>(tiles, s, l, stride, c, n, offsets, o); break;
    case 6: launch_pack<6>(tiles, s, l, stride, c, n, offsets, o); break;
    case 7: launch_pack<7>(tiles, s, l, stride, c, n, offsets, o); break;
    default: launch_pack<8>(tiles, s, l, stride, c, n, offsets, o); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
