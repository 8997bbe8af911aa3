// fused_extract.cu — the chunk step's k-mer extraction for Hopper (sm_90a).
//
// Replaces docs/experiments_pallas_extract.py extract_chunk_lanes_major (K8,
// :132; its body _extract_kernel, :57): the fusion of the JAX package's
// ops.encode and ops.extract into one pass over a chunk's reads.
//
// Computes, for reads [R, L] uint8 (ASCII: A, C, G, T = 0..3 in either case,
// any other byte invalid and coded 3) and k in 1..128, every window p < P =
// L-k+1 of every read, read-major (window w = r*P + p): its NL = ceil(k/16)
// key lanes of 16 bases, 2 bits a base, MSB-first, the last lane's unused
// bases 0; with `canonical`, the lexicographic minimum of those lanes and the
// reverse complement's (left-aligned the same way; a tie keeps the forward
// lanes).  A window is valid when its k bases are all A/C/G/T.  Two modes:
//   records: lane i of window w at dst[i*ld + off + w] and its validity (1 or
//            0) at dst[NL*ld + off + w]; every window's lanes as computed.
//   keys:    lane i at dst[i*ld + off + w]; a masked window gets 0xFFFFFFFF in
//            every lane.  When k % 16 == 0 and not canonical, a valid all-T
//            window is bit-identical to that sentinel: it is added to *allt
//            (int64), one atomicAdd a block, and written as the sentinel.
// Any R >= 1 and L >= k; window and destination offsets are 64-bit.
//
// What bounds it: memory.  It must read the R*L bytes of the reads once and
// write 4*NL bytes a window (keys) or 4*(NL+1) (records): at the main chunk
// step (396,825 reads x 100 bp, k=31, keys) 39.7 MB read and 222 MB written,
// 0.078 ms at 3.35 TB/s.  Its arithmetic is a few tens of 32-bit integer
// operations a window and lane.  So the reads are loaded once, with 16-byte
// loads; every intermediate stays in shared memory or registers (no int64
// temporaries, no scratch in device memory, no second pass); and
// consecutive threads write consecutive windows of each lane.
//
// Design.  The Pallas kernel takes a block of whole reads and builds every
// 16-base group with a log tree of shifts over the block (4 passes), then the
// validity with a log-doubling OR (7 passes at k=128).  Here a block takes the
// chunk as one flat byte array and kTile consecutive window starts b in [b0,
// b0 + kTile): short reads lie whole in a block, and a read longer than a
// tile is cut along the row into tiles that overlap by a halo of the 16*NL - 1
// >= k - 1 bases after the tile, so no read length is refused.  A block
//   1. loads bytes [b0, b0 + kTile + 16*NL) with aligned 16-byte loads into
//      shared memory (the loads start at the 16-byte boundary at or below b0;
//      bytes past the chunk are never used);
//   2. encodes them, 16 bases a thread: one word of 2-bit codes, MSB-first
//      (s_codes[j] holds local bases 16j..16j+15), and one 16-bit word of
//      invalid flags (bit m of s_inv16[j] for base 16j+m); a base past the
//      chunk or past the staged range is invalid;
//   3. for each window start (thread t takes starts t, t + 256, ...: a warp
//      writes 32 consecutive windows) that is a window (its column below P),
//      builds the 16 bases at any base q from two code words with one funnel
//      shift, so lane i is the group at q = p + 16i, tail-masked; the reverse
//      complement's full lane i is the complemented group at p + k - 16(i+1)
//      with its 2-bit groups reversed (__brev, then a swap within each pair),
//      its partial last lane the group at p reversed the same way and shifted
//      left; validity is the count of invalid bases in [p, p+k), a popcount
//      over at most five 32-bit flag words, equal to 0;
//   4. writes each lane's word at the window's index (and the validity plane
//      or the sentinel), and in keys mode adds the block's all-T windows to
//      *allt once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                  // window starts a block
constexpr int kStarts = kTile / kThreads;    // window starts a thread
constexpr int kHalo = 128;                   // staged bases past the tile: 16*NL <= 128
constexpr int kWords = (kTile + kHalo) / 16; // code words (and 16-bit flag words) a block
// Staged bytes: the tile, the halo and up to 15 bytes of alignment before b0,
// and the 16 bytes the encoding of the last word may read past them.
constexpr int kRawChunks = (15 + kTile + kHalo) / 16 + 2;

static_assert(kTile % kThreads == 0 && kTile % 32 == 0, "a tile is whole warps and flag words");

// Code of one ASCII base and whether it is one of A, C, G, T (either case):
// A=0, C=1, G=2, T=3, anything else 3 and invalid.
__device__ __forceinline__ uint32_t encode(uint32_t c, bool& invalid) {
  const uint32_t u = c & 0xDFu;  // clears bit 5: 'a', 'c', 'g', 't' become upper case, and no other byte does
  invalid = !(u == 'A' || u == 'C' || u == 'G' || u == 'T');
  return u == 'A' ? 0u : u == 'C' ? 1u : u == 'G' ? 2u : 3u;
}

// The sixteen 2-bit groups of v in reverse order.
__device__ __forceinline__ uint32_t rev_groups(uint32_t v) {
  const uint32_t x = __brev(v);  // reverses the groups and the two bits of each
  return ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
}

template <int NL, bool kCanonical, bool kKeys>
__global__ void __launch_bounds__(kThreads)
    extract_kernel(const uint8_t* __restrict__ reads, long long R, long long L, int k,
                   uint32_t* __restrict__ dst, long long ld, long long off,
                   unsigned long long* __restrict__ allt) {
  __shared__ uint4 s_raw[kRawChunks];
  __shared__ uint32_t s_codes[kWords];
  __shared__ uint32_t s_inv[kWords / 2];  // as 16-bit words: s_inv16[j] flags bases 16j..16j+15
  __shared__ unsigned long long s_allt;

  const long long N = R * L;  // bytes of the chunk
  const long long P = L - k + 1;
  const long long b0 = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int shift = (int)((uintptr_t)(reads + b0) & 15u);
  const int staged = kTile + 16 * NL;  // local bases [0, staged) are loaded (those below N - b0)

  // 1. Aligned 16-byte loads of [b0 - shift, b0 + staged); a chunk is loaded
  // when it holds a byte of the reads.
  {
    const uint4* src = reinterpret_cast<const uint4*>(reads + b0 - shift);
    const int chunks = (shift + staged + 15) / 16;
    for (int c = tid; c < chunks; c += kThreads) {
      if (b0 - shift + 16LL * c < N) s_raw[c] = __ldg(src + c);
    }
  }
  if (kKeys && tid == 0) s_allt = 0;
  __syncthreads();

  // 2. Encode 16 bases a thread.
  {
    const uint32_t* raw32 = reinterpret_cast<const uint32_t*>(s_raw);
    uint16_t* s_inv16 = reinterpret_cast<uint16_t*>(s_inv);
    const long long limit = N - b0 < staged ? N - b0 : staged;  // local bases that hold read bytes
    for (int j = tid; j < kWords; j += kThreads) {
      const int o = shift + 16 * j;  // byte offset of base 16j in s_raw
      const int w = o >> 2, s = 8 * (o & 3);
      uint32_t code = 0, inv = 0;
#pragma unroll
      for (int m4 = 0; m4 < 4; ++m4) {
        const uint32_t bytes = __funnelshift_r(raw32[w + m4], raw32[w + m4 + 1], s);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int m = 4 * m4 + b;
          bool bad;
          uint32_t c = encode((bytes >> (8 * b)) & 0xFFu, bad);
          if (16 * j + m >= limit) {
            c = 3u;
            bad = true;
          }
          code |= c << (30 - 2 * m);
          inv |= (uint32_t)bad << m;
        }
      }
      s_codes[j] = code;
      s_inv16[j] = (uint16_t)inv;
    }
  }
  __syncthreads();

  // 3-4. Windows.  The row and column of local base p: b0 = r0*L + c0.
  const long long r0 = b0 / L, c0 = b0 - r0 * L;
  const bool allt_on = kKeys && !kCanonical && (k % 16 == 0);
  unsigned my_allt = 0;
  // The 16 bases from local base q, MSB-first.
  auto group = [&](int q) -> uint32_t {
    const int j = q >> 4;
    return __funnelshift_l(s_codes[j + 1], s_codes[j], 2 * (q & 15));
  };
#pragma unroll 1
  for (int it = 0; it < kStarts; ++it) {
    const int p = it * kThreads + tid;
    if (b0 + p >= N) break;
    long long col = c0 + p, row = r0;
    if (L >= kTile) {  // c0 < L and p < kTile <= L
      if (col >= L) {
        col -= L;
        ++row;
      }
    } else {  // col < L + kTile < 2*kTile
      const uint32_t d = (uint32_t)col / (uint32_t)L;
      row += d;
      col -= (long long)d * L;
    }
    if (col >= P) continue;
    const long long w = row * P + col;

    uint32_t key[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int n = k - 16 * i < 16 ? k - 16 * i : 16;
      key[i] = group(p + 16 * i) & (n == 16 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (2 * n)));
    }
    if (kCanonical) {
      uint32_t rc[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int n = k - 16 * i < 16 ? k - 16 * i : 16;
        rc[i] = n == 16 ? rev_groups(~group(p + k - 16 * (i + 1)))
                        : rev_groups(~group(p)) << (2 * (16 - n));
      }
      bool take_rc = false, decided = false;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (!decided && rc[i] != key[i]) {
          take_rc = rc[i] < key[i];
          decided = true;
        }
      }
      if (take_rc) {
#pragma unroll
        for (int i = 0; i < NL; ++i) key[i] = rc[i];
      }
    }

    int bad = 0;  // invalid bases in [p, p + k)
    for (int q = p, end = p + k; q < end;) {
      const int lo = q & 31, hi = end - q + lo < 32 ? end - q + lo : 32;
      const uint32_t mask = (uint32_t)(((1ull << hi) - 1) & ~((1ull << lo) - 1));
      bad += __popc(s_inv[q >> 5] & mask);
      q += hi - lo;
    }
    const bool valid = bad == 0;

    uint32_t* out = dst + off + w;
    if (kKeys) {
      if (allt_on && valid) {
        bool all_ones = true;
#pragma unroll
        for (int i = 0; i < NL; ++i) all_ones = all_ones && key[i] == 0xFFFFFFFFu;
        my_allt += all_ones;
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) out[i * ld] = valid ? key[i] : 0xFFFFFFFFu;
    } else {
#pragma unroll
      for (int i = 0; i < NL; ++i) out[i * ld] = key[i];
      out[NL * ld] = valid ? 1u : 0u;
    }
  }

  if (allt_on) {
    for (int o = 16; o > 0; o >>= 1) my_allt += __shfl_xor_sync(0xFFFFFFFFu, my_allt, o);
    if ((tid & 31) == 0 && my_allt) atomicAdd(&s_allt, (unsigned long long)my_allt);
    __syncthreads();
    if (tid == 0 && s_allt) atomicAdd(allt, s_allt);
  }
}

template <int NL>
cudaError_t launch(const uint8_t* reads, long long R, long long L, int k, bool canonical, bool keys,
                   uint32_t* dst, long long ld, long long off, unsigned long long* allt, cudaStream_t s) {
  const long long blocks = (R * L + kTile - 1) / kTile;
  const dim3 grid((unsigned)blocks);
  if (keys) {
    if (canonical) {
      extract_kernel<NL, true, true><<<grid, kThreads, 0, s>>>(reads, R, L, k, dst, ld, off, allt);
    } else {
      extract_kernel<NL, false, true><<<grid, kThreads, 0, s>>>(reads, R, L, k, dst, ld, off, allt);
    }
  } else if (canonical) {
    extract_kernel<NL, true, false><<<grid, kThreads, 0, s>>>(reads, R, L, k, dst, ld, off, allt);
  } else {
    extract_kernel<NL, false, false><<<grid, kThreads, 0, s>>>(reads, R, L, k, dst, ld, off, allt);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fx_tile_bases() { return kTile; }

// One launch.  reads: [R, L] uint8, row-major, contiguous, R >= 1, L >= k,
// 1 <= k <= 128; dst: NL rows (keys) or NL + 1 rows (records) of ld uint32
// each, the chunk's R*(L-k+1) windows written at columns [off, off +
// R*(L-k+1)); allt: one int64 (keys mode; unused in records mode).  Returns
// a cudaError_t.
int fx_extract(const void* reads, long long R, long long L, int k, int canonical, int keys, void* dst,
               long long ld, long long off, void* allt, void* stream) {
  if (R < 1 || k < 1 || k > 128 || L < k || off < 0 || ld < off + R * (L - k + 1) || (keys && !allt) ||
      R * L / kTile >= 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* r = static_cast<const uint8_t*>(reads);
  auto* d = static_cast<uint32_t*>(dst);
  auto* a = static_cast<unsigned long long*>(allt);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((k + 15) / 16) {
    case 1: return launch<1>(r, R, L, k, canonical, keys, d, ld, off, a, s);
    case 2: return launch<2>(r, R, L, k, canonical, keys, d, ld, off, a, s);
    case 3: return launch<3>(r, R, L, k, canonical, keys, d, ld, off, a, s);
    case 4: return launch<4>(r, R, L, k, canonical, keys, d, ld, off, a, s);
    case 5: return launch<5>(r, R, L, k, canonical, keys, d, ld, off, a, s);
    case 6: return launch<6>(r, R, L, k, canonical, keys, d, ld, off, a, s);
    case 7: return launch<7>(r, R, L, k, canonical, keys, d, ld, off, a, s);
    default: return launch<8>(r, R, L, k, canonical, keys, d, ld, off, a, s);
  }
}

}  // extern "C"
