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
// 0.078 ms at 3.35 TB/s.  So the reads are loaded once, with 16-byte loads;
// every intermediate stays in shared memory or registers (no scratch in
// device memory, no second pass); and a warp's 32 threads write 32
// consecutive windows of each lane.  Its arithmetic must stay below that
// time: a few tens of 32-bit instructions a window, none of them a division
// or a 64-bit operation, and nothing done again for each window that the
// staging can do once for each base.
//
// Design.  The Pallas kernel takes a block of whole reads and builds every
// 16-base group with a log tree of shifts over the block (4 passes), then the
// validity with a log-doubling OR (7 passes at k=128).  Here a block takes the
// chunk as one flat byte array and the windows that start in its kTile bytes
// [b0, b0 + kTile): short reads lie whole in a block, and a read longer than
// a tile is cut along the row into tiles whose windows read a halo of up to
// 16*NL - 1 >= k - 1 bases past the tile, so no read length is refused.  A
// block
//   1. stages the bytes from the 16-byte boundary at or below b0 (b0 - shift)
//      on: thread t loads the aligned 16 bytes t (zeros past the chunk) and
//      encodes them, 16 bases, into one word of 2-bit codes, MSB-first
//      (s_code[t]); the same word complemented with its groups reversed
//      (s_rc[t + 1]: the reverse complement's order); and 16 invalid flags
//      (bit m of s_inv16[t] for base 16t + m).  Four bytes at a time: the code
//      of A/C/G/T in either case is ((c >> 1) ^ (c >> 2)) & 3 in each byte, a
//      byte is valid when it equals the letter of its code (bit 5 cleared),
//      an invalid byte is coded 3, and one multiply gathers four codes (or
//      flags) into one byte.  256 threads stage 4096 bytes in one pass: the
//      tile, the halo and the alignment;
//   2. while it loads, two threads find the block's windows: those before b0
//      and those before b1 = min(b0 + kTile, N), each r*P + min(c, P) for
//      the byte's row r and column c (the block's only divisions);
//   3. gives thread t the block's windows t, t + 256, ...: window i of the
//      block lies d = (c0 + i) / P rows past the first window's (column c0),
//      so it starts at staged base q = q0 + i + d*(k - 1).  d is one multiply
//      (__umulhi by a multiplier the host computes for P) when reads are
//      shorter than a tile, and one compare (0 or 1) otherwise;
//   4. builds lane i of the window from two code words by one funnel shift,
//      the same shift for every lane (q + 16i has q's low bits), so the NL
//      lanes take NL + 1 shared loads; the reverse complement's lane i is one
//      funnel shift of two s_rc words at base q + k - 1 - 16i (again one
//      shift for all its lanes); the partial last lane of both is masked.
//      Validity: the window's k flags lie in ceil(k/32) = (NL+1)/2 funnel
//      shifts of adjacent 32-bit flag words, the last masked, OR'd and
//      compared with 0;
//   5. writes each lane's word at column off + w (and the validity plane or
//      the sentinel), and in keys mode adds the block's all-T windows to
//      *allt once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 128;  // staged bases past the tile: 16*NL <= 128
// Window starts a block: the tile, its halo and up to 15 bytes of alignment
// before it fill the 16 * kThreads staged bytes.
constexpr int kTile = 16 * kThreads - kHalo - 16;  // 3952
constexpr int kFlagWords = 16 * kThreads / 32;     // 32-bit invalid-flag words a block
// One multiply gathers the 2-bit codes at bits 0, 8, 16, 24 into the top byte,
// MSB-first (shifts 30, 20, 10, 0), and the flags at bits 3, 7, 11, ..., 31
// of two words into the top byte, base order from bit 24 (shifts 21, 14, 7,
// 0).  The other partial products land below bit 24 on bits of their own, so
// nothing carries into the top byte.
constexpr uint32_t kGatherCodes = (1u << 30) | (1u << 20) | (1u << 10) | 1u;
constexpr uint32_t kGatherFlags = (1u << 21) | (1u << 14) | (1u << 7) | 1u;

static_assert(kTile > 0 && kTile % 16 == 0, "a tile is whole aligned chunks");
static_assert(kTile + 15 + kHalo <= 16 * kThreads, "one staged chunk a thread covers the tile and its halo");

// Four ASCII bytes (base b in byte b) → their codes (byte b: A=0, C=1, G=2,
// T=3 in either case, anything else 3) and invalid flags (0x80 in byte b).
__device__ __forceinline__ uint32_t encode4(uint32_t x, uint32_t& bad) {
  const uint32_t u = x & 0xDFDFDFDFu;  // clears bit 5: 'a', 'c', 'g', 't' become upper case, and no other byte does
  const uint32_t c = ((u >> 1) ^ (u >> 2)) & 0x03030303u;
  // The letter of each code: 'A' + 0, 2, 6, 19 for codes 0..3 (no byte carries).
  const uint32_t letter = 0x41414141u + 2u * c + (c & 0x02020202u) + 11u * ((c >> 1) & c & 0x01010101u);
  const uint32_t diff = u ^ letter;
  bad = (((diff & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | diff) & 0x80808080u;  // a byte of diff that is not 0
  return c | (bad >> 6) | (bad >> 7);
}

// The sixteen 2-bit groups of v in reverse order.
__device__ __forceinline__ uint32_t rev_groups(uint32_t v) {
  const uint32_t x = __brev(v);  // reverses the groups and the two bits of each
  return ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
}

template <int NL, bool kCanonical, bool kKeys>
__global__ void __launch_bounds__(kThreads)
    extract_kernel(const uint8_t* __restrict__ reads, long long R, long long L, int k, uint32_t magic,
                   uint32_t* __restrict__ dst, long long ld, long long off, unsigned long long* __restrict__ allt) {
  __shared__ uint32_t s_code[kThreads];
  __shared__ uint32_t s_rc[kThreads + 1];  // s_rc[j + 1]: word j reverse-complemented; s_rc[0] below word 0
  __shared__ uint32_t s_inv[kFlagWords];   // as 16-bit words: s_inv16[j] flags bases 16j..16j+15
  __shared__ long long s_before[2];        // windows that start before b0, before b1
  __shared__ long long s_col0;             // b0's column
  __shared__ unsigned long long s_allt;

  const long long N = R * L;  // bytes of the chunk
  const long long P = L - k + 1;
  const long long b0 = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int shift = (int)((uintptr_t)(reads + b0) & 15u);

  // 1-2. Stage and encode 16 bytes a thread; two threads count windows.
  {
    const long long g = b0 - shift + 16LL * tid;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < N) v = __ldg(reinterpret_cast<const uint4*>(reads + g));
    if (tid < 2) {
      const long long b = tid == 0 ? b0 : (b0 + kTile < N ? b0 + kTile : N);
      const long long r = b / L, c = b - r * L;
      s_before[tid] = r * P + (c < P ? c : P);
      if (tid == 0) s_col0 = c;
    }
    if (kKeys && tid == 0) s_allt = 0;
    uint32_t f0, f1, f2, f3;
    const uint32_t y0 = encode4(v.x, f0) * kGatherCodes, y1 = encode4(v.y, f1) * kGatherCodes;
    const uint32_t y2 = encode4(v.z, f2) * kGatherCodes, y3 = encode4(v.w, f3) * kGatherCodes;
    const uint32_t code = __byte_perm(__byte_perm(y3, y2, 0x0073), __byte_perm(y1, y0, 0x0073), 0x5410);
    const uint32_t flags = __byte_perm(((f0 >> 4) | f1) * kGatherFlags, ((f2 >> 4) | f3) * kGatherFlags, 0x0073);
    s_code[tid] = code;
    s_rc[tid + 1] = rev_groups(~code);
    reinterpret_cast<uint16_t*>(s_inv)[tid] = (uint16_t)flags;
    if (tid == 0) s_rc[0] = 0;
  }
  __syncthreads();

  // 3-5. Windows.
  const long long w0 = s_before[0], col0 = s_col0;
  const int count = (int)(s_before[1] - w0);
  const bool in_row = col0 < P;  // the first window is in b0's row (else at column 0 of the next)
  const int q0 = shift + (in_row ? 0 : (int)(L - col0));
  const bool long_rows = L >= kTile;  // then a block's windows lie in at most two rows
  const uint32_t c0 = in_row ? (uint32_t)col0 : 0u;  // < P < kTile when !long_rows
  const long long left = in_row ? P - col0 : P;     // windows of the first window's row from it
  const int row_left = left < kTile ? (int)left : kTile;
  const int km1 = k - 1;
  const int n_last = k - 16 * (NL - 1);  // bases of the last lane
  const uint32_t lane_mask = n_last == 16 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (2 * n_last));
  constexpr int kFlagSpan = (NL + 1) / 2;  // ceil(k/32) flag words a window
  const int v_last = k - 32 * (kFlagSpan - 1);
  const uint32_t v_mask = v_last == 32 ? 0xFFFFFFFFu : (1u << v_last) - 1u;
  const bool allt_on = kKeys && !kCanonical && (k % 16 == 0);
  unsigned my_allt = 0;
  uint32_t* const out0 = dst + off + w0;

#pragma unroll 1
  for (int i = tid; i < count; i += kThreads) {
    const int d = long_rows ? (int)(i >= row_left) : (int)__umulhi(2u * (c0 + (uint32_t)i), magic);
    const int q = q0 + i + d * km1;  // staged base of the window's first base

    uint32_t key[NL];
    {
      const int j = q >> 4, s = 2 * (q & 15);
      uint32_t hi = s_code[j];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const uint32_t lo = s_code[j + l + 1];
        key[l] = __funnelshift_l(lo, hi, s);
        hi = lo;
      }
      key[NL - 1] &= lane_mask;
    }
    if (kCanonical) {
      const int e = q + km1;  // the window's last base: the reverse complement's first
      const int je = e >> 4, s = 30 - 2 * (e & 15);
      uint32_t rc[NL];
      uint32_t hi = s_rc[je + 1];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const uint32_t lo = s_rc[je - l];
        rc[l] = __funnelshift_l(lo, hi, s);
        hi = lo;
      }
      rc[NL - 1] &= lane_mask;
      bool take_rc = false, decided = false;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (!decided && rc[l] != key[l]) {
          take_rc = rc[l] < key[l];
          decided = true;
        }
      }
      if (take_rc) {
#pragma unroll
        for (int l = 0; l < NL; ++l) key[l] = rc[l];
      }
    }

    uint32_t bad = 0;  // invalid flags of bases q..q+k-1
    {
      const int jv = q >> 5, s = q & 31;
      uint32_t lo = s_inv[jv];
#pragma unroll
      for (int t = 0; t < kFlagSpan; ++t) {
        const uint32_t hi = s_inv[jv + t + 1];
        const uint32_t x = __funnelshift_r(lo, hi, s);
        bad |= t == kFlagSpan - 1 ? x & v_mask : x;
        lo = hi;
      }
    }
    const bool valid = bad == 0;

    uint32_t* out = out0 + i;
    if (kKeys) {
      if (allt_on && valid) {
        bool all_ones = true;
#pragma unroll
        for (int l = 0; l < NL; ++l) all_ones = all_ones && key[l] == 0xFFFFFFFFu;
        my_allt += all_ones;
      }
#pragma unroll
      for (int l = 0; l < NL; ++l) out[l * ld] = valid ? key[l] : 0xFFFFFFFFu;
    } else {
#pragma unroll
      for (int l = 0; l < NL; ++l) out[l * ld] = key[l];
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
  // d = floor(n / P) = __umulhi(2n, floor(2^31 / P) + 1) for n * P < 2^31: here n < P + kTile and P < kTile.
  const uint32_t magic = L < kTile ? (uint32_t)((1ull << 31) / (unsigned long long)(L - k + 1) + 1) : 0u;
  if (keys) {
    if (canonical) {
      extract_kernel<NL, true, true><<<grid, kThreads, 0, s>>>(reads, R, L, k, magic, dst, ld, off, allt);
    } else {
      extract_kernel<NL, false, true><<<grid, kThreads, 0, s>>>(reads, R, L, k, magic, dst, ld, off, allt);
    }
  } else if (canonical) {
    extract_kernel<NL, true, false><<<grid, kThreads, 0, s>>>(reads, R, L, k, magic, dst, ld, off, allt);
  } else {
    extract_kernel<NL, false, false><<<grid, kThreads, 0, s>>>(reads, R, L, k, magic, dst, ld, off, allt);
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
