// lane_sort.cu — multi-lane merge sort for Hopper (sm_90a), the device sort
// behind sort_reduce.
//
// Replaces kmer_counter_tpu/ops/pallas_sort.py leaf_sort (K6) and
// _merge_pass with _diag_splits (K7), which sort_ops there runs together.
//
// Computes: n rows of NL uint32 key lanes (1 <= NL <= 8, lane-major, one
// device array per lane; unsigned lexicographic order, lane 0 most
// significant) sorted ascending, with one uint32 payload lane riding along.
// Order among equal keys is unspecified (is_stable=False): the leaf is an
// unstable network, the merges take A first on ties.  n is any size: every
// block masks its own ragged edge.
//
// What bounds it: memory.  A merge pass does a few compares per row but
// reads and writes (NL+1)*4 bytes per row of device memory, and a sort of n
// rows makes ceil(log2(n / tile)) such passes after the leaf.
//
// Design: a merge sort, as the TPU kernels compute it, not a radix sort.
// An LSD radix sort over NL 32-bit lanes makes 4*NL passes of 8-bit digits
// (28 at NL=7); the merge sort's pass count does not grow with NL, each
// compare takes all lanes at once, and the merge-path split is the one the
// merge-fold-compact kernel uses (lanes.cuh, shared by both sources).
//   1. leaf:  one block per tile of kTile(NL) rows.  The block stages its
//      rows in shared memory; each thread sorts kItems rows in registers
//      (odd-even transposition), then log2(kThreads) block-wide merge-path
//      rounds double the sorted runs up to the tile.
//   2. pass:  adjacent sorted runs of `run` rows merge into runs of 2*run,
//      ping-ponging between two buffers the wrapper allocates.  A split
//      kernel finds, by binary search, how many rows of the pair's A run
//      precede each output tile; a merge kernel stages the tile's A and B
//      windows in shared memory, merges them (a merge-path search per
//      thread, then a serial merge of kItems rows) and writes the tile out
//      with coalesced stores.
// The tile is sized by NL so that (NL+1)*4 bytes a row fit in static shared
// memory (at most 36 KB, at NL=8): 4096 rows at NL=1, 2048 at NL=2-3, 1024
// above.
//
// Masking is by index, never by key.  Windows come from exact split
// offsets, so no slack row ever enters a merge, and the leaf and the merge
// rounds bound every run by the rows that exist.  (The Pallas _merge_pass
// masks window slack to (sentinel key, payload 0) and keeps half of the
// merged rows, so a slack row can take the place of a genuine all-ones row
// and its payload is lost; here an all-ones key is an ordinary key.)
// Row indices are 64-bit; lanes compare as uint32.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::key_le;
using lanes::merge_path_split;
using lanes::num_tiles;
using lanes::Ops;
using lanes::OutOps;
using lanes::smem_le;

constexpr int kThreads = 256;

template <int NL>
__host__ __device__ constexpr int items() {
  return NL == 1 ? 16 : (NL <= 3 ? 8 : 4);
}
template <int NL>
__host__ __device__ constexpr int tile() {
  return kThreads * items<NL>();
}

template <int NL>
struct Smem {
  uint32_t ops[NL + 1][tile<NL>()];  // key lanes, then the payload
};

// Merges sorted runs A = sm[a0, a0+la) and B = sm[b0, b0+lb) at output rows
// [diag, diag+cnt) of their merge (A first on ties) into reg.
template <int NL, int kI>
__device__ __forceinline__ void merge_rows(const Smem<NL>& sm, int a0, int la, int b0, int lb,
                                           int diag, int cnt, uint32_t (&reg)[kI][NL + 1]) {
  const int lo = merge_path_split(diag, la, lb, [&](int i, int j) {
    return smem_le<NL>(sm, a0 + i, b0 + j);
  });
  int ia = lo, ib = diag - lo;
#pragma unroll
  for (int q = 0; q < kI; ++q) {
    if (q < cnt) {
      const bool take_a = ib >= lb || (ia < la && smem_le<NL>(sm, a0 + ia, b0 + ib));
      const int src = take_a ? a0 + ia++ : b0 + ib++;
#pragma unroll
      for (int l = 0; l <= NL; ++l) reg[q][l] = sm.ops[l][src];
    }
  }
}

template <int NL, int kI>
__device__ __forceinline__ void store_rows(Smem<NL>& sm, int at, int cnt,
                                           const uint32_t (&reg)[kI][NL + 1]) {
#pragma unroll
  for (int q = 0; q < kI; ++q) {
    if (q < cnt) {
#pragma unroll
      for (int l = 0; l <= NL; ++l) sm.ops[l][at + q] = reg[q][l];
    }
  }
}

// K6: sorts rows [t*kT, min((t+1)*kT, n)) for block t.
template <int NL>
__global__ void __launch_bounds__(kThreads)
    leaf_kernel(Ops in, OutOps out, long long n) {
  constexpr int kI = items<NL>();
  constexpr int kT = tile<NL>();
  __shared__ Smem<NL> sm;
  const long long base = (long long)blockIdx.x * kT;
  const int len = (int)(n - base < kT ? n - base : kT);
  for (int r = threadIdx.x; r < len; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) sm.ops[l][r] = in.p[l][base + r];
  }
  __syncthreads();

  // Each thread sorts its v <= kI rows in registers: odd-even transposition,
  // with every compare-exchange past the v-th row skipped.
  const int p0 = threadIdx.x * kI;
  const int v = max(0, min(kI, len - p0));
  uint32_t reg[kI][NL + 1];
#pragma unroll
  for (int q = 0; q < kI; ++q) {
    if (q < v) {
#pragma unroll
      for (int l = 0; l <= NL; ++l) reg[q][l] = sm.ops[l][p0 + q];
    }
  }
#pragma unroll
  for (int round = 0; round < kI; ++round) {
#pragma unroll
    for (int q = round & 1; q + 1 < kI; q += 2) {
      if (q + 1 < v && !key_le<NL>(reg[q], reg[q + 1])) {
#pragma unroll
        for (int l = 0; l <= NL; ++l) {
          const uint32_t x = reg[q][l];
          reg[q][l] = reg[q + 1][l];
          reg[q + 1][l] = x;
        }
      }
    }
  }
  store_rows<NL, kI>(sm, p0, v, reg);
  __syncthreads();

  // Block-wide merge rounds: runs of w rows merge into runs of 2w.  A
  // thread's kI output rows lie inside one group of 2w rows.
  for (int w = kI; w < kT; w *= 2) {
    const int g0 = p0 / (2 * w) * (2 * w);
    const int la = max(0, min(w, len - g0));
    const int lb = max(0, min(w, len - g0 - w));
    const int diag = min(p0 - g0, la + lb);
    const int cnt = min(kI, la + lb - diag);
    merge_rows<NL, kI>(sm, g0, la, g0 + w, lb, diag, cnt, reg);
    __syncthreads();
    store_rows<NL, kI>(sm, g0 + diag, cnt, reg);
    __syncthreads();
  }

  for (int r = threadIdx.x; r < len; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) out.p[l][base + r] = sm.ops[l][r];
  }
}

// The pair of runs that output row `row` of a pass belongs to: A =
// [pbase, pbase+la), B = [pbase+run, pbase+run+lb).
struct Pair {
  long long pbase, la, lb;
};

__device__ __forceinline__ Pair pair_of(long long row, long long n, long long run) {
  Pair p;
  p.pbase = row / (2 * run) * (2 * run);
  p.la = n - p.pbase < run ? n - p.pbase : run;
  const long long rest = n - p.pbase - run;
  p.lb = rest <= 0 ? 0 : (rest < run ? rest : run);
  return p;
}

// K7, split: for each output tile t, the number of rows of its pair's A run
// among the pair's first d merged rows, d = the tile's start within the
// pair (A first on ties, as in merge_rows).
template <int NL>
__global__ void splits_kernel(Ops in, long long n, long long run, long long num_tiles,
                              long long* splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_tiles) return;
  const Pair p = pair_of(t * tile<NL>(), n, run);
  const long long d = t * tile<NL>() - p.pbase;
  splits[t] = merge_path_split(d, p.la, p.lb, [&](long long i, long long j) {
    uint32_t ka[NL], kb[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      ka[l] = in.p[l][p.pbase + i];
      kb[l] = in.p[l][p.pbase + run + j];
    }
    return key_le<NL>(ka, kb);
  });
}

// K7, merge: output tile t of the pass.
template <int NL>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(Ops in, OutOps out, long long n, long long run, const long long* splits) {
  constexpr int kI = items<NL>();
  constexpr int kT = tile<NL>();
  __shared__ Smem<NL> sm;
  const long long t = blockIdx.x;
  const long long out0 = t * kT;
  const Pair p = pair_of(out0, n, run);
  const long long plen = p.la + p.lb;
  const long long d0 = out0 - p.pbase;
  const long long d1 = d0 + kT < plen ? d0 + kT : plen;
  // The tile that ends its pair consumes both runs to their ends; any other
  // tile ends where the next tile of the same pair starts.
  const long long i0 = splits[t];
  const long long i1 = d1 == plen ? p.la : splits[t + 1];
  const long long j0 = d0 - i0, j1 = d1 - i1;
  const int la = (int)(i1 - i0), lb = (int)(j1 - j0), len = la + lb;

  const long long a_row0 = p.pbase + i0, b_row0 = p.pbase + run + j0;
  for (int r = threadIdx.x; r < la; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) sm.ops[l][r] = in.p[l][a_row0 + r];
  }
  for (int r = threadIdx.x; r < lb; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) sm.ops[l][la + r] = in.p[l][b_row0 + r];
  }
  __syncthreads();

  uint32_t reg[kI][NL + 1];
  const int diag = min((int)threadIdx.x * kI, len);
  const int cnt = min(kI, len - diag);
  merge_rows<NL, kI>(sm, 0, la, la, lb, diag, cnt, reg);
  __syncthreads();
  store_rows<NL, kI>(sm, diag, cnt, reg);
  __syncthreads();

  for (int r = threadIdx.x; r < len; r += kThreads) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) out.p[l][out0 + r] = sm.ops[l][r];
  }
}

template <int NL>
int run_leaf(const Ops& in, const OutOps& out, long long n, cudaStream_t stream) {
  leaf_kernel<NL><<<(unsigned)num_tiles(n, tile<NL>()), kThreads, 0, stream>>>(in, out, n);
  return cudaGetLastError();
}

template <int NL>
int run_pass(const Ops& in, const OutOps& out, long long n, long long run, long long* splits,
             cudaStream_t stream) {
  const long long tiles = num_tiles(n, tile<NL>());
  splits_kernel<NL><<<(unsigned)num_tiles(tiles, 256), 256, 0, stream>>>(in, n, run, tiles,
                                                                           splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<NL><<<(unsigned)tiles, kThreads, 0, stream>>>(in, out, n, run, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per leaf tile and per merge output tile at num_keys key lanes; 0 for
// an unsupported num_keys.
int ls_tile_rows(int num_keys) {
  switch (num_keys) {
    case 1: return tile<1>();
    case 2: return tile<2>();
    case 3: return tile<3>();
    case 4: return tile<4>();
    case 5: return tile<5>();
    case 6: return tile<6>();
    case 7: return tile<7>();
    case 8: return tile<8>();
    default: return 0;
  }
}

// K6.  in_ptrs / out_ptrs: host arrays of num_keys+1 device pointers to n
// rows (key lanes, then the payload).  Sorts every tile of out.  Returns a
// cudaError_t.
int ls_leaf_sort(const void* const* in_ptrs, void* const* out_ptrs, int num_keys, long long n,
                 void* stream) {
  const Ops in = lanes::make_ops(in_ptrs, num_keys + 1);
  const OutOps out = lanes::make_out_ops(out_ptrs, num_keys + 1);
  auto s = static_cast<cudaStream_t>(stream);
#define LS_LEAF_CALL(NL) run_leaf<NL>(in, out, n, s)
  switch (num_keys) {
    case 1: return LS_LEAF_CALL(1);
    case 2: return LS_LEAF_CALL(2);
    case 3: return LS_LEAF_CALL(3);
    case 4: return LS_LEAF_CALL(4);
    case 5: return LS_LEAF_CALL(5);
    case 6: return LS_LEAF_CALL(6);
    case 7: return LS_LEAF_CALL(7);
    case 8: return LS_LEAF_CALL(8);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7, one pass: sorted runs of `run` rows (a multiple of the tile) in in
// merge pairwise into runs of 2*run in out.  splits: [ceil(n / tile)]
// int64 scratch.  Returns a cudaError_t.
int ls_merge_pass(const void* const* in_ptrs, void* const* out_ptrs, int num_keys, long long n,
                  long long run, void* splits, void* stream) {
  const Ops in = lanes::make_ops(in_ptrs, num_keys + 1);
  const OutOps out = lanes::make_out_ops(out_ptrs, num_keys + 1);
  auto* sp = static_cast<long long*>(splits);
  auto s = static_cast<cudaStream_t>(stream);
#define LS_PASS_CALL(NL) run_pass<NL>(in, out, n, run, sp, s)
  switch (num_keys) {
    case 1: return LS_PASS_CALL(1);
    case 2: return LS_PASS_CALL(2);
    case 3: return LS_PASS_CALL(3);
    case 4: return LS_PASS_CALL(4);
    case 5: return LS_PASS_CALL(5);
    case 6: return LS_PASS_CALL(6);
    case 7: return LS_PASS_CALL(7);
    case 8: return LS_PASS_CALL(8);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
