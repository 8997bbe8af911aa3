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
// What bounds it: memory, in principle.  A merge pass does a few compares
// per row but reads and writes (NL+1)*4 bytes per row of device memory,
// and a sort of n rows makes ceil(log2(n / leaf tile)) such passes after
// the leaf.  So the leaf tile is as large as shared memory allows, and
// every pass moves its rows with 16-byte accesses.  In practice the
// merges in shared memory wait on chains of dependent loads (each row a
// thread takes decides which row it loads next), and the split searches on
// round trips to device memory: occupancy, not bytes, sets the pace.
//
// Design: a merge sort, as the TPU kernels compute it, not a radix sort.
// An LSD radix sort over NL 32-bit lanes makes 4*NL passes of 8-bit digits
// (28 at NL=7); the merge sort's pass count does not grow with NL, each
// compare takes all lanes at once, and the merge-path split is the one the
// merge-fold-compact kernel uses (lanes.cuh, shared by both sources).
//   1. leaf:  one block per tile of leaf_rows(NL) rows (16384 at NL <= 2,
//      8192 at NL 3-4, 4096 above), in dynamic shared memory; 1024 or 512
//      threads.  The block stages its rows there; each thread sorts kI rows
//      (16, or 8 above NL = 4) in registers with a
//      bitonic network whose comparators all put the smaller row first, so
//      that rows past the tile's end, which no comparator touches, stay
//      last (masked by index); then block-wide merge-path rounds double the
//      sorted runs up to the tile.
//   2. pass:  adjacent sorted runs of `run` rows merge into runs of 2*run,
//      ping-ponging between two buffers the wrapper allocates, one launch a
//      pass.  Block t owns output rows [t*M, (t+1)*M) of the pass: two of
//      its warps find where that range starts and ends in the pair's A and
//      B runs (a merge-path search over device memory that probes 32 points
//      at once, one per lane, first around the diagonal's proportional
//      point), the block stages both windows in shared memory (all its
//      loads in flight at once), merges them there and writes its rows out.
//      256 threads; M and the blocks an SM are chosen per NL (merge_items,
//      merge_blocks_per_sm).
// ls_sort enqueues the leaf and every pass: one C call per sort.
//
// Shared memory: lane l of tile row r lives at word l*padded(T) + pad(r),
// one spare word after every 32 rows.  A warp's blocked accesses (thread i
// at row i*k + q, k a power of two up to 32) and striped ones (row b + i)
// then touch 32 distinct banks.  Device memory: rows move with 16-byte
// accesses between each lane's first and last 16-byte boundary and one word
// at a time outside them (lanes.cuh head_rows).
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

using lanes::merge_rows;
using lanes::num_tiles;
using lanes::Ops;
using lanes::OutOps;
using lanes::padded;
using lanes::store_lane;
using lanes::store_rows;
using lanes::Tile;

// Leaf: rows per thread, threads per block.  The block-wide merge rounds
// wait on shared-memory loads in a chain per thread, so the leaf wants many
// threads with short chains: 16 rows a thread where the registers allow it.
// At NL <= 2 that is one block of 1024 threads an SM, 16384 rows: on the
// H100 it sorted 111M rows 1.75 ms faster than 8192-row tiles of 512
// threads (one pass fewer, and twice the threads to hide the leaf's
// latency; PERF.md).
template <int NL>
__host__ __device__ constexpr int leaf_items() {
  return NL <= 4 ? 16 : 8;
}
template <int NL>
__host__ __device__ constexpr int leaf_threads() {
  return NL <= 2 ? 1024 : 512;
}
template <int NL>
__host__ __device__ constexpr int leaf_rows() {
  return leaf_threads<NL>() * leaf_items<NL>();
}
// Merge pass: 256 threads, and per NL the rows a thread takes and the
// blocks an SM.  More blocks an SM overlap the blocks that wait on device
// memory (the split search, the staging) with those that merge, but the
// launch bound then caps the registers at 65536 / (256 * blocks), and a
// thread holds its kI output rows and its staged 16-byte loads, (NL + 1) *
// kI words each.  So kI shrinks as NL grows, and each NL takes the most
// blocks that do not spill (-Xptxas -v): 4, but 3 at NL <= 2 (kI = 16) and
// at NL = 8.  On the H100 the choice at NL 3-4 sorted 32M rows 9% faster
// than 3 blocks, and at NL 5-7 beat 3 blocks by 10% and 2 blocks of kI = 8
// by 4%; 5 blocks spill at NL 7-8 and were 6% slower (PERF.md).  Shared
// memory (228 KB an SM, 1 KB of it reserved per block) holds each choice.
constexpr int kMergeThreads = 256;
template <int NL>
__host__ __device__ constexpr int merge_items() {
  return NL <= 2 ? 16 : (NL <= 4 ? 8 : 4);
}
template <int NL>
__host__ __device__ constexpr int merge_blocks_per_sm() {
  return NL <= 2 || NL == 8 ? 3 : 4;
}
template <int NL>
__host__ __device__ constexpr int merge_rows_per_block() {
  return kMergeThreads * merge_items<NL>();
}
template <int NL, int kT>
__host__ __device__ constexpr int smem_bytes() {
  return (NL + 1) * padded(kT) * 4;
}
template <int NL>
__host__ __device__ constexpr bool merge_shape_fits() {
  return merge_items<NL>() % 4 == 0 &&
         merge_blocks_per_sm<NL>() * (smem_bytes<NL, merge_rows_per_block<NL>()>() + 1024) <= 233472;
}

// Rows [0, len) of lane p (device memory) handed to put(row, value), spread
// over the block: 16-byte loads, kBatch of them in flight per thread, with
// the head and tail rows (at most 3 each) one word at a time.
template <int kThreads, class Put>
__device__ __forceinline__ void load_lane(const uint32_t* p, int len, Put put) {
  constexpr int kBatch = 8;
  const int head = lanes::head_rows(p, len);
  const int body = (len - head) >> 2;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int i0 = threadIdx.x; i0 < body; i0 += kBatch * kThreads) {
    uint4 x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i0 + b * kThreads < body) x[b] = __ldg(v + i0 + b * kThreads);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      if (i < body) {
        const int r = head + 4 * i;
        put(r, x[b].x);
        put(r + 1, x[b].y);
        put(r + 2, x[b].z);
        put(r + 3, x[b].w);
      }
    }
  }
  if (threadIdx.x < 6) {  // head rows [0, head), tail rows [head + 4*body, len)
    const int r = (int)threadIdx.x < head ? (int)threadIdx.x : (int)threadIdx.x + 4 * body;
    if (r < len) put(r, __ldg(p + r));
  }
}

// A merge pass's windows into its tile: rows [0, la) of every lane from
// row a_row of `in` to tile rows [0, la), rows [0, lb) from b_row to tile
// rows [la, la+lb).  16-byte loads, and one word at a time for the up to 3
// rows before each window's first 16-byte boundary and after its last; all
// of the block's loads are in flight before the first store to shared
// memory, so the staging waits on one round trip to device memory, not on
// one per lane and window.
template <int NL, int kT, int kThreads>
__device__ __forceinline__ void stage_windows(const Ops& in, long long a_row, int la, long long b_row,
                                              int lb, const Tile<NL, kT>& sm) {
  constexpr int kPer = kT / 4 / kThreads;  // 16-byte loads per thread and lane, at most
  uint4 x[NL + 1][kPer];
  uint32_t edge[NL + 1];
  const int e = threadIdx.x;  // thread e < 12 moves edge row e%6 of window e/6
#pragma unroll
  for (int l = 0; l <= NL; ++l) {
    const uint32_t* pa = in.p[l] + a_row;
    const uint32_t* pb = in.p[l] + b_row;
    const int ha = lanes::head_rows(pa, la), hb = lanes::head_rows(pb, lb);
    const int va = (la - ha) >> 2, vb = (lb - hb) >> 2;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = threadIdx.x + j * kThreads;
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
    const int ha = lanes::head_rows(in.p[l] + a_row, la), hb = lanes::head_rows(in.p[l] + b_row, lb);
    const int va = (la - ha) >> 2, vb = (lb - hb) >> 2;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = threadIdx.x + j * kThreads;
      const int r = k < va ? ha + 4 * k : la + hb + 4 * (k - va);
      if (k < va + vb) {
        sm.at(l, r) = x[l][j].x;
        sm.at(l, r + 1) = x[l][j].y;
        sm.at(l, r + 2) = x[l][j].z;
        sm.at(l, r + 3) = x[l][j].w;
      }
    }
    if (e < 12) {
      const int f = e % 6, len = e < 6 ? la : lb, h = e < 6 ? ha : hb, v = e < 6 ? va : vb;
      const int r = f < h ? f : f + 4 * v;
      if (r < len) sm.at(l, (e < 6 ? 0 : la) + r) = edge[l];
    }
  }
}

// x > y over NL lanes, without branches (for rows held in registers).
template <int NL>
__device__ __forceinline__ bool reg_gt(const uint32_t* x, const uint32_t* y) {
  bool gt = false, eq = true;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    gt = gt || (eq && x[l] > y[l]);
    eq = eq && x[l] == y[l];
  }
  return gt;
}

// Sorts rows [0, v) of x ascending: a bitonic network of kI log2(kI)
// (log2(kI) + 1) / 4 comparators, each of which puts the smaller row at the
// lower index.  A comparator (i, j), i < j, is skipped when j >= v, so rows
// [v, kI) (past the tile's end) are never read and never move.
template <int NL, int kI>
__device__ __forceinline__ void sort_in_registers(uint32_t (&x)[kI][NL + 1], int v) {
#pragma unroll
  for (int k = 2; k <= kI; k *= 2) {
#pragma unroll
    for (int s = k / 2; s >= 1; s /= 2) {
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const int j = s == k / 2 ? i ^ (k - 1) : i ^ s;  // the first stage of a merge flips
        if (j > i && j < v && reg_gt<NL>(x[i], x[j])) {
#pragma unroll
          for (int l = 0; l <= NL; ++l) {
            const uint32_t t = x[i][l];
            x[i][l] = x[j][l];
            x[j][l] = t;
          }
        }
      }
    }
  }
}

// K6: sorts rows [t*T, min((t+1)*T, n)) for block t, T = leaf_rows<NL>().
template <int NL>
__global__ void __launch_bounds__(leaf_threads<NL>(), 1)
    leaf_kernel(Ops in, OutOps out, long long n) {
  constexpr int kThreads = leaf_threads<NL>(), kI = leaf_items<NL>(), kT = leaf_rows<NL>();
  extern __shared__ uint32_t smem[];
  const Tile<NL, kT> sm{smem};
  const long long base = (long long)blockIdx.x * kT;
  const int len = (int)(n - base < kT ? n - base : kT);
#pragma unroll
  for (int l = 0; l <= NL; ++l) {
    load_lane<kThreads>(in.p[l] + base, len, [&](int r, uint32_t x) { sm.at(l, r) = x; });
  }
  __syncthreads();

  const int p0 = threadIdx.x * kI;
  const int v = max(0, min(kI, len - p0));
  uint32_t reg[kI][NL + 1];
#pragma unroll
  for (int q = 0; q < kI; ++q) {
#pragma unroll
    for (int l = 0; l <= NL; ++l) reg[q][l] = q < v ? sm.at(l, p0 + q) : 0u;
  }
  sort_in_registers<NL, kI>(reg, v);
  store_rows<NL, kT, kI>(sm, p0, v, reg);
  __syncthreads();

  // Block-wide merge rounds: runs of w rows merge into runs of 2w.  A
  // thread's kI output rows lie inside one group of 2w rows.  Once w >= len
  // the tile is one run.
  for (int w = kI; w < len; w *= 2) {
    const int g0 = p0 / (2 * w) * (2 * w);
    const int la = max(0, min(w, len - g0));
    const int lb = max(0, min(w, len - g0 - w));
    const int diag = min(p0 - g0, la + lb);
    const int cnt = min(kI, la + lb - diag);
    merge_rows<NL, kT, kI>(sm, g0, la, g0 + w, lb, diag, cnt, reg);
    __syncthreads();
    store_rows<NL, kT, kI>(sm, g0 + diag, cnt, reg);
    __syncthreads();
  }

#pragma unroll
  for (int l = 0; l <= NL; ++l) {
    store_lane<kThreads>(out.p[l] + base, len, [&](int r) { return sm.at(l, r); });
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

// Row ra of `in` <= row rb (device memory), reading lane after lane only
// while they are equal: a probe of the split search below mostly reads one
// word of each row, not NL.
template <int NL>
__device__ __forceinline__ bool row_le(const Ops& in, long long ra, long long rb) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const uint32_t a = __ldg(in.p[l] + ra), b = __ldg(in.p[l] + rb);
    if (a != b) return a < b;
  }
  return true;
}

// lanes::merge_path_split of diagonal d in the merge of A = rows [a0,
// a0+la) and B = [b0, b0+lb) of `in` (device memory), computed by a whole
// warp: each round, lane k probes the last row of the k-th of 32 equal
// slices of the candidate range, and the ballot of "A row <= B row" (true
// up to the split, false after it) names the slice that holds it.  log32
// rounds of dependent loads instead of log2.  Every lane returns it.
template <int NL>
__device__ long long warp_split(const Ops& in, long long a0, long long la, long long b0,
                                long long lb, long long d) {
  const int lane = threadIdx.x % 32;
  long long lo = d > lb ? d - lb : 0, hi = d < la ? d : la;
  // Most splits lie near the diagonal's proportional point d*la/(la+lb):
  // first, lanes 0 and 1 test whether kNear candidates around it bracket
  // the split, and if they do the search starts from those alone (three
  // rounds, not six, in a run of 50M rows).
  constexpr long long kNear = 32768;
  if (hi - lo > kNear) {
    const long long est = d * la / (la + lb);
    const long long w_lo = est - kNear / 2 > lo ? est - kNear / 2 : lo;
    const long long w_hi = w_lo + kNear < hi ? w_lo + kNear : hi;
    const long long i = lane == 0 ? w_lo - 1 : w_hi;  // split > w_lo-1, split <= w_hi
    bool holds = lane > 1 || (lane == 0 ? w_lo == lo : w_hi == hi);
    if (!holds) holds = row_le<NL>(in, a0 + i, b0 + d - 1 - i) == (lane == 0);
    if (__all_sync(0xFFFFFFFFu, holds)) {
      lo = w_lo;
      hi = w_hi;
    }
  }
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + (lane + 1) * step - 1;
    const bool a_le_b = i < hi && row_le<NL>(in, a0 + i, b0 + d - 1 - i);
    const long long c = __popc(__ballot_sync(0xFFFFFFFFu, a_le_b));
    const long long end = lo + (c + 1) * step - 1;
    lo += c * step;
    hi = end < hi ? end : hi;
  }
  return lo;
}

// K7, one pass: output tile t of the pass.
template <int NL>
__global__ void __launch_bounds__(kMergeThreads, merge_blocks_per_sm<NL>())
    merge_kernel(Ops in, OutOps out, long long n, long long run) {
  constexpr int kI = merge_items<NL>(), kT = merge_rows_per_block<NL>();
  static_assert(merge_shape_fits<NL>(), "merge tile: 16-byte staging, shared memory for its blocks");
  extern __shared__ uint32_t smem[];
  __shared__ long long s_split[2];
  const Tile<NL, kT> sm{smem};
  const long long out0 = (long long)blockIdx.x * kT;
  const Pair p = pair_of(out0, n, run);
  const long long d0 = out0 - p.pbase;
  const long long d1 = d0 + kT < p.la + p.lb ? d0 + kT : p.la + p.lb;
  const int warp = threadIdx.x / 32;
  if (warp < 2) {  // warp 0 finds where the tile starts in A, warp 1 where it ends
    const long long s = warp_split<NL>(in, p.pbase, p.la, p.pbase + p.la, p.lb, warp ? d1 : d0);
    if (threadIdx.x % 32 == 0) s_split[warp] = s;
  }
  __syncthreads();
  const long long i0 = s_split[0], i1 = s_split[1];
  const int la = (int)(i1 - i0), lb = (int)(d1 - i1 - (d0 - i0)), len = la + lb;
  stage_windows<NL, kT, kMergeThreads>(in, p.pbase + i0, la, p.pbase + p.la + (d0 - i0), lb, sm);
  __syncthreads();

  uint32_t reg[kI][NL + 1];
  const int diag = min((int)threadIdx.x * kI, len);
  const int cnt = min(kI, len - diag);
  merge_rows<NL, kT, kI>(sm, 0, la, la, lb, diag, cnt, reg);
  __syncthreads();
  store_rows<NL, kT, kI>(sm, diag, cnt, reg);
  __syncthreads();

#pragma unroll
  for (int l = 0; l <= NL; ++l) {
    store_lane<kMergeThreads>(out.p[l] + out0, len, [&](int r) { return sm.at(l, r); });
  }
}

Ops as_in(const OutOps& o) {
  Ops in{};
  for (int i = 0; i < lanes::kMaxOps; ++i) in.p[i] = o.p[i];
  return in;
}

// Merge passes after a leaf of `tile` rows: runs of tile, 2*tile, ...
// rows until one run holds all n.
int merge_passes(long long n, long long tile) {
  int passes = 0;
  for (long long run = tile; run < n; run *= 2) ++passes;
  return passes;
}

// The leaf into buf[0], then merge_passes(n, leaf tile) passes.  Returns
// the buffer that holds the result, or -cudaError_t.
template <int NL>
int sort_lanes(const Ops& in, const OutOps (&buf)[2], long long n, cudaStream_t stream) {
  constexpr int kLeafRows = leaf_rows<NL>(), kMergeRows = merge_rows_per_block<NL>();
  constexpr int kLeafSmem = smem_bytes<NL, kLeafRows>(), kMergeSmem = smem_bytes<NL, kMergeRows>();
  cudaError_t err = cudaFuncSetAttribute(leaf_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kLeafSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(merge_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMergeSmem);
  }
  if (err != cudaSuccess) return -(int)err;
  leaf_kernel<NL><<<(unsigned)num_tiles(n, kLeafRows), leaf_threads<NL>(), kLeafSmem, stream>>>(
      in, buf[0], n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return -(int)err;
  const int passes = merge_passes(n, kLeafRows);
  for (int p = 0; p < passes; ++p) {
    merge_kernel<NL><<<(unsigned)num_tiles(n, kMergeRows), kMergeThreads, kMergeSmem, stream>>>(
        as_in(buf[p % 2]), buf[1 - p % 2], n, (long long)kLeafRows << p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return -(int)err;
  }
  return passes % 2;
}

}  // namespace

extern "C" {

// Rows per leaf tile at num_keys key lanes; 0 for an unsupported num_keys.
int ls_tile_rows(int num_keys) {
  switch (num_keys) {
    case 1: return leaf_rows<1>();
    case 2: return leaf_rows<2>();
    case 3: return leaf_rows<3>();
    case 4: return leaf_rows<4>();
    case 5: return leaf_rows<5>();
    case 6: return leaf_rows<6>();
    case 7: return leaf_rows<7>();
    case 8: return leaf_rows<8>();
    default: return 0;
  }
}

// Merge passes (one launch each, after the leaf's) that ls_sort makes for
// n rows at num_keys key lanes; -1 for an unsupported num_keys.
int ls_merge_passes(int num_keys, long long n) {
  const int tile = ls_tile_rows(num_keys);
  return tile ? merge_passes(n, tile) : -1;
}

// K6 + K7: the whole sort, enqueued on `stream`.  in_ptrs, buf0_ptrs,
// buf1_ptrs: host arrays of num_keys+1 device pointers to n rows (key
// lanes, then the payload); in is read only, buf0 and buf1 are the
// ping-pong buffers (buf1 is not touched when ls_merge_passes is 0).
// Returns which buffer holds the sorted rows (0 or 1), or -cudaError_t.
int ls_sort(const void* const* in_ptrs, void* const* buf0_ptrs, void* const* buf1_ptrs,
            int num_keys, long long n, void* stream) {
  if (n <= 0 || num_keys < 1 || num_keys > 8) return -(int)cudaErrorInvalidValue;
  const Ops in = lanes::make_ops(in_ptrs, num_keys + 1);
  const OutOps buf[2] = {lanes::make_out_ops(buf0_ptrs, num_keys + 1),
                         lanes::make_out_ops(buf1_ptrs, num_keys + 1)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (num_keys) {
    case 1: return sort_lanes<1>(in, buf, n, s);
    case 2: return sort_lanes<2>(in, buf, n, s);
    case 3: return sort_lanes<3>(in, buf, n, s);
    case 4: return sort_lanes<4>(in, buf, n, s);
    case 5: return sort_lanes<5>(in, buf, n, s);
    case 6: return sort_lanes<6>(in, buf, n, s);
    case 7: return sort_lanes<7>(in, buf, n, s);
    default: return sort_lanes<8>(in, buf, n, s);
  }
}

}  // extern "C"
