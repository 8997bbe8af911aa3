"""K8, the fused encode + extract (ops.fused_extract), on the CPU.

- The plain version against the Pallas kernel it replaces
  (docs/experiments_pallas_extract.py, loaded by path as its own test
  loads it) in interpret mode: records exactly, and the keys mode against
  the Pallas records masked by their validity plane, all-T windows moved
  to the side count.
- A NumPy model of the CUDA kernel's algorithm (csrc/fused_extract.cu)
  against the plain version, at every k from 1 to 128, in both modes: the
  staging of a block's bytes at the misalignment of the reads' pointer,
  the encoding into code words and invalid-flag words, the 16-base groups
  from two code words by a funnel shift, the reverse complement by bit
  reversal, the validity from the count of invalid bases in the window,
  the row tiled by byte range with its halo, and the writes at a column
  offset into a larger region.  The CUDA kernel itself runs only on the
  card (tests/test_torch_cuda.py, chip_smoke.py).
- The wrappers' checks.

Tolerance: exact equality; everything is integer.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu_torch.ops import fused_extract as fx
from kmer_counter_tpu_torch.ops import pipeline
from kmer_counter_tpu_torch.ops.u32 import to_numpy
from kmer_counter_tpu_torch.records import active_lanes

from tests.test_torch_cuda import EXTRACT_TILE, extract_reads

CPU = torch.device("cpu")
M = 0xFFFFFFFF
BLOCK_ROWS = 64  # the Pallas kernel's block at these tests' size

_spec = importlib.util.spec_from_file_location(
    "experiments_pallas_extract",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs",
                 "experiments_pallas_extract.py"),
)
_pallas_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pallas_mod)

PALLAS_KS = [15, 16, 31, 33, 55, 64]


@functools.lru_cache(maxsize=None)
def _pallas_case(k, canonical):
    """(reads, Pallas K8 records [NL+1, R*P] uint32) in interpret mode; R is
    two Pallas blocks.  Cached: each interpret call takes seconds."""
    reads = extract_reads(np.random.default_rng(k), 2 * BLOCK_ROWS, k + 21)
    out = _pallas_mod.extract_chunk_lanes_major(jnp.asarray(reads), k, canonical, block_rows=BLOCK_ROWS,
                                                interpret=True)
    return reads, np.asarray(out)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", PALLAS_KS)
def test_plain_k8_matches_pallas_interpret(k, canonical):
    reads, want = _pallas_case(k, canonical)
    got = to_numpy(fx.extract_chunk_lanes_major(torch.from_numpy(reads), k, canonical))
    np.testing.assert_array_equal(got, want)
    assert 0 < want[-1].sum() < want.shape[1]  # valid and masked windows both


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", PALLAS_KS)
def test_keys_mode_matches_pallas_masked(k, canonical):
    reads, rec = _pallas_case(k, canonical)
    lanes, valid = rec[:-1], rec[-1] == 1
    allt = valid & (lanes == M).all(0) if k % 16 == 0 and not canonical else np.zeros_like(valid)
    want = np.where(valid & ~allt, lanes, np.uint32(M))
    got, got_allt = pipeline.extract_chunk_keys(torch.from_numpy(reads), k, canonical)
    np.testing.assert_array_equal(to_numpy(got), want)
    assert int(got_allt) == int(allt.sum())
    if k % 16 == 0 and not canonical:
        assert allt.sum() > 0  # extract_reads holds all-T reads


# ---- a NumPy model of csrc/fused_extract.cu ---------------------------------

HALO = 128  # kHalo: staged bases past a tile
GARBAGE = ord("A")  # what the model puts in staged bytes the kernel never loads


def _funnel_r(lo, hi, s):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> s, s in [0, 31]."""
    return ((hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)) >> s.astype(np.uint64)) & M


def _funnel_l(lo, hi, s):
    """__funnelshift_l: the high 32 bits of (hi:lo) << s, s in [0, 31]."""
    x = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    return ((x << s.astype(np.uint64)) >> np.uint64(32)) & M


def _rev_groups(v):
    """__brev, then a swap of the two bits of each group."""
    bits = (v[..., None] >> np.arange(32, dtype=np.uint64)) & 1
    x = (bits[..., ::-1] << np.arange(32, dtype=np.uint64)).sum(-1)
    return ((x & 0x55555555) << np.uint64(1)) | ((x >> np.uint64(1)) & 0x55555555)


def kernel_model(reads, k, canonical, keys, dst, off, tile=EXTRACT_TILE, shift=0):
    """The kernel's steps on numpy arrays, each block's as the kernel takes
    them: writes ``dst`` (uint32, NL or NL+1 rows) at columns off + w and
    returns the all-T count (keys mode).  ``shift``: the reads' pointer
    modulo 16, which places the staged bytes in shared memory."""
    R, L = reads.shape
    NL, N, P = active_lanes(k), R * L, L - k + 1
    flat = reads.reshape(-1)
    words = (tile + HALO) // 16  # kWords
    raw_chunks = (15 + tile + HALO) // 16 + 2  # kRawChunks
    staged = tile + 16 * NL
    B = -(-N // tile)
    b0 = np.arange(B, dtype=np.int64) * tile

    # 1. aligned 16-byte chunks of [b0 - shift, b0 + staged), those that hold a byte of the reads
    chunks = (shift + staged + 15) // 16
    assert chunks <= raw_chunks
    idx = np.arange(raw_chunks * 16)[None]
    src = b0[:, None] - shift + idx  # the reads' byte of each staged byte
    loaded = (idx // 16 < chunks) & (b0[:, None] - shift + 16 * (idx // 16) < N)
    raw = np.where(loaded & (src >= 0) & (src < N), flat[np.clip(src, 0, N - 1)], GARBAGE).astype(np.uint8)
    raw32 = raw.view("<u4").astype(np.uint64)  # [B, 4 * raw_chunks]

    # 2. encode: word j holds local bases 16j..16j+15
    limit = np.minimum(N - b0, staged)
    o = shift + 16 * np.arange(words)
    w, s = o >> 2, 8 * (o & 3)
    assert (w + 4 < raw32.shape[1]).all()
    code = np.zeros((B, words), np.uint64)
    inv16 = np.zeros((B, words), np.uint64)
    for m4 in range(4):
        byte4 = _funnel_r(raw32[:, w + m4], raw32[:, w + m4 + 1], np.broadcast_to(s, (B, words)))
        for b in range(4):
            m = 4 * m4 + b
            u = ((byte4 >> np.uint64(8 * b)) & 0xFF) & 0xDF
            c = np.select([u == ord("A"), u == ord("C"), u == ord("G")], [0, 1, 2], 3).astype(np.uint64)
            bad = ~np.isin(u, [ord("A"), ord("C"), ord("G"), ord("T")])
            past = (16 * np.arange(words) + m)[None] >= limit[:, None]
            c[past], bad = 3, bad | past
            code |= c << np.uint64(30 - 2 * m)
            inv16 |= bad.astype(np.uint64) << np.uint64(m)
    inv32 = inv16[:, 0::2] | (inv16[:, 1::2] << np.uint64(16))

    # 3. windows: local starts p of each block; row and column of b0 + p
    p = np.arange(tile)[None].repeat(B, 0)
    r0, c0 = b0 // L, b0 % L
    col, row = c0[:, None] + p, r0[:, None].repeat(tile, 1)
    if L >= tile:
        wrap = col >= L
        col, row = col - wrap * L, row + wrap
    else:
        d = col // L
        col, row = col - d * L, row + d
    is_window = (b0[:, None] + p < N) & (col < P)
    win = row * P + col

    def group(q):
        j = q >> 4
        return _funnel_l(np.take_along_axis(code, j + 1, 1), np.take_along_axis(code, j, 1), 2 * (q & 15))

    key = []
    for i in range(NL):
        n = min(16, k - 16 * i)
        mask = M if n == 16 else ~(M >> (2 * n)) & M
        key.append(group(p + 16 * i) & mask)
    if canonical:
        rc = []
        for i in range(NL):
            n = min(16, k - 16 * i)
            if n == 16:
                rc.append(_rev_groups(~group(p + k - 16 * (i + 1)) & M))
            else:
                rc.append((_rev_groups(~group(p) & M) << np.uint64(2 * (16 - n))) & M)
        take_rc, decided = np.zeros(p.shape, bool), np.zeros(p.shape, bool)
        for i in range(NL):
            differ = ~decided & (rc[i] != key[i])
            take_rc |= differ & (rc[i] < key[i])
            decided |= differ
        key = [np.where(take_rc, r, f) for r, f in zip(rc, key)]

    # validity: invalid bases in [p, p + k), 32 flags a word
    q, end, n_bad = p.copy(), p + k, np.zeros(p.shape, np.int64)
    for _ in range(5):
        active = q < end
        lo = q & 31
        hi = np.minimum(end - q + lo, 32)
        mask = ((np.uint64(1) << hi.astype(np.uint64)) - np.uint64(1)) & ~((np.uint64(1) << lo.astype(np.uint64))
                                                                           - np.uint64(1))
        hit = np.take_along_axis(inv32, np.minimum(q >> 5, inv32.shape[1] - 1), 1) & mask
        n_bad += np.where(active, np.bitwise_count(hit), 0)
        q = np.where(active, q + hi - lo, q)
    assert (q >= end).all()  # five words cover any window
    valid = n_bad == 0

    # 4. writes
    cols = off + win[is_window]
    v = valid[is_window]
    allt = 0
    if keys:
        if k % 16 == 0 and not canonical:
            allt = int((v & np.all([x[is_window] == M for x in key], axis=0)).sum())
        for i in range(NL):
            dst[i, cols] = np.where(v, key[i][is_window], M)
    else:
        for i in range(NL):
            dst[i, cols] = key[i][is_window]
        dst[NL, cols] = v
    return allt


def _model_vs_plain(reads, k, canonical, tile, shift, off=5, tail=3):
    """Both modes of the model against the plain versions, written at
    column ``off`` of a region ``tail`` columns wider than needed; the
    columns around the chunk keep their pattern."""
    R, L = reads.shape
    NL, n = active_lanes(k), R * (L - k + 1)
    t = torch.from_numpy(reads)
    want_rec = to_numpy(fx.extract_chunk_lanes_major(t, k, canonical))
    want_keys, want_allt = fx.extract_chunk_keys_reference(t, k, canonical)
    for keys, want in ((False, want_rec), (True, to_numpy(want_keys))):
        pattern = np.uint32(0x5A5A5A5A)
        dst = np.full((NL + (not keys), off + n + tail), pattern, np.uint32)
        allt = kernel_model(reads, k, canonical, keys, dst, off, tile, shift)
        np.testing.assert_array_equal(dst[:, off : off + n], want, err_msg=f"k={k} L={L} keys={keys}")
        assert (dst[:, :off] == pattern).all() and (dst[:, off + n :] == pattern).all()
        if keys:
            assert allt == int(want_allt)


@pytest.mark.parametrize("k", range(1, 129))
def test_kernel_model_matches_plain(k):
    """Every k, both modes, canonical or not, at a tile of 64 bases: reads
    shorter than the tile, a tile that cuts reads, reads longer than the
    tile (cut along the row with the halo), and each pointer alignment."""
    rng = np.random.default_rng(k)
    for L, R in ((k, 7), (k + 1, 5), (k + 17, 4), (k + 150, 2)):
        reads = extract_reads(rng, R, L)
        for canonical in (False, True):
            _model_vs_plain(reads, k, canonical, tile=64, shift=(k + L) % 16)


@pytest.mark.parametrize("k,canonical", [(31, True), (32, False), (128, False), (101, True), (1, False)])
def test_kernel_model_at_the_kernel_tile(k, canonical):
    """The kernel's own tile: a chunk that ends one read past a tile, and
    reads longer than a tile."""
    rng = np.random.default_rng(k)
    for R, L in ((EXTRACT_TILE // 100 + 1, 100), (2, EXTRACT_TILE + 300), (1, max(k, 7))):
        _model_vs_plain(extract_reads(rng, R, max(L, k)), k, canonical, tile=EXTRACT_TILE, shift=3)


def test_model_all_t_windows_go_to_the_side_count():
    for k in (16, 32, 64, 128):
        reads = np.full((3, k + 9), ord("T"), np.uint8)
        reads[1, 4] = ord("t")
        reads[2, 5] = ord("N")
        dst = np.zeros((active_lanes(k), 3 * 10), np.uint32)
        assert kernel_model(reads, k, False, True, dst, 0, tile=64) == 10 + 10 + 4
        assert (dst == M).all()
        _model_vs_plain(reads, k, False, tile=64, shift=0)


# ---- the wrappers on the CPU --------------------------------------------------


def test_keys_into_writes_its_columns_and_adds_allt():
    k = 32
    reads = extract_reads(np.random.default_rng(1), 6, 50)
    t = torch.from_numpy(reads)
    want, want_allt = fx.extract_chunk_keys_reference(t, k, False)
    n = want.shape[1]
    dst = torch.full((2, n + 20), 7, dtype=torch.int32)
    allt = torch.tensor(5, dtype=torch.int64)
    assert fx.extract_chunk_keys_into(t, k, False, dst, 11, allt) == n
    assert torch.equal(dst[:, 11 : 11 + n], want)
    assert (dst[:, :11] == 7).all() and (dst[:, 11 + n :] == 7).all()
    assert int(allt) == 5 + int(want_allt) and int(want_allt) > 0


def test_pipeline_results_are_the_plain_versions():
    k = 33
    reads = torch.from_numpy(extract_reads(np.random.default_rng(2), 5, 60))
    lanes, counts = pipeline.extract_chunk(reads, k, True)
    rec = fx.extract_chunk_lanes_major_reference(reads, k, True)
    assert torch.equal(lanes, rec[:-1]) and torch.equal(counts, rec[-1])
    keys, allt = pipeline.extract_chunk_keys(reads, k, True)
    want, want_allt = fx.extract_chunk_keys_reference(reads, k, True)
    assert torch.equal(keys, want) and int(allt) == int(want_allt) == 0


@pytest.mark.parametrize("bad", ["non_contiguous", "int64", "short", "k0", "k129", "1d"])
def test_wrappers_reject_bad_reads(bad):
    reads = torch.from_numpy(extract_reads(np.random.default_rng(0), 4, 40))
    k = {"short": 41, "k0": 0, "k129": 129}.get(bad, 15)
    if bad == "non_contiguous":
        reads = reads[:, ::2]
    elif bad == "int64":
        reads = reads.to(torch.int64)
    elif bad == "1d":
        reads = reads.reshape(-1)
    err = TypeError if bad == "int64" else ValueError
    with pytest.raises(err):
        fx.extract_chunk_lanes_major(reads, k)
    dst = torch.zeros((8, 4000), dtype=torch.int32)
    with pytest.raises(err):
        fx.extract_chunk_keys_into(reads, k, False, dst, 0, torch.zeros((), dtype=torch.int64))


def test_wrappers_raise_on_a_device_without_a_kernel():
    reads = torch.empty((4, 40), dtype=torch.uint8, device="meta")
    before = fx.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        fx.extract_chunk_lanes_major(reads, 15)
    dst = torch.empty((1, 104), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fx.extract_chunk_keys_into(reads, 15, False, dst, 0, torch.zeros((), dtype=torch.int64, device="meta"))
    assert fx.launches == before


@pytest.mark.parametrize("bad", ["dtype", "lanes", "overflow", "offset", "allt", "device"])
def test_keys_into_rejects_a_bad_destination(bad):
    reads = torch.from_numpy(extract_reads(np.random.default_rng(0), 4, 40))  # k=20: NL 2, 84 windows
    dst = torch.zeros((2, 100), dtype=torch.int32)
    allt, off = torch.zeros((), dtype=torch.int64), 0
    if bad == "dtype":
        dst = dst.to(torch.int64)
    elif bad == "lanes":
        dst = torch.zeros((3, 100), dtype=torch.int32)
    elif bad == "overflow":
        off = 17
    elif bad == "offset":
        off = -1
    elif bad == "allt":
        allt = torch.zeros(2, dtype=torch.int64)
    elif bad == "device":
        dst = dst.to("meta")
    with pytest.raises(ValueError):
        fx.extract_chunk_keys_into(reads, 20, False, dst, off, allt)
    fx.extract_chunk_keys_into(reads, 20, False, torch.zeros((2, 100), dtype=torch.int32), 16,
                               torch.zeros((), dtype=torch.int64))
