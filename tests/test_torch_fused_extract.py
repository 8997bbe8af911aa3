"""K8, the fused encode + extract (ops.fused_extract), on the CPU.

- The plain version against the Pallas kernel it replaces
  (docs/experiments_pallas_extract.py, loaded by path as its own test
  loads it) in interpret mode: records exactly, and the keys mode against
  the Pallas records masked by their validity plane, all-T windows moved
  to the side count.
- A NumPy model of the CUDA kernel's algorithm (csrc/fused_extract.cu)
  against the plain version, at every k from 1 to 128, in both modes, at
  every pointer alignment, at a small tile and at the kernel's own: the
  staging of a block's bytes a 16-byte chunk a thread at the misalignment
  of the reads' pointer, the four-bytes-at-a-time encode into code words,
  reverse-complemented code words and 32-bit invalid-flag words, the
  enumeration of the windows that start in a block's range (the window's
  row by the host's multiplier, or by a compare for reads longer than the
  tile), the lanes from two words by one funnel shift, the validity from
  funnel shifts of flag words, and the writes at a column offset into a
  larger region; and its pieces alone at their edges (a block that begins
  in a read's tail or starts no window, the multiplier at every P it gets,
  the encode on every byte).  The CUDA kernel itself runs only on the card
  (tests/test_torch_cuda.py, chip_smoke.py).
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
from kmer_counter_tpu_torch.ops.encode import encode_reads
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

THREADS = 256  # kThreads: one staged 16-byte chunk a thread
HALO = 128  # kHalo: staged bases past a tile
GARBAGE = ord("A")  # what the model puts in loaded bytes outside the reads
GATHER_CODES = (1 << 30) | (1 << 20) | (1 << 10) | 1  # kGatherCodes
GATHER_FLAGS = (1 << 21) | (1 << 14) | (1 << 7) | 1  # kGatherFlags


def tile_of(threads):
    """kTile for a block of ``threads``: 16 * threads staged bytes less the
    halo and 16 bytes of alignment."""
    return 16 * threads - HALO - 16


SMALL_THREADS = 14  # a tile of 80 bases: reads cross and exceed it
assert tile_of(THREADS) == EXTRACT_TILE


def _u64(x):
    return np.asarray(x, np.uint64)


def _funnel_r(lo, hi, s):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> s, s in [0, 31]."""
    return ((_u64(hi) << np.uint64(32) | _u64(lo)) >> _u64(s)) & M


def _funnel_l(lo, hi, s):
    """__funnelshift_l: the high 32 bits of (hi:lo) << s, s in [0, 31]."""
    x = _u64(hi) << np.uint64(32) | _u64(lo)
    return ((x << _u64(s)) >> np.uint64(32)) & M


def _umulhi(a, b):
    """__umulhi: the high 32 bits of the 64-bit product of two uint32."""
    return (_u64(a) * _u64(b)) >> np.uint64(32)


def _byte_perm(x, y, sel):
    """__byte_perm(x, y, sel): byte i of the result is byte (sel >> 4i) & 7
    of the 8 bytes y:x."""
    xy = _u64(y) << np.uint64(32) | _u64(x)
    out = np.zeros(np.shape(xy), np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((xy >> np.uint64(8 * b)) & 0xFF) << np.uint64(8 * i)
    return out


def _rev_groups(v):
    """__brev, then a swap of the two bits of each group."""
    v = _u64(v)
    bits = (v[..., None] >> np.arange(32, dtype=np.uint64)) & 1
    x = (bits[..., ::-1] << np.arange(32, dtype=np.uint64)).sum(-1)
    return ((x & 0x55555555) << np.uint64(1)) | ((x >> np.uint64(1)) & 0x55555555)


def encode4(x):
    """The kernel's encode4 on 32-bit words of four ASCII bytes: (codes, 2
    bits in each byte, an invalid byte coded 3; invalid flags, 0x80 in each
    invalid byte)."""
    u = _u64(x) & 0xDFDFDFDF
    c = ((u >> np.uint64(1)) ^ (u >> np.uint64(2))) & 0x03030303
    letter = 0x41414141 + 2 * c + (c & 0x02020202) + 11 * ((c >> np.uint64(1)) & c & 0x01010101)
    diff = u ^ letter
    bad = (((diff & 0x7F7F7F7F) + 0x7F7F7F7F) | diff) & 0x80808080
    return c | (bad >> np.uint64(6)) | (bad >> np.uint64(7)), bad


def stage(raw):
    """Step 1 on the staged bytes ``[B, 16 * threads] uint8``: (s_code [B,
    threads], s_rc [B, threads + 1], s_inv [B, threads / 2] 32-bit flag
    words)."""
    w = raw.view("<u4").astype(np.uint64).reshape(raw.shape[0], -1, 4)
    codes, bad = encode4(w)
    y = (codes * GATHER_CODES) & M
    code = _byte_perm(_byte_perm(y[..., 3], y[..., 2], 0x0073), _byte_perm(y[..., 1], y[..., 0], 0x0073), 0x5410)
    lo = ((bad[..., 0] >> np.uint64(4)) | bad[..., 1]) * GATHER_FLAGS & M
    hi = ((bad[..., 2] >> np.uint64(4)) | bad[..., 3]) * GATHER_FLAGS & M
    flags16 = _byte_perm(lo, hi, 0x0073) & 0xFFFF
    s_rc = np.concatenate([np.zeros((raw.shape[0], 1), np.uint64), _rev_groups(~code & M)], axis=1)
    return code, s_rc, flags16[:, 0::2] | (flags16[:, 1::2] << np.uint64(16))


def block_windows(N, L, k, tile):
    """Step 2 for every block: (b0, w0, count, col0) — the windows that
    start before b0, those that start in [b0, b0 + tile), b0's column."""
    P = L - k + 1
    b0 = np.arange(-(-N // tile), dtype=np.int64) * tile

    def before(b):
        return (b // L) * P + np.minimum(b % L, P)

    w0 = before(b0)
    return b0, w0, before(np.minimum(b0 + tile, N)) - w0, b0 % L


def magic_of(P):
    """The host's multiplier for d = n // P: floor(2^31 / P) + 1."""
    return (1 << 31) // P + 1


def kernel_model(reads, k, canonical, keys, dst, off, threads=THREADS, shift=0):
    """The kernel's steps on numpy arrays, each block's as the kernel takes
    them: writes ``dst`` (uint32, NL or NL+1 rows) at columns off + w and
    returns the all-T count (keys mode).  ``shift``: the reads' pointer
    modulo 16, which places the staged bytes in shared memory."""
    R, L = reads.shape
    NL, N, P = active_lanes(k), R * L, L - k + 1
    tile = tile_of(threads)
    flat = reads.reshape(-1)
    b0, w0, count, col0 = block_windows(N, L, k, tile)
    B = len(b0)

    # 1. thread t loads the aligned chunk at b0 - shift + 16t when it starts before N, else zeros
    x = np.arange(16 * threads)[None]
    g = b0[:, None] - shift + x
    loaded = b0[:, None] - shift + 16 * (x // 16) < N
    inside = np.where((g >= 0) & (g < N), flat[np.clip(g, 0, N - 1)], GARBAGE)
    code, s_rc, s_inv = stage(np.where(loaded, inside, 0).astype(np.uint8))

    # 3. window i of a block: d rows past the first window's, at staged base q
    in_row = col0 < P
    q0 = shift + np.where(in_row, 0, L - col0)
    i = np.arange(tile)[None]
    if L >= tile:
        row_left = np.minimum(np.where(in_row, P - col0, P), tile)
        d = (i >= row_left[:, None]).astype(np.int64)
    else:
        c0 = np.where(in_row, col0, 0)
        assert ((c0[:, None] + i) * P < 1 << 31).all()
        d = _umulhi(2 * (c0[:, None] + i), magic_of(P)).astype(np.int64)
    is_window = i < count[:, None]
    q = np.where(is_window, q0[:, None] + i + d * (k - 1), 0)
    assert (q[is_window] < shift + tile).all()  # a window starts in the block's tile

    def take(a, idx):
        assert (idx >= 0).all() and (idx < a.shape[1]).all()
        return np.take_along_axis(a, idx, 1)

    # 4. lanes: one funnel shift of two words each, the same shift for every lane
    n_last = k - 16 * (NL - 1)
    lane_mask = M if n_last == 16 else ~(M >> (2 * n_last)) & M
    j, s = q >> 4, 2 * (q & 15)
    key = [_funnel_l(take(code, j + l + 1), take(code, j + l), s) for l in range(NL)]
    key[-1] &= lane_mask
    if canonical:
        e = q + k - 1
        je, s = e >> 4, 30 - 2 * (e & 15)
        rc = [_funnel_l(take(s_rc, je - l), take(s_rc, je - l + 1), s) for l in range(NL)]
        rc[-1] &= lane_mask
        take_rc, decided = np.zeros(q.shape, bool), np.zeros(q.shape, bool)
        for l in range(NL):
            differ = ~decided & (rc[l] != key[l])
            take_rc |= differ & (rc[l] < key[l])
            decided |= differ
        key = [np.where(take_rc, r, f) for r, f in zip(rc, key)]

    # validity: (NL+1)/2 funnel shifts of adjacent flag words, the last masked
    span = (NL + 1) // 2
    v_last = k - 32 * (span - 1)
    v_mask = M if v_last == 32 else (1 << v_last) - 1
    jv, s = q >> 5, q & 31
    bad = np.zeros(q.shape, np.uint64)
    for t in range(span):
        x = _funnel_r(take(s_inv, jv + t), take(s_inv, jv + t + 1), s)
        bad |= x & v_mask if t == span - 1 else x
    valid = bad == 0

    # 5. writes at column off + w0 + i
    cols = off + (w0[:, None] + i)[is_window]
    v = valid[is_window]
    allt = 0
    if keys:
        if k % 16 == 0 and not canonical:
            allt = int((v & np.all([x[is_window] == M for x in key], axis=0)).sum())
        for l in range(NL):
            dst[l, cols] = np.where(v, key[l][is_window], M)
    else:
        for l in range(NL):
            dst[l, cols] = key[l][is_window]
        dst[NL, cols] = v
    return allt


def _model_vs_plain(reads, k, canonical, threads, shift, off=5, tail=3):
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
        allt = kernel_model(reads, k, canonical, keys, dst, off, threads, shift)
        np.testing.assert_array_equal(dst[:, off : off + n], want, err_msg=f"k={k} L={L} keys={keys}")
        assert (dst[:, :off] == pattern).all() and (dst[:, off + n :] == pattern).all()
        if keys:
            assert allt == int(want_allt)


@pytest.mark.parametrize("k", range(1, 129))
def test_kernel_model_matches_plain(k):
    """Every k, both modes, canonical or not, at a tile of 80 bases: reads
    shorter than the tile (the multiplier), a tile that cuts reads, reads
    longer than the tile (cut along the row with the halo), and a pointer
    alignment that moves with k and L."""
    rng = np.random.default_rng(k)
    for L, R in ((k, 7), (k + 1, 5), (k + 17, 4), (k + 150, 2)):
        reads = extract_reads(rng, R, L)
        for canonical in (False, True):
            _model_vs_plain(reads, k, canonical, threads=SMALL_THREADS, shift=(k + L) % 16)


@pytest.mark.parametrize("shift", range(16))
def test_kernel_model_at_every_alignment(shift):
    """Each of the 16 pointer alignments, at k with a full, a partial and a
    single-base last lane, reads shorter and longer than the small tile."""
    rng = np.random.default_rng(100 + shift)
    for k, L, R in ((31, 45, 9), (32, 32, 11), (97, 200, 2), (128, 131, 3)):
        reads = extract_reads(rng, R, L)
        for canonical in (False, True):
            _model_vs_plain(reads, k, canonical, threads=SMALL_THREADS, shift=shift)


@pytest.mark.parametrize("k,canonical", [(31, True), (32, False), (128, False), (101, True), (1, False)])
def test_kernel_model_at_the_kernel_tile(k, canonical):
    """The kernel's own tile: a chunk that ends one read past a tile, and
    reads longer than a tile."""
    rng = np.random.default_rng(k)
    for R, L in ((EXTRACT_TILE // 100 + 1, 100), (2, EXTRACT_TILE + 300), (1, max(k, 7))):
        _model_vs_plain(extract_reads(rng, R, max(L, k)), k, canonical, threads=THREADS, shift=3)


def test_model_all_t_windows_go_to_the_side_count():
    for k in (16, 32, 64, 128):
        reads = np.full((3, k + 9), ord("T"), np.uint8)
        reads[1, 4] = ord("t")
        reads[2, 5] = ord("N")
        dst = np.zeros((active_lanes(k), 3 * 10), np.uint32)
        assert kernel_model(reads, k, False, True, dst, 0, threads=SMALL_THREADS) == 10 + 10 + 4
        assert (dst == M).all()
        _model_vs_plain(reads, k, False, threads=SMALL_THREADS, shift=0)


@pytest.mark.parametrize("threads", [SMALL_THREADS, THREADS])
def test_model_block_that_begins_in_a_reads_tail(threads):
    """A block whose range begins inside a read's last k-1 bases has its
    first window at column 0 of the next read."""
    k, L = 101, 151
    R = 2 * tile_of(threads) // L + 3
    _, _, count, col0 = block_windows(R * L, L, k, tile_of(threads))
    assert ((col0 >= L - k + 1) & (count > 0)).any()
    reads = extract_reads(np.random.default_rng(7), R, L)
    for canonical in (False, True):
        _model_vs_plain(reads, k, canonical, threads=threads, shift=5)


@pytest.mark.parametrize("threads,k,R,L", [(10, 40, 5, 40), (THREADS, 31, None, 100)])
def test_model_block_without_a_window(threads, k, R, L):
    """A block whose whole range lies in reads' tails starts no window: with
    L = k and a 16-base tile, and at the kernel's tile a last block that
    begins in the last read's tail."""
    tile = tile_of(threads)
    if R is None:  # the chunk ends 1..k-1 bytes past a tile boundary
        R = next(r for r in range(tile // L, 4 * tile) if 0 < r * L % tile < k)
    _, _, count, _ = block_windows(R * L, L, k, tile)
    assert (count == 0).any()
    reads = extract_reads(np.random.default_rng(8), R, L)
    for canonical in (False, True):
        _model_vs_plain(reads, k, canonical, threads=threads, shift=9)


def test_multiplier_division_matches_floor_division():
    """d = __umulhi(2n, floor(2^31 / P) + 1) is n // P for every n the
    kernel gives it (n < P + tile) at every P from 1 to 300 and at the
    largest P of a read shorter than the tile."""
    for P in [*range(1, 301), EXTRACT_TILE - 2, EXTRACT_TILE - 1]:
        n = np.arange(P + EXTRACT_TILE, dtype=np.uint64)
        np.testing.assert_array_equal(_umulhi(2 * n, magic_of(P)), n // np.uint64(P), err_msg=f"P={P}")


def test_encode4_matches_plain_encode_on_every_byte():
    """The four-bytes-at-a-time encode against ops/encode.py on all 256 byte
    values, at every position within a word, and its staged code, reverse
    complement and flag words against a base-by-base build."""
    values = np.arange(256, dtype=np.uint8)
    codes, valid = (t.numpy() for t in encode_reads(torch.from_numpy(values[None])))
    for rot in range(4):  # byte b of each word: values[(4w + b + rot) % 256]
        raw = np.roll(values, -rot)
        c, bad = encode4(raw.view("<u4"))
        got_codes = (c[:, None] >> (8 * np.arange(4, dtype=np.uint64))) & 3
        got_bad = (bad[:, None] >> (8 * np.arange(4, dtype=np.uint64) + 7)) & 1
        np.testing.assert_array_equal(got_codes.reshape(-1), np.roll(codes[0], -rot))
        np.testing.assert_array_equal(got_bad.reshape(-1) == 1, ~np.roll(valid[0], -rot))
    raw = np.random.default_rng(3).permutation(np.tile(values, 4))[None]  # 1024 bytes: 64 words
    code, s_rc, s_inv = stage(raw)
    c, v = (t.numpy()[0] for t in encode_reads(torch.from_numpy(raw)))
    c16 = c.reshape(-1, 16).astype(np.uint64)
    want = (c16 << (30 - 2 * np.arange(16, dtype=np.uint64))).sum(1)
    np.testing.assert_array_equal(code[0], want)
    np.testing.assert_array_equal(s_rc[0, 1:], ((3 - c16) << (2 * np.arange(16, dtype=np.uint64))).sum(1))
    want_inv = ((~v).reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)
    np.testing.assert_array_equal(s_inv[0], want_inv)


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
