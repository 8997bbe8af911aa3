"""D1-D7, the Mosaic probes under docs/ (ops.probes and the probe
harnesses), on the CPU.

- The plain versions against the Pallas functions they replace, run in
  interpret mode on the same seeded operands: D1's three bodies from
  docs/probe_compact_overhead.py, loaded by path at one tile and, for the
  network body, at two (nothing crosses a tile); D2, D3 (G = 4), D4-D6
  (``q1``-``q3``, called whole) and D7's merge kernel (R = 4 and R = 512),
  their functions taken from the parsed sources of
  docs/experiments_bitonic_merge.py and docs/experiments_mosaic_caps.py
  (which run their probes at import) with ``pl.pallas_call`` wrapped to
  add ``interpret=True`` and record each call's operands and result.
  Nothing under docs/ changes.
- The plain versions against NumPy over many seeded shapes, and models of
  the CUDA kernels' arithmetic (csrc/probes.cu: the warp's ballot search
  for a tile's split, ballot by ballot, against the binary one, with its
  rounds counted; the 16-byte staging and the tiles on the output's grid,
  with every warp instruction's shared-memory banks counted; the chunked
  block scan with its carry; C's remainder for the rows) against the plain
  versions.  The CUDA kernels run only on the card
  (tests/test_torch_cuda.py, chip_smoke.py).
- The three harnesses' ``main(device=cpu)`` at reduced sizes, and the
  wrappers' checks.

Tolerance: exact equality; everything is integer.
"""

import ast
import importlib.util
import os
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kmer_counter_tpu_torch.ops import probes
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy
from kmer_counter_tpu_torch.probes import ProbeFailed, experiments_bitonic_merge, experiments_mosaic_caps
from kmer_counter_tpu_torch.probes import probe_compact_overhead

from tests.test_torch_cuda import (PROBE_GATHER_CASES, PROBE_MERGE_TIE_CASES, PROBE_MERGE_TILE, PROBE_NET_THREADS,
                                   PROBE_PART, PROBE_TILE, PROBE_TILE_CASES, probe_gather_case, probe_keys,
                                   probe_merge_case, probe_tie_case, probe_tile_case, wrapper_stream_case)

CPU = torch.device("cpu")
DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
M = 0xFFFFFFFF


def t32(a: np.ndarray) -> torch.Tensor:
    return from_numpy(a, CPU)


# ---- the Pallas functions in interpret mode ---------------------------------


class RecordingPallas:
    """``pl`` with ``pallas_call`` run in interpret mode; each call's
    operands and result are kept in ``calls`` as NumPy arrays."""

    def __init__(self):
        self.calls = []

    def pallas_call(self, kernel, **kw):
        call = pl.pallas_call(kernel, interpret=True, **kw)

        def run(*ops):
            out = call(*ops)
            self.calls.append(([np.asarray(v) for v in ops], np.asarray(out)))
            return out

        return run

    def __getattr__(self, name):
        return getattr(pl, name)


class EagerJax:
    """``jax`` with ``jit`` a no-op, so that the recorder sees values."""

    @staticmethod
    def jit(fn):
        return fn

    def __getattr__(self, name):
        return getattr(jax, name)


def probe_namespace(script: str, names: set, **values) -> tuple[dict, RecordingPallas]:
    """The named top-level functions and assignments of docs/<script>,
    executed in a namespace of their own (the script itself runs its probes
    at import), then ``values`` set in it."""
    path = os.path.join(DOCS, script)
    tree = ast.parse(open(path).read())
    body = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name in names)
            or (isinstance(node, ast.Assign) and any(getattr(t, "id", None) in names for t in node.targets))]
    assert {getattr(n, "name", None) or n.targets[0].id for n in body} == names
    rec = RecordingPallas()
    ns = {"jax": EagerJax(), "jnp": jnp, "np": np, "pl": rec, "pltpu": pltpu}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    ns.update(values)
    return ns, rec


def load_d1(monkeypatch, tiles: int):
    """docs/probe_compact_overhead.py loaded by path in interpret mode at
    ``tiles`` tiles; the JAX compilation-cache setting it makes is undone."""
    monkeypatch.setenv("PROBE_INTERPRET", "1")
    monkeypatch.setenv("PROBE_TILES", str(tiles))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    spec = importlib.util.spec_from_file_location("probe_compact_overhead",
                                                  os.path.join(DOCS, "probe_compact_overhead.py"))
    module = importlib.util.module_from_spec(spec)
    old = jax.config.jax_compilation_cache_dir
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    assert module.TILE == probes.TILE and module.N == tiles * probes.TILE
    return module


def d1_operands(tiles: int, seed: int):
    """3 operands and a live flag at ~3% with a live row at the last index of
    every tile, and the first row of the second tile live."""
    rng = np.random.default_rng(seed)
    n = tiles * PROBE_TILE
    ops = probe_keys(rng, (3, n), ascending=False)
    live = np.where(rng.random(n) < 0.03, rng.integers(1, 2**32, n, dtype=np.uint64), 0).astype(np.uint32)
    live[PROBE_TILE - 1 :: PROBE_TILE] = 0x80000000
    if tiles > 1:
        live[PROBE_TILE] = 1
    return ops, live


@pytest.mark.parametrize("mode,tiles", [("copy", 1), ("cumsum", 1), ("network", 1), ("network", 2)])
def test_d1_plain_matches_pallas_interpret(monkeypatch, mode, tiles):
    module = load_d1(monkeypatch, tiles)
    ops, live = d1_operands(tiles, seed=tiles)
    want = np.stack([np.asarray(v).reshape(-1) for v in
                     module.VARIANTS[mode]()(*[jnp.asarray(v) for v in ops], jnp.asarray(live))])
    got = to_numpy(probes.tile_compact([t32(v) for v in ops], t32(live), mode))
    np.testing.assert_array_equal(got, want)
    if mode == "network":
        # each tile's live rows at its front: nothing crossed a tile
        alive = (live != 0).reshape(tiles, -1)
        for t in range(tiles):
            k = int(alive[t].sum())
            tile = want[:, t * PROBE_TILE : (t + 1) * PROBE_TILE]
            np.testing.assert_array_equal(tile[:, :k], ops[:, t * PROBE_TILE : (t + 1) * PROBE_TILE][:, alive[t]])
            assert not tile[:, k:].any()


BITONIC = {"T", "_merge_block", "merge_kernel", "merge", "merge_kernel_g", "merge_many"}


def _d2_operands(case):
    rng = np.random.default_rng(0)
    if case == "probe":  # the probe's own draws
        return tuple(np.sort(rng.integers(0, 2**32, 1024, dtype=np.uint64).astype(np.uint32)) for _ in range(2))
    return probe_keys(rng, 1024), probe_keys(rng, 1024)  # 0, 0xFFFFFFFF, 2^31 and runs of duplicates


@pytest.mark.parametrize("case", ["probe", "extremes_and_duplicates"])
def test_d2_plain_matches_pallas_interpret(case):
    ns, rec = probe_namespace("experiments_bitonic_merge.py", BITONIC)
    a, b = _d2_operands(case)
    ns["merge"](jnp.asarray(a.reshape(8, 128)), jnp.asarray(b[::-1].copy().reshape(8, 128)))
    (a_op, b_op), want = rec.calls[-1]
    got = experiments_bitonic_merge.merge(t32(a_op), t32(b_op))
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(want.reshape(-1), np.sort(np.concatenate([a, b])))


def test_d3_plain_matches_pallas_interpret():
    G = 4
    ns, rec = probe_namespace("experiments_bitonic_merge.py", BITONIC, G=G)
    rng = np.random.default_rng(1)
    A, B = probe_keys(rng, (G, 1024)), probe_keys(rng, (G, 1024))
    ns["merge_many"](jnp.asarray(A), jnp.asarray(B))
    (a_op, b_op), want = rec.calls[-1]
    assert a_op.shape == b_op.shape == (G, 8, 128) and want.shape == (G, 16, 128)
    got = experiments_bitonic_merge.merge_many(t32(a_op), t32(b_op))
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(want.reshape(G, -1), np.sort(np.concatenate([A, B], 1), 1))


CAPS = {"q1", "q2", "q3"}


def test_d4_d5_d6_plain_match_pallas_interpret():
    ns, rec = probe_namespace("experiments_mosaic_caps.py", CAPS, rng=np.random.default_rng(0))
    for q in ("q1", "q2", "q3"):
        assert ns[q]() == "correct"
    (x1,), want1 = rec.calls[0]
    (x2,), want2 = rec.calls[1]
    (starts, x3), want3 = rec.calls[2]
    np.testing.assert_array_equal(to_numpy(experiments_mosaic_caps.roll_rows(t32(x1), -3)), want1)
    np.testing.assert_array_equal(to_numpy(experiments_mosaic_caps.roll_rows(t32(x2), 3)), want2)
    got3 = probes.row_gather(t32(x3), torch.from_numpy(starts.copy()), 8, 0)
    np.testing.assert_array_equal(to_numpy(got3), want3)
    assert tuple(starts) == experiments_mosaic_caps.STARTS


MERGE_NETWORK = {"R", "_partner_down", "_partner_up", "_flat_iota", "_ce", "_shift_mask_up", "merge_kernel"}


@pytest.mark.parametrize("R", [4, 512])
def test_d7_plain_matches_pallas_interpret(R):
    ns, rec = probe_namespace("experiments_mosaic_caps.py", MERGE_NETWORK, R=R)
    rng = np.random.default_rng(R)
    a, b = probe_keys(rng, R * 128), probe_keys(rng, R * 128)
    # q4's call (docs/experiments_mosaic_caps.py:200-209), without its timing loop
    rec.pallas_call(ns["merge_kernel"], out_shape=jax.ShapeDtypeStruct((2 * R, 128), jnp.uint32),
                    in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
                    out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))(jnp.asarray(a.reshape(R, 128)),
                                                                     jnp.asarray(b.reshape(R, 128)))
    (a_op, b_op), want = rec.calls[-1]
    got = probes.pair_merge(t32(a_op.reshape(1, -1)), t32(b_op.reshape(1, -1)), b_descending=False)
    np.testing.assert_array_equal(to_numpy(got).reshape(2 * R, 128), want)
    np.testing.assert_array_equal(want.reshape(-1), np.sort(np.concatenate([a, b])))


# ---- the plain versions against NumPy ---------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_plain_pair_merge_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        G, ta, tb = int(rng.integers(1, 6)), int(rng.integers(0, 3000)), int(rng.integers(0, 3000))
        a, b = probe_merge_case(rng, G, ta, tb)
        want = np.sort(np.concatenate([a, b], 1), 1)
        for desc in (False, True):
            got = probes.pair_merge(t32(a), t32(b[:, ::-1] if desc else b), b_descending=desc)
            np.testing.assert_array_equal(to_numpy(got), want)


def numpy_tile_compact(ops: np.ndarray, live: np.ndarray, mode: str) -> np.ndarray:
    """D1 a tile at a time, a row at a time in the tile's order."""
    out = np.zeros_like(ops)
    for t0 in range(0, live.size, PROBE_TILE):
        rows = range(t0, t0 + PROBE_TILE)
        if mode == "copy":
            out[:, rows] = ops[:, rows]
        elif mode == "cumsum":
            dead = np.concatenate([[0], np.cumsum(live[rows] == 0)[:-1]]).astype(np.uint32)
            out[:, rows] = ops[:, rows] + dead
        else:
            keep = np.flatnonzero(live[rows]) + t0
            out[:, t0 : t0 + keep.size] = ops[:, keep]
    return out


@pytest.mark.parametrize("name", sorted(PROBE_TILE_CASES))
def test_plain_tile_compact_matches_numpy(name):
    ops, live = probe_tile_case(np.random.default_rng(5), *PROBE_TILE_CASES[name])
    for mode in probes.MODES:
        got = probes.tile_compact([t32(v) for v in ops], t32(live), mode)
        np.testing.assert_array_equal(to_numpy(got), numpy_tile_compact(ops, live, mode), mode)


def test_plain_cumsum_wraps_mod_2_32():
    ops = np.full((1, PROBE_TILE), M - 2, np.uint32)
    got = to_numpy(probes.tile_compact([t32(ops[0])], t32(np.zeros(PROBE_TILE, np.uint32)), "cumsum"))
    np.testing.assert_array_equal(got[0, :5], [M - 2, M - 1, M, 0, 1])


@pytest.mark.parametrize("name", sorted(PROBE_GATHER_CASES))
def test_plain_row_gather_matches_numpy(name):
    R, W, starts, rows, shift = PROBE_GATHER_CASES[name]
    x = probe_gather_case(np.random.default_rng(2), R, W)
    got = probes.row_gather(t32(x), torch.tensor(starts, dtype=torch.int32), rows, shift)
    want = np.stack([np.roll(x, -(s + shift), 0)[:rows] for s in starts])
    np.testing.assert_array_equal(to_numpy(got), want)


def test_plain_row_gather_raises_on_a_window_outside_x():
    x = t32(np.zeros((16, 4), np.uint32))
    for starts, rows in (([9], 8), ([-1], 8), ([0, 17], 1)):
        with pytest.raises(ValueError, match="inside x"):
            probes.row_gather(x, torch.tensor(starts, dtype=torch.int32), rows, 0)


# ---- models of the CUDA kernels' arithmetic ------------------------------------


def merge_path_split(d, la, lb, a_le_b):
    """lanes.cuh merge_path_split."""
    lo, hi = max(d - lb, 0), min(d, la)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a_le_b(mid, d - 1 - mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


def pad(r):
    """lanes.cuh pad: one spare word after every 32 of a shared-memory tile."""
    return r + r // 32


def warp_split(d, ta, tb, a_at, b_at):
    """probes.cu warp_split, ballot by ballot: each round lane k probes the
    last candidate of the k-th of 32 equal slices of the candidates, and the
    count of the ballot of "A <= B" names the slice that holds the split.
    Returns (split, rounds of loads)."""
    lo, hi = max(d - tb, 0), min(d, ta)
    rounds = 0
    while lo < hi:
        step = (hi - lo + 31) >> 5
        probe = [lo + (k + 1) * step - 1 for k in range(32)]
        ballot = sum((i < hi and a_at(i) <= b_at(d - 1 - i)) << k for k, i in enumerate(probe))
        c = bin(ballot).count("1")
        lo, hi = lo + c * step, min(lo + (c + 1) * step - 1, hi)
        rounds += 1
    return lo, rounds


def conflicts(banks_by_instruction):
    """Extra shared-memory wavefronts: for each warp instruction (a list of
    the banks its active lanes touch), the lanes that share a bank."""
    return sum(len(b) - len(set(b)) for b in banks_by_instruction)


def model_stage(keys, start, rev, threads, iters):
    """probes.cu stage_load + stage_store of keys (a range of a row whose
    first key lies ``start`` words past a 16-byte boundary): ({tile index:
    key}, f, the stores' bank conflicts).  Chunk c, the c-th 16-byte chunk
    from the one the range starts in, goes to thread c % threads in round
    c // threads; a whole chunk is one 16-byte load, the head and tail a word
    at a time."""
    n = len(keys)
    h = start % 4
    chunks = (h + n + 3) // 4
    assert chunks <= threads * iters
    f = -(h + n) % 32 if rev else h
    tile, stores = {}, []
    for it in range(iters):
        for w in range(threads // 32):
            for q in range(4):
                banks = []
                for lane in range(32):
                    c = 32 * w + lane + it * threads
                    k = 4 * c - h + q
                    if c < chunks and 0 <= k < n:
                        idx = f + n - 1 - k if rev else f + k
                        assert idx not in tile
                        tile[idx] = keys[k]
                        banks.append(pad(idx) % 32)
                stores.append(banks)
    return tile, f, conflicts(stores)


# probes.cu FitShape and SpreadShape: (threads, outputs a thread) of a block
# where a pair fits one block, and where it is spread over blocks.
FIT_SHAPE, SPREAD_SHAPE = (256, 8), (256, 4)


def model_pair_merge(a, b_stored, b_desc, starts=(0, 0, 0), stats=None):
    """pair_merge_kernel: a block a tile of threads*items output words of one
    pair (FIT_SHAPE where the pair fits one tile, else SPREAD_SHAPE), the
    tiles on the output's 16-byte grid (``starts``: the words past a 16-byte
    boundary at which a, b and the output begin); warps 0 and 1 find the
    tile's splits (warp_split), the block stages its A and B ranges in
    16-byte chunks (model_stage), thread t merges the tile's words [items t,
    items (t+1)) that lie in the pair from its own split into the padded
    output tile, and the block writes the tile out, whole 16-byte chunks at
    once.
    Asserts that every output word is written once, by a 16-byte store on a
    16-byte boundary or as a head or tail word.  ``stats``, when given,
    collects the most rounds of a split and the bank conflicts of each
    phase."""
    G, ta = a.shape
    tb = b_stored.shape[1]
    n = ta + tb
    shift = 3 if n % 4 else starts[2] % 4
    threads, items = FIT_SHAPE if n + shift <= FIT_SHAPE[0] * FIT_SHAPE[1] else SPREAD_SHAPE
    tile = threads * items
    iters = -(-(tile // 4 + 2) // threads)
    tiles = -(-(n + shift) // tile)
    out = np.zeros((G, n), np.uint32)
    writes = np.zeros((G, n), int)
    st = {} if stats is None else stats
    for key in ("rounds", "stage", "merge", "store"):
        st.setdefault(key, 0)
    for blk in range(G * tiles):
        g = blk // tiles
        pa, pb = a[g].tolist(), b_stored[g].tolist()
        o = (starts[2] + g * n) % 4  # the row's first word past a 16-byte boundary
        e0 = (blk - g * tiles) * tile - o
        d0, d1 = max(e0, 0), min(e0 + tile, n)
        if d0 >= d1:
            continue

        def b_at(j):
            return pb[tb - 1 - j] if b_desc else pb[j]

        (a0, r0), (a1, r1) = (warp_split(d, ta, tb, lambda i: pa[i], b_at) for d in (d0, d1))
        st["rounds"] = max(st["rounds"], r0, r1)
        length = d1 - d0
        la = min(max(a1 - a0, 0), length)
        lb = length - la
        b0 = d0 - a0
        sb0 = tb - b0 - lb if b_desc else b0  # B's range as stored
        tile_a, fa, ca = model_stage(pa[a0 : a0 + la], starts[0] + g * ta + a0, False, threads, iters)
        tile_b, fb, cb = model_stage(pb[sb0 : sb0 + lb], starts[1] + g * tb + sb0, b_desc, threads, iters)
        st["stage"] += ca + cb
        assert max([fa + la, fb + lb, 0]) <= tile + 32

        def sa(i):
            return tile_a[fa + i]

        def sb(j):
            return tile_b[fb + j]

        lo, hi = d0 - e0, d0 - e0 + length
        s_out, merge_stores, loads = {}, defaultdict(list), defaultdict(list)  # banks by (warp, round, q)
        for t in range(threads):
            t0 = items * t
            first = max(t0, lo)
            cnt = min(t0 + items, hi) - first
            if cnt <= 0:
                continue
            ia = merge_path_split(first - lo, la, lb, lambda i, j: sa(i) <= sb(j))
            ib = first - lo - ia
            for q in range(cnt):
                if ib >= lb or (ia < la and sa(ia) <= sb(ib)):
                    s_out[first + q], ia = sa(ia), ia + 1
                else:
                    s_out[first + q], ib = sb(ib), ib + 1
                merge_stores[t // 32, q].append(pad(first + q) % 32)
        st["merge"] += conflicts(merge_stores.values())
        assert sorted(s_out) == list(range(lo, hi))
        for t in range(threads):
            for it, i in enumerate(range(4 * t, hi, 4 * threads)):
                whole = i >= lo and i + 4 <= hi
                if whole:
                    assert (starts[2] + g * n + e0 + i) % 4 == 0, "a 16-byte store off a 16-byte boundary"
                for q in range(4):
                    if lo <= i + q < hi:
                        out[g, e0 + i + q] = s_out[i + q]
                        writes[g, e0 + i + q] += 1
                        loads[t // 32, it, q].append(pad(i + q) % 32)
        st["store"] += conflicts(loads.values())
    assert (writes == 1).all(), "an output word written twice or never"
    return out


def model_vs_plain(a, b, starts=(0, 0, 0)):
    """model_pair_merge against the plain version, B in either order; the
    staging stores and the output tile's loads free of bank conflicts.
    Returns the stats of the B-descending run."""
    for desc in (False, True):
        b_stored = np.ascontiguousarray(b[:, ::-1]) if desc else b
        want = to_numpy(probes.pair_merge(t32(a), t32(b_stored), b_descending=desc))
        stats = {}
        np.testing.assert_array_equal(model_pair_merge(a, b_stored, desc, starts, stats=stats), want)
        assert stats["stage"] == stats["store"] == 0, stats
    return stats


# Shapes of the model: the probes' pair (D2), several blocks a pair, one
# side short or empty, a pair of exactly two blocks; then rows of A, B and
# the output starting 1, 2 and 3 words past a 16-byte boundary (Ta, Tb or
# Ta + Tb not a multiple of 4, G > 1).
MODEL_MERGE_SHAPES = [(1, 1024, 1024), (3, 2047, 2049), (1, 5000, 17), (2, 0, 3000), (1, 4096, 4096),
                      (3, 1025, 1023), (5, 2050, 2046), (3, 1026, 1025), (2, 3, 2046), (3, 2050, 2048),
                      (4, 4097, 5)]


@pytest.mark.parametrize("shape", MODEL_MERGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_model_of_pair_merge_kernel_matches_plain(shape):
    stats = model_vs_plain(*probe_merge_case(np.random.default_rng(sum(shape)), *shape))
    if shape[0] == 1 and shape[1] + shape[2] <= PROBE_MERGE_TILE:
        assert stats["rounds"] == 0  # a pair in one block searches nothing
    if sum(shape[1:]) % 4 == 0:
        assert stats["merge"] == 0  # every row on the grid: the merge's stores too


@pytest.mark.parametrize("starts", [(1, 2, 3), (3, 1, 2), (2, 3, 1)])
def test_model_of_pair_merge_kernel_on_unaligned_tensors(starts):
    """a, b and the output beginning off a 16-byte boundary (column slices,
    or views into a larger buffer)."""
    model_vs_plain(*probe_merge_case(np.random.default_rng(sum(starts)), 3, 2050, 2049), starts)


@pytest.mark.parametrize("name", sorted(PROBE_MERGE_TIE_CASES))
def test_model_of_pair_merge_kernel_with_ties_across_blocks(name):
    model_vs_plain(*probe_tie_case(np.random.default_rng(3), *PROBE_MERGE_TIE_CASES[name]))


SPLIT_SMALL = {"empty_a": (0, 7), "empty_b": (9, 0), "one_each": (1, 1), "short": (37, 64), "odd": (300, 257),
               "long_a": (1000, 33)}


def split_case(rng, case):
    """(a, b ascending, the diagonals to search): a tie-heavy small pair
    (probe_keys: runs of 0, 0xFFFFFFFF, 0x80000000 and 12345) at every
    diagonal, or a pair of 65,536 keys a side at both ends and 300 random
    diagonals."""
    if case.startswith("large"):
        a, b = probe_keys(rng, 65536), probe_keys(rng, 65536)
        return a, b, [0, 1, 65535, 65536, 65537, 131071, 131072, *rng.integers(0, 131073, 300).tolist()]
    ta, tb = SPLIT_SMALL[case]
    return probe_keys(rng, ta), probe_keys(rng, tb), range(ta + tb + 1)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("case", [*SPLIT_SMALL, "large_0", "large_1", "large_2"])
def test_warp_split_matches_merge_path_split(case, desc):
    """warp_split's ballot search finds lanes.cuh merge_path_split's split
    (A first on ties) at every diagonal searched, with B stored in either
    order; at most 4 rounds of loads at 65,536 keys a side."""
    rng = np.random.default_rng([len(case), int(desc)])
    a, b, diagonals = split_case(rng, case)
    pa, pb = a.tolist(), (b[::-1] if desc else b).tolist()
    tb = len(pb)

    def b_at(j):
        return pb[tb - 1 - j] if desc else pb[j]

    most = 0
    for d in diagonals:
        got, rounds = warp_split(d, len(pa), tb, lambda i: pa[i], b_at)
        assert got == merge_path_split(d, len(pa), tb, lambda i, j: pa[i] <= b_at(j)), d
        most = max(most, rounds)
    if case.startswith("large"):
        assert 3 <= most <= 4


def model_tile_cumsum(ops, live, threads=1024):
    """tile_compact_kernel's cumsum: a tile in chunks of 4 rows a thread,
    each thread's dead count scanned across the block, the chunk's total
    carried to the next."""
    out = np.zeros_like(ops)
    chunk = 4 * threads
    for base in range(0, live.size, PROBE_TILE):
        carry = 0
        for c in range(0, PROBE_TILE, chunk):
            rows = base + c + np.arange(chunk)
            on = (live[rows] == 0).reshape(threads, 4)
            mine = on.sum(1)
            before = carry + np.concatenate([[0], np.cumsum(mine)[:-1]])
            within = np.cumsum(on, 1) - on  # before it in its thread
            out[:, rows] = ops[:, rows] + (before[:, None] + within).reshape(-1).astype(np.uint32)
            carry += int(mine.sum())
    return out


def spread4(x):
    """probes.cu spread4: bit k of a byte moved to bit 4k."""
    x = (x | (x << 12)) & 0x000F000F
    x = (x | (x << 6)) & 0x03030303
    return (x | (x << 3)) & 0x11111111


def model_warp_masks(on):
    """probes.cu warp_masks: ``on`` [..., 1024] (a warp's rows live) to
    [..., 32] mask words.  Load i brings word q of 16-byte word 32 i + l to
    lane l; a ballot a load and word position; lane L takes byte L % 4 of
    load L / 4's four ballots, spread to every fourth bit."""
    w = on.reshape(*on.shape[:-1], 8, 32, 4).astype(np.int64)
    ballots = (w << np.arange(32)[:, None]).sum(-2)  # [..., load, q]: bit l set if lane l's word q is live
    lane = np.arange(32)
    byte = (ballots[..., lane // 4, :] >> (8 * (lane % 4))[:, None]) & 0xFF
    return sum(spread4(byte[..., q]) << q for q in range(4))


def model_tile_network(ops, live, parts=PROBE_TILE // PROBE_PART, threads=PROBE_NET_THREADS, tail_lo=max):
    """tile_compact_kernel's network: a cluster of ``parts`` CTAs a tile, a
    CTA a part, a thread 32 consecutive rows held as a mask word (built by
    warp_masks).  The block scan of the threads' popcounts ranks them in
    their part; the parts' counts (each CTA's s_count, read by the whole
    cluster) give each part its base rank and the tile's total; a live row
    goes to base + thread's rank + popc(its mask below the row); each CTA
    zeroes its part's rows at or past the total, a scalar head to a
    multiple of 4, then 16-byte words (``tail_lo(total, part's first
    row)`` is where a CTA's zeros begin).  Every output row must be written
    exactly once: the live rows and the zero tails never overlap."""
    n_ops, n = ops.shape
    part = PROBE_TILE // parts
    per = part // threads
    assert per == 32 and threads % 32 == 0
    out = np.zeros_like(ops)
    writes = np.zeros(n, int)  # stores to each output row
    bit = np.arange(per, dtype=np.int64)
    for base in range(0, n, PROBE_TILE):
        on = live[base : base + PROBE_TILE].reshape(parts, threads, per) != 0
        mask = model_warp_masks(on.reshape(parts, threads // 32, 32 * per)).reshape(parts, threads)
        assert np.array_equal(mask, (on.astype(np.int64) << bit).sum(-1))
        pop = np.bitwise_count(mask).astype(np.int64)
        count = pop.sum(1)  # s_count of each CTA
        total = int(count.sum())
        rank = (np.cumsum(pop, 1) - pop) + (np.cumsum(count) - count)[:, None]
        below = np.bitwise_count(mask[..., None] & ((1 << bit) - 1)).astype(np.int64)
        dst = base + (rank[..., None] + below)[on]
        out[:, dst] = ops[:, base + np.flatnonzero(on)]
        np.add.at(writes, dst, 1)
        for c in range(parts):
            lo, hi = tail_lo(total, c * part), (c + 1) * part
            if lo < hi:
                lo4 = (lo + 3) & ~3
                assert lo4 <= hi and hi % 4 == 0
                for a, b in ((lo, lo4), (lo4, hi)):  # the scalar head, then 16-byte words
                    out[:, base + a : base + b] = 0
                    writes[base + a : base + b] += 1
    assert (writes == 1).all(), "an output row written twice or never"
    return out


def model_tile_compact(ops, live, mode):
    """tile_compact_kernel's cumsum and network."""
    return model_tile_cumsum(ops, live) if mode == "cumsum" else model_tile_network(ops, live)


@pytest.mark.parametrize("name", sorted(PROBE_TILE_CASES))
def test_model_of_tile_compact_kernel_matches_plain(name):
    ops, live = probe_tile_case(np.random.default_rng(7), *PROBE_TILE_CASES[name])
    for mode in ("cumsum", "network"):
        want = to_numpy(probes.tile_compact([t32(v) for v in ops], t32(live), mode))
        np.testing.assert_array_equal(model_tile_compact(ops, live, mode), want, mode)


def test_model_of_tile_network_catches_a_tail_zeroed_below_the_total():
    """The model's write count finds the fault the cluster exchange guards
    against: a CTA that zeroed its whole part would wipe live rows that
    other parts place there."""
    ops, live = probe_tile_case(np.random.default_rng(7), 3, 8, "residues")
    with pytest.raises(AssertionError, match="written twice"):
        model_tile_network(ops, live, tail_lo=lambda total, start: start)


@pytest.mark.parametrize("name", sorted(PROBE_GATHER_CASES))
def test_model_of_row_gather_kernel_matches_plain(name):
    """row_gather_kernel's source row: C's remainder (the sign of the
    dividend) of the shift by R on the host and of the start by R on the
    device, their sum with j brought into [0, R) by two additions or
    subtractions of R; also at starts outside the contract, where the
    kernel still reads inside x."""
    R, W, starts, rows, shift = PROBE_GATHER_CASES[name]
    x = probe_gather_case(np.random.default_rng(3), R, W)

    def source_rows(starts):
        v = np.fmod(np.asarray(starts, np.int64), R)[:, None] + np.fmod(shift, R) + np.arange(rows)
        for _ in range(2):
            v = np.where(v < 0, v + R, v)
        for _ in range(2):
            v = np.where(v >= R, v - R, v)
        return v

    want = to_numpy(probes.row_gather(t32(x), torch.tensor(starts, dtype=torch.int32), rows, shift))
    np.testing.assert_array_equal(x[source_rows(starts)], want)
    wild = [2**31 - 1, -(2**31), -1, R + 5]
    np.testing.assert_array_equal(source_rows(wild), (np.asarray(wild)[:, None] + shift + np.arange(rows)) % R)


# ---- the harnesses on the CPU --------------------------------------------------


def test_mosaic_caps_harness_on_cpu(capsys):
    results = experiments_mosaic_caps.main(CPU, r=4, reps=2)
    assert list(results) == ["Q1 roll axis0", "Q2 unaligned row slice+concat", "Q3 dyn DMA + scalar prefetch",
                             "Q4 odd-even merge 2x64K"]
    out = capsys.readouterr().out
    assert out.count(": OK correct") == 4


def test_bitonic_merge_harness_on_cpu(capsys):
    results = experiments_bitonic_merge.main(CPU, g=4, reps=2)
    assert results["grid_ms"] > 0
    out = capsys.readouterr().out
    assert "merge correct: True" in out and "grid merge correct: True" in out and "records ->" in out


def test_compact_overhead_harness_on_cpu(capsys):
    results = probe_compact_overhead.main(CPU, n_tiles=2, chain=2, reps=2)
    assert list(results) == list(probe_compact_overhead.VARIANTS)
    assert all(len(r["times_ms"]) == 2 for r in results.values())
    out = capsys.readouterr().out
    assert out.count(", correct") == 4 and out.count("ms/call x2") == 4


def test_harness_raises_on_a_wrong_result(monkeypatch):
    real = probes.row_gather

    def off_by_one(x, starts, rows, shift):
        return real(x, starts, rows, shift + 1)

    monkeypatch.setattr(probes, "row_gather", off_by_one)
    with pytest.raises(ProbeFailed, match="Q1: WRONG VALUES"):
        experiments_mosaic_caps.main(CPU, r=4, reps=1)


def test_harness_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        experiments_mosaic_caps.main()


# ---- the wrappers' checks ------------------------------------------------------


def test_wrappers_have_no_fallback_for_other_devices():
    meta = torch.zeros((1, PROBE_TILE), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        probes.pair_merge(meta, meta, b_descending=True)
    with pytest.raises(RuntimeError, match="no kernel"):
        probes.row_gather(meta, meta[0, :1], 1, 0)


def test_stream_helper_is_never_reached_for_cpu_tensors(monkeypatch):
    """CPU tensors take the plain versions before any launch-path work: the
    stream helper (a CUDA build's binding) is never called for them."""
    from kmer_counter_tpu_torch import cuda_build

    def no_stream(device_index):
        raise AssertionError("the stream helper was called for CPU tensors")

    monkeypatch.setattr(cuda_build, "current_stream", no_stream)
    before = dict(probes.launches)
    x = probe_gather_case(np.random.default_rng(1), 16, 128)
    got = probes.row_gather(t32(x), torch.tensor([0], dtype=torch.int32), 16, -3)
    np.testing.assert_array_equal(to_numpy(got)[0], np.roll(x, 3, 0))
    ops, live = probe_tile_case(np.random.default_rng(1), 2, 1, 0.03)
    for mode in probes.MODES:
        got = probes.tile_compact([t32(v) for v in ops], t32(live), mode)
        np.testing.assert_array_equal(to_numpy(got), probe_compact_overhead.expected(mode, ops, live))
    assert probes.launches == before


@pytest.mark.parametrize("name", ["fused_extract", "lane_sort", "merge_fold_compact", "compact_live", "pair_merge"])
def test_every_wrapper_takes_the_plain_version_for_cpu_tensors(monkeypatch, name):
    """The wrappers that take the stream's raw handle (cuda_build's binding,
    in a CUDA build only) run their plain versions for CPU tensors and never
    reach it; no launch is counted."""
    from kmer_counter_tpu_torch import cuda_build

    def no_stream(device_index):
        raise AssertionError("the stream helper was called for CPU tensors")

    monkeypatch.setattr(cuda_build, "current_stream", no_stream)
    inputs, wrapper, plain, agree, count = wrapper_stream_case(name, np.random.default_rng(4))
    src = [torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x) for x in inputs]
    before = count()
    assert agree(wrapper(*src), plain(*src))
    assert count() == before


def test_tile_compact_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2 * PROBE_TILE, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of TILE"):
        probes.tile_compact([x[:PROBE_TILE + 4]], x[:PROBE_TILE + 4], "copy")
    with pytest.raises(ValueError, match="16-byte"):
        probes.tile_compact([x[1 : PROBE_TILE + 1]], x[:PROBE_TILE], "copy")
    with pytest.raises(ValueError, match="mode"):
        probes.tile_compact([x], x, "full")
    with pytest.raises(ValueError, match="1 to 9"):
        probes.tile_compact([x] * 10, x, "copy")
    with pytest.raises(TypeError, match="int32"):
        probes.tile_compact([x.to(torch.int64)], x, "copy")


def test_pair_merge_and_row_gather_refuse_bad_shapes():
    with pytest.raises(ValueError, match=r"\[G, Ta\]"):
        probes.pair_merge(torch.zeros((2, 3), dtype=torch.int32), torch.zeros((3, 3), dtype=torch.int32),
                          b_descending=False)
    with pytest.raises(ValueError, match="rows"):
        probes.row_gather(torch.zeros((4, 2), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), 5, 0)
