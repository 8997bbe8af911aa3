"""The plain compaction K2 (ops.compact_live) vs the JAX Pallas kernel.

``pallas_sort.compact_live`` runs in interpret mode at a 1024-row tile (at
most 3 tiles); the port runs on CPU tensors, so its wrapper takes the plain
version.  Every output row must match bit for bit, fill included.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Its cross-tile protocol (a chained scan with decoupled
look-back: tickets, aggregate and inclusive-prefix status words, the
look-back over them, then the fill from the live total) is modelled here
in numpy, with the tiles completing in order and in a shuffled order.
``out_rows`` (the output cut to the prefix's columns, as consolidate3
asks for it) is held against the JAX kernel's output cut the same way.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu.ops import pallas_sort as ps
from kmer_counter_tpu_torch.ops import compact_live as cl
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy

from tests.test_torch_cuda import TILE, compact_case

CPU = torch.device("cpu")
M = 0xFFFFFFFF


def _port(ops, live, num_keys, out_rows=None):
    got = cl.compact_live([from_numpy(v, CPU) for v in ops], from_numpy(live, CPU), num_keys, out_rows)
    return to_numpy(got)


def _numpy(ops, live, num_keys, out_rows=None):
    out_rows = len(live) if out_rows is None else out_rows
    rows = np.stack(ops)[:, live != 0][:, :out_rows]
    out = np.zeros((len(ops), out_rows), np.uint32)
    out[:num_keys] = M
    out[:, : rows.shape[1]] = rows
    return out


@pytest.mark.parametrize("density,NL,tiles", [(0.0, 1, 2), (0.5, 2, 3), (1.0, 4, 2)])
def test_plain_compact_matches_pallas(density, NL, tiles):
    ops, live = compact_case(np.random.default_rng(NL), NL, tiles * TILE, density)
    got = _port(ops, live, NL)
    want = ps.compact_live([jnp.asarray(v) for v in ops], jnp.asarray(live), num_keys=NL,
                           tile=TILE, interpret=True)
    np.testing.assert_array_equal(got, np.stack([np.asarray(v) for v in want]))


@pytest.mark.parametrize("where", ["zero", "below_live", "at_live", "above_live"])
def test_plain_compact_with_out_rows_matches_pallas_cut_to_the_prefix(where):
    """What consolidate3 asks of K2: the output's first out_rows columns,
    against the JAX kernel's output cut as _c3_compact cuts it ([:cp]);
    out_rows below the live count is the consolidation that loses
    records."""
    ops, live = compact_case(np.random.default_rng(3), 2, 2 * TILE, 0.3)
    n_live = int((live != 0).sum())
    out_rows = {"zero": 0, "below_live": n_live // 2, "at_live": n_live, "above_live": TILE + 3}[where]
    got = _port(ops, live, 2, out_rows)
    want = ps.compact_live([jnp.asarray(v) for v in ops], jnp.asarray(live), num_keys=2, tile=TILE,
                           interpret=True)
    np.testing.assert_array_equal(got, np.stack([np.asarray(v)[:out_rows] for v in want]))


@pytest.mark.parametrize("n", [1, 7, 4097])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_plain_compact_with_out_rows_matches_numpy(n, density):
    ops, live = compact_case(np.random.default_rng(n), 3, n, density)
    n_live = int((live != 0).sum())
    for out_rows in sorted({0, 1, n_live // 2, n_live, n} & set(range(n + 1))):
        np.testing.assert_array_equal(_port(ops, live, 3, out_rows), _numpy(ops, live, 3, out_rows))
    with pytest.raises(ValueError, match="out_rows"):
        _port(ops, live, 3, n + 1)


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4097, 12_345])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_plain_compact_at_ragged_sizes_matches_numpy(n, density):
    """Sizes the JAX function refuses (no multiple of its tile)."""
    ops, live = compact_case(np.random.default_rng(n), 3, n, density)
    np.testing.assert_array_equal(_port(ops, live, 3), _numpy(ops, live, 3))


def test_live_may_be_an_operand_and_num_keys_any():
    rng = np.random.default_rng(5)
    ops, _ = compact_case(rng, 2, 3000, 0.5)
    ops[-1][rng.random(3000) < 0.5] = 0  # the counts lane doubles as the flags
    for num_keys in (0, 1, 3):
        np.testing.assert_array_equal(_port(ops, ops[-1], num_keys), _numpy(ops, ops[-1], num_keys))


AGGREGATE, PREFIX = 1, 2  # status flags of a tile; 0: nothing published yet
WINDOW = 32  # status words a look-back reads at once (one per lane of a warp)


def _tile_block(t, T, shift, ops, live, status, out, stats, window_len, out_rows):
    """One block of the CUDA kernel on tile t, as a generator that yields
    wherever another block may run: it publishes its live count (tile 0
    its inclusive prefix at once), reads the status words of the
    window_len tiles before it (words before tile 0 read as a prefix of 0), waits
    while one nearer than the nearest inclusive prefix has published
    nothing, adds them up to that prefix, moves window_len tiles back if
    there is none, publishes its inclusive prefix and places its live rows.  Row
    r is virtual row r + shift, as the kernel lays its tiles on the flags'
    16-byte grid."""
    rows = [v - shift for v in range(max(t * T, shift), min((t + 1) * T, len(live) + shift))]
    agg = sum(1 for r in rows if live[r])
    if t > 0:
        status[t] = (AGGREGATE, agg)
        yield
    excl, end = 0, t
    while end > 0:
        window = [status[i] if i >= 0 else (PREFIX, 0) for i in range(end - 1, end - 1 - window_len, -1)]
        stop = next((k for k, (flag, _) in enumerate(window) if flag == PREFIX), window_len)
        if any(flag == 0 for flag, _ in window[:stop]):
            stats["spins"] += 1
            yield
            continue
        stats["windows"] += 1
        excl += sum(value for _, value in window[: stop + 1])
        if stop < window_len:
            break
        end -= window_len
    status[t] = (PREFIX, excl + agg)
    yield
    for r in rows:
        if live[r]:
            if excl < out_rows:  # live rows of rank out_rows and above are not written
                out[:, excl] = ops[:, r]
            excl += 1


def _emulate_kernel(ops, live, T, resident=1, seed=0, shift=0, num_keys=2, window_len=WINDOW, out_rows=None):
    """The CUDA kernel's protocol in numpy for tiles of T rows: tickets go
    out in tile order to at most `resident` blocks at once, and a block
    drawn at random (seeded) takes each next step; with resident=1 the
    tiles run one after another, in order.  Then the fill writes every row
    from the last tile's inclusive prefix (or out_rows, if less) up to
    out_rows (n by default).  ``window_len``: the tiles a look-back round
    reads (the kernel's WINDOW; fewer make long walks common).  Returns
    (out, stats)."""
    ops = np.stack(ops)
    out_rows = len(live) if out_rows is None else out_rows
    out = np.full((len(ops), out_rows), 0x5A5A5A5A, np.uint32)  # no row the kernel leaves unwritten
    tiles = -(-(len(live) + shift) // T)
    status = [(0, 0)] * tiles
    stats = Counter()
    rng = np.random.default_rng(seed)
    blocks, ticket = [], 0
    while blocks or ticket < tiles:
        while len(blocks) < resident and ticket < tiles:
            blocks.append(_tile_block(ticket, T, shift, ops, live, status, out, stats, window_len, out_rows))
            ticket += 1
        k = int(rng.integers(len(blocks)))
        try:
            next(blocks[k])
        except StopIteration:
            blocks.pop(k)
    flag, total = status[-1]
    assert flag == PREFIX
    out[:num_keys, min(total, out_rows):] = M
    out[num_keys:, min(total, out_rows):] = 0
    return out, stats


@pytest.mark.parametrize("T", [1, 3, 64, 4096])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_kernel_tile_logic_matches_plain(T, density):
    ops, live = compact_case(np.random.default_rng(T), 2, 5000, density)
    got, stats = _emulate_kernel(ops, live, T)
    np.testing.assert_array_equal(got, _port(ops, live, 2))
    assert stats["spins"] == 0  # in order, every look-back finds its predecessor's prefix


@pytest.mark.parametrize("T", [1, 3, 64, 4096])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_kernel_tile_logic_in_a_shuffled_order_matches_plain(T, density):
    """300 blocks resident (more than a look-back window), stepped in a
    seeded random order, on flags 1 to 3 words past a 16-byte boundary;
    then with look-back rounds of 4 tiles, so that walks over several
    rounds are common."""
    ops, live = compact_case(np.random.default_rng(T), 2, 5000, density)
    want = _port(ops, live, 2)
    for window_len in (WINDOW, 4):
        got, stats = _emulate_kernel(ops, live, T, resident=300, seed=T, shift=1 + T % 3,
                                     window_len=window_len)
        np.testing.assert_array_equal(got, want)
        if T <= 3:  # thousands of tiles: some look-backs met a tile that had published nothing
            assert stats["spins"] > 0
    if T <= 3:
        assert stats["windows"] > -(-5003 // T)  # some walks took more than one round


@pytest.mark.parametrize("T", [3, 64, 4096])
@pytest.mark.parametrize("where", ["zero", "below_live", "at_live", "above_live"])
def test_kernel_tile_logic_with_out_rows_matches_plain(T, where):
    """The protocol writing out_rows columns, shuffled, on flags a word
    past a 16-byte boundary."""
    ops, live = compact_case(np.random.default_rng(T), 2, 5000, 0.4)
    n_live = int((live != 0).sum())
    out_rows = {"zero": 0, "below_live": n_live // 3, "at_live": n_live, "above_live": 4999}[where]
    got, _ = _emulate_kernel(ops, live, T, resident=300, seed=T, shift=1, out_rows=out_rows)
    np.testing.assert_array_equal(got, _port(ops, live, 2, out_rows))


@pytest.mark.parametrize(
    "ops,live,num_keys,err",
    [
        ([torch.zeros(4, dtype=torch.int64)], torch.zeros(4, dtype=torch.int32), 1, TypeError),
        ([torch.zeros(4, dtype=torch.int32)], torch.zeros(5, dtype=torch.int32), 1, ValueError),
        ([torch.zeros(4, dtype=torch.int32)] * 10, torch.zeros(4, dtype=torch.int32), 1, ValueError),
        ([torch.zeros(4, dtype=torch.int32)], torch.zeros(4, dtype=torch.int32), 2, ValueError),
        ([torch.zeros((4, 2), dtype=torch.int32)[:, 0]], torch.zeros(4, dtype=torch.int32), 1, ValueError),
    ],
)
def test_compact_rejects_operands_the_kernel_does_not_take(ops, live, num_keys, err):
    with pytest.raises(err):
        cl.compact_live(ops, live, num_keys)


def test_compact_wrapper_has_no_fallback_for_other_devices():
    ops = [torch.zeros(4, dtype=torch.int32, device="meta") for _ in range(2)]
    with pytest.raises(RuntimeError, match="no kernel"):
        cl.compact_live(ops, ops[-1], 1)
