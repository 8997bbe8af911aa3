"""The plain compaction K2 (ops.compact_live) vs the JAX Pallas kernel.

``pallas_sort.compact_live`` runs in interpret mode at a 1024-row tile (at
most 3 tiles); the port runs on CPU tensors, so its wrapper takes the plain
version.  Every output row must match bit for bit, fill included.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Its cross-tile logic (per-tile live counts, then
``tile_offsets``, then per-tile compaction) is checked here in numpy.
"""

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


def _port(ops, live, num_keys):
    got = cl.compact_live([from_numpy(v, CPU) for v in ops], from_numpy(live, CPU), num_keys)
    return to_numpy(got)


def _numpy(ops, live, num_keys):
    keep = live != 0
    out = np.zeros((len(ops), len(live)), np.uint32)
    out[:num_keys] = M
    out[:, : keep.sum()] = np.stack(ops)[:, keep]
    return out


@pytest.mark.parametrize("density,NL,tiles", [(0.0, 1, 2), (0.5, 2, 3), (1.0, 4, 2)])
def test_plain_compact_matches_pallas(density, NL, tiles):
    ops, live = compact_case(np.random.default_rng(NL), NL, tiles * TILE, density)
    got = _port(ops, live, NL)
    want = ps.compact_live([jnp.asarray(v) for v in ops], jnp.asarray(live), num_keys=NL,
                           tile=TILE, interpret=True)
    np.testing.assert_array_equal(got, np.stack([np.asarray(v) for v in want]))


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


def _emulate_kernel(ops, live, T):
    """The CUDA kernel's passes in numpy for a tile of T rows: per-tile live
    counts, cl.tile_offsets, then each tile's live rows in order at its
    offset and its share of the fill."""
    n = len(live)
    tiles = -(-n // T)
    tile_live = np.array([np.count_nonzero(live[t * T : (t + 1) * T]) for t in range(tiles)], np.int64)
    tile_off, total = cl.tile_offsets(torch.from_numpy(tile_live))
    out = np.empty((len(ops), n), np.uint32)
    for t in range(tiles):
        pos = int(tile_off[t])
        for r in range(t * T, min(t * T + T, n)):
            if live[r]:
                out[:, pos] = [v[r] for v in ops]
                pos += 1
        fill = range(max(t * T, int(total)), min(t * T + T, n))
        out[:, fill] = np.array([M] * 2 + [0] * (len(ops) - 2), np.uint32)[:, None]
    return out


@pytest.mark.parametrize("T", [1, 3, 64, 4096])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_kernel_tile_logic_matches_plain(T, density):
    ops, live = compact_case(np.random.default_rng(T), 2, 5000, density)
    np.testing.assert_array_equal(_emulate_kernel(ops, live, T), _port(ops, live, 2))


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
