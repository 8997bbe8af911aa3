"""The port's multi-lane sort (ops.lane_sort.sort_ops, plain version on the
CPU) vs the JAX Pallas sort and numpy.

``pallas_sort.sort_ops`` runs in interpret mode at a 1024-row tile (slow:
each case stays within 3 tiles).  Keys must match bit for bit; the order
among equal keys is unspecified in both, so payloads are compared as a
multiset per key.  The JAX inputs hold no all-ones key with a nonzero
payload, except in the test that pins the JAX sort's fault with one.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_counter_tpu.ops import pallas_sort as ps
from kmer_counter_tpu_torch.ops import lane_sort as ls
from kmer_counter_tpu_torch.ops.sortcount import sort_reduce
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy

from tests.test_torch_cuda import SORT_CASES

CPU = torch.device("cpu")
M = 0xFFFFFFFF
TILE = 1024


def _by_key_then_payload(keys: np.ndarray, payload: np.ndarray) -> np.ndarray:
    rows = np.vstack([keys, payload[None]])
    return rows[:, np.lexsort(rows[::-1])]


def _port(keys: np.ndarray, payload: np.ndarray):
    k, p = ls.sort_ops(from_numpy(keys, CPU), from_numpy(payload, CPU))
    return to_numpy(k), to_numpy(p)


def _jax(keys: np.ndarray, payload: np.ndarray):
    out = ps.sort_ops([*(jnp.asarray(v) for v in keys), jnp.asarray(payload)], keys.shape[0],
                      tile=TILE, interpret=True)
    return np.stack([np.asarray(v) for v in out[:-1]]), np.asarray(out[-1])


def _keys(rng, kind, NL, n):
    if kind == "heavy_dups":
        return rng.integers(0, 4, (NL, n)).astype(np.uint32)
    keys = rng.integers(0, M, (NL, n), dtype=np.uint64).astype(np.uint32)  # never all-ones
    keys[0, : n // 4] = keys[0, n // 4 : n // 2]  # shared first lanes: ties resolve on later ones
    if kind == "random":
        return keys
    keys = keys[:, np.lexsort(keys[::-1])]
    return keys if kind == "presorted" else np.ascontiguousarray(keys[:, ::-1])


@pytest.mark.parametrize("kind", ["random", "presorted", "reversed", "heavy_dups"])
@pytest.mark.parametrize("NL,n", [(1, 3 * TILE), (2, 3 * TILE), (4, 2 * TILE), (7, 2 * TILE)])
def test_sort_matches_jax_pallas_sort(NL, n, kind):
    rng = np.random.default_rng(NL * 10 + len(kind))
    keys = _keys(rng, kind, NL, n)
    payload = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    port, jax_out = _port(keys, payload), _jax(keys, payload)
    np.testing.assert_array_equal(port[0], jax_out[0])
    np.testing.assert_array_equal(port[0], keys[:, np.lexsort(keys[::-1])])
    want = _by_key_then_payload(keys, payload)
    np.testing.assert_array_equal(_by_key_then_payload(*port), want)
    np.testing.assert_array_equal(_by_key_then_payload(*jax_out), want)


def test_jax_sort_loses_all_ones_payload_port_keeps_it():
    """The JAX fault (ROADMAP Queue 3): _merge_pass masks window slack to
    (all-ones key, payload 0) by key and keeps half of the merged rows, so
    a slack row can replace a genuine all-ones row across a merge pass."""
    n = 2 * TILE
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**31, (1, n)).astype(np.uint32)
    keys[0, [5, 1500]] = M
    payload = np.arange(1, n + 1, dtype=np.uint32)
    jax_keys, jax_payload = _jax(keys, payload)
    np.testing.assert_array_equal(jax_keys[0], np.sort(keys[0]))  # the keys come out sorted
    assert sorted(jax_payload[jax_keys[0] == M]) != [6, 1501]  # ...the all-ones payloads do not
    assert not np.array_equal(np.sort(jax_payload), payload)
    port_keys, port_payload = _port(keys, payload)
    np.testing.assert_array_equal(port_keys, jax_keys)
    assert sorted(port_payload[port_keys[0] == M]) == [6, 1501]
    np.testing.assert_array_equal(np.sort(port_payload), payload)
    # as sort_reduce's counts: the all-ones key keeps its total
    u_lanes, u_counts, n_u = sort_reduce(from_numpy(keys, CPU), from_numpy(payload, CPU))
    assert to_numpy(u_lanes)[0, n_u - 1] == M and int(to_numpy(u_counts)[n_u - 1]) == 6 + 1501


@pytest.mark.parametrize("name", sorted(SORT_CASES))
def test_sort_cases_match_numpy(name):
    keys, payload = SORT_CASES[name](np.random.default_rng(0))
    got = _port(keys, payload)
    np.testing.assert_array_equal(got[0], keys[:, np.lexsort(keys[::-1])])
    np.testing.assert_array_equal(_by_key_then_payload(*got), _by_key_then_payload(keys, payload))


def test_sort_takes_column_slices_of_a_wider_table(rng):
    table = from_numpy(rng.integers(0, 50, (2, 300)).astype(np.uint32), CPU)
    counts = torch.arange(300, dtype=torch.int32)
    keys, payload = ls.sort_ops(table[:, :120], counts[:120])  # lanes strided by 300
    want = ls.sort_ops(table[:, :120].contiguous(), counts[:120].clone())
    assert torch.equal(keys, want[0]) and torch.equal(payload, want[1])


@pytest.mark.parametrize(
    "keys,payload,err",
    [
        (torch.zeros((2, 4), dtype=torch.int64), torch.zeros(4, dtype=torch.int32), TypeError),
        (torch.zeros((9, 4), dtype=torch.int32), torch.zeros(4, dtype=torch.int32), ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), ValueError),
        (torch.zeros((2, 4), dtype=torch.int32), torch.zeros(5, dtype=torch.int32), ValueError),
        (torch.zeros((4, 2), dtype=torch.int32).T, torch.zeros(4, dtype=torch.int32), ValueError),
    ],
)
def test_sort_rejects_operands_the_kernel_does_not_take(keys, payload, err):
    with pytest.raises(err):
        ls.sort_ops(keys, payload)


def test_sort_reduce_sorts_through_device_sort(rng, monkeypatch):
    calls = []
    real = ls.sort_ops

    def recording(keys, payload):
        calls.append(tuple(keys.shape))
        return real(keys, payload)

    monkeypatch.setattr(ls, "sort_ops", recording)
    lanes = rng.integers(0, 9, (2, 500)).astype(np.uint32)
    counts = rng.integers(0, 3, 500).astype(np.uint32)
    sort_reduce(from_numpy(lanes, CPU), from_numpy(counts, CPU))
    assert calls == [(2, 500)]
