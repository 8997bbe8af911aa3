"""The port's prefix-routed merge (kmer_counter_tpu_torch.parallel.shuffle)
against the JAX package's, on an 8-position CPU mesh beside conftest's 8
virtual CPU devices: the slices each position owns, the sampled splitters
bit for bit, and each position's routed table against JAX ``route_merge_local``
cut to its ``num_unique``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from kmer_counter_tpu.parallel import shuffle as jax_shuffle
from kmer_counter_tpu.parallel.mesh import DATA_AXIS, make_mesh as jax_make_mesh
from kmer_counter_tpu_torch.ops.u32 import from_numpy, to_numpy
from kmer_counter_tpu_torch.parallel import shuffle
from kmer_counter_tpu_torch.parallel.mesh import make_mesh

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import golden_bytes

CPU = torch.device("cpu")
D = 8


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(D), make_mesh(devices=[CPU] * D)


def _tables(rng, NL, C, skew=False):
    """Per position: U distinct keys ascending (U varies, one position
    empty) in a [NL, C] block padded with count 0; lane-major numpy."""
    lanes = np.zeros((NL, D * C), np.uint32)
    counts = np.zeros(D * C, np.uint32)
    live = []
    for d in range(D):
        U = 0 if d == 3 else int(rng.integers(C // 4, C))
        keys = rng.integers(0, 2**32, size=(3 * U, NL), dtype=np.uint64).astype(np.uint32)
        if skew:  # canonical-like: lead lanes in the low eighth of the space
            keys[:, 0] >>= 3
        keys = np.unique(keys, axis=0)[:U]
        U = len(keys)
        lanes[:, d * C : d * C + U] = keys.T
        counts[d * C : d * C + U] = rng.integers(1, 9, size=U)
        live.append(U)
    return lanes, counts, live


def _port_tables(lanes, counts, live, C):
    return [(from_numpy(lanes[:, d * C : d * C + u], CPU), from_numpy(counts[d * C : d * C + u], CPU))
            for d, u in enumerate(live)]


@pytest.mark.parametrize("positions", [2, 5, 8])
def test_split_sizes_are_the_jax_owner_counts(positions):
    """The exact-size exchange cuts the ranges that JAX ``owner_of_splitters``
    gives: each position's slice of an ascending table holds the rows JAX
    assigns it, and the slices tile the table in position order."""
    rng = np.random.default_rng(positions)
    lane0 = np.sort(rng.integers(0, 2**32, 5000, dtype=np.uint64)).astype(np.uint32)
    lane0[-3:] = 0xFFFFFFFF
    splitters = np.sort(rng.integers(0, 2**32, positions - 1, dtype=np.uint64)).astype(np.uint32)
    splitters[0] = lane0[100]  # a boundary equal to a key: the key goes to the upper range
    want = np.asarray(jax_shuffle.owner_of_splitters(jnp.asarray(lane0), jnp.asarray(splitters)))
    assert (np.diff(want) >= 0).all()
    sizes = shuffle.split_sizes(from_numpy(lane0[None], CPU), splitters, positions)
    np.testing.assert_array_equal(sizes, np.bincount(want, minlength=positions))


@pytest.mark.parametrize("NL,skew", [(1, False), (2, True), (4, False)])
def test_splitters_equal_jax_bit_for_bit(meshes, NL, skew):
    jmesh, pmesh = meshes
    C = 256
    lanes, counts, live = _tables(np.random.default_rng(NL), NL, C, skew)
    j_lanes = jax.device_put(jnp.asarray(lanes), NamedSharding(jmesh, P(None, DATA_AXIS)))
    j_counts = jax.device_put(jnp.asarray(counts), NamedSharding(jmesh, P(DATA_AXIS)))
    want = np.asarray(jax_shuffle.sampled_splitters_host(jmesh, j_lanes, j_counts, C, D))
    got = shuffle.sampled_splitters_host(pmesh, [t[0][0] for t in _port_tables(lanes, counts, live, C)])
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("NL,skew", [(2, True)])
def test_routed_tables_equal_jax_route_merge_local(meshes, NL, skew):
    """Each position's routed table equals the JAX route's output for that
    position cut to its num_unique, with the same splitters; the JAX route
    needs buckets of the whole table here (cap = C) for the skewed keys."""
    jmesh, pmesh = meshes
    C = 64
    lanes, counts, live = _tables(np.random.default_rng(10 + NL), NL, C, skew)
    tables = _port_tables(lanes, counts, live, C)
    splitters = shuffle.sampled_splitters_host(pmesh, [t[0][0] for t in tables])

    def body(l, c, s):
        ol, oc, nu, ov = jax_shuffle.route_merge_local(l, c, DATA_AXIS, D, C, splitters=s)
        return ol, oc, nu[None], ov[None]

    fn = shard_map(body, mesh=jmesh, in_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P()),
                   out_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)))
    jl, jc, jn, jo = (np.asarray(x) for x in fn(lanes, counts, jnp.asarray(splitters)))
    assert int(jo.max()) == 0
    plan = shuffle.plan_route(pmesh, tables, splitters)
    out = list(shuffle.route_merge_local(pmesh, tables, plan))
    assert plan.rounds == 1 and [pos for pos, _, _ in out] == list(range(D))
    block = D * C
    for d, (_, pl, pc) in enumerate(out):
        n = pc.shape[0]
        assert n == int(jn[d])
        np.testing.assert_array_equal(to_numpy(pl), jl[:, d * block : d * block + n])
        np.testing.assert_array_equal(to_numpy(pc), jc[d * block : d * block + n])
    assert plan.balance.sum() == sum(live)
    # The ranges tile the key space in position order.
    firsts = [int(to_numpy(pl)[0, 0]) for _, pl, pc in out if pc.shape[0]]
    assert firsts == sorted(firsts)


@pytest.mark.parametrize("max_rows", [40, 150])
def test_a_crowded_range_arrives_in_rounds_under_its_row_budget(meshes, max_rows):
    """Splitters sampled from other tables (frozen at an earlier route)
    crowd the skewed keys into the lowest ranges, which receive more rows
    than a position may: the range arrives in rounds of sources, none
    receiving more than ``max_rows`` (a larger slice alone excepted), and
    the pieces of each range merge into the one-round route's table."""
    _, pmesh = meshes
    C = 64
    rng = np.random.default_rng(max_rows)
    lanes, counts, live = _tables(rng, 2, C, skew=True)
    tables = _port_tables(lanes, counts, live, C)
    early = _port_tables(*_tables(rng, 2, C), C)  # uniform keys: splitters across the whole space
    splitters = shuffle.sampled_splitters_host(pmesh, [t[0][0] for t in early])
    whole = {pos: (to_numpy(pl), to_numpy(pc))
             for pos, pl, pc in shuffle.route_merge_local(pmesh, tables, shuffle.plan_route(pmesh, tables, splitters))}
    plan = shuffle.plan_route(pmesh, tables, splitters, max_rows)
    assert plan.balance.max() > max_rows and plan.rounds > 1
    for t in range(plan.rounds):
        rows = plan.round_rows(t)
        for e in range(D):
            assert rows[:, e].sum() <= max(max_rows, rows[:, e].max())
    assert sum(plan.round_rows(t) for t in range(plan.rounds)).tolist() == plan.every.tolist()
    got = {}
    for pos, pl, pc in shuffle.route_merge_local(pmesh, tables, plan):
        for key, c in zip(map(tuple, to_numpy(pl).T.tolist()), to_numpy(pc).tolist()):
            got.setdefault(pos, {})
            got[pos][key] = got[pos].get(key, 0) + c
    for pos, (wl, wc) in whole.items():
        assert got.get(pos, {}) == dict(zip(map(tuple, wl.T.tolist()), wc.tolist())), pos


def test_skewed_keys_reach_jax_result_without_a_retry(tmp_path, meshes):
    """tests/test_mesh_engine.py::test_mesh_engine_skewed_keys_overflow_retry's
    input: every k-mer over A and C, merge_slack=1/8.  The JAX two-level
    finalize overflows its buckets and retries at twice the capacity; the
    port's exchange sends exact slices, so there is nothing to retry, and
    the dump is the JAX engine's, byte for byte (the two-level table), and
    golden's with each table."""
    from kmer_counter_tpu.config import Options as JaxOptions
    from kmer_counter_tpu.engine import MeshCountEngine as JaxMesh
    from kmer_counter_tpu.parallel import pipeline as jax_pipeline
    from kmer_counter_tpu_torch.config import Options
    from kmer_counter_tpu_torch.engine import MeshCountEngine

    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(7)
    chars = np.frombuffer(b"AC", dtype=np.uint8)
    reads = chars[rng.integers(0, 2, size=(96, 40))]
    write_fastq(tmp_path / "in" / "a.fastq", ["".join(map(chr, r)) for r in reads])
    want = golden_bytes(tmp_path, 15, False)
    retries = []
    real = jax_pipeline.ShardedCounter2._build_route

    def build_route(self):
        retries.append(self.bucket_cap)
        return real(self)

    jax_pipeline.ShardedCounter2._build_route = build_route
    try:
        for impl in ("one", "two"):
            kw = dict(kmer_length=15, input_dir=str(tmp_path / "in"), reads_per_chunk=16, table_impl=impl,
                      table_slots=3000, merge_slack=0.125, verbose=0)
            engine = MeshCountEngine(Options(output_file=str(tmp_path / "port.bin"), **kw), mesh=meshes[1])
            engine.run()
            assert (tmp_path / "port.bin").read_bytes() == want, impl
            assert sum(engine.route_balance) > 0 and engine.route_rounds == 1
            if impl == "two":
                JaxMesh(JaxOptions(output_file=str(tmp_path / "jax.bin"), mesh_shape=(D,), **kw)).run()
                assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    finally:
        jax_pipeline.ShardedCounter2._build_route = real
    assert len(retries) > 1  # the JAX two-level route was rebuilt for a retry
