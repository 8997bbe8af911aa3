"""The port's spans on the CPU: ``Metrics.timer`` as a torch.profiler
range while a profiler records (and none while none does), every phase of
a count under its timer, the copy back's byte counter, the dump's two
phases, the ``profile=true`` trace, and scripts/profile_spans.py's reading
of such a trace."""

import json
import threading

import numpy as np
import pytest
import torch

from kmer_counter_tpu import metrics as jax_metrics
from kmer_counter_tpu_torch import engine, metrics, records
from kmer_counter_tpu_torch.__main__ import main
from kmer_counter_tpu_torch.config import Options
from kmer_counter_tpu_torch.io.dump import dump_table
from kmer_counter_tpu_torch.ops.u32 import counts_to_host, from_numpy, lanes_to_host
from kmer_counter_tpu_torch.parallel.mesh import make_mesh

from tests.test_ingest import random_seqs, write_fastq

CPU = torch.device("cpu")
# The main route keeps the finalized lanes on the card: the copy back is the
# counts' copy alone (no host transpose), and the dump formats on the card.
MAIN_SPANS = ("run", "setup", "ingest_wait", "dispatch", "consolidate", "finalize", "finalize.copy_back",
              "finalize.copy_back.d2h", "close", "dump", "dump.format", "dump.format.pack", "dump.format.d2h",
              "dump.write")
INGEST_SPANS = ("ingest", "feed.acquire", "stage")


def _input(tmp_path, rng, n=40, L=60):
    d = tmp_path / "in"
    d.mkdir()
    seqs = random_seqs(rng, n, L)
    write_fastq(d / "a.fastq", seqs[: n // 2])
    write_fastq(d / "b.fastq", seqs[n // 2:])
    return str(d)


def _count(tmp_path, rng, table_impl, k=21, **kw):
    opts = Options(kmer_length=k, input_dir=_input(tmp_path, rng), output_file=str(tmp_path / "o.bin"),
                   table_impl=table_impl, reads_per_chunk=4, table_slots=256, prefetch_chunks=1, **kw)
    return engine.CountEngine(opts, device=CPU).run()


def _spill_input(tmp_path, rng):
    d = tmp_path / "in"
    d.mkdir()
    write_fastq(d / "a.fastq", random_seqs(rng, 80, 40))
    return str(d)


def _direct_children(spans, outer):
    """The spans of ``spans`` (from _kmer_spans) on ``outer``'s thread whose
    innermost enclosing span is ``outer``."""
    def encloses(a, b):
        return a is not b and a[3] == b[3] and a[1] <= b[1] and b[2] <= a[2]

    inside = [s for s in spans if encloses(outer, s)]
    return [s for s in inside if not any(encloses(o, s) for o in inside)]


def _kmer_spans(trace_path):
    """The trace's ``kmer.*`` ranges: [(name, ts, end, tid)]."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("tid"))
            for e in events if e.get("ph") == "X" and e.get("name", "").startswith(metrics.SPAN_PREFIX)]


class _Spy:
    """``torch.profiler.record_function`` that counts its uses."""

    def __init__(self, real):
        self.real, self.names = real, []

    def __call__(self, name, *args, **kwargs):
        self.names.append(name)
        return self.real(name, *args, **kwargs)


def test_timer_opens_no_profiler_range_without_a_profiler(monkeypatch):
    spy = _Spy(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    m = metrics.Metrics()
    assert not metrics.profiler_recording()
    with m.timer("dump"):
        with m.timer("dump.format"):
            pass
    assert spy.names == []
    assert m.timer_calls == {"dump": 1, "dump.format": 1}


def test_timer_opens_a_prefixed_range_while_a_profiler_records(monkeypatch):
    spy = _Spy(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    m = metrics.Metrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert metrics.profiler_recording()
        with m.timer("finalize"):
            pass
    assert spy.names == ["kmer.finalize"]
    with m.timer("finalize"):
        pass
    assert spy.names == ["kmer.finalize"] and m.timer_calls["finalize"] == 2


def test_uncovered_takes_off_only_the_timers_directly_inside():
    m = metrics.Metrics()

    def other_thread():
        with m.timer("ingest"):
            sum(range(20_000))

    with m.timer("run"):
        with m.timer("dump"):
            with m.timer("dump.format"):
                sum(range(20_000))
            sum(range(20_000))
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        with m.timer("close"):
            pass
        sum(range(20_000))
    t = m.timers
    assert m.uncovered("run") == pytest.approx(t["run"] - t["dump"] - t["close"], abs=1e-9)
    assert m.uncovered("dump") == pytest.approx(t["dump"] - t["dump.format"], abs=1e-9)
    assert m.uncovered("dump.format") == t["dump.format"] and m.uncovered("ingest") == t["ingest"]
    assert 0 < m.uncovered("run") < t["run"]
    assert m.uncovered("never") == 0.0 and "never" not in m.timers


def test_snapshot_keys_equal_the_jax_metrics_keys():
    port, jax_m = metrics.Metrics(), jax_metrics.Metrics()
    for m in (port, jax_m):
        m.count("d2h_bytes", 12)
        for name in ("run", "dump", "dump.format"):
            with m.timer(name):
                pass
    snap, jax_snap = port.snapshot(), jax_m.snapshot()
    assert snap.keys() == jax_snap.keys()
    assert snap["timers_s"].keys() == jax_snap["timers_s"].keys()
    assert snap["timer_calls"] == jax_snap["timer_calls"]
    assert snap["counters"] == jax_snap["counters"]


def test_timers_are_nested_ranges_on_the_main_thread_under_a_profiler(tmp_path):
    m = metrics.Metrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with m.timer("run"):
            with m.timer("dump"):
                with m.timer("dump.format"):
                    sum(range(1000))
                with m.timer("dump.write"):
                    sum(range(1000))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    spans = {name: (ts, end, tid) for name, ts, end, tid in _kmer_spans(tmp_path / "t.json")}
    assert set(spans) == {"kmer.run", "kmer.dump", "kmer.dump.format", "kmer.dump.write"}
    assert len({tid for _, _, tid in spans.values()}) == 1
    for inner, outer in (("dump", "run"), ("dump.format", "dump"), ("dump.write", "dump")):
        (s, e, _), (os_, oe, _) = spans["kmer." + inner], spans["kmer." + outer]
        assert os_ <= s <= e <= oe, (inner, outer)
    assert spans["kmer.dump.format"][1] <= spans["kmer.dump.write"][0]


@pytest.mark.parametrize("table_impl", ["two", "one"])
def test_a_count_has_every_span(tmp_path, rng, table_impl):
    stats = _count(tmp_path, rng, table_impl)
    timers, calls = stats.metrics["timers_s"], stats.metrics["timer_calls"]
    assert set(MAIN_SPANS + INGEST_SPANS) <= set(timers), sorted(set(MAIN_SPANS + INGEST_SPANS) - set(timers))
    assert calls["run"] == calls["close"] == calls["dump"] == calls["finalize"] == 1
    assert calls["feed.acquire"] == calls["stage"] == stats.chunks
    assert stats.wall_seconds == pytest.approx(timers["run"], abs=1e-6)
    assert 0 <= stats.metrics["counters"]["unspanned_us"] <= 1e6 * timers["run"]
    assert timers["dump.format"] + timers["dump.write"] <= timers["dump"] + 1e-5
    assert timers["dump.format.pack"] + timers["dump.format.d2h"] <= timers["dump.format"] + 1e-5
    assert timers["finalize.copy_back"] <= timers["finalize"] + 1e-5
    assert timers["finalize.copy_back.d2h"] <= timers["finalize.copy_back"] + 1e-5
    assert "finalize.copy_back.transpose" not in timers


@pytest.mark.parametrize("table_impl", ["two", "one"])
def test_a_spilling_count_takes_its_spill_and_merge_off_the_unspanned_part(tmp_path, rng, table_impl):
    opts = Options(kmer_length=15, input_dir=_spill_input(tmp_path, rng), output_file=str(tmp_path / "o.bin"),
                   temp_dir=str(tmp_path / "tmp"), table_impl=table_impl, reads_per_chunk=4, table_slots=400)
    stats = engine.CountEngine(opts, device=CPU).run()
    assert stats.spilled_runs >= 2
    timers = stats.metrics["timers_s"]
    side_by_side = timers["run"] - timers["spill"] - timers["merge"] - timers["finalize"] - timers["dispatch"]
    assert 0 <= stats.metrics["counters"]["unspanned_us"] <= 1e6 * side_by_side + 1


def test_a_mesh_count_that_spills_inside_its_consolidations_is_not_taken_off_twice(tmp_path, rng):
    opts = Options(kmer_length=15, input_dir=_spill_input(tmp_path, rng), output_file=str(tmp_path / "o.bin"),
                   temp_dir=str(tmp_path / "tmp"), reads_per_chunk=8, table_slots=400)
    stats = engine.MeshCountEngine(opts, mesh=make_mesh(devices=[CPU] * 2)).run()
    timers = stats.metrics["timers_s"]
    assert stats.spilled_runs >= 1 and "spill" in timers
    assert 0 <= stats.metrics["counters"]["unspanned_us"] <= 1e6 * (timers["run"] - timers["consolidate"]) + 1


@pytest.mark.parametrize("table_impl", ["two", "one"])
def test_d2h_bytes_are_the_finalized_rows(tmp_path, rng, table_impl):
    # The counts of every finalized row.  On the CPU the record image is
    # the plain pack's host tensor, so no copy adds to it (on the card the
    # image counts too: tests/test_torch_cuda.py).
    k = 21
    stats = _count(tmp_path, rng, table_impl, k=k)
    counters = stats.metrics["counters"]
    assert stats.distinct_kmers > 0
    assert counters["dump_records_host"] == stats.distinct_kmers
    assert "dump_records_card" not in counters
    assert counters["d2h_bytes"] == stats.distinct_kmers * 4


@pytest.mark.parametrize("n", [0, 5, 9])
def test_copy_back_is_the_table_on_the_host(rng, n):
    NL, cap = 3, 9
    lanes = rng.integers(0, 2**32, (NL, cap), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32)
    m = metrics.Metrics()
    got_counts = counts_to_host(from_numpy(counts, CPU), n, m)
    got_lanes = lanes_to_host(from_numpy(lanes, CPU)[:, :n], m)
    assert got_lanes.flags.c_contiguous and got_lanes.shape == (n, NL)
    np.testing.assert_array_equal(got_lanes, lanes[:, :n].T)
    np.testing.assert_array_equal(got_counts, counts[:n])
    assert got_counts.dtype == np.uint32
    assert m.counters["d2h_bytes"] == n * (NL + 1) * 4
    assert m.timer_calls == {"finalize.copy_back": 2, "finalize.copy_back.d2h": 2, "finalize.copy_back.transpose": 1}
    np.testing.assert_array_equal(lanes_to_host(from_numpy(lanes, CPU)[:, :n]), got_lanes)
    np.testing.assert_array_equal(counts_to_host(from_numpy(counts, CPU), n), got_counts)


@pytest.mark.parametrize("k,num_unique,append", [(15, None, False), (33, 17, False), (101, None, True)])
def test_dump_table_with_and_without_metrics_writes_the_same_bytes(tmp_path, rng, k, num_unique, append):
    NL = records.active_lanes(k)
    lanes = rng.integers(0, 2**32, (25, NL), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 50, 25).astype(np.uint32)
    counts[::4] = 0  # empty slots are not written
    m = metrics.Metrics()
    paths = tmp_path / "plain.bin", tmp_path / "spanned.bin"
    if append:
        for p in paths:
            p.write_bytes(b"head")
    n_plain = dump_table(str(paths[0]), lanes, counts, num_unique, append)
    n_spanned = dump_table(str(paths[1]), lanes, counts, num_unique, append, metrics=m)
    assert n_plain == n_spanned > 0
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert m.timer_calls == {"dump": 1, "dump.format": 1, "dump.write": 1}


def test_spans_nest_inside_the_run_in_a_profiled_count(tmp_path, rng):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _count(tmp_path, rng, "two")
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    spans = _kmer_spans(tmp_path / "t.json")
    (run,) = [s for s in spans if s[0] == "kmer.run"]
    main_tid = run[3]
    on_main = [s for s in spans if s[3] == main_tid and s[0] != "kmer.run"]
    two_level = MAIN_SPANS + ("consolidate.raw_sort",)
    assert {s[0] for s in on_main} == {"kmer." + name for name in two_level if name != "run"}
    assert all(run[1] <= s[1] <= s[2] <= run[2] for s in on_main)
    # The phases directly inside the run lie side by side, and each phase
    # opens at one depth only.
    phases = _direct_children(spans, run)
    assert {"kmer.setup", "kmer.finalize", "kmer.dump", "kmer.close"} <= {s[0] for s in phases}
    starts = sorted(s[1:3] for s in phases)
    assert all(a[1] <= b[0] for a, b in zip(starts, starts[1:]))
    assert not {s[0] for s in phases} & {s[0] for s in on_main if s not in phases}


@pytest.mark.parametrize("k,canonical,passes", [(31, True, 1), (55, False, 2)])
def test_the_raw_sort_opens_once_a_consolidation(tmp_path, rng, k, canonical, passes):
    """The two-level raw sort's timer, ``consolidate.raw_sort``, opens once
    inside each consolidation's span, with its rows (every raw row: each
    window of the reads) and its stable sort passes (one a two-lane digit:
    1 at k=31, 2 at k=55) counted."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stats = _count(tmp_path, rng, "two", k=k, canonical=canonical)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    calls, counters = stats.metrics["timer_calls"], stats.metrics["counters"]
    consolidations = calls["consolidate"]
    assert consolidations >= 2 and calls["consolidate.raw_sort"] == consolidations
    assert counters["raw_sort_passes"] == passes * consolidations
    assert counters["raw_sort_rows"] == 40 * (60 - k + 1)
    spans = _kmer_spans(tmp_path / "t.json")
    outer = [s for s in spans if s[0] == "kmer.consolidate"]
    inner = [s for s in spans if s[0] == "kmer.consolidate.raw_sort"]
    assert len(outer) == len(inner) == consolidations
    assert all(sum(o[3] == i[3] and o[1] <= i[1] <= i[2] <= o[2] for i in inner) == 1 for o in outer)


@pytest.mark.parametrize("table_impl", ["two", "one"])
def test_profile_flag_traces_the_run_and_the_prefetch_thread(tmp_path, rng, table_impl):
    out = tmp_path / "o.bin"
    argv = ["kmerLength=21", f"inputFileLocation={_input(tmp_path, rng)}", f"outputFile={out}",
            f"tableImpl={table_impl}", "readsPerChunk=4", "tableSlots=256", "profile=true"]
    assert main(argv, CPU) == 0
    spans = _kmer_spans(f"{out}.trace/trace.json")
    names = {name for name, *_ in spans}
    assert {"kmer.run", "kmer.setup", "kmer.dump", "kmer.finalize.copy_back"} <= names
    (run,) = [s for s in spans if s[0] == "kmer.run"]
    if metrics._all_threads_config() is not None:
        ingest = [s for s in spans if s[0] == "kmer.ingest"]
        assert ingest and all(s[3] != run[3] for s in ingest)
        assert {"kmer.stage", "kmer.feed.acquire"} <= names


def test_the_prefetch_thread_records_into_an_all_threads_profile(tmp_path):
    config = metrics._all_threads_config()
    if config is None:
        pytest.skip("this torch cannot record threads started inside a trace")
    m = metrics.Metrics()

    def work():
        with m.timer("ingest"):
            sum(range(1000))

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], experimental_config=config) as p:
        with m.timer("run"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    p.export_chrome_trace(str(tmp_path / "t.json"))
    spans = {name: tid for name, _, _, tid in _kmer_spans(tmp_path / "t.json")}
    assert spans.keys() == {"kmer.run", "kmer.ingest"} and spans["kmer.run"] != spans["kmer.ingest"]


@pytest.mark.parametrize("mesh", [False, True])
def test_an_input_without_a_k_mer_still_runs_and_dumps_in_spans(tmp_path, mesh):
    d = tmp_path / "in"
    d.mkdir()
    write_fastq(d / "a.fastq", ["ACGTACGT"] * 3)
    opts = Options(kmer_length=21, input_dir=str(d), output_file=str(tmp_path / "o.bin"))
    eng = engine.MeshCountEngine(opts, mesh=make_mesh(devices=[CPU] * 2)) if mesh else engine.CountEngine(opts, CPU)
    stats = eng.run()
    assert (tmp_path / "o.bin").read_bytes() == b""
    timers = stats.metrics["timers_s"]
    assert {"run", "setup", "dump", "dump.format", "dump.write"} <= set(timers)
    assert stats.wall_seconds == pytest.approx(timers["run"], abs=1e-6)


@pytest.mark.parametrize("table_impl", ["two", "one"])
def test_a_mesh_count_has_the_run_spans(tmp_path, rng, table_impl):
    opts = Options(kmer_length=21, input_dir=_input(tmp_path, rng), output_file=str(tmp_path / "o.bin"),
                   table_impl=table_impl, reads_per_chunk=8, table_slots=512)
    stats = engine.MeshCountEngine(opts, mesh=make_mesh(devices=[CPU] * 2)).run()
    timers, calls = stats.metrics["timers_s"], stats.metrics["timer_calls"]
    assert {"run", "setup", "ingest_wait", "dispatch", "close", "dump", "dump.format", "dump.write",
            "ingest", "feed.acquire", "stage"} <= set(timers)
    assert calls["run"] == calls["close"] == 1
    assert stats.wall_seconds == pytest.approx(timers["run"], abs=1e-6)
    assert "position_consolidations" in stats.metrics["counters"]
    assert not hasattr(stats, "ingest_seconds")


def _profile_spans_script():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "profile_spans.py")
    spec = importlib.util.spec_from_file_location("profile_spans", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_uncovered_part_of_the_run_counts_overlaps_once():
    ps = _profile_spans_script()
    run = dict(ts=0.0, dur=100.0)
    inner = [dict(ts=10.0, dur=20.0), dict(ts=15.0, dur=5.0), dict(ts=25.0, dur=15.0), dict(ts=90.0, dur=30.0)]
    assert ps.uncovered_us(run, inner) == 100.0 - (40.0 - 10.0) - 10.0
    assert ps.uncovered_us(run, []) == 100.0


def test_profile_spans_reads_a_profile_trace_by_the_programs_spans(tmp_path, rng):
    from gpubench import trace as tr

    ps = _profile_spans_script()
    out = tmp_path / "o.bin"
    argv = ["kmerLength=21", f"inputFileLocation={_input(tmp_path, rng)}", f"outputFile={out}",
            "readsPerChunk=4", "tableSlots=256", "profile=true"]
    assert main(argv, CPU) == 0
    got = ps.read_trace(f"{out}.trace/trace.json", 1200, tr)
    main_spans = {name[len("kmer."):] for name in got["main_ms"]}
    assert set(MAIN_SPANS) - {"run"} <= main_spans
    assert 0 <= got["unspanned_ms"] <= got["run_ms"]
    assert got["main_ms"]["kmer.dump.format"] + got["main_ms"]["kmer.dump.write"] <= got["main_ms"]["kmer.dump"]
    # No card: one idle stretch, the whole run, named by a program span.
    assert got["d2h_copies"] == 0 and got["d2h_gbps"] is None and got["device_busy_ms"] == 0
    (name, seconds), = got["idle_gaps"]
    assert name.startswith("kmer.") and seconds * 1e3 == pytest.approx(got["run_ms"])
