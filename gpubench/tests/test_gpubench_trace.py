"""The trace's reading: attribution of device intervals to the layer spans
and the program's spans through their launches, busy and idle time, the
breakdown, the roofline arithmetic, and the spans around the program's
functions."""

import json

import pytest
import torch

from gpubench import roofline
from gpubench import trace as tr
from gpubench.harness import Window


def chrome(events):
    return {"traceEvents": [dict(ph="X", **e) for e in events] + [{"ph": "s", "name": "flow"}]}


# One count (main thread 1, ingest thread 2): a chunk step whose kernel is
# launched from the span; a consolidation with two kernels (one launched
# inside an op, one by a driver call) and a copy; a kernel launched outside
# every span; a device event whose launch the trace lost; the ingest
# thread's launch, inside no span.
SYNTHETIC = chrome([
    dict(cat="user_annotation", name="gpubench.count", ts=0, dur=1000, tid=1, args={"External id": 1}),
    dict(cat="user_annotation", name="gpubench.chunk_step", ts=10, dur=20, tid=1, args={"External id": 2}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=15, dur=2, tid=1, args={"correlation": 100}),
    dict(cat="kernel", name="void extract_kernel<2>(int*)", ts=40, dur=50, tid=7, pid=0,
         args={"correlation": 100, "stream": 7}),
    dict(cat="user_annotation", name="gpubench.consolidate", ts=200, dur=300, tid=1, args={"External id": 3}),
    dict(cat="cpu_op", name="aten::sort", ts=210, dur=50, tid=1, args={"External id": 4}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=230, dur=2, tid=1, args={"correlation": 98}),
    dict(cat="kernel", name="sort_kernel", ts=260, dur=100, tid=7, pid=0, args={"correlation": 98, "stream": 7}),
    dict(cat="kernel", name="lost_launch", ts=880, dur=5, tid=7, pid=0, args={"correlation": 97}),
    dict(cat="cuda_driver", name="cuLaunchKernel", ts=300, dur=2, tid=1, args={"correlation": 101}),
    dict(cat="kernel", name="fold_kernel<2>", ts=370, dur=30, tid=7, pid=0, args={"correlation": 101}),
    dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=450, dur=2, tid=1, args={"correlation": 102}),
    dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=455, dur=20, tid=9, pid=0, args={"correlation": 102}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=600, dur=2, tid=1, args={"correlation": 103}),
    dict(cat="kernel", name="other_kernel", ts=610, dur=40, tid=7, pid=0, args={"correlation": 103}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=220, dur=2, tid=2, args={"correlation": 104}),
    dict(cat="kernel", name="ingest_kernel", ts=700, dur=10, tid=7, pid=0, args={"correlation": 104}),
    dict(cat="user_annotation", name="gpubench.ingest_wait", ts=800, dur=150, tid=1, args={}),
    dict(cat="kernel", name="spin_kernel", ts=-500, dur=100, tid=7, pid=0, args={"correlation": 99}),
])


# The program's own spans over SYNTHETIC's count: its run; a consolidation
# opened after the harness span's first launch (as the program's leaves
# out the prefix's growth); a dump whose write holds the idle stretch
# 710-880; and the prefetch thread's parse, on another thread.
PROGRAM_SPANS = [
    dict(cat="user_annotation", name="kmer.run", ts=2, dur=996, tid=1),
    dict(cat="user_annotation", name="kmer.consolidate", ts=250, dur=240, tid=1),
    dict(cat="user_annotation", name="kmer.dump", ts=720, dur=160, tid=1),
    dict(cat="user_annotation", name="kmer.dump.write", ts=760, dur=110, tid=1),
    dict(cat="user_annotation", name="kmer.ingest", ts=0, dur=900, tid=2),
]
WITH_PROGRAM = {"traceEvents": SYNTHETIC["traceEvents"] + [dict(ph="X", **e) for e in PROGRAM_SPANS]}


def test_device_time_is_attributed_to_the_span_that_launched_it():
    events = tr.read_chrome_trace(SYNTHETIC)
    assert tr.layer_device_us(events, "chunk_step") == (50.0, 1)
    assert tr.layer_device_us(events, "consolidate") == (150.0, 3)  # sort, fold, the copy
    assert tr.layer_device_us(events, "finalize") == (0.0, 0)
    assert tr.window_of(events) == (0.0, 1000.0)
    assert tr.main_tid(events) == 1


def test_the_programs_spans_are_kept_under_their_whole_names():
    events = tr.read_chrome_trace(WITH_PROGRAM)
    spans = {e["name"] for e in events if e["kind"] == "span"}
    assert spans == {"count", "chunk_step", "consolidate", "ingest_wait", "kmer.run", "kmer.consolidate",
                     "kmer.dump", "kmer.dump.write", "kmer.ingest"}
    # The fold and the copy, launched at 300 and 450; not the sort, at 230.
    assert tr.layer_device_us(events, "kmer.consolidate") == (50.0, 2)
    assert tr.layer_device_us(events, "consolidate") == (150.0, 3)
    assert tr.layer_device_us(events, "kmer.dump") == (0.0, 0)
    # The ingest thread's launch, at 220, lies in that thread's own kmer.ingest.
    assert tr.layer_device_us(events, "kmer.ingest") == (10.0, 1)
    assert tr.window_of(events) == (0.0, 1000.0) and tr.main_tid(events) == 1


def test_an_idle_gap_is_named_by_the_innermost_span_of_either_kind():
    events = tr.read_chrome_trace(WITH_PROGRAM)
    gaps = tr.idle_gaps(events, tr.window_of(events), 1)
    assert ["kmer.dump.write", pytest.approx(170e-6)] in gaps  # 710-880, its middle in the write
    assert ["kmer.run", pytest.approx(170e-6)] in gaps  # 90-260, in the run and no phase of it
    assert ["kmer.consolidate", pytest.approx(55e-6)] in gaps  # 400-455, inside both consolidations
    assert ["ingest_wait", pytest.approx(115e-6)] in gaps  # 885-1000, the harness's wait inside the run
    assert not any(name == "kmer.ingest" for name, _ in gaps)  # another thread's span names nothing
    assert sum(g[1] for g in gaps) == pytest.approx(745e-6)


def test_busy_idle_and_the_breakdown():
    events = tr.read_chrome_trace(SYNTHETIC)
    window = tr.window_of(events)
    # 40-90, 260-360, 370-400, 455-475, 610-650, 700-710, 880-885; the spin before the window
    assert tr.busy_us(events, window) == pytest.approx(50 + 100 + 30 + 20 + 40 + 10 + 5)
    gaps = tr.idle_gaps(events, window, 1)
    assert gaps[0] == ["count", pytest.approx(170e-6)]  # 90-260, its middle before the consolidation
    assert ["count", pytest.approx(170e-6)] in gaps  # 710-880, its middle before the wait
    assert ["ingest_wait", pytest.approx(115e-6)] in gaps  # 885-1000, its middle in the wait
    assert ["consolidate", pytest.approx(55e-6)] in gaps  # 400-455
    assert len(gaps) == 8 and sum(g[1] for g in gaps) == pytest.approx(745e-6)
    ops = tr.device_ops(events, window)
    assert ops[0] == ["sort_kernel", pytest.approx(100e-6)] and ["extract_kernel<2>", pytest.approx(50e-6)] in ops
    assert not any(name == "spin_kernel" for name, _ in ops)


def test_roofline_arithmetic():
    data = dict(reads=1000, read_length=100, k=31, windows=70_000, valid_windows=60_000, distinct=5_000)
    assert roofline.lanes(31) == 2 and roofline.lanes(32) == 2 and roofline.lanes(33) == 3
    assert roofline.chunk_step_bytes(data) == 100_000 + 8 * 70_000
    assert roofline.consolidate_bytes(data) == 8 * 60_000 + 12 * 5_000
    # 3.35e6 bytes a count, 2 counts, in 4 us: 2 us at the peak rate is 50%.
    assert roofline.roofline_pct(3_350_000, 2, 4.0) == pytest.approx(50.0)
    assert roofline.roofline_pct(1, 1, 0.0) is None


def test_readers_of_the_window():
    from gpubench import cells

    events = tr.read_chrome_trace(SYNTHETIC)
    data = dict(reads=1000, read_length=100, k=31, windows=70_000, valid_windows=60_000, distinct=5_000)
    stats = type("Stats", (), {"metrics": {"timers_s": {"dispatch": 0.004, "consolidate": 0.010}}})()
    count = type("Count", (), {"stats": stats})()
    win = Window(counts=[count, count], data=data, events=events, busy_s=260e-6, window_s=1000e-6)
    read = lambda name: cells.load_reader(cells.BENCH_DIR, name)(win)  # noqa: E731
    assert read("engine.dispatch_ms") == pytest.approx(4.0)
    assert read("two_level.consolidate_ms") == pytest.approx(10.0)
    assert read("feed.stage_ms") is None  # no such timer: nothing to read
    assert read("device.idle_pct") == pytest.approx(74.0)
    assert read("chunk_step.roofline_pct") == pytest.approx(
        100 * (2 * roofline.chunk_step_bytes(data) / 3.35e12) / 50e-6)
    assert read("two_level.consolidate_roofline_pct") == read("one_level.consolidate_roofline_pct")
    win.events = []
    assert read("chunk_step.roofline_pct") is None and read("two_level.consolidate_roofline_pct") is None


def test_spans_wrap_the_program_and_are_undone(tmp_path):
    from kmer_counter_tpu_torch import engine
    from kmer_counter_tpu_torch.ops import pipeline, table, table2

    before = (pipeline.count_step_two_level, table2.consolidate3, table.consolidate, engine.dump_table,
              engine.CountEngine._chunks)
    with tr.spans_installed():
        assert pipeline.count_step_two_level is not before[0] and table2.consolidate3 is not before[1]
        assert engine.CountEngine._chunks is not before[4]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(tr.PREFIX + "count"):
                table.consolidate(table.make_table(64, 2, torch.device("cpu")))
        prof.export_chrome_trace(str(tmp_path / "t.json"))
    assert (pipeline.count_step_two_level, table2.consolidate3, table.consolidate, engine.dump_table,
            engine.CountEngine._chunks) == before
    events = tr.read_chrome_trace(json.loads((tmp_path / "t.json").read_text()))
    spans = [e for e in events if e["kind"] == "span"]
    assert {e["name"] for e in spans} == {"count", "consolidate"}
    c = next(e for e in spans if e["name"] == "consolidate")
    n = next(e for e in spans if e["name"] == "count")
    assert n["ts"] <= c["ts"] and c["ts"] + c["dur"] <= n["ts"] + n["dur"] and c["tid"] == n["tid"]
