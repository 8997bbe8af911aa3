"""The readers of the program's spans and counters (the dump, the copy back
and its rate, set-up, close, the feed's slot wait, the run's unspanned
rest), on hand-built windows; every reader's reading unchanged by the
program's own ``kmer.*`` ranges, which the trace keeps; and the tiny
cell's traced result with every program-span metric."""

import os

import pytest
import torch

from gpubench import cells, harness
from gpubench import trace as tr
from gpubench.harness import Window
from gpubench.tests._tiny import tiny_checkout
from gpubench.tests.test_gpubench_trace import SYNTHETIC, chrome

NEW_SPAN_METRICS = {
    "dump.wall_ms": "dump",
    "dump.format_ms": "dump.format",
    "dump.write_ms": "dump.write",
    "finalize.copy_back_ms": "finalize.copy_back",
    "engine.setup_ms": "setup",
    "engine.close_ms": "close",
    "feed.acquire_ms": "feed.acquire",
}
DATA = dict(reads=1000, read_length=100, k=31, windows=70_000, valid_windows=60_000, distinct=5_000)


def read(name, window):
    return cells.load_reader(cells.BENCH_DIR, name)(window)


def counts(*snapshots):
    """Stand-ins for the harness's counts, each with its RunStats' metrics."""
    out = []
    for snap in snapshots:
        stats = type("Stats", (), {"metrics": snap})()
        out.append(type("Count", (), {"stats": stats})())
    return out


TIMERS = {"run": 0.100, "setup": 0.004, "ingest_wait": 0.030, "dispatch": 0.002, "consolidate": 0.008,
          "finalize": 0.012, "finalize.copy_back": 0.006, "close": 0.001, "dump": 0.040, "dump.format": 0.030,
          "dump.write": 0.009, "feed.acquire": 0.003, "ingest": 0.050, "stage": 0.007}


@pytest.mark.parametrize("metric,timer", sorted(NEW_SPAN_METRICS.items()))
def test_each_span_reader_reads_its_timer_ms_a_count(metric, timer):
    other = dict(TIMERS, **{timer: 3 * TIMERS[timer]})
    win = Window(counts=counts({"timers_s": TIMERS}, {"timers_s": other}), data=DATA)
    assert read(metric, win) == pytest.approx(1e3 * 2 * TIMERS[timer])


@pytest.mark.parametrize("metric", sorted(NEW_SPAN_METRICS) + ["engine.unspanned_ms", "finalize.d2h_gbps"])
def test_a_program_without_the_spans_reads_nothing(metric):
    """The parent program has none of these timers or counters."""
    old = {"timers_s": {"ingest": 0.05, "dispatch": 0.002, "finalize": 0.01}, "counters": {"chunks": 8}}
    win = Window(counts=counts(old, old), data=DATA, events=tr.read_chrome_trace(D2H_TRACE))
    assert read(metric, win) is None


def test_unspanned_reads_the_programs_counter_ms_a_count():
    # The program's ``unspanned_us``, not the timers: the run's own
    # reckoning of what its phases left uncovered.
    win = Window(counts=counts({"timers_s": TIMERS, "counters": {"unspanned_us": 3_000}},
                               {"timers_s": TIMERS, "counters": {"unspanned_us": 1_000}}), data=DATA)
    assert read("engine.unspanned_ms", win) == pytest.approx(2.0)
    # A count without the counter adds nothing to the sum.
    win = Window(counts=counts({"counters": {"unspanned_us": 3_000}}, {"counters": {}}), data=DATA)
    assert read("engine.unspanned_ms", win) == pytest.approx(1.5)


# Two counts (main thread 1): each a finalize whose copies go to the host
# (launched by cudaMemcpyAsync inside the count), a copy to the card and a
# kernel beside them; a device-to-host copy launched between the counts.
D2H_TRACE = chrome([
    dict(cat="user_annotation", name="gpubench.count", ts=0, dur=1000, tid=1),
    dict(cat="user_annotation", name="kmer.run", ts=5, dur=990, tid=1),
    dict(cat="user_annotation", name="kmer.finalize.copy_back", ts=100, dur=400, tid=1),
    dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=110, dur=2, tid=1, args={"correlation": 1}),
    dict(cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pageable)", ts=120, dur=200, tid=9, args={"correlation": 1}),
    dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=330, dur=2, tid=1, args={"correlation": 2}),
    dict(cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pageable)", ts=340, dur=50, tid=9, args={"correlation": 2}),
    dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=600, dur=2, tid=1, args={"correlation": 3}),
    dict(cat="gpu_memcpy", name="Memcpy HtoD (Pinned -> Device)", ts=610, dur=90, tid=9, args={"correlation": 3}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=700, dur=2, tid=1, args={"correlation": 4}),
    dict(cat="kernel", name="sort_kernel", ts=710, dur=80, tid=7, args={"correlation": 4}),
    dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=1100, dur=2, tid=1, args={"correlation": 5}),
    dict(cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pageable)", ts=1110, dur=500, tid=9,
         args={"correlation": 5}),
    dict(cat="user_annotation", name="gpubench.count", ts=2000, dur=1000, tid=1),
    dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=2110, dur=2, tid=1, args={"correlation": 6}),
    dict(cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pageable)", ts=2120, dur=250, tid=9,
         args={"correlation": 6}),
])


def test_the_copy_rate_counts_only_device_to_host_copies_launched_in_a_count():
    events = tr.read_chrome_trace(D2H_TRACE)
    win = Window(counts=counts({"counters": {"d2h_bytes": 3_000_000}}, {"counters": {"d2h_bytes": 1_000_000}}),
                 data=DATA, events=events)
    # 4e6 bytes over 200 + 50 + 250 us of device-to-host copies: 8 GB/s;
    # the copy to the card, the kernel and the copy between counts left out.
    assert read("finalize.d2h_gbps", win) == pytest.approx(4e6 / 500e-6 / 1e9)
    win.events = []
    assert read("finalize.d2h_gbps", win) is None
    win.events = [e for e in events if e["kind"] != "device"]
    assert read("finalize.d2h_gbps", win) is None


def _with_program_spans(trace):
    """``trace`` with the program's ``kmer.*`` ranges added on the main
    thread and the prefetch thread, nested in and across the harness's."""
    extra = [
        dict(cat="user_annotation", name="kmer.run", ts=2, dur=990, tid=1),
        dict(cat="user_annotation", name="kmer.setup", ts=3, dur=6, tid=1),
        dict(cat="user_annotation", name="kmer.dispatch", ts=12, dur=20, tid=1),
        dict(cat="user_annotation", name="kmer.consolidate", ts=205, dur=290, tid=1),
        dict(cat="user_annotation", name="kmer.finalize", ts=500, dur=100, tid=1),
        dict(cat="user_annotation", name="kmer.finalize.copy_back", ts=450, dur=60, tid=1),
        dict(cat="user_annotation", name="kmer.dump", ts=700, dur=250, tid=1),
        dict(cat="user_annotation", name="kmer.dump.format", ts=701, dur=200, tid=1),
        dict(cat="user_annotation", name="kmer.ingest", ts=0, dur=500, tid=2),
        dict(cat="user_annotation", name="kmer.feed.acquire", ts=210, dur=30, tid=2),
        dict(cat="user_annotation", name="count", ts=0, dur=1000, tid=1),
        dict(cat="user_annotation", name="kmer.count", ts=0, dur=1000, tid=1),
    ]
    return {"traceEvents": list(trace["traceEvents"]) + [dict(ph="X", **e) for e in extra]}


@pytest.mark.parametrize("trace", [SYNTHETIC, D2H_TRACE], ids=["synthetic", "d2h"])
def test_every_existing_reading_is_the_same_with_the_programs_spans(trace):
    plain = tr.read_chrome_trace(trace)
    spanned = tr.read_chrome_trace(_with_program_spans(trace))
    window = tr.window_of(plain)
    assert tr.window_of(spanned) == window and tr.main_tid(spanned) == tr.main_tid(plain)
    assert tr.device_ops(spanned, window) == tr.device_ops(plain, window)
    assert tr.busy_us(spanned, window) == tr.busy_us(plain, window)
    stats = {"timers_s": TIMERS, "counters": {"d2h_bytes": 10_000, "unspanned_us": 2_000}}
    wins = [Window(counts=counts(stats, stats), data=DATA, events=ev, busy_s=tr.busy_us(ev, window) / 1e6,
                   window_s=(window[1] - window[0]) / 1e6) for ev in (plain, spanned)]
    names = [f[:-3] for f in os.listdir(os.path.join(cells.BENCH_DIR, "layer_metrics")) if f.endswith(".py")]
    assert set(NEW_SPAN_METRICS) | {"engine.unspanned_ms", "finalize.d2h_gbps"} < set(names)
    for name in names:  # every reader, as the trace now keeps the program's spans
        assert read(name, wins[1]) == read(name, wins[0]), name
    assert read("device.idle_pct", wins[0]) is not None


def test_the_tiny_cells_traced_result_has_every_program_span_metric(tmp_path):
    root = tiny_checkout(tmp_path / "checkout")
    cell = cells.resolve("tiny.mini", root)
    r = harness.run(cell, 11, 0.3, True, torch.device("cpu"), cache_dir=str(tmp_path / "cache"),
                    log=lambda _: None)
    assert r["correct"] is True
    got = r["metrics"]
    assert set(NEW_SPAN_METRICS) | {"engine.unspanned_ms"} <= set(got)
    assert all(got[name]["value"] > 0 for name in NEW_SPAN_METRICS if name != "feed.acquire_ms")
    assert got["dump.format_ms"]["value"] + got["dump.write_ms"]["value"] <= got["dump.wall_ms"]["value"]
    assert got["engine.unspanned_ms"]["value"] >= 0
    assert "finalize.d2h_gbps" not in got  # the trace's metrics need the card
