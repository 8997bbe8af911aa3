"""The readers of the two-level raw sort, ``two_level.raw_sort_device_ms``
and ``two_level.raw_sort_roofline_pct``, on a hand-built window at k=31
and k=55, and nothing read where the program has no
``kmer.consolidate.raw_sort`` span; and a tiny read set counted under
``k55f_two.json``'s own flags, only ``gpuMemoryLimit`` and
``readsPerChunk`` scaled down, byte-equal to the reference."""

import json
import os

import pytest
import torch

from gpubench import cells, harness, roofline
from gpubench import trace as tr
from gpubench.harness import Window
from gpubench.tests._tiny import TINY_TRAFFIC, checkout_with
from gpubench.tests.test_gpubench_trace import chrome

METRICS = ("two_level.raw_sort_device_ms", "two_level.raw_sort_roofline_pct")

# Two counts (main thread 1): each a consolidation whose raw sort launches a
# sort and a gather inside the program's raw-sort span, then the merge
# after it; a sort launched between the counts, inside no span.
RAW_SORT_TRACE = chrome([
    dict(cat="user_annotation", name="gpubench.count", ts=0, dur=1000, tid=1),
    dict(cat="user_annotation", name="kmer.consolidate", ts=100, dur=400, tid=1),
    dict(cat="user_annotation", name="kmer.consolidate.raw_sort", ts=110, dur=200, tid=1),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=120, dur=2, tid=1, args={"correlation": 1}),
    dict(cat="kernel", name="DeviceRadixSortOnesweepKernel", ts=130, dur=60, tid=7, args={"correlation": 1}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=200, dur=2, tid=1, args={"correlation": 2}),
    dict(cat="kernel", name="index_elementwise_kernel", ts=210, dur=40, tid=7, args={"correlation": 2}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=350, dur=2, tid=1, args={"correlation": 3}),
    dict(cat="kernel", name="fold_kernel<4>", ts=360, dur=30, tid=7, args={"correlation": 3}),
    dict(cat="user_annotation", name="gpubench.count", ts=2000, dur=1000, tid=1),
    dict(cat="user_annotation", name="kmer.consolidate", ts=2100, dur=400, tid=1),
    dict(cat="user_annotation", name="kmer.consolidate.raw_sort", ts=2110, dur=200, tid=1),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=2120, dur=2, tid=1, args={"correlation": 4}),
    dict(cat="kernel", name="DeviceRadixSortOnesweepKernel", ts=2130, dur=100, tid=7, args={"correlation": 4}),
    dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=1500, dur=2, tid=1, args={"correlation": 5}),
    dict(cat="kernel", name="DeviceRadixSortOnesweepKernel", ts=1510, dur=500, tid=7, args={"correlation": 5}),
])


def read(name, window):
    return cells.load_reader(cells.BENCH_DIR, name)(window)


def window(k, events, counts=2):
    data = dict(reads=1000, read_length=100, k=k, windows=1000 * (100 - k + 1), valid_windows=900 * (100 - k + 1),
                distinct=5_000)
    return Window(counts=[object()] * counts, data=data, events=events)


@pytest.mark.parametrize("k,lanes", [(31, 2), (55, 4)])
def test_the_raw_sort_readers_read_the_spans_device_time_and_bytes(k, lanes):
    win = window(k, tr.read_chrome_trace(RAW_SORT_TRACE))
    # 60 + 40 + 100 us launched inside the raw-sort spans, over 2 counts;
    # the merge after the span and the sort between the counts left out.
    assert read("two_level.raw_sort_device_ms", win) == pytest.approx(0.1)
    valid = 900 * (100 - k + 1)
    assert read("two_level.raw_sort_roofline_pct", win) == pytest.approx(
        100 * (2 * 8 * lanes * valid / roofline.HBM_BYTES_PER_S) / 200e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_the_raw_sort_span_reads_nothing(metric):
    """The parent program opens ``kmer.consolidate`` and no raw-sort span;
    a one-level count has no raw sort; an untraced window has no events."""
    without = {"traceEvents": [e for e in RAW_SORT_TRACE["traceEvents"]
                               if e.get("name") != "kmer.consolidate.raw_sort"]}
    assert read(metric, window(55, tr.read_chrome_trace(without))) is None
    assert read(metric, window(55, [])) is None
    assert read(metric, window(55, None)) is None


def test_a_tiny_set_under_the_k55f_two_flags_counts_as_the_reference(tmp_path):
    """The configuration's own flags, ``gpuMemoryLimit`` and
    ``readsPerChunk`` divided by 1000 (a 2,000-read mix in a few chunks and
    consolidations, the limit the plan keeps), on the CPU: the dump equals
    the reference's, record for record."""
    with open(os.path.join(cells.BENCH_DIR, "configs", "k55f_two.json")) as fh:
        config = json.load(fh)
    flags = dict(config["flags"], gpuMemoryLimit=config["flags"]["gpuMemoryLimit"] // 1000,
                 readsPerChunk=config["flags"]["readsPerChunk"] // 1000)
    small = dict(config, name="k55f_small", flags=flags, reduced=["gpuMemoryLimit", "readsPerChunk"])
    cell = {"name": "k55f_small.mini", "config": "k55f_small", "traffic": "mini", "chips": 1, "why": "tests"}
    root = checkout_with(tmp_path / "checkout", {"k55f_small": small}, [cell], {"mini": TINY_TRAFFIC},
                         like="k31c_two.ecoli_err")
    c = cells.resolve("k55f_small.mini", root)
    assert c.flags == {**config["flags"], "gpuMemoryLimit": 8_000_000, "readsPerChunk": 262}
    result = harness.run(c, 2_100_000_003, 0.5, False, torch.device("cpu"), cache_dir=str(tmp_path / "cache"))
    assert result["checks"]["records_wrong"]["value"] == 0
    assert result["correct"] is True and result["failed"] == 0
