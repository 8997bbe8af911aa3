"""The reader of the ingest's block counters, ``ingest.ready_pct``, on
hand-built windows: the share of the blocks taken already parsed, summed
over the counts, and nothing without the counters."""

import pytest

from gpubench import cells
from gpubench.harness import Window
from gpubench.tests.test_gpubench_spans import DATA, counts


def read(window):
    return cells.load_reader(cells.BENCH_DIR, "ingest.ready_pct")(window)


def test_the_counts_blocks_are_summed():
    win = Window(counts=counts({"counters": {"ingest_blocks_ready": 100, "ingest_blocks_waited": 28}},
                               {"counters": {"ingest_blocks_ready": 120, "ingest_blocks_waited": 8}}), data=DATA)
    assert read(win) == pytest.approx(100.0 * 220 / 256)
    win = Window(counts=counts({"counters": {"ingest_blocks_ready": 64, "ingest_units": 16}}), data=DATA)
    assert read(win) == 100.0


@pytest.mark.parametrize("snapshot", [{"counters": {"chunks": 8, "d2h_bytes": 100}}, {},
                                      {"counters": {"ingest_blocks_ready": 0, "ingest_blocks_waited": 0}}],
                         ids=["parent", "no_counters", "nothing_served"])
def test_no_counters_read_nothing(snapshot):
    win = Window(counts=counts(snapshot, snapshot), data=DATA)
    assert read(win) is None
