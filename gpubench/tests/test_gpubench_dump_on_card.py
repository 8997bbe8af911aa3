"""The reader of the dump's route counters, ``dump.on_card_pct``, on
hand-built windows: 100 where the card formatted every record, the card's
share where both routes wrote, and nothing without the counters."""

import pytest

from gpubench import cells
from gpubench.harness import Window
from gpubench.tests.test_gpubench_spans import DATA, counts


def read(window):
    return cells.load_reader(cells.BENCH_DIR, "dump.on_card_pct")(window)


def test_card_only_counters_read_100():
    win = Window(counts=counts({"counters": {"dump_records_card": 4_000}},
                               {"counters": {"dump_records_card": 5_000}}), data=DATA)
    assert read(win) == 100.0


def test_mixed_counters_read_the_cards_share():
    win = Window(counts=counts({"counters": {"dump_records_card": 3_000, "dump_records_host": 1}},
                               {"counters": {"dump_records_host": 999}}), data=DATA)
    assert read(win) == pytest.approx(75.0)
    win = Window(counts=counts({"counters": {"dump_records_host": 10}}), data=DATA)
    assert read(win) == 0.0


@pytest.mark.parametrize("snapshot", [{"counters": {"chunks": 8, "d2h_bytes": 100}}, {},
                                      {"counters": {"dump_records_card": 0, "dump_records_host": 0}}],
                         ids=["parent", "no_counters", "nothing_dumped"])
def test_no_counters_read_nothing(snapshot):
    win = Window(counts=counts(snapshot, snapshot), data=DATA)
    assert read(win) is None
