"""The one-level table's consolidations before the finalize, on the host's
clock (each ends in a read-back of the distinct count): the program's
``consolidate`` timer, ms a count (summed over the traced window's counts,
divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("consolidate")
