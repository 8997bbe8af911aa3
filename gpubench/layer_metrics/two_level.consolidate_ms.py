"""The two-level table's consolidations, mid-run and final, on the host's
clock (each ends in a read-back of the live count): the program's
``consolidate`` timer, ms a count (summed over the traced window's counts,
divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("consolidate")
