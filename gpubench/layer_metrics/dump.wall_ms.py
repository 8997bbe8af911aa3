"""The dump, from the finalized table on the host to the written output:
the program's ``dump`` span (a timer), ms a count (summed over the traced
window's counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("dump")
