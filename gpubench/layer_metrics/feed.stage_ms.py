"""The chunk's copy into its pinned slot, in the prefetch thread: the
program's ``stage`` timer, ms a count (summed over the traced window's
counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("stage")
