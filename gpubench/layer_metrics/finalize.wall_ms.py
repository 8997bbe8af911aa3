"""The finalize, to the sorted table on the host, on the host's clock: the
program's ``finalize`` timer, ms a count (summed over the traced window's
counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("finalize")
