"""The finalize's copy of the finalized table to the host, with its host
transpose: the program's ``finalize.copy_back`` span (a timer, inside
``finalize``), ms a count (summed over the traced window's counts, divided
by the counts)."""


def read(window):
    return window.timer_ms_per_count("finalize.copy_back")
