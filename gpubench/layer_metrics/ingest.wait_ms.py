"""The main thread blocked on the queue of parsed chunks: the program's
``ingest_wait`` timer, ms a count (summed over the traced window's counts,
divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("ingest_wait")
