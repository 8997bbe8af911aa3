"""Parsing FASTQ into chunks, in the prefetch thread: the program's
``ingest`` timer, ms a count (summed over the traced window's counts,
divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("ingest")
