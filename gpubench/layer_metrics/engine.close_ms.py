"""The close of a count's chunk stream (the feed closed, the prefetch
thread joined, the source closed): the program's ``close`` span (a timer),
ms a count (summed over the traced window's counts, divided by the
counts)."""


def read(window):
    return window.timer_ms_per_count("close")
