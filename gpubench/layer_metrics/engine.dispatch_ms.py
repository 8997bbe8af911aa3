"""The engine loop's enqueue of each chunk's copy and step, on the host
(not device time): the program's ``dispatch`` timer, ms a count (summed
over the traced window's counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("dispatch")
