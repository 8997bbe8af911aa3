"""A count's set-up before its first chunk (the source opened and probed,
the plan, a resume, the feed's ring, the table's allocation): the
program's ``setup`` span (a timer), ms a count (summed over the traced
window's counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("setup")
