"""The prefetch thread blocked on a free pinned slot of the feed's ring
(back-pressure from the card): the program's ``feed.acquire`` span (a
timer, in the prefetch thread), ms a count (summed over the traced
window's counts, divided by the counts)."""


def read(window):
    return window.timer_ms_per_count("feed.acquire")
