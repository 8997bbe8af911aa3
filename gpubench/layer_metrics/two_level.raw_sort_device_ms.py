"""The two-level table's raw sort, device ms a count: every kernel and
copy launched inside the program's ``kmer.consolidate.raw_sort`` spans
(the stable sort passes over the raw rows' int64 digits and their
gathers; mid-run and final consolidations), summed over the traced
window, divided by its counts.  A program without the span reads
nothing."""

from gpubench import trace as tr

SPAN = "kmer.consolidate.raw_sort"


def read(window):
    if not window.events or not window.counts:
        return None
    us, n = tr.layer_device_us(window.events, SPAN)
    return us / 1e3 / len(window.counts) if n else None
