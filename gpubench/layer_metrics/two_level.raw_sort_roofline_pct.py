"""The two-level raw sort's share of its roofline, %: the bytes a count's
raw sorts need together (each valid window's key lanes read once and its
sorted row written once: 8 bytes a lane a valid window) at the card's
peak rate, against the device time of everything launched inside the
program's ``kmer.consolidate.raw_sort`` spans.  A program without the
span reads nothing."""

from gpubench import roofline

SPAN = "kmer.consolidate.raw_sort"


def raw_sort_bytes(data: dict) -> int:
    """A count's raw sorts: 4 bytes a key lane read and 4 written, for
    every valid window."""
    return 8 * roofline.lanes(data["k"]) * data["valid_windows"]


def read(window):
    return window.roofline_pct(SPAN, raw_sort_bytes(window.data))
