"""The consolidations' share of their roofline, %: the bytes a count's
consolidations need together (each valid window's key read once, the
distinct table written once) at the card's peak rate, against the device
time of every kernel and copy launched inside the consolidation spans
(the raw sort, the merges, the prefix's growth; mid-run and final)."""

from gpubench import roofline


def read(window):
    return window.roofline_pct("consolidate", roofline.consolidate_bytes(window.data))
