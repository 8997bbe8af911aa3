"""The chunk step's share of its roofline, %: the bytes it needs (each
read byte read once, each window's key lanes written once) at the card's
peak rate, against the device time of every kernel and copy launched
inside the chunk-step spans (K8 and the one-level table's append)."""

from gpubench import roofline


def read(window):
    return window.roofline_pct("chunk_step", roofline.chunk_step_bytes(window.data))
