"""The card's peak and the work of each layer, counted from the cell's
data, never from a kernel's name or launch shape: a kernel that a later
change replaces leaves the work, and so the share, as it was.

Peak: the H100 SXM data sheet's device-memory rate, 3.35 TB/s at a 700 W
power limit (the run logs the card's limit beside it).  Every layer here
is bound by bytes: counting keys does no arithmetic worth a bound."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def lanes(k: int) -> int:
    """32-bit key lanes a k-mer takes on the card (2 bits a base)."""
    return -(-k // 16)


def chunk_step_bytes(data: dict) -> int:
    """A count's chunk steps: each read byte read once, and each window's
    key lanes written once."""
    return data["reads"] * data["read_length"] + 4 * lanes(data["k"]) * data["windows"]


def consolidate_bytes(data: dict) -> int:
    """A count's consolidations together: each valid window's key read once,
    and the count's distinct table (key lanes and a count a row) written
    once."""
    NL = lanes(data["k"])
    return 4 * NL * data["valid_windows"] + 4 * (NL + 1) * data["distinct"]


def roofline_pct(bytes_per_count: int, counts: int, device_us: float):
    """Percent of the bound's time (the bytes at the peak rate) that the
    device took, or None when nothing ran there."""
    if device_us <= 0 or counts <= 0:
        return None
    return 100.0 * (bytes_per_count * counts / HBM_BYTES_PER_S) / (device_us / 1e6)
