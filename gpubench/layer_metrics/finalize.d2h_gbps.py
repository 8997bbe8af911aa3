"""The rate of the copies from the card to the host, GB/s: the bytes the
finalize's copy back reads from the card (the program's ``d2h_bytes``
counter, summed over the traced window's counts) over the device time of
every device-to-host copy launched inside the counts' spans (the
finalize's copies and a few 4-byte read-backs, whose time is a small
fraction of theirs)."""

from gpubench import trace as tr

D2H = "Memcpy DtoH"


def read(window):
    counters = [c.stats.metrics.get("counters", {}) for c in window.counts if c.stats is not None]
    moved = sum(c.get("d2h_bytes", 0) for c in counters)
    if not window.events or not any("d2h_bytes" in c for c in counters):
        return None
    copies = [e for e in window.events if e["kind"] != "device" or e["name"].startswith(D2H)]
    us, n = tr.layer_device_us(copies, "count")
    return moved / (us * 1e3) if n and us > 0 else None
