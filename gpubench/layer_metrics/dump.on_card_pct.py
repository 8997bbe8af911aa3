"""The share of the dumped records that the card formatted: the program's
``dump_records_card`` over it and ``dump_records_host`` (the records each
route of the dump wrote), summed over the traced window's counts, %.  A
program without the counters, or a window that dumped nothing, reads
nothing."""


def read(window):
    counters = [c.stats.metrics.get("counters", {}) for c in window.counts if c.stats is not None]
    if not any("dump_records_card" in c or "dump_records_host" in c for c in counters):
        return None
    card = sum(c.get("dump_records_card", 0) for c in counters)
    total = card + sum(c.get("dump_records_host", 0) for c in counters)
    return 100.0 * card / total if total else None
