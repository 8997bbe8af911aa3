"""The part of a count's ``run`` span that no span opened directly inside
it on the main thread covers (set-up, the waits for chunks, the
dispatches, the consolidations, the finalize, the close, the dump, and
any other phase a path opens there): the work no layer owns yet, from the
program's ``unspanned_us`` counter, ms a count (summed over the traced
window's counts, divided by the counts)."""


def read(window):
    counters = [c.stats.metrics.get("counters", {}) for c in window.counts if c.stats is not None]
    if not counters or not any("unspanned_us" in c for c in counters):
        return None
    return sum(c.get("unspanned_us", 0) for c in counters) / 1e3 / len(window.counts)
