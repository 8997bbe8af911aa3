"""The share of the parsed blocks that the ingest's consumer took already
parsed: the program's ``ingest_blocks_ready`` over it and
``ingest_blocks_waited`` (the blocks it had to wait for), summed over the
traced window's counts, %.  A program without the counters, or a window
that served no block, reads nothing."""


def read(window):
    counters = [c.stats.metrics.get("counters", {}) for c in window.counts if c.stats is not None]
    if not any("ingest_blocks_ready" in c or "ingest_blocks_waited" in c for c in counters):
        return None
    ready = sum(c.get("ingest_blocks_ready", 0) for c in counters)
    total = ready + sum(c.get("ingest_blocks_waited", 0) for c in counters)
    return 100.0 * ready / total if total else None
