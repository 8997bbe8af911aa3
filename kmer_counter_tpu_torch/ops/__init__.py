"""Device ops of the port: encode, extract, chunk step, sort-reduce, the
two-level table and the merge-fold-compact kernel (see each module)."""
