"""Device ops of the port: encode, extract, the fused extraction kernel
behind the chunk step, sort-reduce, the tables and the merge, compaction
and sort kernels (see each module)."""
