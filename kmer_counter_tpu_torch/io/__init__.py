"""Host I/O of the port: FASTQ ingest (io.fastq, with the C++ reader in
io.native), the record dump (io.dump) and the text printer (io.printer).
Copies of the JAX package's modules of the same names, so that the port
imports nothing of it."""
