"""The plain reference: an independent NumPy count of the reads the
harness generated, and the dump's record format."""
