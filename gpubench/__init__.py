"""The benchmark of kmer_counter_tpu_torch: whole CLI counts on one card.

``python3 gpubench/run.py --workload <config>.<traffic> --seed N --seconds S --trace 0|1``
from the root of a checkout.  Nothing here imports JAX or the JAX package.
"""
