"""kmer_counter_tpu_torch — the PyTorch + CUDA port of kmer_counter_tpu.

The JAX package (``kmer_counter_tpu``) stays the reference; this package
runs the same single-device count paths on an NVIDIA GPU:

  __main__ (CLI)          → engine.CountEngine (chunk loop, ingest thread)
  ops.pipeline            → chunk step: ops.fused_extract (K8: encode +
                            extract, written into the raw region)
  ops.table2              → two-level table: raw sort + consolidation
                            (consolidate3 and its split variants)
  ops.table               → one-level table (tableImpl=one)
  ops.sortcount           → multi-lane sort + segment reduce (finalize)

and, each replacing Pallas kernels with hand-written CUDA (csrc/):
ops.merge_fold_compact (K1, and the kernel template that ops.merge_runs'
K3/K4/K5 share), ops.compact_live (K2) and ops.lane_sort (K6 + K7, the
sort behind sortcount.device_sort), all of pallas_sort; and
ops.fused_extract (K8, docs/experiments_pallas_extract.py: the chunk
step; its plain version is ops.encode + ops.extract).

The NumPy-only layers it needs are its own copies of the JAX package's:
config (Options), records (the ABI), metrics, and io.fastq / io.native /
io.dump / io.printer.  Nothing here imports jax or the JAX package.

Conventions: device key lanes and counts are ``torch.int32`` tensors that
hold the uint32 bit pattern (torch's uint32 lacks shifts and compares on
CPU); plain versions widen to int64 before they compare, shift or add.
There is no global device choice: callers pass a ``torch.device`` to
``engine.CountEngine`` and everything below follows its tensors.
"""

from kmer_counter_tpu_torch import records
from kmer_counter_tpu_torch.config import Options

__version__ = "0.1.0"

__all__ = ["Options", "records", "__version__"]
