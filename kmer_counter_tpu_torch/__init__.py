"""kmer_counter_tpu_torch — the PyTorch + CUDA port of kmer_counter_tpu.

The JAX package (``kmer_counter_tpu``) stays the reference; this package
runs the same single-device two-level count path on an NVIDIA GPU:

  __main__ (CLI)          → engine.CountEngine (chunk loop, ingest thread)
  ops.pipeline            → chunk step: ops.encode + ops.extract + raw append
  ops.table2              → two-level table: raw sort + consolidation
  ops.merge_fold_compact  → the hand-written CUDA kernel (csrc/) that
                            replaces pallas_sort.merge_fold_compact_bitonic
  ops.sortcount           → multi-lane sort + segment reduce (finalize)

NumPy-only layers are reused from the JAX package, not copied: config
(Options), records (ABI), io.fastq / io.dump / io.printer, golden and
utils.seqgen.  Nothing here imports jax.

Conventions: device key lanes and counts are ``torch.int32`` tensors that
hold the uint32 bit pattern (torch's uint32 lacks shifts and compares on
CPU); plain versions widen to int64 before they compare, shift or add.
There is no global device choice: callers pass a ``torch.device`` to
``engine.CountEngine`` and everything below follows its tensors.
"""

from kmer_counter_tpu import records
from kmer_counter_tpu.config import Options

__version__ = "0.1.0"

__all__ = ["Options", "records", "__version__"]
