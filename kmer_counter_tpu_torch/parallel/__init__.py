"""Several positions and processes — counterpart of
kmer_counter_tpu.parallel.

Reads are data-parallel over the positions of a mesh (parallel.mesh);
each position accumulates a partial count table of the single-device
engine's kind; at merge time every record goes to the position that owns
its key range (parallel.shuffle), which sort-reduces its range, and the
range tables concatenated in position order are the globally sorted
table (parallel.pipeline).
"""

from kmer_counter_tpu_torch.parallel.mesh import Mesh, make_mesh
from kmer_counter_tpu_torch.parallel.pipeline import ShardedCounter, ShardedCounter2

__all__ = ["Mesh", "make_mesh", "ShardedCounter", "ShardedCounter2"]
