"""Worker of tests/test_torch_multiprocess.py: one rank of a gloo process
group that runs the port's MeshCountEngine over CPU positions (two by
default), once for each job, in order, in the one process group.

    python tests/torch_multiproc_worker.py RANK WORLD STORE JOB [-- JOB ...]

    JOB: INPUT_DIR OUTPUT_FILE TABLE_IMPL K [TABLE_SLOTS [TEMP_DIR [CHECKPOINT_DIR CHECKPOINT_EVERY]]]

STORE is the path of the group's FileStore (no TCP port, so that tests
may run in parallel).  KMER_TEST_POSITIONS=P gives each rank P positions
(2 by default), on KMER_TEST_DEVICE (cpu by default; cuda puts every
position on the one card, which gloo's collectives take through the
host).  KMER_TEST_CRASH_AFTER_CHUNKS=N makes every rank exit
with code 17 before its step N+1 (the same step on every rank, so the
collectives stay in lockstep up to the crash).  Each job that ends prints
``rank R ok out=OUTPUT_FILE ...``.
"""

import datetime
import os
import sys


def main():
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jobs, job = [], []
    for arg in sys.argv[4:] + ["--"]:
        if arg == "--":
            jobs.append(job)
            job = []
        else:
            job.append(arg)

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from kmer_counter_tpu_torch.config import Options
    from kmer_counter_tpu_torch.engine import MeshCountEngine
    from kmer_counter_tpu_torch.parallel import pipeline as pl
    from kmer_counter_tpu_torch.parallel.mesh import make_mesh

    crash_after = int(os.environ.get("KMER_TEST_CRASH_AFTER_CHUNKS", "0"))
    if crash_after:
        for cls in (pl.ShardedCounter, pl.ShardedCounter2):
            real, done = cls.step, [0]

            def step(self, reads, _real=real, _done=done):
                if _done[0] >= crash_after:
                    print(f"rank {rank} simulated crash", flush=True)
                    os._exit(17)
                _done[0] += 1
                return _real(self, reads)

            cls.step = step

    positions = int(os.environ.get("KMER_TEST_POSITIONS", "2"))
    device = torch.device(os.environ.get("KMER_TEST_DEVICE", "cpu"))
    for job in jobs:
        input_dir, output_file, impl, k = job[0], job[1], job[2], int(job[3])
        table_slots = int(job[4]) if len(job) > 4 else 0
        temp_dir = (job[5] or None) if len(job) > 5 else None
        ckpt_dir = job[6] if len(job) > 6 else None
        ckpt_every = int(job[7]) if len(job) > 7 else 0
        opts = Options(kmer_length=k, canonical=True, input_dir=input_dir, output_file=output_file, table_impl=impl,
                       reads_per_chunk=32, table_slots=table_slots or None, temp_dir=temp_dir,
                       checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every, verbose=1 if ckpt_dir else 0)
        engine = MeshCountEngine(opts, mesh=make_mesh(devices=[device] * positions))
        stats = engine.run()
        print(f"rank {rank} ok out={output_file} reads={stats.reads} distinct={stats.distinct_kmers} "
              f"consolidations={stats.consolidations} spilled={stats.spilled_runs} rounds={engine.route_rounds}",
              flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
