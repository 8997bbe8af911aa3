"""The one-level slice on CPU (``tableImpl=one``): the port's CLI and
CountEngine against the JAX CLI and CountEngine with ``tableImpl=one``,
and against golden.  Output files must be byte-identical.
"""

import pytest
import torch

from kmer_counter_tpu.__main__ import main as jax_main
from kmer_counter_tpu.config import Options
from kmer_counter_tpu.engine import CountEngine as JaxCountEngine
from kmer_counter_tpu_torch.__main__ import main
from kmer_counter_tpu_torch.engine import CountEngine

from tests.test_ingest import random_seqs, write_fastq
from tests.test_torch_engine import golden_bytes

CPU = torch.device("cpu")


def _input(tmp_path, rng, n_reads, length, all_t=False):
    (tmp_path / "in").mkdir()
    seqs = random_seqs(rng, n_reads, length)
    for i in range(0, n_reads, 3):  # N bases in every third read
        p = int(rng.integers(0, length))
        seqs[i] = seqs[i][:p] + "N" + seqs[i][p + 1 :]
    if all_t:
        seqs[3] = "T" * length
        seqs[4] = "T" * (length // 2) + "N" + "T" * (length - length // 2 - 1)
    write_fastq(tmp_path / "in" / "a.fastq", seqs[: n_reads // 2])
    write_fastq(tmp_path / "in" / "b.fastq", seqs[n_reads // 2 :])


@pytest.mark.parametrize(
    "k,canonical,all_t",
    [(15, False, False), (16, False, True), (31, True, False), (55, False, False), (101, True, False)],
)
def test_cli_one_level_matches_jax_cli_and_golden(tmp_path, rng, k, canonical, all_t):
    _input(tmp_path, rng, 30, 120, all_t)
    argv = [f"kmerLength={k}", f"canonical={str(canonical).lower()}", "tableImpl=one",
            f"inputFileLocation={tmp_path / 'in'}", "readsPerChunk=4", "tableSlots=300", "verbose=0"]
    assert main(argv + [f"outputFile={tmp_path / 'port.bin'}"], device=CPU) == 0
    assert jax_main(argv + [f"outputFile={tmp_path / 'jax.bin'}"]) == 0
    port = (tmp_path / "port.bin").read_bytes()
    assert len(port) > 0
    assert port == (tmp_path / "jax.bin").read_bytes() == golden_bytes(tmp_path, k, canonical)


def test_engine_one_level_grows_the_table(tmp_path, rng, capsys):
    _input(tmp_path, rng, 40, 60)
    stats = []
    for name, engine in (("port", lambda o: CountEngine(o, device=CPU)), ("jax", JaxCountEngine)):
        opts = Options(kmer_length=21, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / f"{name}.bin"),
                       verbose=1, reads_per_chunk=4, table_slots=64, table_impl="one")
        stats.append(engine(opts).run())
        assert "growing table" in capsys.readouterr().out
    port = (tmp_path / "port.bin").read_bytes()
    assert port == (tmp_path / "jax.bin").read_bytes() == golden_bytes(tmp_path, 21, False)
    ps, js = stats
    assert ps.consolidations > 2
    for field in ("reads", "bases", "chunks", "consolidations", "distinct_kmers", "total_kmers"):
        assert getattr(ps, field) == getattr(js, field), field


def test_engine_one_level_spill_is_not_ported(tmp_path, rng):
    """The options that raised before spilling was ported: the table now
    spills to tempFileLocation instead of growing past twice tableSlots,
    and the dump equals the JAX engine's and golden."""
    _input(tmp_path, rng, 40, 60)
    stats = []
    for name, engine in (("port", lambda o: CountEngine(o, device=CPU)), ("jax", JaxCountEngine)):
        opts = Options(kmer_length=21, input_dir=str(tmp_path / "in"), output_file=str(tmp_path / f"{name}.bin"),
                       verbose=0, reads_per_chunk=4, table_slots=64, table_impl="one",
                       temp_dir=str(tmp_path / f"spill_{name}"))
        stats.append(engine(opts).run())
    port = (tmp_path / "port.bin").read_bytes()
    assert port == (tmp_path / "jax.bin").read_bytes() == golden_bytes(tmp_path, 21, False)
    assert stats[0].spilled_runs >= 2
    assert stats[0].distinct_kmers == stats[1].distinct_kmers
