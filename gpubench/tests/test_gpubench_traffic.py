"""The generator: the same seed gives the same reads, of the stated sizes,
'N' and substitution shares."""

import json
import os

import numpy as np
import pytest

from gpubench import cells
from gpubench.traffic import generate

PARAMS = {"genome_length": 50_000, "reads": 20_000, "read_length": 100, "substitution_share": 0.01,
          "n_share": 0.001, "files": 4}


def test_same_seed_same_reads_and_another_seed_other_reads():
    a = generate.make_reads(PARAMS, 2**33 + 1)
    assert np.array_equal(a, generate.make_reads(PARAMS, 2**33 + 1))
    assert not np.array_equal(a, generate.make_reads(PARAMS, 2**33 + 2))


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11, -3])
def test_sizes_and_shares(seed):
    reads = generate.make_reads(PARAMS, seed)
    assert reads.shape == (20_000, 100) and reads.dtype == np.uint8
    n = reads.size
    assert set(np.unique(reads).tobytes()) <= set(b"ACGTN")
    share_n = (reads == ord("N")).sum() / n
    assert abs(share_n - 0.001) < 5 * (0.001 / n) ** 0.5
    clean = generate.make_reads(dict(PARAMS, substitution_share=0.0, n_share=0.0), seed)
    # The same genome and starts: the substitutions are where clean and
    # erroneous reads differ outside the N positions.
    diff = (clean != reads) & (reads != ord("N"))
    share_sub = diff.sum() / n
    assert abs(share_sub - 0.01) < 5 * (0.01 / n) ** 0.5


def test_a_substitution_always_changes_the_base_uniformly():
    p = dict(PARAMS, substitution_share=0.2, n_share=0.0)
    clean = generate.make_reads(dict(p, substitution_share=0.0), 9)
    noisy = generate.make_reads(p, 9)
    changed = clean != noisy
    code = {ord(b): i for i, b in enumerate("ACGT")}
    lut = np.zeros(256, np.int64)
    for b, i in code.items():
        lut[b] = i
    shift = (lut[noisy[changed]] - lut[clean[changed]]) % 4
    counts = np.bincount(shift, minlength=4)
    assert counts[0] == 0
    assert all(abs(c / changed.sum() - 1 / 3) < 0.01 for c in counts[1:])


def test_bernoulli_positions_are_a_bernoulli_process():
    rng = generate.rng_of(3)
    pos = generate.bernoulli_positions(rng, 10_000_000, 0.001)
    assert np.all(np.diff(pos) > 0) and pos[0] >= 0 and pos[-1] < 10_000_000
    assert abs(len(pos) - 10_000) < 5 * 100
    assert len(generate.bernoulli_positions(rng, 1000, 0.0)) == 0


def test_fastq_files_hold_the_reads_in_order(tmp_path):
    reads = generate.make_reads(PARAMS, 4)
    paths = generate.write_read_set(str(tmp_path), PARAMS, reads)
    assert [os.path.basename(p) for p in paths] == [f"reads_{i:02d}.fastq" for i in range(4)]
    lines = b"".join(open(p, "rb").read() for p in paths).split(b"\n")
    assert len(lines) == 4 * len(reads) + 1 and lines[-1] == b""
    assert all(lines[4 * i + 1] == reads[i].tobytes() for i in range(0, len(reads), 997))
    assert lines[0] == b"@r" and lines[2] == b"+" and lines[3] == b"I" * 100


@pytest.mark.parametrize("traffic", ["ecoli", "ecoli_err"])
def test_each_mix_states_every_parameter(traffic):
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        workloads = json.load(fh)["workloads"]
    cell = cells.resolve(next(w["name"] for w in workloads if w["traffic"] == traffic))
    assert all(p in cell.traffic for p in generate.PARAMS)
    assert cell.traffic["genome_length"] == 4_641_652 and cell.traffic["reads"] == 2_000_000
    assert cell.traffic["substitution_share"] == (0.01 if traffic == "ecoli_err" else 0.0)
