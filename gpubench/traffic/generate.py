"""The one generator of read sets: a random genome, reads sampled
uniformly from it, substitutions, 'N' bases, written as FASTQ files.

The sampling and the FASTQ format are a frozen copy of ``sample_reads``
and ``write_fastq`` from the repository's ``chip_smoke.py``; substitutions
are new.  A traffic file (``<traffic>.json``) holds the parameters:

    genome_length       bases of the random ACGT genome
    reads, read_length  the read set's shape
    substitution_share  each base, independently, replaced by one of the
                        other three (uniformly), before the 'N' mask
    n_share             each base, independently, replaced by 'N'
    files               FASTQ files the reads are split into, in order

The same seed gives the same reads.  Positions of substitutions and of
'N' are drawn as a Bernoulli process, by geometric gaps, so that their
cost follows their number and not the read set's size.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
PARAMS = ("genome_length", "reads", "read_length", "substitution_share", "n_share", "files")


def rng_of(seed: int) -> np.random.Generator:
    """The generator for any whole-number seed (negative ones included)."""
    return np.random.default_rng(seed % (1 << 64))


def bernoulli_positions(rng: np.random.Generator, n: int, p: float) -> np.ndarray:
    """Ascending positions in [0, n), each taken with probability p
    independently of the others."""
    if p <= 0 or n <= 0:
        return np.zeros(0, np.int64)
    mean = n * p
    parts, last = [], -1
    while True:
        gaps = rng.geometric(p, size=int(mean + 8 * mean ** 0.5 + 64))
        pos = last + np.cumsum(gaps)
        parts.append(pos[pos < n])
        if pos[-1] >= n:
            return np.concatenate(parts)
        last = int(pos[-1])


def make_reads(params: dict, seed: int) -> np.ndarray:
    """[reads, read_length] uint8 ASCII reads of the traffic ``params``."""
    missing = [p for p in PARAMS if p not in params]
    if missing:
        raise ValueError(f"traffic parameters missing: {', '.join(missing)}")
    G, R, L = int(params["genome_length"]), int(params["reads"]), int(params["read_length"])
    if not 0 < L <= G:
        raise ValueError(f"read_length {L} must be in 1..genome_length {G}")
    rng = rng_of(seed)
    genome = ACGT[rng.integers(0, 4, size=G, dtype=np.uint8)]
    starts = rng.integers(0, G - L + 1, size=R)
    reads = np.lib.stride_tricks.sliding_window_view(genome, L)[starts]
    flat = reads.reshape(-1)
    sub = bernoulli_positions(rng, flat.size, float(params["substitution_share"]))
    if len(sub):
        code = (flat[sub] >> 1 ^ flat[sub] >> 2) & 3  # A, C, G, T -> 0, 1, 2, 3
        flat[sub] = ACGT[(code + rng.integers(1, 4, size=len(sub), dtype=np.uint8)) & 3]
    flat[bernoulli_positions(rng, flat.size, float(params["n_share"]))] = ord("N")
    return reads


def write_fastq(path: str, reads: np.ndarray) -> None:
    """4-line FASTQ records ("@r", the read, "+", a quality of 'I's)."""
    R, L = reads.shape
    rec = np.empty((R, 2 * L + 7), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3 : 3 + L] = reads
    rec[:, 3 + L : 6 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + L : 6 + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())


def write_read_set(directory: str, params: dict, reads: np.ndarray) -> list[str]:
    """The reads split in order into ``files`` FASTQ files in ``directory``;
    returns their paths."""
    os.makedirs(directory, exist_ok=True)
    files = int(params["files"])
    bounds = np.linspace(0, len(reads), files + 1).astype(np.int64)
    paths = []
    for f in range(files):
        path = os.path.join(directory, f"reads_{f:02d}.fastq")
        write_fastq(path, reads[bounds[f] : bounds[f + 1]])
        paths.append(path)
    return paths
